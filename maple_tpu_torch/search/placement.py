"""Stepwise-addition placement search and application.

``find_best_parent_for_new_sample`` performs the DFS placement search with
the reference's stop rules (allowedFails / thresholdLogLK, strict or
non-strict — reference findBestParentForNewSample :7912-8293);
``place_sample_on_tree`` applies a placement, possibly creating a new root,
and fires dirty propagation (reference placeSampleOnTree :8370-8710).

The per-candidate scoring is the append_prob_node kernel; when a device
batcher is installed (maple_tpu_torch.ops), whole DFS frontiers are scored in one
batched TPU call instead of one merge at a time.
"""
from __future__ import annotations

from math import exp
from typing import Optional

from ..core import genomelist as gl
from ..core import kernels as K
from ..models.hnz import get_hnz
from ..runtime.partials import TreeRuntime


class PlacementStats:
    __slots__ = ("num_minors_found", "total_missed_minors", "sum_child_lks",
                 "num_child_lks", "warned_blen", "dfs_visits", "fine_evals")

    def __init__(self):
        self.num_minors_found = 0
        self.total_missed_minors = 0
        self.sum_child_lks = 0.0
        self.num_child_lks = 0
        self.warned_blen = False
        # native-engine search telemetry: candidate nodes visited by the
        # placement DFS and fine-phase 3-branch optimizations performed
        self.dfs_visits = 0
        self.fine_evals = 0


def find_best_parent_for_new_sample(rt: TreeRuntime, root: int, diffs,
                                    sample, stats: PlacementStats,
                                    compute_placement_support_only=False,
                                    batcher=None, diffs_time=None):
    """Search the whole tree for the best placement of a new sample.

    Returns (best_node, best_score, best_branch_lengths, best_diffs) — with
    best_branch_lengths None when the sample was absorbed as a minor
    sequence.  In support-only mode returns (possiblePlacements,
    bestPlacementTotalLh) instead.
    """
    tree = rt.tree
    cfg = rt.cfg
    dc = rt.dc
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    probVect = tree.probVect
    probVectTotUp = tree.probVectTotUp
    lRef = rt.refd.lRef
    use_hnz = tree.use_hnz
    eff0 = dc.effectivelyNon0BLen
    one_mut = dc.oneMutBLen
    only_identical = (bool(cfg.errorRateSiteSpecificFile)
                      or bool(cfg.errorRateFixed) or cfg.estimateErrorRate
                      or cfg.estimateSiteSpecificErrorRate
                      or cfg.supportFor0Branches or bool(cfg.HnZ))
    strict_stop = not cfg.nonStrictStopRules
    allowed_fails = cfg.allowedFails
    threshold_log_lk = dc.thresholdLogLK
    threshold_opt = dc.thresholdLogLKoptimization
    threshold_consecutive = dc.thresholdLogLKconsecutivePlacement

    dtt = rt.do_time_tree
    if dtt:
        from ..models import timetree as tt
        T = rt.time
        probVectTime = tree.probVectTime
        probVectTotUpTime = tree.probVectTotUpTime
        probVectUpRightTime = tree.probVectUpRightTime
        probVectUpLeftTime = tree.probVectUpLeftTime
    best_nodes = []
    best_node = root
    best_branch_lengths = (False, False, one_mut)
    if tree.mutations[root]:
        diffs = rt.pass_down(diffs, root)
    best_diffs = diffs

    def try_absorb_minor(node, diffs_at):
        """Absorb as a minor sequence if strictly less informative; returns
        True when absorbed (reference :7934-8010)."""
        comparison = kern.is_minor_sequence(probVect[node], diffs_at,
            only_find_identical=only_identical)
        comparison2 = 0
        if dtt:
            comparison2 = tt.is_minor_date(
                probVectTime[node], diffs_time,
                only_find_identical=only_identical)
        if comparison == 1 and ((not dtt) or comparison2 == 1) \
                and not compute_placement_support_only:
            tree.minorSequences[node].append(sample)
            if use_hnz:
                tree.nDesc0[node] += 1
                if dist[node] <= eff0 and up[node] is not None:
                    p0 = node
                    while dist[p0] <= eff0 and up[p0] is not None:
                        p0 = up[p0]
                        tree.nDesc0[p0] += 1
            stats.num_minors_found += 1
            if (not cfg.onlyNambiguities) and rt.model.using_error_rate:
                # refresh routes through the runtime so native mirrors and
                # shared-ambiguity aliasing stay consistent (:3959)
                rt.refresh_terminal_errors(node)
            if dtt:
                tt.update_terminal_time(T, tree, node, diffs_time,
                                        len(tree.minorSequences[node]),
                                        only_add_one=True)
            if (rt.model.using_error_rate or dtt) \
                    and up[node] is not None:
                rt.update_partials(
                    [(node, 2, True, False),
                     (up[node], tree.child_index(node), True, False)])
            return True
        if comparison == 2 and ((not dtt) or comparison2 == 2):
            stats.total_missed_minors += 1
        return False

    if not children[root]:
        if try_absorb_minor(root, diffs):
            return root, 1.0, None, diffs

    root_vect = rt.root_vector(probVect[root], False, False, root)
    best_lk_diff = kern.append_prob_node(root_vect, diffs, True, one_mut)
    if dtt:
        _rv_time, rv_time_cost = tt.merge_vectors_time(
            T, probVectTime[root], 0.0, diffs_time, one_mut,
            return_lk=True)
        best_lk_diff += rv_time_cost
    if use_hnz:
        best_lk_diff += get_hnz(cfg.HnZ, tree.nDesc0[root] + 1) \
            - get_hnz(cfg.HnZ, tree.nDesc0[root])
    original_lk_diff = best_lk_diff
    nodes_to_visit = []
    for child in children[root]:
        dc_child = diffs
        if tree.mutations[child]:
            dc_child = rt.pass_down(diffs, child)
        nodes_to_visit.append((child, best_lk_diff, 0, dc_child))

    while nodes_to_visit:
        t1, parent_lk, failed_passes, diffs_at = nodes_to_visit.pop()
        if not children[t1]:
            if try_absorb_minor(t1, diffs_at):
                return t1, 1.0, None, diffs_at

        if (dist[t1] > eff0 or dtt) and up[t1] is not None:
            # score a mid-branch placement above t1
            if cfg.deeperSearchForLongBranches \
                    and dist[t1] > dc.BLenThresholdDeeperSearch:
                up_vect = tree.vect_up_for(t1)
                if tree.mutations[t1]:
                    up_vect = rt.pass_down(up_vect, t1)
                is_tip = tree.is_tip(t1)
                best_appending = one_mut
                mid_lower = kern.merge_vectors(probVect[t1], dist[t1] / 2, is_tip, diffs_at,
                    best_appending, True)
                best_top = kern.estimate_branch_length(up_vect, mid_lower)
                mid_top = kern.merge_vectors(up_vect, best_top, False, diffs_at, best_appending,
                    True, is_up_down=True)
                best_bottom = kern.estimate_branch_length(mid_top, probVect[t1], from_tip_c=is_tip)
                new_mid = kern.merge_vectors(up_vect, best_top, False, probVect[t1], best_bottom,
                    is_tip, is_up_down=True)
                lk_diff = kern.append_prob_node(new_mid, diffs_at, True,
                                             best_appending)
                if dtt:
                    up_vect_time = probVectUpRightTime[up[t1]] \
                        if t1 == children[up[t1]][0] \
                        else probVectUpLeftTime[up[t1]]
                    nmt = tt.merge_vectors_time(
                        T, up_vect_time, best_top, probVectTime[t1],
                        best_bottom, is_up_down=True, return_lk=True)
                    if isinstance(nmt[0], int):
                        lk_diff += float("-inf")
                    else:
                        lk_diff += nmt[1]
                if use_hnz:
                    lk_diff += _hnz_mid_branch_term(
                        rt, t1, best_top, best_bottom)
            else:
                lk_diff = kern.append_prob_node(probVectTotUp[t1],
                                             diffs_at, True, one_mut)
                best_bottom = dist[t1] / 2
                best_top = dist[t1] / 2
                best_appending = one_mut
                if dtt:
                    lk_diff += probVectTotUpTime[t1][1]
                    lk_diff += tt.append_prob_node_time(
                        T, probVectTotUpTime[t1][0], diffs_time, one_mut)
                if use_hnz:
                    if dist[t1] <= eff0:
                        p0 = up[t1]
                        while dist[p0] <= eff0 and up[p0] is not None:
                            p0 = up[p0]
                        lk_diff += get_hnz(cfg.HnZ, tree.nDesc0[p0] + 1) \
                            - get_hnz(cfg.HnZ, tree.nDesc0[p0])
                    else:
                        lk_diff += get_hnz(cfg.HnZ, 2) - get_hnz(cfg.HnZ, 1)
            if lk_diff >= best_lk_diff:
                kern.shorten(diffs_at)
                best_lk_diff = lk_diff
                best_node = t1
                failed_passes = 0
                best_nodes.append((t1, lk_diff, diffs_at))
                best_diffs = diffs_at
                best_branch_lengths = (best_top, best_bottom / 2,
                                       best_appending)
            elif lk_diff > best_lk_diff - threshold_opt:
                best_nodes.append((t1, lk_diff, diffs_at))
            if lk_diff < (parent_lk - threshold_consecutive):
                failed_passes += 1
        else:
            lk_diff = parent_lk

        if strict_stop:
            keep_going = (failed_passes <= allowed_fails
                          and lk_diff > best_lk_diff - threshold_log_lk)
        else:
            keep_going = (failed_passes <= allowed_fails
                          or lk_diff > best_lk_diff - threshold_log_lk)
        if keep_going:
            for c in children[t1]:
                dc_child = diffs_at
                if tree.mutations[c]:
                    dc_child = rt.pass_down(diffs_at, c)
                nodes_to_visit.append((c, lk_diff, failed_passes, dc_child))

    # ---- fine placement: optimize branch lengths on the best candidates ----
    best_score = best_lk_diff
    if compute_placement_support_only:
        support_state = _SupportState()
    best_mid_vector = None
    for node, score, diffs_at in best_nodes:
        if not (score >= best_lk_diff - threshold_opt
                or (compute_placement_support_only
                    and score >= best_lk_diff
                    - dc.thresholdLogLKoptimizationTopology)):
            continue
        up_vect = tree.vect_up_for(node)
        if tree.mutations[node]:
            up_vect = rt.pass_down(up_vect, node)
        is_tip = tree.is_tip(node)
        best_appending = kern.estimate_branch_length(probVectTotUp[node], diffs_at, from_tip_c=True)
        mid_lower = kern.merge_vectors(probVect[node], dist[node] / 2, is_tip, diffs_at,
            best_appending, True)
        best_top = kern.estimate_branch_length(up_vect, mid_lower)
        mid_top = kern.merge_vectors(up_vect, best_top, False, diffs_at, best_appending, True,
            is_up_down=True)
        best_bottom = kern.estimate_branch_length(mid_top, probVect[node], from_tip_c=is_tip)
        new_mid = kern.merge_vectors(up_vect, best_top, False, probVect[node], best_bottom,
            is_tip, is_up_down=True)
        appending_cost = kern.append_prob_node(new_mid, diffs_at, True,
                                            best_appending)
        if dtt:
            up_vect_time = probVectUpRightTime[up[node]] \
                if node == children[up[node]][0] \
                else probVectUpLeftTime[up[node]]
            nmt = tt.merge_vectors_time(
                T, up_vect_time, best_top, probVectTime[node], best_bottom,
                is_up_down=True, return_lk=True)
            if isinstance(nmt[0], int):
                appending_cost += float("-inf")
            else:
                appending_cost += tt.append_prob_node_time(
                    T, nmt[0], diffs_time, best_appending)
                appending_cost += nmt[1]
                appending_cost -= tt.append_prob_node_time(
                    T, up_vect_time, probVectTime[node], dist[node])
        # account for the change in the appended-on branch's own likelihood
        initial_cost = kern.append_prob_node(up_vect, probVect[node],
                                          is_tip, dist[node])
        new_partial_cost = kern.append_prob_node(up_vect, probVect[node], is_tip, best_bottom + best_top)
        optimized_score = appending_cost + new_partial_cost - initial_cost
        if use_hnz:
            optimized_score, best_top, best_bottom = _hnz_optimize_placement(
                rt, node, diffs_at, up_vect, is_tip, optimized_score,
                best_top, best_bottom, best_appending)
        if optimized_score >= best_score:
            best_node = node
            best_score = optimized_score
            best_branch_lengths = (best_top, best_bottom, best_appending)
            best_diffs = diffs_at
            best_mid_vector = new_mid
        if compute_placement_support_only:
            support_state.record(rt, node, optimized_score,
                                 (best_top, best_bottom, best_appending),
                                 new_mid)

    if best_score == float("-inf"):
        best_score = original_lk_diff

    if compute_placement_support_only:
        return support_state.finalize(
            rt, root, best_score, best_node, best_branch_lengths,
            best_mid_vector)
    return best_node, best_score, best_branch_lengths, best_diffs


def _hnz_mid_branch_term(rt, t1, best_top, best_bottom):
    tree = rt.tree
    cfg = rt.cfg
    eff0 = rt.dc.effectivelyNon0BLen
    if best_top > eff0 and best_bottom > eff0:
        return get_hnz(cfg.HnZ, 2) - get_hnz(cfg.HnZ, 1)
    if best_top > eff0:
        return get_hnz(cfg.HnZ, tree.nDesc0[t1] + 1) \
            - get_hnz(cfg.HnZ, tree.nDesc0[t1])
    p0 = tree.up[t1]
    while tree.dist[p0] <= eff0 and tree.up[p0] is not None:
        p0 = tree.up[p0]
    return get_hnz(cfg.HnZ, tree.nDesc0[p0] + 1) \
        - get_hnz(cfg.HnZ, tree.nDesc0[p0])


def _hnz_optimize_placement(rt, node, diffs_at, up_vect, is_tip,
                            optimized_score, best_top, best_bottom,
                            best_appending):
    """HnZ corrections for the optimized placement, including trying a
    0-length bottom branch (reference :8039-8064, :8151-8200)."""
    tree = rt.tree
    cfg = rt.cfg
    kern = rt.kern
    eff0 = rt.dc.effectivelyNon0BLen
    dist = tree.dist
    up = tree.up
    if best_top > eff0 and best_bottom > eff0:
        optimized_score += get_hnz(cfg.HnZ, 2) - get_hnz(cfg.HnZ, 1)
    elif best_top > eff0:
        optimized_score += get_hnz(cfg.HnZ, tree.nDesc0[node] + 1) \
            - get_hnz(cfg.HnZ, tree.nDesc0[node])
    else:
        p0 = up[node]
        while dist[p0] <= eff0 and up[p0] is not None:
            p0 = up[p0]
        optimized_score += get_hnz(cfg.HnZ, tree.nDesc0[p0] + 1) \
            - get_hnz(cfg.HnZ, tree.nDesc0[p0])
    if best_bottom > eff0 and dist[node] > eff0:
        alt_mid = kern.merge_vectors(up_vect, best_top + best_bottom, False,
            tree.probVect[node], 0.0, is_tip, is_up_down=True)
        alt_cost = kern.append_prob_node(alt_mid, diffs_at, True,
                                      best_appending)
        initial_cost = kern.append_prob_node(up_vect, tree.probVect[node],
                                          is_tip, dist[node])
        new_partial = kern.append_prob_node(up_vect, tree.probVect[node], is_tip,
            best_bottom + best_top)
        alt_optimized = alt_cost + new_partial - initial_cost
        alt_optimized += get_hnz(cfg.HnZ, tree.nDesc0[node] + 1) \
            - get_hnz(cfg.HnZ, tree.nDesc0[node])
        if alt_optimized > optimized_score:
            optimized_score = alt_optimized
            best_top = best_top + best_bottom
            best_bottom = 0.0
    return optimized_score, best_top, best_bottom


class _SupportState:
    """Collects candidate placements for support-only search (reference
    :8105-8293)."""

    def __init__(self):
        self.nodes = []
        self.lk_costs = []
        self.blens = []
        self.total_lhs = []
        self.root_placement = None
        self.root_considered = False

    def record(self, rt, node, score, blens, mid_vector):
        tree = rt.tree
        eff0 = rt.dc.effectivelyNon0BLen
        top, bottom, appending = blens
        different = True
        if top <= eff0:
            different = False
        if tree.dist[node] <= eff0 and tree.up[tree.up[node]] is not None:
            different = False
        if (not self.root_considered) and top <= eff0:
            top_node = tree.up[node]
            while tree.dist[top_node] <= eff0 \
                    and tree.up[top_node] is not None:
                top_node = tree.up[top_node]
            if tree.up[top_node] is None:
                self.root_considered = True
                self.root_placement = (top_node, score, blens, mid_vector)
                return
        if different:
            self.nodes.append(node)
            self.lk_costs.append(score)
            self.blens.append(blens)
            self.total_lhs.append(mid_vector)

    def finalize(self, rt, root, best_score, best_node, best_blens,
                 best_mid_vector):
        tree = rt.tree
        eff0 = rt.dc.effectivelyNon0BLen
        if self.root_placement:
            add_root = True
            if tree.children[root]:
                rc = set(tree.children[root])
                if any(p in rc for p in self.nodes):
                    add_root = False
            if add_root:
                t1, score, blens, lh = self.root_placement
                self.nodes.append(t1)
                self.lk_costs.append(score)
                self.blens.append(blens)
                self.total_lhs.append(lh)
        if not self.nodes:
            self.nodes.append(best_node)
            self.lk_costs.append(best_score)
            self.blens.append(best_blens)
            self.total_lhs.append(best_mid_vector)
        # re-anchor 0-top-length placements at the polytomy parent
        for i in range(len(self.blens)):
            top, bottom, appending = self.blens[i]
            if top <= eff0:
                top_node = self.nodes[i]
                while tree.dist[top_node] <= eff0 \
                        and tree.up[top_node] is not None:
                    top_node = tree.up[top_node]
                if tree.up[top_node] is not None:
                    top_node = tree.up[top_node]
                    while tree.dist[top_node] <= eff0 \
                            and tree.up[top_node] is not None:
                        top_node = tree.up[top_node]
                    self.nodes[i] = top_node
                    self.blens[i] = (tree.dist[top_node], top, appending)
        tot = 0.0
        sup = []
        for lk in self.lk_costs:
            v = exp(lk)
            sup.append(v)
            tot += v
        possible = []
        best_lh = []
        highest = 0
        for i, v in enumerate(sup):
            v = v / tot if tot else 0.0
            if v >= rt.cfg.minBranchSupport:
                possible.append((self.nodes[i], v, self.blens[i]))
            if v > highest:
                highest = v
                best_lh = self.total_lhs[i]
        return possible, best_lh


def place_sample_on_tree(rt: TreeRuntime, node: int, new_partials, sample,
                         new_child_lk, best_up_length, best_down_length,
                         best_appending_length, pseudo_mut_counts,
                         stats: PlacementStats,
                         new_partials_time=None) -> Optional[int]:
    """Apply a placement: new internal node + leaf, or a new root; updates
    nDesc/MAT and fires update_partials (reference placeSampleOnTree
    :8370-8710).  Returns the new root id if the root changed."""
    tree = rt.tree
    cfg = rt.cfg
    dc = rt.dc
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    probVect = tree.probVect
    eff0 = dc.effectivelyNon0BLen
    use_hnz = tree.use_hnz
    dtt = rt.do_time_tree
    # native + active error model: tag the tip's ambiguity lists up front
    # so every cached vector derived from it below carries alias tags
    # (exactly the list references the Python kernels would keep, :3959)
    new_partials, pending_tip = rt.adopt_tip_pending(new_partials)
    if dtt:
        from ..models import timetree as tt
        T = rt.time
        probVectTime = tree.probVectTime
        probVectTotUpTime = tree.probVectTotUpTime
        probVectUpRightTime = tree.probVectUpRightTime
        probVectUpLeftTime = tree.probVectUpLeftTime
        dateData = tree.dateData
    try_new_root = False
    if new_child_lk < -0.01:
        stats.sum_child_lks += new_child_lk
        stats.num_child_lks += 1
    vect_up = None
    child = None
    if up[node] is None:
        try_new_root = True
        root_new_partials = new_partials
        tot_root = rt.root_vector(probVect[node], False, False, node)
        best_appending_length = kern.estimate_branch_length(tot_root, new_partials, from_tip_c=True)
        root = node
        new_child_lk = kern.append_prob_node(tot_root, new_partials, True,
                                          best_appending_length)
        if dtt:
            _trt, trt_cost = tt.merge_vectors_time(
                T, probVectTime[node], 0.0, new_partials_time,
                best_appending_length, return_lk=True)
            new_child_lk += trt_cost
    else:
        child = tree.child_index(node)
        vect_up = tree.probVectUpRight[up[node]] if child == 0 \
            else tree.probVectUpLeft[up[node]]
        if dtt:
            vect_up_time = probVectUpRightTime[up[node]] if child == 0 \
                else probVectUpLeftTime[up[node]]
        if tree.mutations[node]:
            vect_up = rt.pass_down(vect_up, node)
        if not best_up_length:
            p_node = up[node]
            while (not dist[p_node]) and up[p_node] is not None:
                p_node = up[p_node]
            if up[p_node] is None:
                root = p_node
                try_new_root = True
                if (not best_down_length) \
                        or best_down_length > 1.01 * dist[node] \
                        or best_down_length < 0.99 * dist[node]:
                    if use_hnz:
                        rt.update_ndesc0_changing_dist(node,
                                                       best_down_length)
                    dist[node] = best_down_length
                    rt.update_partials([(node, 2, True, dtt),
                                        (up[node], child, True, dtt)])
            if try_new_root:
                p_node = up[node]
                root_new_partials = new_partials
                if tree.mutations[node]:
                    root_new_partials = rt.pass_up(new_partials, node)
                while (not dist[p_node]) and up[p_node] is not None:
                    if tree.mutations[p_node]:
                        root_new_partials = rt.pass_up(root_new_partials,
                                                       p_node)
                    p_node = up[p_node]
    is_tip = tree.is_tip(node)

    if try_new_root:
        # consider making (root, new sample) children of a brand-new root
        node = root
        prob_old_root = rt.find_prob_root(probVect[node], node=node)
        if dtt:
            prob_old_root += tt.find_prob_root_time(probVectTime[node])
        root_up_left = rt.root_vector(probVect[node],
                                      best_appending_length / 2, is_tip,
                                      node)
        best_right = kern.estimate_branch_length(root_up_left,
                                              root_new_partials,
                                              from_tip_c=True)
        root_up_right = rt.root_vector(root_new_partials, best_right, True,
                                       node)
        best_left = kern.estimate_branch_length(root_up_right,
                                             probVect[node],
                                             from_tip_c=is_tip)
        # second round of root branch-length optimization
        root_up_left = rt.root_vector(probVect[node], best_left, is_tip,
                                      node)
        best_right = kern.estimate_branch_length(root_up_left,
                                              root_new_partials,
                                              from_tip_c=True)
        root_up_right = rt.root_vector(root_new_partials, best_right, True,
                                       node)
        best_left = kern.estimate_branch_length(root_up_right,
                                             probVect[node],
                                             from_tip_c=is_tip)
        prob_vect_root = kern.merge_vectors(probVect[node], best_left, is_tip, root_new_partials,
            best_right, True, n_minor1=len(tree.minorSequences[node]))
        prob_root = kern.append_prob_node(root_up_left, root_new_partials,
                                       True, best_right)
        prob_root += rt.find_prob_root(prob_vect_root, node=node)
        if dtt:
            prob_vect_root_time, prob_root_time = tt.merge_vectors_time(
                T, probVectTime[node], best_left, new_partials_time,
                best_right, return_lk=True)
            prob_root += prob_root_time
            prob_root += tt.find_prob_root_time(prob_vect_root_time)
            root_up_right_time = tt.root_vector_time(
                T, new_partials_time, best_right)
        if use_hnz:
            prob_root += get_hnz(cfg.HnZ, 2) - get_hnz(cfg.HnZ, 1)
        parent_lk_diff = prob_root - prob_old_root
        if parent_lk_diff <= new_child_lk:
            # placing as a direct descendant of the root is better
            best_right = best_appending_length
            best_left = False
            prob_vect_root = kern.merge_vectors(probVect[node], best_left, is_tip, root_new_partials,
                best_right, True)
            root_up_right = rt.root_vector(root_new_partials, best_right,
                                           True, node)
            if dtt:
                prob_vect_root_time = tt.merge_vectors_time(
                    T, probVectTime[node], best_left, new_partials_time,
                    best_right)
                root_up_right_time = tt.root_vector_time(
                    T, new_partials_time, best_right)
        new_root = tree.add_node()
        if prob_vect_root is None:
            raise RuntimeError("new root probVect is None in placement")
        rt.shorten(prob_vect_root)
        probVect[new_root] = prob_vect_root
        rt.shorten(root_up_right)
        tree.probVectUpRight[new_root] = root_up_right
        tree.probVectUpLeft[new_root] = rt.root_vector(
            probVect[node], best_left, is_tip, node)
        rt.shorten(tree.probVectUpLeft[new_root])
        if dtt:
            probVectTime[new_root] = prob_vect_root_time
            probVectUpRightTime[new_root] = root_up_right_time
            probVectUpLeftTime[new_root] = tt.root_vector_time(
                T, probVectTime[node], best_left)
        tree.mutations[new_root] = tree.mutations[node]
        tree.mutations[node] = []
        up[node] = new_root
        dist[node] = best_left
        if use_hnz:
            tree.nDesc0[new_root] = 2 if best_left > eff0 \
                else tree.nDesc0[node] + 1
        children[new_root].append(node)
        if children[node]:
            tree.nDesc[new_root] += tree.nDesc[node]
        if best_left:
            tree.nDesc[new_root] += 1
        if best_right:
            tree.nDesc[new_root] += 1
        new_node = tree.add_node()
        tree.name[-1] = sample
        dist[-1] = best_right
        _warn_long_branch(best_right, stats)
        up[new_node] = new_root
        children[new_root].append(new_node)
        rt.shorten(root_new_partials)
        probVect[new_node] = root_new_partials
        rt.adopt_pending_as(pending_tip, new_node)
        if best_right or dtt:
            tree.probVectTotUp[new_node] = kern.merge_vectors(tree.probVectUpLeft[new_root], best_right / 2, False,
                root_new_partials, best_right / 2, True, is_up_down=True)
            rt.shorten(tree.probVectTotUp[new_node])
        if dtt:
            probVectTime[new_node] = new_partials_time
            dateData[new_node] = new_partials_time
            new_tot, new_tot_prob = tt.merge_vectors_time(
                T, probVectUpLeftTime[new_root], best_right / 2,
                new_partials_time, best_right / 2, is_up_down=True,
                return_lk=True)
            if isinstance(new_tot, int):
                tt.resolve_time_inconsistency(T, tree, new_node, new_tot)
                new_tot, new_tot_prob = tt.merge_vectors_time(
                    T, probVectUpLeftTime[new_root], best_right / 2,
                    new_partials_time, best_right / 2, is_up_down=True,
                    return_lk=True)
            new_tot_prob -= tt.append_prob_node_time(
                T, probVectUpLeftTime[new_root], new_partials_time,
                best_right)
            probVectTotUpTime[new_node] = (new_tot, new_tot_prob)
        rt.update_partials([(node, 2, True, dtt)])
        # NOTE: the reference does NOT gate placement-time promotion on
        # --noLocalRef (only setUpMAT is gated, :166/:6219); reproduced
        # for parity (:8543-8544)
        if (not tree.mutations[new_root]) \
                and tree.nDesc[new_root] >= cfg.maxNumDescendantsForMATClade \
                and rt.kern.num_non4(probVect[new_root]) > cfg.minNumNon4:
            rt.make_node_reference(new_root)
        return new_root

    # ---- ordinary case: insert a new internal node above `node` ----
    new_internal = tree.add_node()
    children[up[node]][child] = new_internal
    up[new_internal] = up[node]
    children[new_internal].append(node)
    up[node] = new_internal
    old_len = dist[node]
    dist[node] = best_down_length
    if use_hnz:
        tree.nDesc0[new_internal] = 2 if best_down_length > eff0 \
            else tree.nDesc0[node] + 1
    pass_up_mutations = False
    if tree.mutations[node] and not best_down_length:
        tree.mutations[new_internal] = tree.mutations[node]
        tree.nDesc[new_internal] = tree.nDesc[node]
        if best_appending_length:
            tree.nDesc[new_internal] += 1
        tree.mutations[node] = []
        descendants_to_pass = 0
    else:
        if tree.mutations[node]:
            pass_up_mutations = True
            tree.nDesc[new_internal] = 1
            descendants_to_pass = 1
        else:
            if children[node]:
                tree.nDesc[new_internal] = tree.nDesc[node]
            else:
                tree.nDesc[new_internal] = 0
            descendants_to_pass = 0
            if best_down_length:
                descendants_to_pass += 1
                tree.nDesc[new_internal] += 1
        tree.mutations[new_internal] = []
        if best_appending_length:
            tree.nDesc[new_internal] += 1
            descendants_to_pass += 1
        if best_down_length and not best_up_length:
            descendants_to_pass -= 1

    new_node = tree.add_node()
    tree.name[-1] = sample
    dist[-1] = best_appending_length
    _warn_long_branch(best_appending_length, stats)
    up[new_node] = new_internal
    children[new_internal].append(new_node)
    dist[new_internal] = best_up_length
    if use_hnz and best_up_length <= eff0:
        p0 = new_internal
        addendum = 1
        if best_down_length <= eff0 and old_len > eff0:
            addendum = tree.nDesc0[node]
        while up[p0] is not None and dist[p0] <= eff0:
            p0 = up[p0]
            tree.nDesc0[p0] += addendum

    probVect[new_node] = new_partials
    rt.adopt_pending_as(pending_tip, new_node)
    if pass_up_mutations:
        probVect[new_node] = rt.pass_up(probVect[new_node], node)
    rt.shorten(probVect[new_node])
    if dtt:
        probVectTime[new_node] = new_partials_time
        dateData[new_node] = new_partials_time
    probVect[new_internal] = kern.merge_vectors(probVect[node], best_down_length, is_tip, new_partials,
        best_appending_length, True)
    if pass_up_mutations:
        probVect[new_internal] = rt.pass_up(probVect[new_internal], node)
    rt.shorten(probVect[new_internal])
    tree.probVectUpRight[new_internal] = kern.merge_vectors(vect_up, best_up_length, False, new_partials,
        best_appending_length, True, is_up_down=True)
    if pass_up_mutations:
        tree.probVectUpRight[new_internal] = rt.pass_up(
            tree.probVectUpRight[new_internal], node)
    rt.shorten(tree.probVectUpRight[new_internal])
    tree.probVectUpLeft[new_internal] = kern.merge_vectors(vect_up, best_up_length, False, probVect[node],
        best_down_length, is_tip, is_up_down=True)
    if pass_up_mutations:
        tree.probVectUpLeft[new_internal] = rt.pass_up(
            tree.probVectUpLeft[new_internal], node)
    rt.shorten(tree.probVectUpLeft[new_internal])
    if probVect[new_internal] is None \
            or tree.probVectUpRight[new_internal] is None \
            or tree.probVectUpLeft[new_internal] is None:
        raise RuntimeError("None genome list created in placement")
    if dtt:
        probVectTime[new_internal] = tt.merge_vectors_time(
            T, probVectTime[node], best_down_length, new_partials_time,
            best_appending_length)
        probVectUpRightTime[new_internal] = tt.merge_vectors_time(
            T, vect_up_time, best_up_length, new_partials_time,
            best_appending_length, is_up_down=True)
        if isinstance(probVectUpRightTime[new_internal], int):
            tt.resolve_time_inconsistency(
                T, tree, new_internal, probVectUpRightTime[new_internal])
            vect_up_time = probVectUpRightTime[up[node]] \
                if node == children[up[node]][0] \
                else probVectUpLeftTime[up[node]]
            probVectUpRightTime[new_internal] = tt.merge_vectors_time(
                T, vect_up_time, best_up_length, new_partials_time,
                best_appending_length, is_up_down=True)
        probVectUpLeftTime[new_internal] = tt.merge_vectors_time(
            T, vect_up_time, best_up_length, probVectTime[node],
            best_down_length, is_up_down=True)
        if isinstance(probVectUpLeftTime[new_internal], int):
            tt.resolve_time_inconsistency(
                T, tree, new_internal, probVectUpLeftTime[new_internal])
            vect_up_time = probVectUpRightTime[up[node]] \
                if node == children[up[node]][0] \
                else probVectUpLeftTime[up[node]]
            probVectUpLeftTime[new_internal] = tt.merge_vectors_time(
                T, vect_up_time, best_up_length, probVectTime[node],
                best_down_length, is_up_down=True)
        new_tot, new_tot_prob = tt.merge_vectors_time(
            T, vect_up_time, best_up_length / 2,
            probVectTime[new_internal], best_up_length / 2,
            is_up_down=True, return_lk=True)
        if isinstance(new_tot, int):
            tt.resolve_time_inconsistency(T, tree, new_internal, new_tot)
            vect_up_time = probVectUpRightTime[up[node]] \
                if node == children[up[node]][0] \
                else probVectUpLeftTime[up[node]]
            new_tot, new_tot_prob = tt.merge_vectors_time(
                T, vect_up_time, best_up_length / 2,
                probVectTime[new_internal], best_up_length / 2,
                is_up_down=True, return_lk=True)
        new_tot_prob -= tt.append_prob_node_time(
            T, vect_up_time, probVectTime[new_internal], best_up_length)
        probVectTotUpTime[new_internal] = (new_tot, new_tot_prob)
        new_tot, new_tot_prob = tt.merge_vectors_time(
            T, probVectUpLeftTime[new_internal],
            best_appending_length / 2, new_partials_time,
            best_appending_length / 2, is_up_down=True, return_lk=True)
        if isinstance(new_tot, int):
            tt.resolve_time_inconsistency(T, tree, new_node, new_tot)
            new_tot, new_tot_prob = tt.merge_vectors_time(
                T, probVectUpLeftTime[new_internal],
                best_appending_length / 2, new_partials_time,
                best_appending_length / 2, is_up_down=True,
                return_lk=True)
        new_tot_prob -= tt.append_prob_node_time(
            T, probVectUpLeftTime[new_internal], new_partials_time,
            best_appending_length)
        probVectTotUpTime[new_node] = (new_tot, new_tot_prob)
    if best_up_length or dtt:
        tree.probVectTotUp[new_internal] = kern.merge_vectors(vect_up, best_up_length / 2, False, probVect[new_internal],
            best_up_length / 2, False, is_up_down=True)
        if pass_up_mutations:
            tree.probVectTotUp[new_internal] = rt.pass_up(
                tree.probVectTotUp[new_internal], node)
        rt.shorten(tree.probVectTotUp[new_internal])
    else:
        tree.probVectTotUp[new_internal] = None
    if best_appending_length or dtt:
        tree.probVectTotUp[new_node] = kern.merge_vectors(tree.probVectUpLeft[new_internal],
            best_appending_length / 2, False, new_partials,
            best_appending_length / 2, True, is_up_down=True)
        if pass_up_mutations:
            tree.probVectTotUp[new_node] = rt.pass_up(
                tree.probVectTotUp[new_node], node)
        rt.shorten(tree.probVectTotUp[new_node])
        if best_appending_length:
            kern.update_pseudo_counts(tree.probVectUpLeft[new_internal],
                                      new_partials, pseudo_mut_counts)
    else:
        tree.probVectTotUp[new_node] = None
    if (not best_down_length) and (not dtt):
        tree.probVectTotUp[node] = None

    if descendants_to_pass:
        p_node = up[new_internal]
        tree.nDesc[p_node] += descendants_to_pass
        while not tree.mutations[p_node]:
            if tree.nDesc[p_node] >= cfg.maxNumDescendantsForMATClade \
                    and rt.kern.num_non4(probVect[p_node]) > cfg.minNumNon4:
                rt.make_node_reference(
                    p_node, old_value=tree.nDesc[p_node]
                    - descendants_to_pass)
                break
            p_node = up[p_node]
            if p_node is None:
                break
            tree.nDesc[p_node] += descendants_to_pass
    rt.update_partials([(node, 2, True, dtt),
                        (up[new_internal], child, True, dtt)])
    return None


def _warn_long_branch(blen, stats: PlacementStats):
    if blen and blen > 0.01 and not stats.warned_blen:
        stats.warned_blen = True
        print("\n WARNING: found branch of length " + str(blen)
              + " ; at high divergence MAPLE-style inference struggles in "
              "accuracy and speed; a traditional phylogenetic approach may "
              "fit better.\n")
