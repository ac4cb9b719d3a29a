"""SPR topology search and application.

``find_best_parent_topology`` (reference :6817-7724) pretend-prunes a subtree
and crawls the tree in all directions carrying "tree without the subtree"
vectors per direction, scoring candidate re-attachments with the placement
stop rules; then re-optimizes 3 branch lengths for candidates within
threshold and computes SPRTA supports softmax(exp(LK-origLK)).
``cut_and_paste_node`` (:9188-9277) executes a move via
``place_subtree_on_tree`` (:8896-9187); ``start_topology_updates``
(:9489-9573) sweeps all dirty nodes; ``run_spr_rounds`` is the driver loop
(:12241-12555) with subrounds while improvement >= 3 logLK.
"""
from __future__ import annotations

from math import exp
from typing import List, Optional, Tuple

from ..core import genomelist as gl
from ..core import kernels as K
from ..models.hnz import get_hnz
from ..runtime.partials import TreeRuntime
from ..runtime.tree import count_dirty_nodes, set_all_dirty


def evaluate_placement(rt: TreeRuntime, mid_tot, down_vect, up_vect,
                       distance, removed_partials, is_removed_tip,
                       from_tip1):
    """3-way branch-length optimization of one candidate attachment
    (reference evaluatePlacement :6790-6806)."""
    kern = rt.kern
    dc = rt.dc
    best_appending = kern.estimate_branch_length(mid_tot, removed_partials, from_tip_c=is_removed_tip)
    mid_lower = kern.merge_vectors(down_vect, distance / 2, from_tip1, removed_partials,
        best_appending, is_removed_tip)
    best_top = kern.estimate_branch_length(up_vect, mid_lower)
    mid_top = kern.merge_vectors(up_vect, best_top, False, removed_partials, best_appending,
        is_removed_tip, is_up_down=True)
    if mid_top is None:
        best_top = rt.cfg.defaultBLen * 0.1
        mid_top = kern.merge_vectors(up_vect, best_top, False, removed_partials, best_appending,
            is_removed_tip, is_up_down=True)
    best_bottom = kern.estimate_branch_length(mid_top, down_vect,
                                           from_tip_c=from_tip1)
    new_mid = kern.merge_vectors(up_vect, best_top, False, down_vect, best_bottom, from_tip1,
        is_up_down=True)
    appending_cost = kern.append_prob_node(new_mid, removed_partials,
                                        is_removed_tip, best_appending)
    return appending_cost, best_bottom, best_top, best_appending


def find_best_parent_topology(rt: TreeRuntime, node: int, child: int,
                              best_lk_diff: float, removed_blen,
                              strict_stop: bool, allowed_fails: int,
                              threshold_log_lk: float,
                              abayes_on: bool = False,
                              network_output: bool = False):
    """SPR search core: find the best re-attachment for the subtree rooted at
    children[node][child].  Returns (best_node, best_score,
    best_branch_lengths, list_of_best_placements, support,
    best_removed_partials)."""
    tree = rt.tree
    cfg = rt.cfg
    dc = rt.dc
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    probVect = tree.probVect
    probVectTotUp = tree.probVectTotUp
    use_hnz = tree.use_hnz
    eff0 = dc.effectivelyNon0BLen
    threshold_opt = dc.thresholdLogLKoptimizationTopology
    threshold_consecutive = dc.thresholdLogLKconsecutivePlacement
    pruned = children[node][child]

    # --timeAwareTopology: carry time-likelihood state through the crawl
    # (reference's unreachable design; crawl items gain a trailing
    # (passed_time, tdist) element, time vectors are frame-free so no MAT
    # pass-downs apply; incompatible time merges drop the candidate)
    taw = rt.do_time_tree and cfg.timeAwareTopology and rt.time is not None
    if taw:
        from ..models import timetree as tt
        T = rt.time
        probVectTime = tree.probVectTime
        probVectUpRightTime = tree.probVectUpRightTime
        probVectUpLeftTime = tree.probVectUpLeftTime
        removed_time = probVectTime[pruned]

        def t_upper(t1):
            """Cached time upper of t1 as seen from its parent."""
            return probVectUpRightTime[up[t1]] \
                if t1 == children[up[t1]][0] else probVectUpLeftTime[up[t1]]

    original_parent0 = node
    while dist[original_parent0] <= eff0 and up[original_parent0] is not None:
        original_parent0 = up[original_parent0]
    best_node = children[node][1 - child]
    best_nodes = []
    nodes_to_visit = []
    removed_rel = rt.pass_up(probVect[pruned], pruned)
    best_removed_partials = rt.pass_down(removed_rel, best_node)
    is_removed_tip = tree.is_tip(pruned)
    original_lk = best_lk_diff
    original_placement = best_node
    original_removed = best_removed_partials

    def ndesc0_to_add_for(anchor_dist_small: bool) -> int:
        if not (use_hnz and anchor_dist_small):
            return 0
        if dist[pruned] >= eff0:
            return -1
        return -tree.nDesc0[pruned]

    if up[node] is not None:
        child_up = 1 if children[up[node]][0] == node else 2
        vect_up_up = tree.probVectUpRight[up[node]] if child_up == 1 \
            else tree.probVectUpLeft[up[node]]
        # crawl up from the pruning point
        prob_vect1 = rt.pass_up(probVect[best_node], best_node)
        removed_rel1 = removed_rel
        if tree.mutations[node]:
            prob_vect1 = rt.pass_up(prob_vect1, node)
            removed_rel1 = rt.pass_up(removed_rel, node)
        item = (up[node], child_up, prob_vect1,
                dist[best_node] + dist[node],
                best_lk_diff, 0, removed_rel1,
                ndesc0_to_add_for(dist[node] < eff0))
        if taw:
            item += ((probVectTime[best_node],
                      dist[best_node] + dist[node]),)
        nodes_to_visit.append(item)
        # crawl down into the sibling
        vect_down = vect_up_up
        if tree.mutations[node]:
            vect_down = rt.pass_down(vect_down, node)
        removed_rel1 = removed_rel
        if tree.mutations[best_node]:
            vect_down = rt.pass_down(vect_down, best_node)
            removed_rel1 = rt.pass_down(removed_rel, best_node)
        item = (best_node, 0, vect_down, dist[best_node] + dist[node],
                best_lk_diff, 0, removed_rel1,
                ndesc0_to_add_for(dist[best_node] < eff0))
        if taw:
            vect_up_up_time = probVectUpRightTime[up[node]] if child_up == 1 \
                else probVectUpLeftTime[up[node]]
            item += ((vect_up_up_time, dist[best_node] + dist[node]),)
        nodes_to_visit.append(item)
        original_blens = (dist[node], dist[best_node], removed_blen)
    else:
        # pruning from the root: start at the sibling's children
        if children[best_node]:
            child1, child2 = children[best_node]
            vect_up1 = rt.pass_up(probVect[child2], child2)
            vect_up1 = rt.root_vector(vect_up1, dist[child2],
                                      tree.is_tip(child2), node)
            if tree.mutations[child1]:
                removed_rel1 = rt.pass_down(best_removed_partials, child1)
                vect_up1 = rt.pass_down(vect_up1, child1)
            else:
                removed_rel1 = best_removed_partials
            item = (child1, 0, vect_up1, dist[child1], best_lk_diff, 0,
                    removed_rel1,
                    ndesc0_to_add_for(dist[child1] < eff0
                                      and dist[best_node] < eff0))
            if taw:
                item += ((tt.root_vector_time(T, probVectTime[child2],
                                              dist[child2]),
                          dist[child1]),)
            nodes_to_visit.append(item)
            vect_up2 = rt.pass_up(probVect[child1], child1)
            vect_up2 = rt.root_vector(vect_up2, dist[child1],
                                      tree.is_tip(child1), node)
            if tree.mutations[child2]:
                removed_rel2 = rt.pass_down(best_removed_partials, child2)
                vect_up2 = rt.pass_down(vect_up2, child2)
            else:
                removed_rel2 = best_removed_partials
            item = (child2, 0, vect_up2, dist[child2], best_lk_diff, 0,
                    removed_rel2,
                    ndesc0_to_add_for(dist[child2] < eff0
                                      and dist[best_node] < eff0))
            if taw:
                item += ((tt.root_vector_time(T, probVectTime[child1],
                                              dist[child1]),
                          dist[child2]),)
            nodes_to_visit.append(item)
        original_blens = (0.0, dist[best_node], removed_blen)
    best_branch_lengths = original_blens

    def hnz_mid_correction(t1, best_top, best_bottom, best_appending,
                           nd_add, at_root_like, from_above):
        """HnZ correction terms during the crawl.  The placement of the
        removed-subtree compensation term nd_add differs by crawl direction
        (reference :7036-7075 for downward, :7269-7305 for upward)."""
        H = lambda n: get_hnz(cfg.HnZ, n)
        nd = tree.nDesc0
        if at_root_like:
            p0 = t1
            while dist[p0] <= eff0 and up[p0] is not None:
                p0 = up[p0]
            if best_appending > eff0:
                return H(nd[p0] + nd_add + 1) - H(nd[p0] + nd_add)
            return H(nd[pruned] + nd[p0] + nd_add) \
                - (H(nd[pruned]) + H(nd[p0] + nd_add))
        if best_bottom <= eff0:
            a = 0 if from_above else nd_add
            if best_appending > eff0:
                return H(nd[t1] + a + 1) - H(nd[t1] + a)
            return H(nd[pruned] + nd[t1] + a) \
                - (H(nd[pruned]) + H(nd[t1] + a))
        if best_top <= eff0:
            a = nd_add if from_above else 0
            p0 = up[t1]
            while dist[p0] <= eff0 and up[p0] is not None:
                p0 = up[p0]
            if best_appending > eff0:
                return H(nd[p0] + a + 1) - H(nd[p0] + a)
            return H(nd[pruned] + nd[p0] + a) \
                - (H(nd[pruned]) + H(nd[p0] + a))
        if best_appending > eff0:
            return H(2) - H(1)
        return H(nd[pruned] + 1) - H(nd[pruned])

    while nodes_to_visit:
        info = nodes_to_visit.pop()
        if taw:
            passed_time, tdist = info[-1]
            info = info[:-1]
        if len(info) == 8:
            t1, direction, passed_partials, distance, last_lk, \
                failed_passes, removed_rel_here, nd_add = info
            needs_updating = True
        else:
            t1, direction, last_lk, failed_passes, removed_rel_here, \
                nd_add = info
            passed_partials = None
            distance = 0.0
            needs_updating = False

        if direction == 0:
            if (not (up[t1] == node or up[t1] is None)) \
                    and (dist[t1] > eff0 or up[up[t1]] is None):
                if needs_updating:
                    is_tip = tree.is_tip(t1)
                    mid_tot = kern.merge_vectors(passed_partials, distance / 2, False,
                        probVect[t1], distance / 2, is_tip, is_up_down=True)
                    if mid_tot is None:
                        continue
                    if not kern.are_vectors_different(mid_tot,
                                                   probVectTotUp[t1]):
                        needs_updating = False
                else:
                    mid_tot = probVectTotUp[t1]
                    distance = dist[t1]
                if mid_tot is None:
                    continue
                if cfg.deeperSearchForLongBranches \
                        and distance > dc.BLenThresholdDeeperSearch:
                    mid_bottom = probVect[t1]
                    vect_up = tree.vect_up_for(t1)
                    if tree.mutations[t1]:
                        vect_up = rt.pass_down(vect_up, t1)
                    from_tip1 = tree.is_tip(t1)
                    mid_prob, best_bottom, best_top, best_appending = \
                        evaluate_placement(rt, mid_tot, mid_bottom, vect_up,
                                           distance, removed_rel_here,
                                           is_removed_tip, from_tip1)
                else:
                    mid_prob = kern.append_prob_node(mid_tot, removed_rel_here, is_removed_tip,
                        removed_blen)
                    best_bottom = distance / 2
                    best_top = distance / 2
                    best_appending = removed_blen
                if taw:
                    mtt = tt.merge_vectors_time(
                        T, passed_time, tdist / 2, probVectTime[t1],
                        tdist / 2, is_up_down=True, return_lk=True)
                    if isinstance(mtt[0], int):
                        mid_prob += float("-inf")
                    else:
                        mid_prob += mtt[1] + tt.append_prob_node_time(
                            T, mtt[0], removed_time, best_appending)
                if use_hnz:
                    mid_prob += hnz_mid_correction(
                        t1, best_top, best_bottom, best_appending, nd_add,
                        at_root_like=(up[up[t1]] is None
                                      and distance <= eff0),
                        from_above=True)
                if mid_prob > best_lk_diff - threshold_opt:
                    if needs_updating:
                        entry = (t1, mid_prob, passed_partials,
                                 probVect[t1], distance, mid_tot,
                                 removed_rel_here)
                        if taw:
                            entry += ((passed_time, probVectTime[t1]),)
                        best_nodes.append(entry)
                    else:
                        best_nodes.append((t1, mid_prob, removed_rel_here))
                if mid_prob > best_lk_diff:
                    best_lk_diff = mid_prob
                    failed_passes = 0
                    kern.shorten(removed_rel_here)
                elif mid_prob < (last_lk - threshold_consecutive):
                    failed_passes += 1
            else:
                mid_prob = last_lk

            if strict_stop:
                traverse = (failed_passes <= allowed_fails
                            and mid_prob > best_lk_diff - threshold_log_lk
                            and children[t1])
            else:
                traverse = (failed_passes <= allowed_fails
                            or mid_prob > best_lk_diff - threshold_log_lk) \
                    and children[t1]
            if traverse:
                for ci in (0, 1):
                    child1 = children[t1][ci]
                    other = children[t1][1 - ci]
                    if needs_updating:
                        other_vect = rt.pass_up(probVect[other], other)
                        vect_next = kern.merge_vectors(passed_partials, distance, False,
                            other_vect, dist[other], tree.is_tip(other),
                            is_up_down=True)
                    else:
                        vect_next = tree.probVectUpRight[t1] if ci == 0 \
                            else tree.probVectUpLeft[t1]
                    if vect_next is None:
                        continue
                    if taw:
                        vect_next_time = tt.merge_vectors_time(
                            T, passed_time, tdist, probVectTime[other],
                            dist[other], is_up_down=True)
                        if isinstance(vect_next_time, int):
                            continue
                    removed_rel1 = removed_rel_here
                    if tree.mutations[child1]:
                        removed_rel1 = rt.pass_down(removed_rel_here, child1)
                    nd_pass = nd_add if (nd_add
                                         and dist[child1] < eff0) else 0
                    if needs_updating:
                        if tree.mutations[child1]:
                            vect_next = rt.pass_down(vect_next, child1)
                        item = (child1, 0, vect_next, dist[child1],
                                mid_prob, failed_passes, removed_rel1,
                                nd_pass)
                    else:
                        item = (child1, 0, mid_prob, failed_passes,
                                removed_rel1, nd_pass)
                    if taw:
                        item += ((vect_next_time, dist[child1]),)
                    nodes_to_visit.append(item)
        else:
            # crawling up from child number (direction-1)
            other_child = children[t1][2 - direction]
            mid_bottom = None
            vect_up = None
            mbt = None  # time twin of mid_bottom (taw only)
            if up[t1] is not None and (dist[t1] > eff0
                                       or up[up[t1]] is None):
                if needs_updating:
                    other_vect = rt.pass_up(probVect[other_child],
                                            other_child)
                    mid_bottom = kern.merge_vectors(passed_partials, distance, False, other_vect,
                        dist[other_child], tree.is_tip(other_child))
                    if mid_bottom is None:
                        continue
                    vect_up = tree.vect_up_for(t1)
                    if tree.mutations[t1]:
                        vect_up = rt.pass_down(vect_up, t1)
                    mid_tot = kern.merge_vectors(vect_up, dist[t1] / 2, False, mid_bottom,
                        dist[t1] / 2, False, is_up_down=True)
                    if probVectTotUp[t1] is None:
                        probVectTotUp[t1] = kern.merge_vectors(vect_up, dist[t1] / 2, False, probVect[t1],
                            dist[t1] / 2, False, is_up_down=True)
                    if mid_tot is None:
                        continue
                    if not kern.are_vectors_different(mid_tot,
                                                   probVectTotUp[t1]):
                        needs_updating = False
                else:
                    mid_tot = probVectTotUp[t1]
                if mid_tot is None:
                    continue
                if cfg.deeperSearchForLongBranches \
                        and dist[t1] > dc.BLenThresholdDeeperSearch:
                    if not needs_updating:
                        mid_bottom = probVect[t1]
                        vect_up = tree.vect_up_for(t1)
                        if tree.mutations[t1]:
                            vect_up = rt.pass_down(vect_up, t1)
                    mid_prob, best_bottom, best_top, best_appending = \
                        evaluate_placement(rt, mid_tot, mid_bottom, vect_up,
                                           dist[t1], removed_rel_here,
                                           is_removed_tip, False)
                else:
                    mid_prob = kern.append_prob_node(mid_tot, removed_rel_here, is_removed_tip,
                        removed_blen)
                    best_bottom = dist[t1] / 2
                    best_top = dist[t1] / 2
                    best_appending = removed_blen
                if taw:
                    mbt = tt.merge_vectors_time(
                        T, passed_time, tdist, probVectTime[other_child],
                        dist[other_child])
                    vut = t_upper(t1)
                    if isinstance(mbt, int):
                        mid_prob += float("-inf")
                        mbt = None
                    else:
                        mtt = tt.merge_vectors_time(
                            T, vut, dist[t1] / 2, mbt, dist[t1] / 2,
                            is_up_down=True, return_lk=True)
                        if isinstance(mtt[0], int):
                            mid_prob += float("-inf")
                        else:
                            mid_prob += mtt[1] + tt.append_prob_node_time(
                                T, mtt[0], removed_time, best_appending)
                if use_hnz:
                    mid_prob += hnz_mid_correction(
                        t1, best_top, best_bottom, best_appending, nd_add,
                        at_root_like=(up[up[t1]] is None
                                      and dist[t1] <= eff0),
                        from_above=False)
                if mid_prob >= (best_lk_diff - threshold_opt):
                    if needs_updating:
                        entry = (t1, mid_prob, vect_up, mid_bottom,
                                 dist[t1], mid_tot, removed_rel_here)
                        if taw:
                            entry += ((vut, mbt),)
                        best_nodes.append(entry)
                    else:
                        best_nodes.append((t1, mid_prob, removed_rel_here))
                if mid_prob > best_lk_diff:
                    best_lk_diff = mid_prob
                    failed_passes = 0
                elif mid_prob < (last_lk - threshold_consecutive):
                    failed_passes += 1
            else:
                mid_prob = last_lk

            if strict_stop:
                keep = (failed_passes <= allowed_fails
                        and mid_prob > best_lk_diff - threshold_log_lk)
            else:
                keep = (failed_passes <= allowed_fails
                        or mid_prob > best_lk_diff - threshold_log_lk)
            if keep:
                if up[t1] is not None:
                    up_child = 0 if t1 == children[up[t1]][0] else 1
                    if needs_updating:
                        vect_up_up = tree.probVectUpRight[up[t1]] \
                            if up_child == 0 else tree.probVectUpLeft[up[t1]]
                        if tree.mutations[t1]:
                            vect_up_up = rt.pass_down(vect_up_up, t1)
                        vect_up2 = kern.merge_vectors(vect_up_up, dist[t1], False,
                            passed_partials, distance, False,
                            is_up_down=True)
                    else:
                        vect_up2 = tree.probVectUpLeft[t1] if direction == 1 \
                            else tree.probVectUpRight[t1]
                    down_time_ok = True
                    if taw:
                        vuut = t_upper(t1)
                        vect_up2_time = tt.merge_vectors_time(
                            T, vuut, dist[t1], passed_time, tdist,
                            is_up_down=True)
                        if isinstance(vect_up2_time, int):
                            down_time_ok = False
                    if vect_up2 is not None and down_time_ok:
                        removed_rel1 = removed_rel_here
                        if tree.mutations[other_child]:
                            removed_rel1 = rt.pass_down(removed_rel_here,
                                                        other_child)
                        nd_pass = nd_add if (nd_add and dist[other_child]
                                             < eff0) else 0
                        if needs_updating:
                            if tree.mutations[other_child]:
                                vect_up2 = rt.pass_down(vect_up2,
                                                        other_child)
                            item = (other_child, 0, vect_up2,
                                    dist[other_child], mid_prob,
                                    failed_passes, removed_rel1, nd_pass)
                        else:
                            item = (other_child, 0, mid_prob, failed_passes,
                                    removed_rel1, nd_pass)
                        if taw:
                            item += ((vect_up2_time, dist[other_child]),)
                        nodes_to_visit.append(item)
                    # continue crawling up
                    if needs_updating:
                        if mid_bottom is None:
                            other_vect = rt.pass_up(probVect[other_child],
                                                    other_child)
                            mid_bottom = kern.merge_vectors(passed_partials, distance, False,
                                other_vect, dist[other_child],
                                tree.is_tip(other_child))
                            if mid_bottom is None:
                                continue
                    up_time_ok = True
                    if taw and mbt is None:
                        mbt = tt.merge_vectors_time(
                            T, passed_time, tdist, probVectTime[other_child],
                            dist[other_child])
                        if isinstance(mbt, int):
                            mbt = None
                            up_time_ok = False
                    removed_rel1 = removed_rel_here
                    if tree.mutations[t1]:
                        removed_rel1 = rt.pass_up(removed_rel_here, t1)
                    nd_pass = nd_add if (nd_add and dist[t1] < eff0) else 0
                    if not up_time_ok:
                        pass
                    elif needs_updating:
                        if tree.mutations[t1]:
                            mid_bottom = rt.pass_up(mid_bottom, t1)
                        item = (up[t1], up_child + 1, mid_bottom, dist[t1],
                                mid_prob, failed_passes, removed_rel1,
                                nd_pass)
                        if taw:
                            item += ((mbt, dist[t1]),)
                        nodes_to_visit.append(item)
                    else:
                        item = (up[t1], up_child + 1, mid_prob,
                                failed_passes, removed_rel1, nd_pass)
                        if taw:
                            item += ((mbt, dist[t1]),)
                        nodes_to_visit.append(item)
                else:
                    # reached the root: reflect into the other child
                    if needs_updating:
                        vect_up2 = rt.root_vector(passed_partials, distance,
                                                  False, t1)
                        if tree.mutations[other_child]:
                            vect_up2 = rt.pass_down(vect_up2, other_child)
                    removed_rel1 = removed_rel_here
                    if tree.mutations[other_child]:
                        removed_rel1 = rt.pass_down(removed_rel_here,
                                                    other_child)
                    nd_pass = nd_add if (nd_add and dist[other_child]
                                         < eff0) else 0
                    if needs_updating:
                        item = (other_child, 0, vect_up2, dist[other_child],
                                mid_prob, failed_passes, removed_rel1,
                                nd_pass)
                    else:
                        item = (other_child, 0, mid_prob, failed_passes,
                                removed_rel1, nd_pass)
                    if taw:
                        item += ((tt.root_vector_time(T, passed_time,
                                                      tdist),
                                  dist[other_child]),)
                    nodes_to_visit.append(item)

    # ---- fine optimization of candidates + SPRTA supports ----
    best_score = original_lk
    if not best_nodes:
        return (original_placement, original_lk, original_blens, [], 1.0,
                original_removed)
    if abayes_on:
        list_of_probable = []
        list_of_lk_costs = []
        root_already = up[original_parent0] is None
        if up[node] is None or (up[up[node]] is None
                                and dist[children[node][1 - child]] > eff0):
            root_already = True
    for node_pair in best_nodes:
        score = node_pair[1]
        if score < original_lk - threshold_opt:
            continue
        t1 = node_pair[0]
        if len(node_pair) == 3:
            up_vect = tree.vect_up_for(t1)
            if tree.mutations[t1]:
                up_vect = rt.pass_down(up_vect, t1)
            down_vect = probVect[t1]
            distance = dist[t1]
            mid_tot = probVectTotUp[t1]
            removed_partials = node_pair[2]
            if taw:
                time_up, time_down = t_upper(t1), probVectTime[t1]
        else:
            up_vect = node_pair[2]
            down_vect = node_pair[3]
            distance = node_pair[4]
            mid_tot = node_pair[5]
            removed_partials = node_pair[6]
            if taw:
                time_up, time_down = node_pair[7]
        from_tip1 = tree.is_tip(t1)
        appending_cost, best_bottom, best_top, best_appending = \
            evaluate_placement(rt, mid_tot, down_vect, up_vect, distance,
                               removed_partials, is_removed_tip, from_tip1)
        if taw:
            nmt = tt.merge_vectors_time(
                T, time_up, best_top, time_down, best_bottom,
                is_up_down=True, return_lk=True)
            if isinstance(nmt[0], int):
                appending_cost += float("-inf")
            else:
                appending_cost += nmt[1] \
                    - tt.finite_or(tt.append_prob_node_time(
                        T, time_up, time_down, distance)) \
                    + tt.append_prob_node_time(T, nmt[0], removed_time,
                                               best_appending)
        initial_cost = kern.append_prob_node(up_vect, down_vect, from_tip1,
                                          distance)
        new_partial_cost = kern.append_prob_node(up_vect, down_vect, from_tip1, best_bottom + best_top)
        optimized_score = appending_cost + new_partial_cost - initial_cost
        if use_hnz:
            optimized_score, best_top, best_bottom = _hnz_spr_correction(
                rt, node, child, t1, original_parent0, up_vect, down_vect,
                distance, removed_partials, is_removed_tip, from_tip1,
                optimized_score, best_top, best_bottom, best_appending)
        if optimized_score >= best_score:
            best_node = t1
            best_score = optimized_score
            best_branch_lengths = (best_top, best_bottom, best_appending)
            best_removed_partials = removed_partials
        if abayes_on:
            different = True
            if t1 == node:
                different = False
            elif t1 == children[node][1 - child]:
                if dist[node] >= eff0 or best_top <= eff0:
                    different = False
            if best_bottom <= eff0 and t1 == original_parent0:
                different = False
            if best_top <= eff0:
                different = False
            if dist[t1] <= eff0 and up[up[t1]] is not None:
                different = False
            if (not root_already) and up[up[t1]] is None \
                    and (best_bottom >= eff0 or best_top <= eff0):
                root_already = True
                list_of_lk_costs.append(optimized_score)
                if network_output:
                    list_of_probable.append(t1)
            elif different:
                list_of_lk_costs.append(optimized_score)
                if network_output:
                    list_of_probable.append(t1)

    if abayes_on:
        final_list = []
        support = 1.0
        tot_support = support
        for i in range(len(list_of_lk_costs)):
            list_of_lk_costs[i] = exp(list_of_lk_costs[i] - original_lk)
            tot_support += list_of_lk_costs[i]
        if not tot_support:
            support = 1.0
        else:
            support = support / tot_support
            if network_output:
                for i in range(len(list_of_lk_costs)):
                    v = list_of_lk_costs[i] / tot_support
                    if v >= cfg.minBranchSupport:
                        final_list.append((list_of_probable[i], v))
        return (best_node, best_score, best_branch_lengths, final_list,
                support, best_removed_partials)
    return (best_node, best_score, best_branch_lengths, [], None,
            best_removed_partials)


def _hnz_spr_correction(rt, node, child, t1, original_parent0, up_vect,
                        down_vect, distance, removed_partials,
                        is_removed_tip, from_tip1, optimized_score,
                        best_top, best_bottom, best_appending):
    """HnZ corrections for the final optimized SPR placement, including the
    0-bottom-length alternative (reference :7518-7634)."""
    tree = rt.tree
    cfg = rt.cfg
    kern = rt.kern
    dc = rt.dc
    eff0 = dc.effectivelyNon0BLen
    up = tree.up
    dist = tree.dist
    nDesc0 = tree.nDesc0
    pruned = tree.children[node][child]
    H = lambda n: get_hnz(cfg.HnZ, n)
    below_t1 = False
    opn0 = node
    if opn0 == t1:
        below_t1 = True
    while dist[opn0] <= eff0 and up[opn0] is not None:
        opn0 = up[opn0]
        if opn0 == t1:
            below_t1 = True
    pn0 = up[t1]
    while dist[pn0] <= eff0 and up[pn0] is not None:
        pn0 = up[pn0]
    comp = 0
    if pn0 == opn0:
        comp = -1 if dist[pruned] else -nDesc0[pruned]
    comp_t1 = 0
    if below_t1:
        comp_t1 = -1 if dist[pruned] else -nDesc0[pruned]
    if best_top > eff0 and best_bottom > eff0:
        if best_appending > eff0:
            addendum = H(2) - H(1)
        else:
            addendum = H(nDesc0[pruned] + 1) - H(nDesc0[pruned])
        if dist[t1] <= eff0:
            addendum += H(nDesc0[pn0] + 1 - comp_t1 + comp - nDesc0[t1]) \
                + H(nDesc0[t1] + comp_t1) - H(nDesc0[pn0] + comp)
    elif best_bottom > eff0:
        if pn0 == original_parent0:
            addendum = float("-inf")
        elif best_appending > eff0:
            if dist[t1] <= eff0:
                addendum = H(nDesc0[pn0] + comp + 2 - comp_t1
                             - nDesc0[t1]) + H(nDesc0[t1] + comp_t1) \
                    - H(nDesc0[pn0] + comp)
            else:
                addendum = H(nDesc0[pn0] + comp + 1) - H(nDesc0[pn0] + comp)
        else:
            if dist[t1] <= eff0:
                addendum = H(nDesc0[pn0] + comp + 1 - comp_t1
                             + nDesc0[pruned] - nDesc0[t1]) \
                    + H(nDesc0[t1] + comp_t1) \
                    - (H(nDesc0[pruned]) + H(nDesc0[pn0] + comp))
            else:
                addendum = H(nDesc0[pn0] + comp + nDesc0[pruned]) \
                    - (H(nDesc0[pruned]) + H(nDesc0[pn0] + comp))
    elif best_top > eff0:
        if t1 == original_parent0:
            addendum = float("-inf")
        elif dist[t1] <= eff0:
            if best_appending > eff0:
                addendum = H(nDesc0[t1] + comp_t1 + 1) \
                    + H(nDesc0[pn0] + 1 + comp - comp_t1 - nDesc0[t1]) \
                    - H(nDesc0[pn0] + comp)
            else:
                addendum = H(nDesc0[t1] + comp_t1 + nDesc0[pruned]) \
                    + H(nDesc0[pn0] + 1 + comp - comp_t1 - nDesc0[t1]) \
                    - (H(nDesc0[pruned]) + H(nDesc0[pn0] + comp))
        else:
            if best_appending > eff0:
                addendum = H(nDesc0[t1] + comp_t1 + 1) \
                    - H(nDesc0[t1] + comp_t1)
            else:
                addendum = H(nDesc0[t1] + comp_t1 + nDesc0[pruned]) \
                    - (H(nDesc0[pruned]) + H(nDesc0[t1] + comp_t1))
    else:
        if pn0 == original_parent0 or t1 == original_parent0:
            addendum = float("-inf")
        elif dist[t1] <= eff0:
            if best_appending > eff0:
                addendum = H(nDesc0[pn0] + comp + 1) - H(nDesc0[pn0] + comp)
            else:
                addendum = H(nDesc0[pn0] + comp + nDesc0[pruned]) \
                    - (H(nDesc0[pruned]) + H(nDesc0[pn0] + comp))
        else:
            if best_appending > eff0:
                addendum = H(nDesc0[pn0] + comp + nDesc0[t1] + comp_t1 + 1) \
                    - (H(nDesc0[pn0] + comp) + H(nDesc0[t1] + comp_t1))
            else:
                addendum = H(nDesc0[pn0] + comp + nDesc0[t1] + comp_t1
                             + nDesc0[pruned]) \
                    - (H(nDesc0[pruned]) + H(nDesc0[pn0] + comp)
                       + H(nDesc0[t1] + comp_t1))
    optimized_score += addendum

    if best_bottom > eff0 and dist[t1] > eff0:
        alt_mid = kern.merge_vectors(up_vect, best_top + best_bottom, False, down_vect, 0.0,
            from_tip1, is_up_down=True)
        alt_cost = kern.append_prob_node(alt_mid, removed_partials,
                                      is_removed_tip, best_appending)
        initial_cost = kern.append_prob_node(up_vect, down_vect, from_tip1,
                                          distance)
        new_partial = kern.append_prob_node(up_vect, down_vect, from_tip1,
                                         best_bottom + best_top)
        alt_optimized = alt_cost + new_partial - initial_cost
        if (best_top + best_bottom) > eff0:
            if t1 == original_parent0:
                addendum = float("-inf")
            elif best_appending > eff0:
                addendum = H(nDesc0[t1] + comp_t1 + 1) \
                    - H(nDesc0[t1] + comp_t1)
            else:
                addendum = H(nDesc0[t1] + comp_t1 + nDesc0[pruned]) \
                    - (H(nDesc0[pruned]) + H(nDesc0[t1] + comp_t1))
        else:
            if pn0 == original_parent0 or t1 == original_parent0:
                addendum = float("-inf")
            elif best_appending > eff0:
                addendum = H(nDesc0[pn0] + comp + nDesc0[t1] + comp_t1 + 1) \
                    - (H(nDesc0[pn0] + comp) + H(nDesc0[t1] + comp_t1))
            else:
                addendum = H(nDesc0[pn0] + comp + nDesc0[t1] + comp_t1
                             + nDesc0[pruned]) \
                    - (H(nDesc0[pruned]) + H(nDesc0[pn0] + comp)
                       + H(nDesc0[t1] + comp_t1))
        alt_optimized += addendum
        if alt_optimized > optimized_score:
            optimized_score = alt_optimized
            best_top = best_top + best_bottom
            best_bottom = 0.0
    return optimized_score, best_top, best_bottom


# ----------------------------------------------------------------------
def place_subtree_on_tree(rt: TreeRuntime, node: int, new_partials,
                          appended_node: int, new_child_lk,
                          best_branch_lengths) -> Optional[int]:
    """Re-attach a pruned subtree below ``node`` (reference
    placeSubtreeOnTree :8896-9187)."""
    tree = rt.tree
    cfg = rt.cfg
    dc = rt.dc
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    probVect = tree.probVect
    eff0 = dc.effectivelyNon0BLen
    best_up, best_down, best_appending = best_branch_lengths
    try_new_root = False
    child = tree.child_index(node)
    vect_up = tree.probVectUpRight[up[node]] if child == 0 \
        else tree.probVectUpLeft[up[node]]
    if not best_up:
        p_node = up[node]
        while (not dist[p_node]) and up[p_node] is not None:
            p_node = up[p_node]
        if up[p_node] is None:
            root = p_node
            try_new_root = True
            if (not best_down) or best_down > 1.01 * dist[node] \
                    or best_down < 0.99 * dist[node]:
                if tree.use_hnz:
                    rt.update_ndesc0_changing_dist(node, best_down)
                dist[node] = best_down
                rt.update_partials([(node, 2, True, False),
                                    (up[node], child, True, False)])
        if try_new_root:
            p_node = up[node]
            root_new_partials = new_partials
            if tree.mutations[node]:
                root_new_partials = rt.pass_up(new_partials, node)
            while (not dist[p_node]) and up[p_node] is not None:
                if tree.mutations[p_node]:
                    root_new_partials = rt.pass_up(root_new_partials, p_node)
                p_node = up[p_node]
    appended_is_tip = tree.is_tip(appended_node)

    if try_new_root:
        node = root
        is_tip = tree.is_tip(node)
        prob_old_root = rt.find_prob_root(probVect[node], node=node)
        root_up_left = rt.root_vector(probVect[node], best_appending / 2,
                                      is_tip, node)
        best_right = kern.estimate_branch_length(root_up_left, root_new_partials, from_tip_c=appended_is_tip)
        root_up_right = rt.root_vector(root_new_partials, best_right,
                                       appended_is_tip, node)
        best_left = kern.estimate_branch_length(root_up_right,
                                             probVect[node],
                                             from_tip_c=is_tip)
        root_up_left = rt.root_vector(probVect[node], best_left, is_tip,
                                      node)
        best_right = kern.estimate_branch_length(root_up_left, root_new_partials, from_tip_c=appended_is_tip)
        root_up_right = rt.root_vector(root_new_partials, best_right,
                                       appended_is_tip, node)
        best_left = kern.estimate_branch_length(root_up_right,
                                             probVect[node],
                                             from_tip_c=is_tip)
        prob_vect_root = kern.merge_vectors(probVect[node], best_left, is_tip, root_new_partials,
            best_right, appended_is_tip,
            n_minor1=len(tree.minorSequences[node]),
            n_minor2=len(tree.minorSequences[appended_node]))
        prob_root = kern.append_prob_node(root_up_left, root_new_partials,
                                       appended_is_tip, best_right)
        prob_root += rt.find_prob_root(prob_vect_root, node=node)
        parent_lk_diff = prob_root - prob_old_root
        if parent_lk_diff <= new_child_lk:
            best_right = best_appending
            best_left = False
            prob_vect_root = kern.merge_vectors(probVect[node], best_left, is_tip, root_new_partials,
                best_right, appended_is_tip)
            root_up_right = rt.root_vector(root_new_partials, best_right,
                                           appended_is_tip, node)
        if tree.mutations[appended_node]:
            rt.num_refs -= 1
        rt.traverse_tree_to_update_mutation_list(appended_node, node)
        if tree.mutations[appended_node]:
            rt.num_refs += 1
        new_root = up[appended_node]
        up[new_root] = None
        tree.dirty[new_root] = True
        dist[new_root] = cfg.defaultBLen
        tree.replacements[new_root] += 1
        if prob_vect_root is None:
            raise RuntimeError("new root probVect None in "
                               "place_subtree_on_tree")
        rt.shorten(prob_vect_root)
        probVect[new_root] = prob_vect_root
        rt.shorten(root_up_right)
        tree.probVectUpRight[new_root] = root_up_right
        tree.probVectUpLeft[new_root] = rt.root_vector(
            probVect[node], best_left, is_tip, node)
        rt.shorten(tree.probVectUpLeft[new_root])
        tree.mutations[new_root] = tree.mutations[node]
        tree.mutations[node] = []
        up[node] = new_root
        dist[node] = best_left
        children[new_root][0] = node
        children[new_root][1] = appended_node
        dist[appended_node] = best_right
        tree.replacements[appended_node] += 1
        if tree.use_hnz:
            tree.nDesc0[new_root] = 1 if dist[node] > eff0 \
                else tree.nDesc0[node]
            tree.nDesc0[new_root] += 1 if dist[appended_node] > eff0 \
                else tree.nDesc0[appended_node]
        rt.update_partials([(node, 2, True, False),
                            (appended_node, 2, True, False)])
        return new_root

    # ---- ordinary re-attachment below `node` ----
    if tree.mutations[node]:
        vect_up = rt.pass_down(vect_up, node)
    is_tip = tree.is_tip(node)
    if tree.mutations[appended_node]:
        rt.num_refs -= 1
    rt.traverse_tree_to_update_mutation_list(appended_node, node)
    if tree.mutations[appended_node]:
        rt.num_refs += 1
    new_internal = up[appended_node]
    tree.mutations[new_internal] = tree.mutations[node]
    tree.mutations[node] = []
    tree.dirty[new_internal] = True
    tree.replacements[new_internal] += 1
    children[up[node]][child] = new_internal
    up[new_internal] = up[node]
    children[new_internal][0] = node
    up[node] = new_internal
    tree.replacements[appended_node] += 1
    children[new_internal][1] = appended_node

    def merge_lower():
        return kern.merge_vectors(probVect[node], best_down, is_tip,
                               new_partials, best_appending, appended_is_tip)

    def merge_up_right():
        return kern.merge_vectors(vect_up, best_up, False, new_partials,
                               best_appending, appended_is_tip,
                               is_up_down=True)

    def merge_up_left():
        return kern.merge_vectors(vect_up, best_up, False, probVect[node],
                               best_down, is_tip, is_up_down=True)

    probVect[new_internal] = merge_lower()
    if probVect[new_internal] is None:
        tree.probVectUpLeft[new_internal] = merge_up_left()
        if tree.probVectUpLeft[new_internal] is None:
            tree.probVectUpRight[new_internal] = merge_up_right()
            best_down = kern.estimate_branch_length(tree.probVectUpRight[new_internal], probVect[node],
                from_tip_c=is_tip)
            tree.probVectUpLeft[new_internal] = merge_up_left()
            best_appending = kern.estimate_branch_length(tree.probVectUpLeft[new_internal], new_partials,
                from_tip_c=appended_is_tip)
        else:
            best_appending = kern.estimate_branch_length(tree.probVectUpLeft[new_internal], new_partials,
                from_tip_c=appended_is_tip)
            tree.probVectUpRight[new_internal] = merge_up_right()
            best_down = kern.estimate_branch_length(tree.probVectUpRight[new_internal], probVect[node],
                from_tip_c=is_tip)
        probVect[new_internal] = merge_lower()
        if probVect[new_internal] is None:
            best_appending = dc.oneMutBLen / 5
            best_down = dc.oneMutBLen / 5
            probVect[new_internal] = merge_lower()
    rt.shorten(probVect[new_internal])
    tree.probVectUpRight[new_internal] = merge_up_right()
    if tree.probVectUpRight[new_internal] is None:
        best_up = kern.estimate_branch_length(vect_up, probVect[new_internal], from_tip_c=False)
        tree.probVectUpLeft[new_internal] = merge_up_left()
        best_appending = kern.estimate_branch_length(tree.probVectUpLeft[new_internal], new_partials,
            from_tip_c=appended_is_tip)
        tree.probVectUpRight[new_internal] = merge_up_right()
        if tree.probVectUpRight[new_internal] is None:
            best_up = dc.oneMutBLen / 5
            best_appending = dc.oneMutBLen / 5
            tree.probVectUpRight[new_internal] = merge_up_right()
        probVect[new_internal] = merge_lower()
    rt.shorten(tree.probVectUpRight[new_internal])
    tree.probVectUpLeft[new_internal] = merge_up_left()
    if tree.probVectUpLeft[new_internal] is None:
        best_up = kern.estimate_branch_length(vect_up, probVect[new_internal], from_tip_c=False)
        best_down = kern.estimate_branch_length(tree.probVectUpRight[new_internal], probVect[node],
            from_tip_c=is_tip)
        tree.probVectUpLeft[new_internal] = merge_up_left()
        if tree.probVectUpLeft[new_internal] is None:
            best_up = dc.oneMutBLen / 5
            best_down = dc.oneMutBLen / 5
            tree.probVectUpLeft[new_internal] = merge_up_left()
        probVect[new_internal] = merge_lower()
        tree.probVectUpRight[new_internal] = merge_up_right()
    rt.shorten(tree.probVectUpLeft[new_internal])
    old_dist = dist[node]
    dist[appended_node] = best_appending
    dist[new_internal] = best_up
    dist[node] = best_down
    if tree.use_hnz:
        nDesc0 = tree.nDesc0
        nDesc0[new_internal] = nDesc0[node] if dist[node] <= eff0 else 1
        nDesc0[new_internal] += 1 if dist[appended_node] > eff0 \
            else nDesc0[appended_node]
        to_add = 0
        if old_dist > eff0 and dist[new_internal] <= eff0:
            to_add = nDesc0[new_internal] - 1
        elif old_dist <= eff0 and dist[new_internal] > eff0:
            to_add = 1 - nDesc0[node]
        elif old_dist <= eff0 and dist[new_internal] <= eff0:
            to_add = nDesc0[new_internal] - nDesc0[node]
        if to_add:
            p0 = up[new_internal]
            while True:
                nDesc0[p0] += to_add
                if dist[p0] > eff0:
                    break
                p0 = up[p0]
                if p0 is None:
                    break
    if not best_appending:
        tree.probVectTotUp[appended_node] = None
    if best_up:
        tree.probVectTotUp[new_internal] = kern.merge_vectors(vect_up, best_up / 2, False, probVect[new_internal],
            best_up / 2, False, is_up_down=True)
        rt.shorten(tree.probVectTotUp[new_internal])
    if not best_down:
        tree.probVectTotUp[node] = None
    rt.update_partials([(node, 2, True, False),
                        (up[new_internal], child, True, False),
                        (appended_node, 2, True, False)])
    return None


def cut_and_paste_node(rt: TreeRuntime, node: int, best_node: int,
                       best_branch_lengths, best_lk,
                       passed_prob_vect) -> Optional[int]:
    """Execute one SPR move: detach, repair around the cut, re-attach
    (reference cutAndPasteNode :9188-9277)."""
    tree = rt.tree
    up = tree.up
    children = tree.children
    dist = tree.dist
    eff0 = rt.dc.effectivelyNon0BLen
    parent = up[node]
    sibling = children[parent][1] if node == children[parent][0] \
        else children[parent][0]
    child_p = None
    if up[parent] is not None:
        child_p = 0 if parent == children[up[parent]][0] else 1
        children[up[parent]][child_p] = sibling
        if tree.use_hnz and dist[parent] <= eff0:
            to_remove = -1 if dist[node] > eff0 else -tree.nDesc0[node]
            if dist[sibling] <= eff0 \
                    and (dist[sibling] + dist[parent]) > eff0:
                to_remove += 1 - tree.nDesc0[sibling]
            p0 = parent
            while dist[p0] <= eff0 and up[p0] is not None:
                p0 = up[p0]
                tree.nDesc0[p0] += to_remove
                if tree.nDesc0[p0] <= 0:
                    raise RuntimeError("negative nDesc0 removing subtree")
    up[sibling] = up[parent]
    dist[sibling] = dist[sibling] + dist[parent]
    if tree.mutations[parent]:
        tree.mutations[sibling] = rt.merge_mutation_lists(
            tree.mutations[parent], tree.mutations[sibling])
    if up[sibling] is None:
        dist[sibling] = 1.0
        if children[sibling]:
            c0, c1 = children[sibling]
            tree.probVectUpRight[sibling] = rt.root_vector(
                rt.pass_up(tree.probVect[c1], c1), dist[c1],
                tree.is_tip(c1), sibling)
            tree.probVectUpLeft[sibling] = rt.root_vector(
                rt.pass_up(tree.probVect[c0], c0), dist[c0],
                tree.is_tip(c0), sibling)
            rt.update_partials([(c0, 2, True, False), (c1, 2, True, False)])
    else:
        rt.update_partials([(sibling, 2, True, False),
                            (up[sibling], child_p, True, False)])
    new_root = place_subtree_on_tree(rt, best_node, passed_prob_vect, node,
                                     best_lk, best_branch_lengths)
    trace = getattr(rt, "trace", None)
    if trace is not None:
        trace.record_move(rt, sibling)
    if up[sibling] is None:
        if new_root is not None:
            return new_root
        return sibling
    return new_root


class SprCounters:
    def __init__(self):
        self.topology_updates = 0
        self.blen_updates = 0


def traverse_tree_for_topology_update(rt: TreeRuntime, node: int,
                                      strict_stop, allowed_fails,
                                      threshold_log_lk,
                                      threshold_topology_placement,
                                      counters: SprCounters,
                                      abayes_on=False, network_output=False):
    """Per-node SPR driver (reference traverseTreeForTopologyUpdate
    :9287-9464).  Returns (new_root, improvement)."""
    tree = rt.tree
    cfg = rt.cfg
    dc = rt.dc
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    eff0 = dc.effectivelyNon0BLen
    new_root = None
    blen_changed = False
    total_improvement = 0.0
    if up[node] is None:
        return new_root, total_improvement
    parent = up[node]
    child = tree.child_index(node)
    vect_up = tree.probVectUpRight[parent] if child == 0 \
        else tree.probVectUpLeft[parent]
    if tree.mutations[node]:
        vect_up = rt.pass_down(vect_up, node)
    best_curren_blen = dist[node]
    is_tip = tree.is_tip(node)
    original_lk = kern.append_prob_node(vect_up, tree.probVect[node],
                                     is_tip, best_curren_blen)
    genetic_lk = original_lk
    # --timeAwareTopology: the current placement's score includes its
    # time-likelihood terms so the comparison against time-scored
    # candidates is like-for-like (reference :9332-9346)
    taw = rt.do_time_tree and cfg.timeAwareTopology and rt.time is not None
    if taw:
        from ..models import timetree as tt
        from ..models.timetree import finite_or as _f
        T = rt.time
        pvT = tree.probVectTime
        sibling = children[parent][1 - child]
        # Ill-defined terms (cached time vectors truncated into mutual
        # incompatibility, reference's unguarded -inf unpacks) drop to 0:
        # that decision falls back to genetic-only comparison instead of
        # poisoning the improvement bookkeeping with -inf/NaN.
        if up[parent] is None:
            mv = tt.merge_vectors_time(T, pvT[node], dist[node],
                                       pvT[sibling], dist[sibling],
                                       return_lk=True)
            olt = _f(mv[1]) if not isinstance(mv[0], int) else 0.0
            olt += tt.find_prob_root_time(pvT[parent]) \
                - tt.find_prob_root_time(pvT[sibling])
        else:
            vect_up_time = tree.probVectUpRightTime[parent] if child == 0 \
                else tree.probVectUpLeftTime[parent]
            olt = _f(tt.append_prob_node_time(T, vect_up_time, pvT[node],
                                              best_curren_blen))
            vuut = tree.probVectUpRightTime[up[parent]] \
                if parent == children[up[parent]][0] \
                else tree.probVectUpLeftTime[up[parent]]
            mv = tt.merge_vectors_time(T, vuut, dist[parent], pvT[sibling],
                                       dist[sibling], is_up_down=True,
                                       return_lk=True)
            if not isinstance(mv[0], int):
                olt += _f(mv[1]) - _f(tt.append_prob_node_time(
                    T, vuut, pvT[sibling], dist[sibling] + dist[parent]))
        original_lk += olt
    if tree.use_hnz:
        pn0 = up[node]
        while dist[pn0] <= eff0 and up[pn0] is not None:
            pn0 = up[pn0]
        if dist[node] > eff0:
            original_lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                - get_hnz(cfg.HnZ, tree.nDesc0[pn0] - 1)
        else:
            original_lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                - (get_hnz(cfg.HnZ, tree.nDesc0[pn0] - tree.nDesc0[node])
                   + get_hnz(cfg.HnZ, tree.nDesc0[node]))
    best_current_lk = original_lk
    if ((genetic_lk < threshold_topology_placement)
            or (cfg.supportFor0Branches and abayes_on)) \
            and up[up[node]] is not None:
        best_curren_blen = kern.estimate_branch_length(vect_up, tree.probVect[node], from_tip_c=is_tip)
        if best_curren_blen or dist[node]:
            if (not best_curren_blen) or (not dist[node]) \
                    or dist[node] / best_curren_blen > 1.01 \
                    or dist[node] / best_curren_blen < 0.99:
                blen_changed = True
            best_current_lk = kern.append_prob_node(vect_up, tree.probVect[node], is_tip, best_curren_blen)
            if taw:
                # same time terms as original_lk with the appending term
                # re-evaluated at the re-estimated branch length
                best_current_lk += olt \
                    + _f(tt.append_prob_node_time(T, vect_up_time,
                                                  pvT[node],
                                                  best_curren_blen)) \
                    - _f(tt.append_prob_node_time(T, vect_up_time,
                                                  pvT[node], dist[node]))
            if tree.use_hnz:
                if best_curren_blen > eff0:
                    if dist[node] > eff0:
                        hz = get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                            - get_hnz(cfg.HnZ, tree.nDesc0[pn0] - 1)
                    else:
                        hz = get_hnz(cfg.HnZ, tree.nDesc0[pn0] + 1
                                     - tree.nDesc0[node]) \
                            - get_hnz(cfg.HnZ, tree.nDesc0[pn0]
                                      - tree.nDesc0[node])
                else:
                    if dist[node] > eff0:
                        hz = get_hnz(cfg.HnZ, tree.nDesc0[pn0]
                                     + tree.nDesc0[node] - 1) \
                            - (get_hnz(cfg.HnZ, tree.nDesc0[pn0])
                               + get_hnz(cfg.HnZ, tree.nDesc0[node]))
                    else:
                        hz = get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                            - (get_hnz(cfg.HnZ, tree.nDesc0[pn0]
                                       - tree.nDesc0[node])
                               + get_hnz(cfg.HnZ, tree.nDesc0[node]))
                best_current_lk += hz
            if best_current_lk < original_lk:
                best_curren_blen = dist[node]
                best_current_lk = original_lk
                blen_changed = False
            if best_current_lk == float("-inf"):
                raise RuntimeError("infinite cost in SPR current placement")

    topology_updated = False
    if ((best_current_lk < threshold_topology_placement or dist[node]
         or tree.use_hnz or taw) and not cfg.doNotImproveTopology) \
            or ((dist[node] or cfg.supportFor0Branches) and abayes_on):
        best_node_so_far, best_lk_diff, best_blens, placements, support, \
            passed_vect = find_best_parent_topology(
                rt, parent, child, best_current_lk, best_curren_blen,
                strict_stop, allowed_fails, threshold_log_lk,
                abayes_on=abayes_on, network_output=network_output)
        if best_lk_diff == float("inf"):
            raise RuntimeError("infinite improvement in SPR search")
        if best_lk_diff < -1e50:
            raise RuntimeError(
                "likelihood cost extremely heavy; is the right reference "
                "being used?")
        if best_lk_diff + threshold_topology_placement > best_current_lk \
                and not cfg.doNotImproveTopology:
            topology_updated = True
            top_node = up[node]
            if best_node_so_far == top_node:
                topology_updated = False
            while (not dist[top_node]) and up[top_node] is not None:
                top_node = up[top_node]
            if best_node_so_far == top_node and not best_blens[1]:
                topology_updated = False
            parent = up[node]
            sibling = children[parent][1] if node == children[parent][0] \
                else children[parent][0]
            if best_node_so_far == sibling:
                topology_updated = False
            if up[best_node_so_far] == sibling and not best_blens[0]:
                topology_updated = False
            if topology_updated:
                counters.topology_updates += 1
                total_improvement = best_lk_diff - original_lk
                if original_lk == float("-inf"):
                    total_improvement = best_lk_diff - best_current_lk
                if total_improvement == float("inf"):
                    raise RuntimeError("infinite topology improvement")
                new_root = cut_and_paste_node(rt, node, best_node_so_far,
                                              best_blens, best_lk_diff,
                                              passed_vect)
                blen_changed = False
        if (not topology_updated) and abayes_on:
            if network_output:
                tree.alternativePlacements[node] = placements
            tree.support[node] = support

    if (not topology_updated) and blen_changed:
        counters.blen_updates += 1
        if tree.use_hnz:
            rt.update_ndesc0_changing_dist(node, best_curren_blen)
        dist[node] = best_curren_blen
        rt.update_partials([(node, 2, True, False),
                            (up[node], child, True, False)])
        total_improvement = best_current_lk - original_lk
        if original_lk == float("-inf"):
            total_improvement = 0
        if total_improvement == float("inf"):
            raise RuntimeError("infinite branch length improvement")
    return new_root, total_improvement


def start_topology_updates(rt: TreeRuntime, node: int, strict_stop,
                           allowed_fails, threshold_log_lk,
                           threshold_topology_placement,
                           check_each_spr=False, abayes_on=False,
                           network_output=False, print_every=10000):
    """Sweep all dirty nodes attempting one SPR each (reference
    startTopologyUpdates :9489-9573)."""
    tree = rt.tree
    from ..native.engine import native_spr_supported, run_native_spr_pass
    if native_spr_supported(rt, abayes_on, network_output, check_each_spr):
        res = run_native_spr_pass(rt, node, strict_stop, allowed_fails,
                                  threshold_log_lk,
                                  threshold_topology_placement)
        if res is not None:
            new_root, improvement, topo, blen = res
            print(f"Topology updates {topo} ; bLen updates {blen}")
            return new_root, improvement
    counters = SprCounters()
    nodes_to_visit = [node]
    total_improvement = 0.0
    new_root = None
    num_nodes = 0
    while nodes_to_visit:
        n = nodes_to_visit.pop()
        nodes_to_visit.extend(tree.children[n])
        if tree.dirty[n] and tree.replacements[n] <= rt.cfg.maxReplacements:
            tree.dirty[n] = False
            if check_each_spr:
                root = n
                while tree.up[root] is not None:
                    root = tree.up[root]
                old_lk = rt.calculate_tree_likelihood(root)
            if abayes_on and network_output:
                tree.alternativePlacements[n] = []
            new_root2, improvement = traverse_tree_for_topology_update(
                rt, n, strict_stop, allowed_fails, threshold_log_lk,
                threshold_topology_placement, counters, abayes_on=abayes_on,
                network_output=network_output)
            if check_each_spr:
                root = n
                while tree.up[root] is not None:
                    root = tree.up[root]
                new_lk = rt.calculate_tree_likelihood(root)
                if new_lk - old_lk < improvement - 0.5 \
                        or new_lk - old_lk > improvement + 0.5:
                    raise RuntimeError(
                        f"SPR move for node {n}: realized improvement "
                        f"{new_lk - old_lk} != predicted {improvement}")
            total_improvement += improvement
            if new_root2 is not None:
                new_root = new_root2
            num_nodes += 1
            if num_nodes % print_every == 0:
                print(f"Processed topology for {num_nodes} nodes.",
                      flush=True)
    print(f"Topology updates {counters.topology_updates} ; bLen updates "
          f"{counters.blen_updates}")
    return new_root, total_improvement


# ----------------------------------------------------------------------
def _parallel_update(run, params, abayes_on):
    """numCores>1 or --deviceTopology topology pass: the device screen on
    ``run.device``, else the engine's threaded search-parallel/apply-serial
    implementation when the state allows it (native/engine.py
    run_native_spr_parallel), else the reference-style fork path
    (parallel_spr.py) — outputs are byte-identical."""
    rt = run.rt
    cfg = run.cfg
    tree = run.tree
    strict, fails, threshold, placement_thresh = params
    if cfg.device_topology and not abayes_on and not cfg.networkOutput:
        # device-screened proposals + the same serial re-validated apply
        # (parallel/batch_spr.py); SPRTA/network need the crawl's
        # per-candidate posteriors and fall through to the paths below
        from ..parallel.batch_spr import device_topology_update
        return device_topology_update(rt, run.root, params, SprCounters(),
                                      device=run.device)
    from ..native.engine import native_spr_supported, run_native_spr_parallel
    if native_spr_supported(rt, abayes_on, cfg.networkOutput,
                            cfg.debugging):
        res = run_native_spr_parallel(rt, run.root, cfg.numCores, strict,
                                      fails, threshold, placement_thresh)
        if res is not None:
            return res
    from .parallel_spr import assign_core_numbers, parallel_topology_update
    if getattr(tree, "coreNum", None) is None:
        assign_core_numbers(tree, run.root, cfg.numCores)
    return parallel_topology_update(
        rt, run.root, params, SprCounters(), cfg.numCores,
        abayes_on=abayes_on, network_output=cfg.networkOutput)


def run_spr_rounds(run, rounds: List[tuple]):
    """SPR rounds + subrounds driver (reference :12241-12555).

    When the configuration allows it, the whole rounds loop runs against
    ONE persistent engine session (native/engine.py NativeSession): every
    recompute, likelihood, branch-length sweep, SPR pass, and EM crawl
    hits the resident C++ tree, and only the topology mirror is refreshed
    for the round-tree newick writes — the per-phase import/export
    round-trips that otherwise dominate large-tree wall time disappear."""
    import time as _time
    cfg = run.cfg
    rt = run.rt
    tree = run.tree
    abayes = cfg.SPRTA
    if abayes:
        tree.support = [None] * len(tree.up)
        if cfg.networkOutput:
            tree.alternativePlacements = [[] for _ in range(len(tree.up))]
    ses = None
    if run._native_session_eligible():
        from ..native.engine import open_native_session
        ses = open_native_session(rt, run.root)
    try:
        _run_spr_rounds_body(run, rounds, _time)
    finally:
        if ses is not None:
            ses.close()


def _run_spr_rounds_body(run, rounds, _time):
    cfg = run.cfg
    rt = run.rt
    tree = run.tree
    abayes = cfg.SPRTA
    for n_round, (strict, fails, threshold, placement_thresh) in \
            enumerate(rounds):
        abayes_on = abayes
        print(f"Starting topological improvement traversal number "
              f"{n_round + 1}", flush=True)
        start = _time.time()
        run._set_all_dirty(run.root)
        rt.recalculate_all(run.root)
        if not cfg.doNotOptimiseBLengths:
            from .blen import optimize_branch_lengths
            lk = rt.calculate_tree_likelihood(run.root)
            print(f"Preliminary branch length optimization from LK: {lk}")
            from ..native.engine import run_native_blen_loop
            sub_round = run_native_blen_loop(rt, run.root)
            if sub_round is None:
                improvement = optimize_branch_lengths(rt, run.root)
                sub_round = 0
                while sub_round < 20 and improvement:
                    sub_round += 1
                    improvement = optimize_branch_lengths(rt, run.root)
            lk = rt.calculate_tree_likelihood(run.root)
            print(f"branch length finalization subround {sub_round + 1} "
                  f"final LK: {lk}", flush=True)
        run._set_all_dirty(run.root)
        rt.recalculate_all(run.root)
        pre_lk = rt.calculate_tree_likelihood(run.root)
        print(f"Likelihood before SPR moves: {pre_lk}", flush=True)
        # the device screen cannot produce SPRTA posteriors: with SPRTA
        # requested and numCores 1 the pass stays serial
        parallelize = cfg.numCores > 1 \
            or (cfg.device_topology and not abayes_on)
        if parallelize:
            new_root, improvement = _parallel_update(
                run, (strict, fails, threshold, placement_thresh),
                abayes_on)
        else:
            new_root, improvement = start_topology_updates(
                rt, run.root, strict, fails, threshold, placement_thresh,
                check_each_spr=cfg.debugging, abayes_on=abayes_on,
                network_output=cfg.networkOutput)
        if new_root is not None:
            run.root = new_root
        run.timings["topology"] += _time.time() - start
        print(f"LK improvement apparently brought: {improvement}")
        rt.recalculate_all(run.root)
        post_lk = rt.calculate_tree_likelihood(run.root)
        print(f"Likelihood after SPR moves: {post_lk}")
        run.write_tree(f"_round{n_round + 1}_preliminary_tree.tree")

        # subrounds on nodes affected by changes
        start = _time.time()
        sub_round = 0
        while sub_round < 20:
            print(f"Topological subround {sub_round + 1}", flush=True)
            if parallelize:
                if rt.native_session is not None:
                    num_dirty, num_nodes = rt.native_session.count_dirty()
                else:
                    from ..runtime.tree import count_dirty_nodes
                    num_dirty, num_nodes = count_dirty_nodes(tree, run.root)
            if parallelize and num_dirty > 0.1 * num_nodes:
                new_root, improvement = _parallel_update(
                    run, (strict, fails, threshold, placement_thresh),
                    abayes_on)
            else:
                new_root, improvement = start_topology_updates(
                    rt, run.root, strict, fails, threshold,
                    placement_thresh, check_each_spr=cfg.debugging,
                    abayes_on=abayes_on,
                    network_output=cfg.networkOutput)
            if new_root is not None:
                run.root = new_root
            print(f"LK improvement apparently brought: {improvement}",
                  flush=True)
            if not cfg.noSubroundTrees:
                run.write_tree(f"_round{n_round + 1}_subround"
                               f"{sub_round + 1}_preliminary_tree.tree")
            if improvement < cfg.thresholdLogLKTopologySubRoundImprovement:
                break
            sub_round += 1
        rt.recalculate_all(run.root)
        post_lk = rt.calculate_tree_likelihood(run.root)
        print(f"Likelihood after SPR subrounds: {post_lk}", flush=True)
        run.timings["topology"] += _time.time() - start

        # EM + branch lengths after this round (reference :12397-12478)
        lk = rt.calculate_tree_likelihood(run.root)
        print(f"Initial LK before EM: {lk}", flush=True)
        run.run_em_step(rates_update="rounds")
        rt.recalculate_all(run.root)
        lk = rt.calculate_tree_likelihood(run.root)
        print(f"LK after one round of EM: {lk}")
        if cfg.estimateErrorRate or cfg.estimateSiteSpecificErrorRate:
            old_lk = float("-inf")
            num_steps = 0
            while lk - old_lk > 1.0 and num_steps < 20:
                if not cfg.doNotOptimiseBLengths:
                    from .blen import optimize_branch_lengths
                    run._set_all_dirty(run.root)
                    optimize_branch_lengths(rt, run.root)
                    rt.recalculate_all(run.root)
                run.run_em_step(rates_update="using")
                rt.recalculate_all(run.root)
                old_lk = lk
                lk = rt.calculate_tree_likelihood(run.root)
                num_steps += 1
        if not cfg.doNotOptimiseBLengths:
            from .blen import optimize_branch_lengths
            rt.recalculate_all(run.root)
            run._set_all_dirty(run.root)
            improvement = optimize_branch_lengths(rt, run.root)
            sub_round = 0
            while sub_round < 20 and improvement:
                sub_round += 1
                improvement = optimize_branch_lengths(rt, run.root)
            rt.recalculate_all(run.root)
            lk = rt.calculate_tree_likelihood(run.root)
            print(f"branch length finalization final LK: {lk}")

        # EM round for the time-scaled mutation rate (reference
        # :12462-12480: unconditional first update, then continue while
        # the time LK improves by >0.1, max 20 steps)
        if rt.do_time_tree:
            run.run_time_em(f"SPR round {n_round + 1}")

        suffix = f"_round{n_round + 1}" if n_round < len(rounds) - 1 else ""
        run.write_outputs(suffix, from_rounds=True)
