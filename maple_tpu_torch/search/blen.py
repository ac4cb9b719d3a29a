"""Branch-length optimization sweep.

Dirty-gated pre-order traversal re-optimizing every branch with the
derivative kernel; the root's two children get a half-mutation-step grid
search over their combined length (reference
traverseTreeToOptimizeBranchLengths :8727-8889).
"""
from __future__ import annotations

import time

from ..core import kernels as K
from ..models.hnz import get_hnz
from ..runtime.partials import TreeRuntime


def optimize_branch_lengths(rt: TreeRuntime, root: int, testing: bool = False,
                            fast_pass: bool = False):
    t0 = time.time()
    try:
        return _optimize_branch_lengths_timed_impl(rt, root, testing, fast_pass)
    finally:
        rt.add_phase_time("blen", time.time() - t0)


def _optimize_branch_lengths_timed_impl(rt: TreeRuntime, root: int, testing: bool = False,
                            fast_pass: bool = False):
    if not testing and rt.kern.name == "native":
        from ..native.engine import run_native_blen_sweep
        updates = run_native_blen_sweep(rt, root, fast_pass=fast_pass)
        if updates is not None:
            return updates
    tree = rt.tree
    cfg = rt.cfg
    dc = rt.dc
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    probVect = tree.probVect
    dirty = tree.dirty
    use_hnz = tree.use_hnz
    eff0 = dc.effectivelyNon0BLen
    lRef = rt.refd.lRef
    dtt = rt.do_time_tree
    if dtt:
        from ..models import timetree as tt
        T = rt.time
        probVectTime = tree.probVectTime
    total_improvement = 0.0
    updates = 0
    if not children[root]:
        return 0
    child1, child2 = children[root]
    if dist[child1] > eff0 or dist[child2] > eff0:
        # grid search over half-mutation steps for the two root branches
        tot_dist = (dist[child1] + dist[child2]) * lRef
        tip1 = tree.is_tip(child1)
        tip2 = tree.is_tip(child2)
        v1 = rt.pass_up(probVect[child1], child1)
        v2 = rt.pass_up(probVect[child2], child2)
        best_cost = float("-inf")
        best_bl1 = None
        for i in range(max(1, round(tot_dist)) * 2 + 1):
            bl1 = min(tot_dist, float(i) / 2)
            bl2 = max(tot_dist - bl1, 0.0)
            bl1 /= lRef
            bl2 /= lRef
            root_vector, cost = kern.merge_vectors(v1, bl1, tip1, v2, bl2, tip2, return_lk=True)
            cost += rt.find_prob_root(root_vector, node=root)
            if dtt:
                rvt, cost_time = tt.merge_vectors_time(
                    T, probVectTime[child1], bl1, probVectTime[child2],
                    bl2, return_lk=True)
                cost_time += tt.find_prob_root_time(rvt)
                cost += cost_time
            if use_hnz:
                if bl1 < eff0:
                    cost += get_hnz(cfg.HnZ, tree.nDesc0[child1] + 1) \
                        - get_hnz(cfg.HnZ, tree.nDesc0[child1])
                if bl2 < eff0:
                    cost += get_hnz(cfg.HnZ, tree.nDesc0[child2] + 1) \
                        - get_hnz(cfg.HnZ, tree.nDesc0[child2])
            if cost > best_cost:
                best_cost = cost
                best_bl1 = bl1
        best_bl2 = max(dist[child1] + dist[child2] - best_bl1, 0.0)
        if use_hnz:
            rt.update_ndesc0_changing_dist(child1, best_bl1)
        dist[child1] = best_bl1
        if not fast_pass:
            rt.update_partials([(child1, 2, True, dtt),
                                (root, 0, True, dtt)])
        if use_hnz:
            rt.update_ndesc0_changing_dist(child2, best_bl2)
        dist[child2] = best_bl2
        if not fast_pass:
            rt.update_partials([(child2, 2, True, dtt),
                                (root, 0, True, dtt)])

    nodes = []
    if children[children[root][0]]:
        nodes.extend(children[children[root][0]])
    if children[children[root][1]]:
        nodes.extend(children[children[root][1]])
    while nodes:
        node = nodes.pop()
        if dirty[node]:
            child = tree.child_index(node)
            up_vect = tree.probVectUpRight[up[node]] if child == 0 \
                else tree.probVectUpLeft[up[node]]
            if tree.mutations[node]:
                up_vect = rt.pass_down(up_vect, node)
            is_tip = tree.is_tip(node)
            best_length = kern.estimate_branch_length(up_vect, probVect[node], from_tip_c=is_tip)
            if best_length or dist[node]:
                if testing or use_hnz or dtt:
                    current_cost = kern.append_prob_node(up_vect, probVect[node], is_tip, dist[node])
                    new_cost = kern.append_prob_node(up_vect, probVect[node], is_tip, best_length)
                    if use_hnz:
                        p0 = up[node]
                        while dist[p0] <= eff0 and up[p0] is not None:
                            p0 = up[p0]
                        if dist[node] > eff0:
                            current_cost += get_hnz(cfg.HnZ, tree.nDesc0[p0])\
                                + get_hnz(cfg.HnZ, tree.nDesc0[node])
                            if best_length > eff0:
                                new_cost += get_hnz(cfg.HnZ,
                                                    tree.nDesc0[p0]) \
                                    + get_hnz(cfg.HnZ, tree.nDesc0[node])
                            else:
                                new_cost += get_hnz(
                                    cfg.HnZ,
                                    tree.nDesc0[p0] + tree.nDesc0[node] - 1)
                        else:
                            current_cost += get_hnz(cfg.HnZ, tree.nDesc0[p0])
                            if best_length > eff0:
                                new_cost += get_hnz(
                                    cfg.HnZ,
                                    tree.nDesc0[p0] + 1 - tree.nDesc0[node])\
                                    + get_hnz(cfg.HnZ, tree.nDesc0[node])
                            else:
                                new_cost += get_hnz(cfg.HnZ, tree.nDesc0[p0])
                    if testing:
                        total_improvement += new_cost - current_cost
                if use_hnz and dist[node] > eff0 and best_length > eff0:
                    cost0 = kern.append_prob_node(up_vect, probVect[node],
                                               is_tip, 0.0)
                    if cost0 > -1000000:
                        cost0 += get_hnz(
                            cfg.HnZ, tree.nDesc0[p0] + tree.nDesc0[node] - 1)
                        if cost0 > new_cost:
                            best_length = 0.0
                            new_cost = cost0
                if (use_hnz or dtt) and current_cost > new_cost:
                    best_length = dist[node]
                    new_cost = current_cost
                if best_length or dist[node]:
                    if (not best_length) or (not dist[node]) \
                            or dist[node] / best_length > 1.01 \
                            or dist[node] / best_length < 0.99:
                        if use_hnz:
                            rt.update_ndesc0_changing_dist(node, best_length)
                        dist[node] = best_length
                        updates += 1
                        if not fast_pass:
                            rt.update_partials([(node, 2, True, dtt),
                                                (up[node], child, True,
                                                 dtt)])
                    else:
                        dirty[node] = False
                else:
                    dirty[node] = False
            else:
                dirty[node] = False
        nodes.extend(children[node])
    if testing:
        return total_improvement
    return updates
