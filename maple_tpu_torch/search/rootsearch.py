"""Root-position search and re-rooting.

``find_best_root`` crawls down from the root evaluating a re-rooting at every
branch with full merge-LK bookkeeping so scores are comparable, re-roots on
improvement and emits rootSupport posteriors (reference findBestRoot
:7730-7902); ``re_root_tree`` flips branch directions and MAT mutation lists
(reference reRootTree :2238-2371).
"""
from __future__ import annotations

import time
from math import exp

from ..core import genomelist as gl
from ..core import kernels as K
from ..runtime.partials import TreeRuntime


def flip_mutations(mutation_list):
    return [(m[0], m[2], m[1]) for m in mutation_list]


def re_root_tree(rt: TreeRuntime, root: int, sample,
                 re_root_at_internal_node: bool = False) -> int:
    """Re-root so that ``sample`` (a node id when re_root_at_internal_node,
    else a sample name) becomes (a child of) the new root (reference
    reRootTree :2238-2371).  Bumps the runtime's mutation epoch:
    re-rooting flips branch directions and MAT lists, invalidating every
    cached upper vector."""
    rt.mark_mutated()
    tree = rt.tree
    cfg = rt.cfg
    up = tree.up
    children = tree.children
    dist = tree.dist
    eff0 = rt.dc.effectivelyNon0BLen
    mutations = tree.mutations
    sample_node = None
    root_muts = None
    if re_root_at_internal_node:
        sample_node = sample
        root_muts = mutations[root]
        chain = [up[sample_node]]
        while up[chain[-1]] != root:
            chain.append(up[chain[-1]])
        while chain:
            n = chain.pop()
            if mutations[n]:
                root_muts = rt.merge_mutation_lists(root_muts, mutations[n])
    else:
        stack = [root]
        while stack:
            n = stack.pop()
            if tree.name[n] == sample:
                sample_node = n
                break
            stack.extend(children[n])
    if sample_node is None:
        print("Input lineage/sample for rerooting not found.")
        return root
    if up[sample_node] is None:
        return sample_node
    if up[up[sample_node]] is None:
        # parent is already the root: just zero the sample-side branch
        parent = up[sample_node]
        sibling = children[parent][1] \
            if sample_node == children[parent][0] else children[parent][0]
        dist[sibling] += dist[sample_node]
        dist[sample_node] = False
        if tree.use_hnz:
            tree.nDesc0[parent] = tree.nDesc0[sample_node]
            if dist[sibling] > eff0:
                tree.nDesc0[parent] += 1
            else:
                tree.nDesc0[parent] += tree.nDesc0[sibling]
        return parent
    new_root = tree.add_node()
    children[new_root].append(sample_node)
    children[new_root].append(up[sample_node])
    old_dist = dist[sample_node]
    old_dist_up = dist[up[sample_node]]
    old_up = up[sample_node]
    old_up_up = up[up[sample_node]]
    dist[new_root] = 0.00000001
    if re_root_at_internal_node:
        dist[old_up] = old_dist / 2
        dist[sample_node] = old_dist / 2
    else:
        dist[sample_node] = 0.0
        dist[old_up] = old_dist
    up[sample_node] = new_root
    up[old_up] = new_root

    current_node = old_up_up
    current_blen = old_dist_up
    current_child = old_up
    current_child_child = sample_node
    old_mutations = None
    if re_root_at_internal_node:
        old_mutations = mutations[current_child]
        mutations[current_child] = []
    # flip branch directions until the old root is reached
    while up[current_node] is not None:
        ncc = 0 if current_child_child == children[current_child][0] else 1
        children[current_child][ncc] = current_node
        if re_root_at_internal_node:
            new_muts = flip_mutations(old_mutations)
            old_mutations = mutations[current_node]
            mutations[current_node] = new_muts
        old_blen = dist[current_node]
        old_p = up[current_node]
        dist[current_node] = current_blen
        up[current_node] = current_child
        current_child_child = current_child
        current_child = current_node
        current_node = old_p
        current_blen = old_blen
    # remove the old root
    ncc = 0 if current_child_child == children[current_child][0] else 1
    num_child = 0 if current_child == children[current_node][0] else 1
    if re_root_at_internal_node:
        new_muts = flip_mutations(old_mutations)
        other = children[current_node][1 - num_child]
        mutations[other] = rt.merge_mutation_lists(new_muts,
                                                   mutations[other])
        mutations[new_root] = root_muts
    other = children[current_node][1 - num_child]
    children[current_child][ncc] = other
    up[other] = current_child
    dist[other] += current_blen
    if tree.use_hnz:
        n0 = current_child
        while n0 is not None:
            if children[n0]:
                c0, c1 = children[n0]
                tree.nDesc0[n0] = 1 if dist[c0] > eff0 else tree.nDesc0[c0]
                tree.nDesc0[n0] += 1 if dist[c1] > eff0 else tree.nDesc0[c1]
            else:
                tree.nDesc0[n0] = 1 + len(tree.minorSequences[n0])
            n0 = up[n0]
    return new_root


def find_best_root(rt: TreeRuntime, root: int, strict_stop=None,
                   allowed_fails=None, threshold_log_lk=None,
                   abayes_on: bool = False) -> int:
    t0 = time.time()
    try:
        return _find_best_root_timed_impl(rt, root, strict_stop,
                                          allowed_fails, threshold_log_lk,
                                          abayes_on)
    finally:
        rt.add_phase_time("root_search", time.time() - t0)


def _find_best_root_timed_impl(rt, root, strict_stop, allowed_fails,
                               threshold_log_lk, abayes_on):
    """Search for a better root position; re-roots the tree and recomputes
    genome lists on improvement (reference findBestRoot :7730-7902)."""
    tree = rt.tree
    cfg = rt.cfg
    dc = rt.dc
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    probVect = tree.probVect
    if strict_stop is None:
        strict_stop = cfg.strictTopologyStopRules
    if allowed_fails is None:
        allowed_fails = cfg.allowedFailsTopology
    if threshold_log_lk is None:
        threshold_log_lk = dc.thresholdLogLKtopology
    threshold_consecutive = dc.thresholdLogLKconsecutivePlacement
    threshold_opt = dc.thresholdLogLKoptimizationTopology

    from ..native.engine import (native_session_eligible,
                                 open_native_session,
                                 run_native_root_search)
    opened_here = False
    if rt.native_session is None and not abayes_on \
            and native_session_eligible(rt):
        # the crawl is read-only against the resident engine; re-rooting
        # (python tree+vector surgery) closes the session first
        opened_here = open_native_session(rt, root) is not None
    native = run_native_root_search(rt, root, strict_stop, allowed_fails,
                                    threshold_log_lk,
                                    threshold_consecutive, threshold_opt)
    if native is not None:
        best_node, best_lk_diff, best_nodes = native
        ses = rt.native_session
        if ses is not None and (opened_here or best_node != root):
            ses.close()
        return _apply_root_result(rt, root, best_node, best_nodes,
                                  abayes_on)
    if rt.native_session is not None:
        # native crawl unsupported: the python crawl below must read real
        # host-side vectors, so any live session ends here
        rt.native_session.close()

    best_node = root
    best_lk_diff = 0.0
    best_nodes = {root: 0.0}
    nodes_to_visit = []

    if children[root]:
        child1, child2 = children[root]
        vect_up1 = rt.pass_up(probVect[child2], child2)
        vect_up2 = rt.pass_up(probVect[child1], child1)
        original_lk_cost = rt.find_prob_root(probVect[root], node=root)
        is_tip2 = tree.is_tip(child2)
        is_tip1 = tree.is_tip(child1)
        _, lk = kern.merge_vectors(vect_up1, dist[child2], is_tip2, vect_up2, dist[child1],
            is_tip1, return_lk=True,
            n_minor1=len(tree.minorSequences[child2]),
            n_minor2=len(tree.minorSequences[child1]))
        original_lk_cost += lk
        if tree.mutations[child1]:
            vect_up1 = rt.pass_down(vect_up1, child1)
        if children[child1]:
            nodes_to_visit.append(
                (child1, vect_up1, dist[child1] + dist[child2], is_tip2,
                 len(tree.minorSequences[child2]), original_lk_cost, 0.0, 0))
        if tree.mutations[child2]:
            vect_up2 = rt.pass_down(vect_up2, child2)
        if children[child2]:
            nodes_to_visit.append(
                (child2, vect_up2, dist[child2] + dist[child1], is_tip1,
                 len(tree.minorSequences[child1]), original_lk_cost, 0.0, 0))

    while nodes_to_visit:
        (t1, passed_partials, distance, is_tip, num_minor, lk_to_remove,
         last_lk, failed_passes) = nodes_to_visit.pop()
        childs = [children[t1][0], children[t1][1]]
        prob_vects = [probVect[childs[0]], probVect[childs[1]]]
        dists = [dist[childs[0]], dist[childs[1]]]
        num_minors = [len(tree.minorSequences[childs[0]]),
                      len(tree.minorSequences[childs[1]])]
        is_tips = []
        for i in range(2):
            prob_vects[i] = rt.pass_up(prob_vects[i], childs[i])
            is_tips.append(tree.is_tip(childs[i]))
        new_lk_to_remove = lk_to_remove
        _, lk = kern.merge_vectors(prob_vects[0], dists[0], is_tips[0], prob_vects[1],
            dists[1], is_tips[1], return_lk=True, n_minor1=num_minors[0],
            n_minor2=num_minors[1])
        new_lk_to_remove += lk
        for i in range(2):
            traverse = False
            up_vect = None
            try:
                up_vect, lk = kern.merge_vectors(prob_vects[1 - i], dists[1 - i], is_tips[1 - i],
                    passed_partials, distance, is_tip, return_lk=True,
                    n_minor1=num_minors[1 - i], n_minor2=num_minor)
                new_lk_to_remove_pass = new_lk_to_remove - lk
                new_root_vect, lk_root = kern.merge_vectors(up_vect, dists[i] / 2, False, prob_vects[i],
                    dists[i] / 2, is_tips[i], return_lk=True, n_minor1=0,
                    n_minor2=num_minors[i])
                root_prob_lk = rt.find_prob_root(new_root_vect, node=t1)
                score = root_prob_lk + lk_root + lk - new_lk_to_remove
                failed_new = failed_passes
                if score > best_lk_diff:
                    kern.shorten(up_vect)
                    best_lk_diff = score
                    best_node = childs[i]
                    failed_new = 0
                elif score < (last_lk - threshold_consecutive):
                    failed_new += 1
                if score >= best_lk_diff - threshold_opt:
                    best_nodes[childs[i]] = score
                if children[childs[i]]:
                    if strict_stop:
                        traverse = (failed_new <= allowed_fails
                                    and score > best_lk_diff
                                    - threshold_log_lk)
                    else:
                        traverse = (failed_new <= allowed_fails
                                    or score > best_lk_diff
                                    - threshold_log_lk)
            except Exception:
                print(f"Stopping root search at node {t1} due to error")
                traverse = False
            if traverse:
                if tree.mutations[childs[i]]:
                    vect_to_pass = rt.pass_down(up_vect, childs[i])
                    kern.shorten(vect_to_pass)
                else:
                    vect_to_pass = up_vect
                nodes_to_visit.append(
                    (childs[i], vect_to_pass, dists[i], False, 0,
                     new_lk_to_remove_pass, score, failed_new))

    return _apply_root_result(rt, root, best_node, best_nodes, abayes_on)


def _apply_root_result(rt: TreeRuntime, root: int, best_node: int,
                       best_nodes: dict, abayes_on: bool) -> int:
    """Re-root/remap/abayes tail of find_best_root, shared by the Python
    and native crawls (reference :7852-7900)."""
    tree = rt.tree
    cfg = rt.cfg
    up = tree.up
    children = tree.children
    if best_node != root:
        # remap the old root's score to the child that stays below it
        root_child = best_node
        nodes_to_invert = []
        while up[root_child] != root:
            root_child = up[root_child]
            if up[root_child] != root:
                nodes_to_invert.append(root_child)
        sibling = children[root][1] if root_child == children[root][0] \
            else children[root][0]
        best_nodes[sibling] = best_nodes.pop(root)
        while nodes_to_invert:
            cur = nodes_to_invert.pop()
            if cur in best_nodes:
                best_nodes[up[cur]] = best_nodes.pop(cur)
        new_root = re_root_tree(rt, root, best_node,
                                re_root_at_internal_node=True)
        best_nodes[new_root] = best_nodes.pop(best_node)
        rt.recalculate_all(new_root)
    else:
        new_root = root

    if abayes_on:
        tree.rootSupport = [None] * len(up)
        normalization = best_nodes[new_root]
        tot = 0.0
        for n in best_nodes:
            best_nodes[n] = exp(best_nodes[n] - normalization)
            tot += best_nodes[n]
        for n in best_nodes:
            best_nodes[n] /= tot
            if best_nodes[n] >= cfg.minBranchSupport:
                tree.rootSupport[n] = best_nodes[n]
    return new_root
