"""Parallel SPR: search-parallel / apply-serial.

The only parallelized phase of the reference (``--numCores N``): node ids
are round-robined over cores (assignCoreNumbers :12164-12195), each
worker read-only scans its nodes proposing (node, placement, improvement)
moves plus SPRTA supports (startTopologyUpdatesParallel :9580-9716), the
driver merges + sorts proposals by improvement and applies them serially,
re-validating each against the mutated tree by re-running the sequential
per-node driver (applySPRMovesParallel :9470-9484).

Workers are forked processes: the whole runtime (including the native
C++ store) is inherited copy-on-write, so no pickling of tree state is
needed; only the small proposal lists cross the process boundary.
"""
from __future__ import annotations

import multiprocessing
import os
import sys
from operator import itemgetter

from ..models.hnz import get_hnz
from .spr import (SprCounters, find_best_parent_topology,
                  traverse_tree_for_topology_update)

# worker state inherited through fork()
_WORK = {}


def assign_core_numbers(tree, root: int, num_cores: int):
    """Round-robin node ids to cores in the reference's traversal order
    (reference :12164-12195)."""
    core_num = [None] * len(tree.up)
    tree.coreNum = core_num
    node = root
    last_node = None
    direction = 0
    current = 0
    num_nodes = 0
    children = tree.children
    up = tree.up
    while node is not None:
        if direction == 0:
            num_nodes += 1
            core_num[node] = current
            current = (current + 1) % num_cores
            if children[node]:
                node = children[node][0]
            else:
                last_node = node
                node = up[node]
                direction = 1
        else:
            if last_node == children[node][0]:
                node = children[node][1]
                direction = 0
            else:
                last_node = node
                node = up[node]
                direction = 1
    print(f"Assigned {num_cores} cores for {num_nodes} nodes.")


def _propose_moves(core: int):
    """Worker: read-only SPR search over this core's dirty nodes
    (reference startTopologyUpdatesParallel :9580-9716)."""
    rt = _WORK["rt"]
    root = _WORK["root"]
    strict, fails, threshold, placement_thresh = _WORK["params"]
    abayes_on = _WORK["abayes_on"]
    network_output = _WORK["network_output"]
    tree = rt.tree
    cfg = rt.cfg
    kern = rt.kern
    up = tree.up
    children = tree.children
    dist = tree.dist
    dirty = tree.dirty
    core_num = tree.coreNum
    eff0 = rt.dc.effectivelyNon0BLen
    proposed = []
    sprta_reporting = []
    nodes_searched = 0
    stack = [root]
    while stack:
        node = stack.pop()
        for c in children[node]:
            stack.append(c)
        if not (dirty[node] and tree.replacements[node]
                <= cfg.maxReplacements and core_num[node] == core):
            continue
        if up[node] is None:
            continue
        nodes_searched += 1
        placement = None
        support = None
        placements = []
        improvement = 0.0
        parent = up[node]
        child = tree.child_index(node)
        vect_up = tree.probVectUpRight[parent] if child == 0 \
            else tree.probVectUpLeft[parent]
        if tree.mutations[node]:
            vect_up = rt.pass_down(vect_up, node)
        best_curren_blen = dist[node]
        is_tip = tree.is_tip(node)
        best_current_lk = kern.append_prob_node(
            vect_up, tree.probVect[node], is_tip, best_curren_blen)
        if tree.use_hnz:
            pn0 = up[node]
            while dist[pn0] <= eff0 and up[pn0] is not None:
                pn0 = up[pn0]
            if dist[node] > eff0:
                best_current_lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                    - get_hnz(cfg.HnZ, tree.nDesc0[pn0] - 1)
            else:
                best_current_lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                    - (get_hnz(cfg.HnZ,
                               tree.nDesc0[pn0] - tree.nDesc0[node])
                       + get_hnz(cfg.HnZ, tree.nDesc0[node]))
        topology_updated = False
        if ((best_current_lk < placement_thresh or dist[node]
             or tree.use_hnz) and not cfg.doNotImproveTopology) \
                or ((dist[node] or cfg.supportFor0Branches) and abayes_on):
            # worker exceptions swallow the node (reference :9703-9704)
            try:
                best_node, best_lk_diff, best_blens, placements, support, \
                    _passed = find_best_parent_topology(
                        rt, parent, child, best_current_lk,
                        best_curren_blen, strict, fails, threshold,
                        abayes_on=abayes_on, network_output=network_output)
                if best_lk_diff + placement_thresh > best_current_lk \
                        and not cfg.doNotImproveTopology:
                    topology_updated = True
                    top_node = up[node]
                    if best_node == top_node:
                        topology_updated = False
                    while (not dist[top_node]) \
                            and up[top_node] is not None:
                        top_node = up[top_node]
                    if best_node == top_node and not best_blens[1]:
                        topology_updated = False
                    parent = up[node]
                    sibling = children[parent][1] \
                        if node == children[parent][0] \
                        else children[parent][0]
                    if best_node == sibling:
                        topology_updated = False
                    if up[best_node] == sibling and not best_blens[0]:
                        topology_updated = False
                    if topology_updated:
                        improvement = best_lk_diff - best_current_lk
                        placement = best_node
            except Exception:
                placement = None
        if support is not None and abayes_on:
            sprta_reporting.append(
                (node, support, placements if network_output else None))
        if placement is not None and not cfg.doNotImproveTopology:
            proposed.append((node, placement, improvement))
    print(f"Searched {nodes_searched} nodes within core {core} and found "
          f"{len(proposed)} proposed SPR moves")
    if abayes_on:
        return proposed, sprta_reporting
    return proposed


def apply_spr_moves(rt, results, params, counters: SprCounters,
                    abayes_on=False, network_output=False):
    """Serially re-validate + apply proposals, best-improvement first
    (reference applySPRMovesParallel :9470-9484; results are sorted
    ascending and popped from the end)."""
    strict, fails, threshold, placement_thresh = params
    tree = rt.tree
    cumulative = 0.0
    new_root = None
    while results:
        node, _placement, _improvement = results.pop()
        if abayes_on and network_output:
            tree.alternativePlacements[node] = []
        nr2, improvement = traverse_tree_for_topology_update(
            rt, node, strict, fails, threshold, placement_thresh,
            counters, abayes_on=abayes_on, network_output=network_output)
        cumulative += improvement
        if nr2 is not None:
            new_root = nr2
    return new_root, cumulative


def parallel_topology_update(rt, root: int, params, counters: SprCounters,
                             num_cores: int, abayes_on=False,
                             network_output=False):
    """One search-parallel / apply-serial pass (reference :12283-12312)."""
    from ..runtime.tree import set_all_dirty
    _WORK["rt"] = rt
    _WORK["root"] = root
    _WORK["params"] = params
    _WORK["abayes_on"] = abayes_on
    _WORK["network_output"] = network_output
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(num_cores) as pool:
        results = pool.map(_propose_moves, range(num_cores))
    tree = rt.tree
    if abayes_on:
        improvements = []
        for proposed, reporting in results:
            improvements.extend(proposed)
            for node, support, placements in reporting:
                tree.support[node] = support
                if network_output:
                    tree.alternativePlacements[node] = placements
    else:
        improvements = []
        for proposed in results:
            improvements.extend(proposed)
    improvements.sort(reverse=False, key=itemgetter(2))
    if os.environ.get("MAPLE_DEBUG_PROPS"):
        for n_, p_, i_ in improvements:
            print(f"PROP {n_} {p_} {i_!r}", file=sys.stderr)
    print("Found proposed SPR moves, merged, and sorted.")
    set_all_dirty(tree, root, dirtiness=False)
    return apply_spr_moves(rt, improvements, params, counters,
                           abayes_on=abayes_on,
                           network_output=network_output)
