"""SPRTA branch-support calibration against a known truth topology.

The library core of the reference's SPRTA benchmarking harness
(its scripts/benchmarking_branchSupport.py:10-38): on data
simulated along a known tree, a well-calibrated support value should
track the probability that the branch is in the true tree.  We classify
every internal branch of the inferred tree as present/absent in the
truth topology using the same Day-1985 interval tables as the RF mode
(analysis/rf.py, reference :2377-2661) and aggregate by support bin.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..runtime.tree import PhyloTree


def branch_truth_flags(tree: PhyloTree, t2: int, leaf_name_dict,
                       node_table, leaf_count,
                       minimum_blen: float = 0.000006
                       ) -> Dict[int, bool]:
    """For each internal node of ``tree`` whose branch is long enough to
    define a split (dist > minimum_blen), whether its leaf bipartition
    exists in the truth tree indexed by ``prepare_tree_comparison``.

    Same unrooted traversal/normalization as robinson_foulds_day1985."""
    children = tree.children
    up = tree.up
    dist = tree.dist
    name = tree.name
    n = len(up)
    explored = [0] * n
    max_so_far = [float("-inf")] * n
    min_so_far = [float("inf")] * n
    n_desc = [0] * n
    flags: Dict[int, bool] = {}
    node = t2
    moving_from = 0
    last_l = float("inf")
    last_r = float("-inf")
    last_desc = 0
    while node != up[t2]:
        if moving_from == 0:
            if not children[node]:
                leaf_num = leaf_name_dict[name[node]]
                last_l = leaf_num
                last_r = leaf_num
                last_desc = 1
                nxt = up[node]
                moving_from = 1
            else:
                nxt = children[node][0]
                moving_from = 0
        else:
            explored[node] += 1
            if last_l < min_so_far[node]:
                min_so_far[node] = last_l
            if last_r > max_so_far[node]:
                max_so_far[node] = last_r
            n_desc[node] += last_desc
            if explored[node] == len(children[node]):
                nxt = up[node]
                moving_from = 1
                last_l = min_so_far[node]
                last_r = max_so_far[node]
                last_desc = n_desc[node]
                if node != t2 and children[node]:
                    if up[node] == t2 and len(children[t2]) == 2:
                        if node == children[t2][1]:
                            current_bl = dist[node] + dist[children[t2][0]]
                            search = True
                        else:
                            search = False
                    else:
                        current_bl = dist[node]
                        search = True
                    if search and current_bl > minimum_blen:
                        if (last_r + 1 - last_l) == last_desc:
                            if last_l > 0:
                                key_l, key_r = last_l, last_r
                            else:
                                key_l, key_r = last_r + 1, leaf_count - 1
                            flags[node] = (
                                (node_table[key_l][0] == key_l
                                 and node_table[key_l][1] == key_r)
                                or (node_table[key_r][0] == key_l
                                    and node_table[key_r][1] == key_r))
                        else:
                            flags[node] = False
            else:
                nxt = children[node][explored[node]]
                moving_from = 0
        node = nxt
    return flags


def calibration_table(tree: PhyloTree, root: int, truth_prep,
                      bins: Optional[List[float]] = None,
                      minimum_blen: float = 0.000006
                      ) -> List[Tuple[float, float, int, float, float]]:
    """Bin inferred branches by SPRTA support and report, per bin:
    (lo, hi, n_branches, fraction_in_truth, mean_support).

    ``truth_prep`` is the tuple from rf.prepare_tree_comparison on the
    truth tree.  Branches without a support value (e.g. the root's
    children merged into one unrooted split) are skipped."""
    if bins is None:
        bins = [0.0, 0.2, 0.4, 0.6, 0.8, 0.9, 0.95, 1.0001]
    leaf_name_dict, node_table, leaf_count = truth_prep[:3]
    flags = branch_truth_flags(tree, root, leaf_name_dict, node_table,
                               leaf_count, minimum_blen)
    rows = []
    for lo, hi in zip(bins, bins[1:]):
        n = 0
        correct = 0
        ssum = 0.0
        for node, in_truth in flags.items():
            s = tree.support[node] if tree.support else None
            if s is None or not (lo <= s < hi):
                continue
            n += 1
            correct += 1 if in_truth else 0
            ssum += s
        rows.append((lo, hi, n, (correct / n) if n else float("nan"),
                     (ssum / n) if n else float("nan")))
    return rows
