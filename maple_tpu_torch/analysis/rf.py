"""Robinson-Foulds distances via Day's 1985 cluster tables, extended with
branch-length scores (RFL / Kuhner-Felsenstein) — reference
prepareTreeComparison :2377-2534 and RobinsonFouldsWithDay1985 :2541-2661.

The first tree is indexed once (leaf intervals + cluster table + branch
length dictionaries); each comparison tree is then scored in one postorder
sweep.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..runtime.tree import PhyloTree


def prepare_tree_comparison(tree: PhyloTree, t1: int, names_in_tree,
                            names_dict, rooted: bool = False,
                            minimum_blen: float = 0.000006):
    children = tree.children
    up = tree.up
    dist = tree.dist
    name = tree.name
    n = len(up)
    explored = [0] * n
    max_so_far = [float("-inf")] * n
    min_so_far = [float("inf")] * n
    n_desc = [0] * n
    leaf_name_dict: Dict = {}
    node_table: List[List[int]] = []
    branch_length_dict: Dict = {}
    leaf_dist_dict: Dict = {}
    sum_branch_lengths = 0.0
    if not rooted:
        n_leaves = 0
        node = t1
        moving_from = 0
        while node != up[t1]:
            if moving_from == 0:
                if not children[node]:
                    n_leaves += 1
                    nxt = up[node]
                    moving_from = 1
                    node_table.append([0, 0])
                else:
                    nxt = children[node][0]
                    moving_from = 0
            else:
                explored[node] += 1
                if explored[node] == len(children[node]):
                    nxt = up[node]
                    moving_from = 1
                else:
                    nxt = children[node][explored[node]]
                    moving_from = 0
            node = nxt
        explored = [0] * n

    leaf_count = 0
    node = t1
    moving_from = 0
    last_l = float("inf")
    last_r = float("-inf")
    last_desc = 0
    num_branches = 0
    while node != up[t1]:
        if moving_from == 0:
            if not children[node]:
                newname = names_in_tree[name[node]].replace(
                    "?", "_").replace("&", "_")
                if newname != names_in_tree[name[node]]:
                    names_dict[newname] = names_dict[
                        names_in_tree[name[node]]]
                    names_in_tree[name[node]] = newname
                leaf_name_dict[name[node]] = leaf_count
                if rooted:
                    node_table.append([0, 0])
                last_l = leaf_count
                last_r = leaf_count
                last_desc = 1
                leaf_count += 1
                nxt = up[node]
                moving_from = 1
                leaf_dist_dict[name[node]] = dist[node]
            else:
                explored[node] = 0
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
                if node != t1:
                    sum_branch_lengths += dist[node]
                if node == t1:
                    node_table[last_r][0] = last_l
                    node_table[last_r][1] = last_r
                else:
                    if (not rooted) and up[node] == t1 \
                            and len(children[t1]) == 2:
                        if node == children[t1][1]:
                            current_bl = dist[node] + dist[children[t1][0]]
                            add_branch = True
                        else:
                            add_branch = False
                    else:
                        current_bl = dist[node]
                        add_branch = True
                    if add_branch and current_bl > minimum_blen:
                        num_branches += 1
                        if rooted or last_l > 0:
                            if node == children[up[node]][-1]:
                                if node_table[last_l][0] == 0 \
                                        and node_table[last_l][1] == 0:
                                    node_table[last_l][0] = last_l
                                    node_table[last_l][1] = last_r
                                else:
                                    node_table[last_r][0] = last_l
                                    node_table[last_r][1] = last_r
                            else:
                                node_table[last_r][0] = last_l
                                node_table[last_r][1] = last_r
                            branch_length_dict[(last_l, last_r)] = current_bl
                        else:
                            # contains leaf 0: re-root at leaf 0 by flipping
                            flipped_l = last_r + 1
                            flipped_r = n_leaves - 1
                            node_table[flipped_l][0] = flipped_l
                            node_table[flipped_l][1] = flipped_r
                            branch_length_dict[(flipped_l, flipped_r)] = \
                                current_bl
            else:
                nxt = children[node][explored[node]]
                moving_from = 0
        node = nxt
    return (leaf_name_dict, node_table, leaf_count, num_branches,
            leaf_dist_dict, branch_length_dict, sum_branch_lengths)


def robinson_foulds_day1985(tree: PhyloTree, t2: int, leaf_name_dict,
                            node_table, leaf_count, num_branches,
                            leaf_dist_dict, branch_length_dict,
                            sum_branch_lengths, rooted: bool = False,
                            minimum_blen: float = 0.000006):
    children = tree.children
    up = tree.up
    dist = tree.dist
    name = tree.name
    n = len(up)
    explored = [0] * n
    max_so_far = [float("-inf")] * n
    min_so_far = [float("inf")] * n
    n_desc = [0] * n
    node = t2
    found_branches = 0
    missed_branches = 0
    moving_from = 0
    last_l = float("inf")
    last_r = float("-inf")
    last_desc = 0
    visited_leaves = 0
    rfl = sum_branch_lengths
    kf = 0.0
    while node != up[t2]:
        if moving_from == 0:
            if not children[node]:
                if name[node] in leaf_name_dict:
                    leaf_num = leaf_name_dict[name[node]]
                else:
                    print(f"{name[node]} not in reference tree - aborting "
                          "RF distance")
                    return None, None, None, None, None, None, None
                last_l = leaf_num
                last_r = leaf_num
                last_desc = 1
                nxt = up[node]
                moving_from = 1
                visited_leaves += 1
                kf += abs(leaf_dist_dict[name[node]] - dist[node])
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
                if node != t2:
                    if (not rooted) and up[node] == t2 \
                            and len(children[t2]) == 2:
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
                            if rooted or last_l > 0:
                                key_l, key_r = last_l, last_r
                            else:
                                key_l, key_r = last_r + 1, leaf_count - 1
                            if (node_table[key_l][0] == key_l
                                    and node_table[key_l][1] == key_r) or \
                               (node_table[key_r][0] == key_l
                                    and node_table[key_r][1] == key_r):
                                found_branches += 1
                                true_dist = branch_length_dict[(key_l,
                                                                key_r)]
                                kf += abs(true_dist - current_bl)
                                rfl -= true_dist
                            else:
                                missed_branches += 1
                                rfl += current_bl
                        else:
                            missed_branches += 1
                            rfl += current_bl
            else:
                nxt = children[node][explored[node]]
                moving_from = 0
        node = nxt
    if visited_leaves < leaf_count:
        print("There are leaves in the reference not found in this tree - "
              f"leafCount {leaf_count} visitedLeaves {visited_leaves}")
        return None, None, None, None, None, None, None
    num_diffs = (num_branches - found_branches) + missed_branches
    rfl += kf
    normalization = num_branches + leaf_count - (2 if rooted else 3)
    return (num_diffs, float(num_diffs) / normalization, leaf_count,
            found_branches, missed_branches, num_branches - found_branches,
            rfl)


def run_rf_mode(cfg) -> str:
    """--inputRFtrees driver (reference :3156-3186); returns output path."""
    from ..io.newick import read_newick
    import os
    out_path = cfg.output + "_RFdistances.txt"
    if os.path.isfile(out_path) and not cfg.overwrite:
        raise FileExistsError(f"{out_path} exists; use overwrite")
    trees, names_in_tree, names_dict = read_newick(
        cfg.inputTree, create_dict=True, only_terminal_node_name=True,
        default_blen=cfg.defaultBLen,
        normalize_input_blen=cfg.normalizeInputBLen)
    tree1, root1 = trees[0]
    prep = prepare_tree_comparison(tree1, root1, names_in_tree, names_dict,
                                   rooted=False)
    other = read_newick(cfg.inputRFtrees,
                        multiple_trees=cfg.multipleInputRFTrees,
                        input_dict_names=names_dict,
                        only_terminal_node_name=True,
                        default_blen=cfg.defaultBLen,
                        normalize_input_blen=cfg.normalizeInputBLen)
    with open(out_path, "w") as f:
        f.write("RF\tnormalisedRF\tleaves\tfoundBranches\tmissedBranches\t"
                "notFoundBranches\tRFL\n")
        for tree, root in other:
            res = robinson_foulds_day1985(tree, root, *prep, rooted=False)
            f.write("\t".join(str(x) for x in res) + "\n")
    return out_path
