"""Lineage assignment by named reference samples.

Given an input (newick or nexus) tree and a list of reference samples with
lineage labels (``--assignmentFile`` fasta-style names or
``--assignmentFileCSV`` name,lineage rows), propagate each reference's
lineage to all 0-distance descendants of the attachment clade and down the
tree until overridden; writes ``<out>_lineageAssignments.csv`` and an
annotated ``<out>_nexusTree.tree`` (reference :3191-3480).

With a nexus input tree a second pass reports per-sample lineage
probability distributions (the reference's support-weighted branch never
activates because readNexus stores ``featureDicts`` while the driver looks
for ``tree.features`` — reproduced faithfully, :3364).
"""
from __future__ import annotations

import os

from ..io.newick import (AnnotationOptions, create_newick, read_newick)
from ..io.nexus import read_nexus
from ..runtime.tree import give_internal_node_names


class _TreeShim:
    """Minimal TreeRuntime stand-in for re_root_tree on a bare input tree
    (no alignment/model loaded in this mode)."""

    def __init__(self, tree, cfg):
        from ..runtime.partials import TreeRuntime
        self.tree = tree
        self.cfg = cfg
        self.dc = type("DC", (), {"effectivelyNon0BLen": 0.0})()
        self._mml = TreeRuntime.merge_mutation_lists

    def merge_mutation_lists(self, m1, m2, downward=False):
        return self._mml(self, m1, m2, downward=downward)

    def mark_mutated(self):
        pass  # no cached-vector runtime in this mode


def _read_references(cfg):
    references = {}
    if cfg.assignmentFileCSV:
        with open(cfg.assignmentFileCSV) as f:
            for line in f:
                parts = line.split(",")
                if len(parts) == 2:
                    references[parts[0]] = parts[1].replace("\n", "")
    else:
        with open(cfg.assignmentFile) as f:
            for line in f:
                if line and line[0] == ">":
                    name = line.replace("\n", "").replace(">", "")
                    references[name] = name
    return references


def run_lineage_assignment_mode(cfg):
    """Standalone mode: no alignment is read (reference :3191-3480)."""
    if cfg.assignmentFile and cfg.assignmentFileCSV:
        raise ValueError("use only one of --assignmentFile and "
                         "--assignmentFileCSV")
    use_nexus = bool(cfg.inputNexusTree) \
        and os.path.isfile(cfg.inputNexusTree)
    if not use_nexus and not os.path.isfile(cfg.inputTree):
        raise FileNotFoundError("input tree not found; use --inputTree or "
                                "--inputNexusTree")
    out_csv = cfg.output + "_lineageAssignments.csv"
    if os.path.isfile(out_csv) and not cfg.overwrite:
        raise FileExistsError(f"{out_csv} exists; use --overwrite")

    print("Reading input tree")
    if use_nexus:
        tree, root = read_nexus(cfg.inputNexusTree)
    else:
        tree, root = read_newick(cfg.inputTree, keep_names=True)[0]
        print("Input tree read")
        if cfg.reRoot:
            from ..search.rootsearch import re_root_tree
            root = re_root_tree(_TreeShim(tree, cfg), root, cfg.reRoot)
    give_internal_node_names(tree, root, replace_names=False)
    print("Input tree read")
    references = _read_references(cfg)
    print("Input lineage definition read")

    children = tree.children
    dist = tree.dist
    up = tree.up
    name = tree.name
    n = len(up)
    tree.lineage = [None] * n
    lineage_list = tree.lineage
    most_ancestral_list = [None] * n
    all_lineages_list = [None] * n
    tree.lineages = [None] * n
    lineages_list = tree.lineages

    uncertainty = use_nexus
    node_dict = {}
    if not use_nexus:
        give_internal_node_names(tree, root)

    fh = open(out_csv, "w")
    node = root
    direction = 0
    lineage = ""
    most_ancestral = []
    all_lineages = []
    while node is not None:
        if children[node]:
            if direction == 0:
                if dist[node]:
                    most2 = []
                    all2 = []
                    stack = list(children[node])
                    while stack:
                        nx = stack.pop()
                        if not dist[nx]:
                            if children[nx]:
                                for c in children[nx]:
                                    stack.append(c)
                            elif name[nx] in references:
                                lin = references[name[nx]]
                                all2.append(lin)
                                ind = 0
                                found_anc = False
                                while ind < len(most2):
                                    if most2[ind] in lin:
                                        found_anc = True
                                        break
                                    elif lin in most2[ind]:
                                        del most2[ind]
                                    else:
                                        ind += 1
                                if not found_anc:
                                    most2.append(lin)
                    if most2:
                        lineage = most2[0]
                        most_ancestral = most2
                        all_lineages = all2
                lineage_list[node] = lineage
                most_ancestral_list[node] = most_ancestral
                all_lineages_list[node] = all_lineages
                if uncertainty:
                    node_dict[name[node]] = node
                node = children[node][0]
            else:
                if direction == len(children[node]):
                    if up[node] is not None:
                        direction = children[up[node]].index(node) + 1
                    node = up[node]
                else:
                    lineage = lineage_list[node]
                    most_ancestral = most_ancestral_list[node]
                    all_lineages = all_lineages_list[node]
                    node = children[node][direction]
                    direction = 0
        else:
            if uncertainty:
                node_dict[name[node]] = node
                if name[node] in references:
                    lineage_list[node] = references[name[node]]
                    if dist[node]:
                        most_ancestral_list[node] = [lineage_list[node]]
                        all_lineages_list[node] = [lineage_list[node]]
                    else:
                        most_ancestral_list[node] = most_ancestral
                        all_lineages_list[node] = all_lineages
                else:
                    lineage_list[node] = lineage
                    most_ancestral_list[node] = most_ancestral
                    all_lineages_list[node] = all_lineages
            else:
                if name[node] in references:
                    fh.write(name[node] + "," + references[name[node]]
                             + "\n")
                else:
                    fh.write(name[node] + "," + lineage + "\n")
            if up[node] is not None:
                direction = children[up[node]].index(node) + 1
            node = up[node]

    print("Finished tree pass for lineage assignment")

    if uncertainty:
        # the reference looks for tree.features which readNexus never sets
        # (:3364), so the support-weighted branch is dead code; keep the
        # lookup for fidelity
        features = getattr(tree, "features", False)
        support = False
        alternative_placements = False
        if features and "support" in features:
            support = features["support"]
            alternative_placements = features.get("alternativePlacements",
                                                  False)
        node = root
        direction = 0
        lineage = ""
        while node is not None:
            if children[node]:
                if direction == 0:
                    lineages = {}
                    if support:
                        for lin in all_lineages_list[node]:
                            lineages[lin] = support[node] / len(
                                all_lineages_list[node])
                        if alternative_placements:
                            for alt, p in alternative_placements[
                                    node].items():
                                alt_lins = all_lineages_list[node_dict[alt]]
                                alt_p = p / len(alt_lins)
                                for al in alt_lins:
                                    lineages[al] = lineages.get(al, 0.0) \
                                        + alt_p
                    else:
                        for lin in all_lineages_list[node]:
                            lineages[lin] = 1.0 / len(
                                all_lineages_list[node])
                    lineages_list[node] = lineages
                    node = children[node][0]
                else:
                    if direction == len(children[node]):
                        if up[node] is not None:
                            direction = children[up[node]].index(node) + 1
                        node = up[node]
                    else:
                        lineage = lineage_list[node]
                        node = children[node][direction]
                        direction = 0
            else:
                lineages = {}
                if name[node] in references:
                    fh.write(name[node] + ","
                             + references[name[node]] + ":1.0\n")
                    lineages[references[name[node]]] = 1.0
                else:
                    if support:
                        for lin in all_lineages_list[node]:
                            lineages[lin] = support[node] / len(
                                all_lineages_list[node])
                        if alternative_placements:
                            for alt, p in alternative_placements[
                                    node].items():
                                alt_lins = all_lineages_list[node_dict[alt]]
                                alt_p = p / len(all_lineages_list[
                                    node_dict[alt]])
                                for al in alt_lins:
                                    lineages[al] = lineages.get(al, 0.0) \
                                        + alt_p
                    else:
                        for lin in all_lineages_list[node]:
                            lineages[lin] = 1.0 / len(
                                all_lineages_list[node])
                    fh.write(name[node])
                    for k in lineages.keys():
                        fh.write("," + k + ":" + str(lineages[k]))
                    fh.write("\n")
                lineages_list[node] = lineages
                if up[node] is not None:
                    direction = children[up[node]].index(node) + 1
                node = up[node]
        print("Finished second tree pass for lineage assignment with "
              "uncertainty")
    print("Lineage assignment completed")
    fh.close()

    opts = AnnotationOptions(performLineageAssignment=True)
    s = create_newick(tree, root, binary=not cfg.nonBinaryTree,
                      names_in_tree=None, annotations=opts,
                      support_for_identical=cfg.supportForIdenticalSequences)
    with open(cfg.output + "_nexusTree.tree", "w") as f:
        f.write("#NEXUS\nbegin taxa;\n\tdimensions ntax="
                + str(_count_tips(tree, root)) + ";\n\ttaxlabels\n")
        _write_taxa_names(f, tree, root)
        f.write(";\nend;\n\nbegin trees;\n\ttree TREE1 = [&R] ")
        f.write(s)
        f.write("\nend;\n")
    print("Output nexus tree with lineage assignments created.")


def _count_tips(tree, root):
    n = 0
    stack = [root]
    while stack:
        nx = stack.pop()
        if tree.children[nx]:
            stack.extend(tree.children[nx])
        else:
            n += 1 + len(tree.minorSequences[nx])
    return n


def _iter_tips_in_order(tree, root):
    """Tips in the reference's writeTaxaNames traversal order
    (reference :2994-3026)."""
    node = root
    direction = 0
    while node is not None:
        if tree.children[node]:
            if direction == 0:
                node = tree.children[node][0]
            elif direction == 1:
                node = tree.children[node][1]
                direction = 0
            else:
                if tree.up[node] is not None:
                    direction = 1 if tree.children[tree.up[node]][0] == node \
                        else 2
                node = tree.up[node]
        else:
            yield node
            if tree.up[node] is not None:
                direction = 1 if tree.children[tree.up[node]][0] == node \
                    else 2
            node = tree.up[node]


def _write_taxa_names(fh, tree, root):
    for tip in _iter_tips_in_order(tree, root):
        fh.write("\t" + str(tree.name[tip]) + "\n")
        for m in tree.minorSequences[tip]:
            fh.write("\t" + str(m) + "\n")
