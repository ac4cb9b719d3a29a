"""Newick / nexus tree I-O.

Character-by-character newick parser producing a :class:`PhyloTree` with
interned sample names (reference readNewick :1812-1956), and the iterative
newick writer with minor-sequence clade expansion and nexus annotation
strings (reference createNewick/stringForNode :2673-2957).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..runtime.tree import PhyloTree

ALLELES_LIST = ["A", "C", "G", "T"]
ALLELES_LIST_EXT = ["A", "C", "G", "T", "?"]


def read_newick(
    path: str,
    multiple_trees: bool = False,
    dirtiness: bool = True,
    create_dict: bool = False,
    input_dict_names: Optional[Dict[str, int]] = None,
    keep_names: bool = False,
    only_terminal_node_name: bool = False,
    default_blen: float = 0.000033,
    normalize_input_blen: float = 1.0,
    keep_iqtree_supports: bool = False,
    use_hnz: bool = False,
    use_time: bool = False,
):
    """Parse newick file(s) into (tree, root) pairs.

    Sample names are interned: ``tree.name[node]`` holds an index into the
    returned ``names_in_tree`` list (or ``input_dict_names`` values), unless
    ``keep_names``.  Negative branch lengths are made positive with a
    warning; absent lengths become ``default_blen``.
    """
    trees: List[Tuple[PhyloTree, int]] = []
    names_in_tree: List[str] = []
    names_dict: Dict[str, int] = {}
    sample_num = 0

    def intern(tree, node_index, name, is_internal_name):
        nonlocal sample_num
        if name == "":
            return
        if keep_names:
            tree.name[node_index] = name
            return
        if input_dict_names is None:
            if (not only_terminal_node_name) or (not is_internal_name):
                tree.name[node_index] = sample_num
                if create_dict:
                    names_dict[name] = sample_num
                sample_num += 1
                names_in_tree.append(name)
        else:
            if (not only_terminal_node_name) or (not is_internal_name):
                key = name.replace("?", "_").replace("&", "_")
                if key not in input_dict_names:
                    raise ValueError(
                        f"sample {name!r} not found in the original tree")
                tree.name[node_index] = input_dict_names[key]

    with open(path) as f:
        line = f.readline()
        while line != "":
            while line == "\n":
                line = f.readline()
            if line == "":
                break
            tree = PhyloTree(use_hnz=use_hnz, use_time=use_time)
            tree.add_node(dirtiness=dirtiness)
            if keep_iqtree_supports:
                tree.IQsupport = [0.0]
            nw = line.strip()
            index = 0
            node_index = len(tree.name) - 1
            name = ""
            dist_str = ""
            finished = False
            is_internal_name = False
            while index < len(nw):
                ch = nw[index]
                if ch == "(":
                    tree.children[node_index].append(len(tree.up))
                    tree.add_node(dirtiness=dirtiness)
                    if keep_iqtree_supports:
                        tree.IQsupport.append(None)
                    tree.up[-1] = node_index
                    node_index = len(tree.up) - 1
                    index += 1
                    is_internal_name = False
                elif ch == ";":
                    trees.append((tree, node_index))
                    finished = True
                    break
                elif ch == "[":
                    while nw[index] != "]":
                        index += 1
                    index += 1
                elif ch == ":":
                    index += 1
                    while nw[index] not in ",);":
                        dist_str += nw[index]
                        index += 1
                elif ch == ",":
                    intern(tree, node_index, name, is_internal_name)
                    name = ""
                    if dist_str != "":
                        d = float(dist_str) * normalize_input_blen
                        if d < 0.0:
                            print("Warning: negative branch length in input "
                                  f"tree: {dist_str}; using absolute value.")
                            d = abs(d)
                        tree.dist[node_index] = d
                        dist_str = ""
                    else:
                        tree.dist[node_index] = default_blen
                    node_index = tree.up[node_index]
                    tree.children[node_index].append(len(tree.up))
                    tree.add_node(dirtiness=dirtiness)
                    if keep_iqtree_supports:
                        tree.IQsupport.append(None)
                    tree.up[-1] = node_index
                    node_index = len(tree.up) - 1
                    index += 1
                    is_internal_name = False
                elif ch == ")":
                    intern(tree, node_index, name, is_internal_name)
                    name = ""
                    if dist_str != "":
                        tree.dist[node_index] = (float(dist_str)
                                                 * normalize_input_blen)
                        dist_str = ""
                    else:
                        tree.dist[node_index] = default_blen
                    if keep_iqtree_supports:
                        supp_str = ""
                        index += 1
                        while nw[index] not in ":);":
                            supp_str += nw[index]
                            index += 1
                        if supp_str != "":
                            v = float(supp_str.split("/")[-1])
                            if v > 1:
                                v = v / 100.0
                            tree.IQsupport[tree.up[node_index]] = v
                    else:
                        index += 1
                    node_index = tree.up[node_index]
                    is_internal_name = True
                else:
                    name += ch
                    index += 1
            if not finished:
                raise ValueError(f"newick string in {path} lacks final ';'")
            if not multiple_trees:
                break
            line = f.readline()

    if keep_names:
        return trees
    if create_dict:
        return trees, names_in_tree, names_dict
    if input_dict_names is None:
        return trees, names_in_tree
    return trees


class AnnotationOptions:
    """Which nexus/newick annotations to emit per node (reference
    stringForNode :2673-2807)."""

    def __init__(self, aBayesPlus=False, estimateMAT=False,
                 networkOutput=False, supportFor0Branches=False,
                 usingErrorRate=False, keepInputIQtreeSupports=False,
                 performLineageAssignment=False, minMutProb=0.01,
                 effectivelyNon0BLen=0.0, root_state_fn=None):
        self.aBayesPlus = aBayesPlus
        self.estimateMAT = estimateMAT
        self.networkOutput = networkOutput
        self.supportFor0Branches = supportFor0Branches
        self.usingErrorRate = usingErrorRate
        self.keepInputIQtreeSupports = keepInputIQtreeSupports
        self.performLineageAssignment = performLineageAssignment
        self.minMutProb = minMutProb
        self.effectivelyNon0BLen = effectivelyNon0BLen
        # callable(tree, node) -> root genome list in root frame (used for
        # the rootState annotation); injected to avoid an io->kernels dep
        self.root_state_fn = root_state_fn


def _mut_list_string(label, entries):
    parts = []
    for m in entries:
        parts.append(ALLELES_LIST_EXT[m[0]] + str(m[1])
                     + ALLELES_LIST_EXT[m[2]] + ":" + str(m[3]))
    return label + "={" + ",".join(parts) + "}"


def string_for_node(tree: PhyloTree, node: int, name_node: str, dist_b: float,
                    opts: AnnotationOptions, names_in_tree=None) -> str:
    """Annotation string for one node in the nexus tree (reference
    stringForNode :2673-2807)."""
    aBayes_active = (opts.aBayesPlus and tree.alternativePlacements is not None
                     and tree.support is not None)
    mat_on = (opts.estimateMAT and tree.mutationsInf is not None
              and tree.Ns is not None)
    errors_on = mat_on and opts.usingErrorRate and tree.errors is not None
    lineage_on = opts.performLineageAssignment and tree.lineage is not None
    iq_on = opts.keepInputIQtreeSupports and tree.IQsupport is not None
    strings = []
    up = tree.up
    children = tree.children
    if aBayes_active or mat_on or iq_on:
        if up[node] is not None and (dist_b > opts.effectivelyNon0BLen
                                     or opts.supportFor0Branches or errors_on):
            if aBayes_active and tree.rootSupport is not None \
                    and tree.rootSupport[node] is not None:
                strings.append("rootSupport=" + str(tree.rootSupport[node]))
            if aBayes_active and (dist_b > opts.effectivelyNon0BLen
                                  or opts.supportFor0Branches) \
                    and tree.support[node] is not None:
                strings.append("support=" + str(tree.support[node]))
                if opts.networkOutput and tree.alternativePlacements[node]:
                    alts = []
                    for alt_node, prob in tree.alternativePlacements[node]:
                        alts.append(
                            names_in_tree[tree.name[alt_node]] + ":"
                            + str(prob))
                    strings.append("alternativePlacements={"
                                   + ",".join(alts) + "}")
            if mat_on and (dist_b or errors_on or not children[node]):
                if tree.mutationsInf[node]:
                    strings.append(_mut_list_string(
                        "mutationsInf", tree.mutationsInf[node]))
                if tree.Ns[node]:
                    parts = []
                    for m in tree.Ns[node]:
                        if isinstance(m, int):
                            parts.append(str(m))
                        else:
                            parts.append(str(m[0]) + "-" + str(m[1]))
                    strings.append("Ns={" + ",".join(parts) + "}")
                if errors_on and (not children[node]) and tree.errors[node]:
                    strings.append(_mut_list_string(
                        "errors", tree.errors[node]))
        elif up[node] is None and mat_on:
            # root state annotation from the root's genome list
            root_vect = opts.root_state_fn(tree, node)
            parts = []
            current = 0
            for entry in root_vect:
                piece = None
                if entry[0] == 5:
                    piece = "N" + str(current + 1) + "-" + str(entry[1])
                    current = entry[1]
                elif entry[0] == 6:
                    vals = []
                    for i in range(4):
                        if entry[-1][i] > opts.minMutProb:
                            vals.append(ALLELES_LIST[i] + str(current + 1)
                                        + ":" + str(entry[-1][i]))
                    piece = ",".join(vals)
                    current += 1
                elif entry[0] < 4:
                    piece = ALLELES_LIST[entry[0]] + str(current + 1) + ":1.0"
                    current += 1
                else:
                    current = entry[1]
                if piece is not None:
                    parts.append(piece)
            strings.append("rootState={" + ",".join(parts) + "}")
            if aBayes_active and tree.rootSupport is not None \
                    and tree.rootSupport[node] is not None:
                strings.append("rootSupport=" + str(tree.rootSupport[node]))
        elif up[node] is None and aBayes_active \
                and tree.rootSupport is not None \
                and tree.rootSupport[node] is not None:
            strings.append("rootSupport=" + str(tree.rootSupport[node]))
        if iq_on:
            strings.append("IQsupport=" + str(tree.IQsupport[node]))
    elif lineage_on and (tree.lineage[node] is not None
                         or tree.lineages[node] is not None):
        if tree.lineage[node] is not None:
            strings.append("lineage=" + tree.lineage[node])
        if tree.lineages[node] is not None and tree.lineages:
            parts = [k + ":" + str(v) for k, v in tree.lineages[node].items()]
            strings.append("lineages={" + ",".join(parts) + "}")
    final = ""
    if opts.networkOutput or not children[node]:
        final = name_node
    if strings:
        final += "[&" + ",".join(strings) + "]"
    return final


def create_newick(tree: PhyloTree, node: int, binary: bool = True,
                  names_in_tree: Optional[list] = None,
                  include_minor_seqs: bool = True,
                  annotations: Optional[AnnotationOptions] = None,
                  support_for_identical: bool = False) -> str:
    """Iterative newick writer with minor-sequence clade expansion
    (reference createNewick :2810-2957)."""
    opts = annotations
    annotate = opts is not None and (opts.aBayesPlus or opts.estimateMAT
                                     or opts.performLineageAssignment)
    write_lineage = opts is not None and opts.performLineageAssignment
    expand_names = support_for_identical or write_lineage
    if expand_names and opts is None:
        # the reference's preliminary-tree writes keep expanding minor
        # sequences via stringForNode with all annotation flags off
        # (:12333, :2864): the call degrades to the plain name
        opts = AnnotationOptions()

    def node_name(n) -> str:
        raw = tree.name[n]
        if names_in_tree is None:
            return str(raw) if raw != "" else ""
        return names_in_tree[raw] if raw != "" else ""

    def minor_name(m) -> str:
        if names_in_tree is None:
            return str(m)
        return names_in_tree[m]

    out: List[str] = []
    next_node = node
    direction = 0
    num_leaves = 0
    up, children, dist = tree.up, tree.children, tree.dist
    minor = tree.minorSequences
    while next_node is not None:
        if children[next_node]:
            if direction == 0:
                if dist[next_node] or binary or up[next_node] is None:
                    out.append("(")
                next_node = children[next_node][0]
            elif direction == 1:
                out.append(",")
                next_node = children[next_node][1]
                direction = 0
            else:
                if dist[next_node] or binary or up[next_node] is None:
                    out.append(")" + node_name(next_node))
                    if annotate:
                        out.append(string_for_node(
                            tree, next_node, "", dist[next_node], opts,
                            names_in_tree))
                    out.append(":" + str(dist[next_node]
                                         if dist[next_node] else 0.0))
                if up[next_node] is not None:
                    direction = 1 if children[up[next_node]][0] == next_node \
                        else 2
                next_node = up[next_node]
        else:
            num_leaves += 1 + len(minor[next_node])
            if minor[next_node] and include_minor_seqs:
                base = node_name(next_node)
                if binary:
                    out.append("(" * len(minor[next_node]))
                    if expand_names:
                        out.append(string_for_node(
                            tree, next_node, base, 0.0, opts, names_in_tree))
                    else:
                        out.append(base)
                    out.append(":")
                    for m in minor[next_node][:-1]:
                        out.append("0.0,")
                        if expand_names:
                            out.append(string_for_node(
                                tree, next_node, minor_name(m), 0.0, opts,
                                names_in_tree))
                        else:
                            out.append(minor_name(m))
                        out.append(":0.0):")
                    out.append("0.0,")
                    last = minor[next_node][-1]
                    if expand_names:
                        out.append(string_for_node(
                            tree, next_node, minor_name(last), 0.0, opts,
                            names_in_tree))
                    else:
                        out.append(minor_name(last))
                    out.append(":0.0)" + base + "_MinorSeqsClade")
                else:
                    if dist[next_node] or up[next_node] is None:
                        out.append("(")
                    if expand_names:
                        out.append(string_for_node(
                            tree, next_node, base, 0.0, opts, names_in_tree))
                    else:
                        out.append(base)
                    out.append(":0.0")
                    for m in minor[next_node]:
                        out.append(",")
                        if expand_names:
                            out.append(string_for_node(
                                tree, next_node, minor_name(m), 0.0, opts,
                                names_in_tree))
                        else:
                            out.append(minor_name(m))
                        out.append(":0.0")
                    if dist[next_node] or up[next_node] is None:
                        out.append(")" + base + "_MinorSeqsClade")
            else:
                out.append(node_name(next_node))
            if annotate:
                out.append(string_for_node(
                    tree, next_node, "", dist[next_node], opts,
                    names_in_tree))
            out.append(":" + str(dist[next_node] if dist[next_node] else 0.0))
            if up[next_node] is not None:
                direction = 1 if children[up[next_node]][0] == next_node else 2
            next_node = up[next_node]
    out.append(";")
    return "".join(out)


def write_nexus(path: str, newick_string: str, names_in_tree: List[str]):
    """Write a nexus file wrapping an annotated newick string
    (reference :12538-12547)."""
    with open(path, "w") as f:
        f.write("#NEXUS\nbegin taxa;\n\tdimensions ntax="
                + str(len(names_in_tree)) + ";\n\ttaxlabels\n")
        for name in names_in_tree:
            f.write("\t" + name + "\n")
        f.write(";\nend;\n\nbegin trees;\n\ttree TREE1 = [&R] ")
        f.write(newick_string)
        f.write("\nend;\n")
