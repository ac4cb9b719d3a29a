"""Taxonium-ready metadata TSV writer (reference writeTSVfile :12065-12140,
tsvForNode :11085-11186, defineSupportedNodes :12045-12061)."""
from __future__ import annotations

from ..runtime.tree import calculate_ndesc

ALLELES_LIST_EXT = ["A", "C", "G", "T", "?"]


def define_supported_nodes(tree, node):
    """Invert alternativePlacements: for each node, which other nodes might be
    placed on the branch above it (reference :12045-12061)."""
    tree.supportTo = [[] for _ in range(len(tree.alternativePlacements))]
    stack = [node]
    while stack:
        n = stack.pop()
        stack.extend(tree.children[n])
        if tree.alternativePlacements[n]:
            for alt, prob in tree.alternativePlacements[n]:
                tree.supportTo[alt].append((n, prob))


def tsv_for_node(tree, node, name, feature_list, names_in_tree,
                 identical_to="", support_for_identical=False,
                 effectively_non0_blen=0.0):
    out = [name + "\t"]
    if identical_to != "":
        out.append(identical_to)
    out.append("\t")
    for feat in feature_list:
        if node is not None:
            feature = getattr(tree, feat, None)
            if feat == "supportGroup":
                if tree.support[node] is not None:
                    if tree.support[node] < 0.9:
                        s = "nDesc<11_"
                        if identical_to == "":
                            for bound in (100000, 10000, 1000, 100, 10):
                                if tree.nDesc[node] > bound:
                                    s = f"nDesc>{bound}_"
                                    break
                        s += "support<0.5" if tree.support[node] < 0.5 \
                            else "support<0.9"
                    else:
                        s = ""
                    out.append(s)
            elif feature is None:
                pass
            elif feat in ("support", "IQsupport"):
                if feature[node] is not None:
                    if feat == "support" and identical_to != "":
                        if support_for_identical:
                            if tree.dist[node] <= effectively_non0_blen:
                                out.append(str(feature[node]))
                            else:
                                out.append("1.0")
                    else:
                        out.append(str(feature[node]))
            elif feat == "supportTo" and identical_to == "":
                parts = []
                for alt, prob in feature[node]:
                    label = names_in_tree[tree.name[alt]]
                    if tree.minorSequences[alt]:
                        label += "_MinorSeqsClade"
                    parts.append(label + ":" + str(prob))
                out.append(",".join(parts))
            elif feat in ("mutationsInf", "errors"):
                if feat == "mutationsInf" and identical_to != "":
                    pass
                else:
                    parts = []
                    for m in feature[node]:
                        parts.append(ALLELES_LIST_EXT[m[0]] + str(m[1])
                                     + ALLELES_LIST_EXT[m[2]] + ":"
                                     + str(m[3]))
                    out.append(",".join(parts))
            elif feat == "Ns":
                if identical_to == "" or support_for_identical:
                    parts = []
                    for m in feature[node]:
                        if isinstance(m, int):
                            parts.append(str(m))
                        else:
                            parts.append(str(m[0]) + "-" + str(m[1]))
                    out.append(",".join(parts))
            elif feat == "lineage":
                out.append(feature[node])
            elif feat == "lineages":
                parts = [k + ":" + str(v) for k, v in feature[node].items()]
                out.append(",".join(parts))
            elif feat == "rootSupport" and identical_to == "":
                if feature[node] is not None:
                    out.append(str(feature[node]))
        out.append("\t")
    out[-1] = "\n"
    return "".join(out)


def write_tsv_file(run, path: str):
    """Write the metadata TSV for the final tree (reference :12065-12140)."""
    cfg = run.cfg
    tree = run.tree
    node = run.root
    names_in_tree = run.names_in_tree
    support_ident = cfg.supportForIdenticalSequences \
        or cfg.assignmentFile or cfg.assignmentFileCSV
    eff0 = run.dc.effectivelyNon0BLen
    feature_names = {}
    if cfg.keepInputIQtreeSupports:
        feature_names["IQsupport"] = "IQsupport"
    if cfg.SPRTA:
        feature_names["support"] = "support"
        feature_names["rootSupport"] = "rootSupport"
        if cfg.networkOutput:
            calculate_ndesc(tree, node)
            define_supported_nodes(tree, node)
            feature_names["supportGroup"] = "supportGroup"
            feature_names["supportTo"] = "supportTo"
    if cfg.estimateMAT:
        feature_names["mutationsInf"] = "mutationsInf"
        feature_names["Ns"] = "Ns"
    if run.model.using_error_rate:
        feature_names["errors"] = "errors"
    lineage_mode = bool(cfg.assignmentFile or cfg.assignmentFileCSV)
    if lineage_mode:
        feature_names["lineage"] = "lineage"
        feature_names["lineages"] = "lineages"
    feature_list = list(feature_names)
    annotate = cfg.SPRTA or cfg.estimateMAT or lineage_mode

    with open(path, "w") as f:
        f.write("strain\tcollapsedTo")
        for feat in feature_list:
            f.write("\t" + feature_names[feat])
        f.write("\n")
        next_node = node
        direction = 0
        children = tree.children
        up = tree.up
        minor = tree.minorSequences
        while next_node is not None:
            if children[next_node]:
                if direction == 0:
                    next_node = children[next_node][0]
                elif direction == 1:
                    next_node = children[next_node][1]
                    direction = 0
                else:
                    if annotate:
                        f.write(tsv_for_node(
                            tree, next_node,
                            names_in_tree[tree.name[next_node]],
                            feature_list, names_in_tree,
                            support_for_identical=support_ident,
                            effectively_non0_blen=eff0))
                    if up[next_node] is not None:
                        direction = 1 if children[up[next_node]][0] \
                            == next_node else 2
                    next_node = up[next_node]
            else:
                base = names_in_tree[tree.name[next_node]]
                if minor[next_node]:
                    clade = base + "_MinorSeqsClade"
                    ref_node = next_node if (support_ident
                                             or lineage_mode) else None
                    f.write(tsv_for_node(
                        tree, ref_node, base, feature_list, names_in_tree,
                        identical_to=clade,
                        support_for_identical=support_ident,
                        effectively_non0_blen=eff0))
                    for s2 in minor[next_node]:
                        f.write(tsv_for_node(
                            tree, ref_node, names_in_tree[s2], feature_list,
                            names_in_tree, identical_to=clade,
                            support_for_identical=support_ident,
                            effectively_non0_blen=eff0))
                    if annotate:
                        f.write(tsv_for_node(
                            tree, next_node, clade, feature_list,
                            names_in_tree,
                            support_for_identical=support_ident,
                            effectively_non0_blen=eff0))
                else:
                    f.write(tsv_for_node(
                        tree, next_node, base, feature_list, names_in_tree,
                        support_for_identical=support_ident,
                        effectively_non0_blen=eff0))
                if up[next_node] is not None:
                    direction = 1 if children[up[next_node]][0] == next_node \
                        else 2
                next_node = up[next_node]
