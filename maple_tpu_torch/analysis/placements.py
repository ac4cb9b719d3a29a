"""Placement-only service and lineage assignment by reference placement.

``--findSamplePlacements``: report best placements + separating mutations
for new samples without modifying the tree (reference :11637-11661,
seekPlacementOfLineageRefs :11273-11310, extractMutations :11224-11271,
outputSamplePlacements :11540-11610).

``--lineageRefs``: place each lineage reference genome on the tree and
assign subtrees whose appending length and SPRTA-style support pass the
thresholds (reference assignLineageByReferencePlacement :11613-11634).

Both are read-only data-parallel passes over a fixed tree — the easy
fully-parallel case; chunks can fan out over processes (reference joblib) or
over the device mesh.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..core.genomelist import TYPE_N, TYPE_O, TYPE_R
from ..io.newick import create_newick, write_nexus
from ..io.tsv import tsv_for_node
from ..runtime.tree import give_internal_node_names
from ..search.placement import find_best_parent_for_new_sample

NUCLEOTIDES = "ACGTRNO"


def extract_mutations(lRef, prob_vect1, prob_vect2, thresh_mutation=0.01):
    """Mutations separating a placement vector from a sample genome
    (reference extractMutations :11224-11271)."""
    out = []
    i1 = i2 = 0
    pos = 0
    e1 = prob_vect1[0]
    e2 = prob_vect2[0]
    while True:
        c1, c2 = e1[0], e2[0]
        if c1 != c2 and c1 < TYPE_N and c2 < TYPE_N:
            if c1 == TYPE_R:
                out.append((e2[1], e2[0], pos + 1, None))
            elif c2 == TYPE_R:
                out.append((e1[0], e1[1], pos + 1, None))
            else:
                out.append((e1[0], e2[0], pos + 1, None))
            pos += 1
        else:
            if c1 != c2 and c1 == TYPE_O and c2 < TYPE_N:
                nuc2 = e1[1] if c2 == TYPE_R else c2
                if e1[-1][nuc2] < thresh_mutation:
                    out.append((c1, nuc2, pos + 1, e1[-1]))
            if c1 in (TYPE_R, TYPE_N) and c2 in (TYPE_R, TYPE_N):
                pos = min(e1[1], e2[1])
            else:
                pos += 1
        if pos == lRef:
            break
        if e1[0] < TYPE_R or e1[0] == TYPE_O:
            i1 += 1
            e1 = prob_vect1[i1]
        elif pos == e1[1]:
            i1 += 1
            e1 = prob_vect1[i1]
        if e2[0] < TYPE_R or e2[0] == TYPE_O:
            i2 += 1
            e2 = prob_vect2[i2]
        elif pos == e2[1]:
            i2 += 1
            e2 = prob_vect2[i2]
    return out


def seek_placements(run, sample_data: Dict, find_placement_only: bool):
    """For each query genome, find its support-weighted placements on the
    fixed tree (reference seekPlacementOfLineageRefs :11273-11355)."""
    rt = run.rt
    tree = run.tree
    t1 = run.root
    tree.lineagePlacements = {}
    n_done = 0
    for name, diffs in sample_data.items():
        new_partials = rt.terminal_vector(diffs)
        possible, best_total_lh = find_best_parent_for_new_sample(
            rt, t1, new_partials, n_done, run.stats,
            compute_placement_support_only=True)
        if possible:
            sorted_placements = sorted(possible, key=lambda x: x[1],
                                       reverse=True)
        else:
            print(f"PossiblePlacements for {name} is empty")
            sorted_placements = []
            best_total_lh = []
        if find_placement_only:
            if sorted_placements:
                sample_partials = rt.kern.export(rt.terminal_vector(diffs))
                muts = extract_mutations(rt.refd.lRef,
                                         rt.kern.export(best_total_lh),
                                         sample_partials,
                                         run.cfg.threshMutation)
                tree.lineagePlacements[name] = (sorted_placements, muts)
            else:
                tree.lineagePlacements[name] = (sorted_placements, None)
        else:
            lineage_root = None
            if sorted_placements:
                placement, support, blens = sorted_placements[0]
                top_bl, bottom_bl, appending_bl = blens
                if appending_bl <= run.dc.lineageRefsThresh \
                        and support >= run.cfg.lineageRefsSupportThresh:
                    tree.lineageAssignments[placement].append(
                        [name, bottom_bl])
                    lineage_root = placement
            tree.lineagePlacements[name] = (sorted_placements, lineage_root)
        n_done += 1
        if n_done % 50 == 0:
            print(f"processed {n_done} placements", flush=True)
    return tree


def _blens_str(names_in_tree, tree, placements):
    placement_strs = []
    blength_strs = []
    for placement, support, blens in placements:
        label = names_in_tree[tree.name[placement]]
        placement_strs.append(f"{label}:{support}")
        parts = [str(b) if b else "0" for b in blens]
        blength_strs.append(f"{label}:({'/'.join(parts)})")
    return ";".join(placement_strs), ";".join(blength_strs)


def find_sample_placements_mode(run):
    """--findSamplePlacements driver (reference findPlacementsForSamples
    :11637-11652 + outputSamplePlacements)."""
    cfg = run.cfg
    sample_data = {}
    for _, name in reversed(run.sorted_distances(
            samples_in_tree=run.samples_in_tree)):
        sample_data[name] = run.data[name]
    seek_placements(run, sample_data, find_placement_only=True)
    give_internal_node_names(run.tree, run.root,
                             names_in_tree=run.names_in_tree,
                             replace_names=False)
    tree = run.tree
    names_in_tree = run.names_in_tree
    with open(cfg.output + "_metaData_samplePlacements.tsv", "w") as f:
        f.write("sample\tplacements\toptimizedBlengths\tmutations\n")
        for key, (placements, muts) in tree.lineagePlacements.items():
            p_str, b_str = _blens_str(names_in_tree, tree, placements)
            mut_strs = []
            if muts is not None:
                for from_state, to_state, position, prob_nuc in muts:
                    if from_state == TYPE_O:
                        tot = sum(prob_nuc)
                        probs = "/".join(f"{p / tot:.6f}" for p in prob_nuc)
                        mut_strs.append(
                            f"{NUCLEOTIDES[from_state]}({probs})"
                            f"{position}{NUCLEOTIDES[to_state]}")
                    else:
                        mut_strs.append(f"{NUCLEOTIDES[from_state]}"
                                        f"{position}"
                                        f"{NUCLEOTIDES[to_state]}")
            f.write(f"{key}\t{p_str}\t{b_str}\t{';'.join(mut_strs)}\n")
    print(f"Sample placements written to "
          f"{cfg.output}_metaData_samplePlacements.tsv", flush=True)
    newick = create_newick(tree, run.root, binary=not cfg.nonBinaryTree,
                           names_in_tree=names_in_tree)
    with open(cfg.output + "_updatedBlengths.tree", "w") as f:
        f.write(newick)


def assign_lineages_by_reference_placement(run, lineage_ref_data: Dict):
    """--lineageRefs driver (reference assignLineageByReferencePlacement
    :11613-11634)."""
    cfg = run.cfg
    tree = run.tree
    n = len(tree.up)
    tree.lineageAssignments = [[] for _ in range(n)]
    tree.lineage = [None] * n
    tree.lineageParent = [None] * n
    tree.lineages = [None] * n
    seek_placements(run, lineage_ref_data, find_placement_only=False)
    # resolve multi-lineage nodes (reference :11335-11352)
    for node in range(n):
        assignments = tree.lineageAssignments[node]
        if assignments:
            if cfg.allowMultiLineagesPerNode:
                tree.lineage[node] = "/".join(a for a, _ in assignments)
            else:
                closest, dist0 = assignments[0]
                for name, d in assignments[1:]:
                    if d < dist0:
                        closest, dist0 = name, d
                tree.lineage[node] = closest
    _annotate_lineage_assignments(tree, run.root)
    _output_lineage_assignments(run)


def _annotate_lineage_assignments(tree, root):
    """Propagate lineages down the tree (reference :11358-11393)."""
    if not tree.lineage[root]:
        tree.lineage[root] = "-"
    tree.lineageParent[root] = "-"
    stack = [(c, tree.lineage[root]) for c in tree.children[root]]
    while stack:
        node, lineage = stack.pop()
        tree.lineageParent[node] = lineage
        if not tree.lineage[node]:
            tree.lineage[node] = lineage
        for c in tree.children[node]:
            stack.append((c, tree.lineage[node]))


def _output_lineage_assignments(run):
    """Writers for the lineage-by-reference mode (reference
    outputLineageAssignments :11413-11537)."""
    cfg = run.cfg
    tree = run.tree
    root = run.root
    names_in_tree = run.names_in_tree
    # supportToLineages (reference defineSupportedToLineages :11396-11408)
    tree.supportToLineages = [[] for _ in range(len(tree.up))]
    for key, (placements, _) in tree.lineagePlacements.items():
        for placement, support, blens in placements:
            if blens[2] <= run.dc.lineageRefsThresh:
                tree.supportToLineages[placement].append([key, support])
    give_internal_node_names(tree, root, names_in_tree=names_in_tree,
                             replace_names=False)
    feature_list = ["lineage", "supportToLineages", "lineageParent"]
    with open(cfg.output + "_metaData_lineageAssignment.tsv", "w") as f:
        f.write("strain\tcollapsedTo")
        for feat in feature_list:
            f.write("\t" + feat)
        f.write("\n")
        next_node = root
        direction = 0
        children = tree.children
        up = tree.up
        while next_node is not None:
            if children[next_node]:
                if direction == 0:
                    next_node = children[next_node][0]
                elif direction == 1:
                    next_node = children[next_node][1]
                    direction = 0
                else:
                    f.write(_lineage_tsv_row(tree, next_node,
                                             names_in_tree, feature_list))
                    if up[next_node] is not None:
                        direction = 1 if children[up[next_node]][0] \
                            == next_node else 2
                    next_node = up[next_node]
            else:
                base = names_in_tree[tree.name[next_node]]
                if tree.minorSequences[next_node]:
                    clade = base + "_MinorSeqsClade"
                    f.write(_lineage_tsv_row(tree, next_node, names_in_tree,
                                             feature_list,
                                             identical_to=clade))
                    for s2 in tree.minorSequences[next_node]:
                        f.write(_lineage_tsv_row(
                            tree, next_node, names_in_tree, feature_list,
                            name_override=names_in_tree[s2],
                            identical_to=clade))
                    f.write(_lineage_tsv_row(tree, next_node, names_in_tree,
                                             feature_list,
                                             name_override=clade))
                else:
                    f.write(_lineage_tsv_row(tree, next_node, names_in_tree,
                                             feature_list))
                if up[next_node] is not None:
                    direction = 1 if children[up[next_node]][0] \
                        == next_node else 2
                next_node = up[next_node]
    print(f"Output lineage assignments at "
          f"{cfg.output}_metaData_lineageAssignment.tsv.", flush=True)

    with open(cfg.output + "_metaData_lineagePlacements.tsv", "w") as f:
        f.write("lineage\tplacements\toptimizedBlengths\t"
                "lineageRootPosition\n")
        for key, (placements, lineage_root) in \
                tree.lineagePlacements.items():
            p_str, b_str = _blens_str(names_in_tree, tree, placements)
            root_str = "-" if lineage_root is None \
                else names_in_tree[tree.name[lineage_root]]
            f.write(f"{key}\t{p_str}\t{b_str}\t{root_str}\n")
    print(f"Output lineage placements at "
          f"{cfg.output}_metaData_lineagePlacements.tsv.", flush=True)

    from ..io.newick import AnnotationOptions
    annotated = create_newick(
        tree, root, binary=not cfg.nonBinaryTree,
        names_in_tree=names_in_tree,
        annotations=AnnotationOptions(performLineageAssignment=True))
    write_nexus(cfg.output + "_lineageAssignment.tree", annotated,
                names_in_tree)
    newick = create_newick(tree, root, binary=not cfg.nonBinaryTree,
                           names_in_tree=names_in_tree)
    with open(cfg.output + "_updatedBlengths.tree", "w") as f:
        f.write(newick)


def _lineage_tsv_row(tree, node, names_in_tree, feature_list,
                     name_override=None, identical_to=""):
    name = name_override or names_in_tree[tree.name[node]]
    row = [name + "\t" + (identical_to if identical_to else "")]
    for feat in feature_list:
        row.append("\t")
        val = getattr(tree, feat)[node]
        if feat == "supportToLineages":
            if val and not identical_to:
                row.append(";".join(f"{k}:{v}" for k, v in val))
        elif val is not None:
            row.append(str(val))
    row.append("\n")
    return "".join(row)
