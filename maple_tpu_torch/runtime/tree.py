"""Struct-of-arrays phylogenetic tree state.

Host-side twin of the reference ``Tree`` class (MAPLEv0.7.5.4.py:331-376):
parallel Python lists indexed by node id.  Each node caches four genome lists
(lower, upper-right, upper-left, mid-branch total) that the incremental
runtime in :mod:`maple_tpu_torch.runtime.partials` keeps consistent after edits.
"""
from __future__ import annotations

from typing import List, Optional


class PhyloTree:
    """Whole-tree state as parallel arrays indexed by node id."""

    __slots__ = (
        "up", "children", "dist", "name", "dirty", "replacements",
        "mutations", "minorSequences", "probVect", "probVectUpRight",
        "probVectUpLeft", "probVectTotUp", "nDesc", "nDesc0",
        "probVectTime", "probVectUpRightTime", "probVectUpLeftTime",
        "probVectTotUpTime", "dateData", "isRef",
        # annotation layers (filled by SPRTA / MAT estimation / lineage)
        "support", "alternativePlacements", "rootSupport", "mutationsInf",
        "Ns", "errors", "lineage", "lineages", "IQsupport", "supportTo",
        "use_hnz", "use_time",
        # analysis layers attach further ad-hoc annotation arrays
        "__dict__",
    )

    def __init__(self, use_hnz: bool = False, use_time: bool = False):
        self.up: List[Optional[int]] = []
        self.children: List[list] = []
        self.dist: List[float] = []
        self.name: List = []
        self.dirty: List[bool] = []
        self.replacements: List[int] = []
        self.mutations: List[list] = []          # MAT local-reference lists
        self.minorSequences: List[list] = []
        self.probVect: List = []
        self.probVectUpRight: List = []
        self.probVectUpLeft: List = []
        self.probVectTotUp: List = []
        self.nDesc: List[int] = []
        self.nDesc0: List[int] = []
        self.use_hnz = use_hnz
        self.use_time = use_time
        self.probVectTime: List = []
        self.probVectUpRightTime: List = []
        self.probVectUpLeftTime: List = []
        self.probVectTotUpTime: List = []
        self.dateData: List = []
        self.isRef: List[bool] = []
        self.support = None
        self.alternativePlacements = None
        self.rootSupport = None
        self.mutationsInf = None
        self.Ns = None
        self.errors = None
        self.lineage = None
        self.lineages = None
        self.IQsupport = None
        self.supportTo = None

    def __len__(self):
        return len(self.up)

    def add_node(self, dirtiness: bool = True) -> int:
        """Append one empty node slot; returns its id."""
        self.up.append(None)
        self.children.append([])
        self.dirty.append(dirtiness)
        self.name.append("")
        self.minorSequences.append([])
        self.mutations.append([])
        self.replacements.append(0)
        self.dist.append(0.0)
        self.probVect.append(None)
        self.probVectUpRight.append(None)
        self.probVectUpLeft.append(None)
        self.probVectTotUp.append(None)
        self.nDesc.append(0)
        if self.use_hnz:
            self.nDesc0.append(1)
        if self.use_time:
            self.probVectTime.append(None)
            self.probVectUpRightTime.append(None)
            self.probVectUpLeftTime.append(None)
            self.probVectTotUpTime.append(None)
            self.dateData.append(False)
        return len(self.up) - 1

    def is_tip(self, node: int) -> bool:
        """A "tip" for likelihood purposes: leaf with no collapsed minor
        sequences (minor sequences make the observation effectively
        multiple tips)."""
        return (not self.children[node]) and (not self.minorSequences[node])

    def child_index(self, node: int) -> int:
        """0 if node is the first child of its parent, else 1."""
        return 0 if self.children[self.up[node]][0] == node else 1

    def vect_up_for(self, node: int):
        """The parent's upper vector pointing at this node (upRight for the
        first child, upLeft for the second)."""
        parent = self.up[node]
        if self.children[parent][0] == node:
            return self.probVectUpRight[parent]
        return self.probVectUpLeft[parent]


def make_tree_binary(tree: PhyloTree, root: int) -> None:
    """Resolve polytomies into right-combs of 0-length branches
    (reference makeTreeBinary :2117-2133)."""
    stack = [root]
    while stack:
        node = stack.pop()
        ch = tree.children[node]
        if ch:
            while len(ch) > 2:
                c2 = ch.pop()
                c1 = ch.pop()
                new = tree.add_node()
                tree.up[c1] = new
                tree.up[c2] = new
                tree.children[new].append(c1)
                tree.children[new].append(c2)
                tree.up[new] = node
                ch.append(new)
            stack.append(ch[0])
            stack.append(ch[1])


def set_all_dirty(tree: PhyloTree, node: int, dirtiness: bool = True) -> None:
    """Mark the whole subtree dirty (or clean) and reset SPR replacement
    counters (reference setAllDirty :8715-8724)."""
    stack = [node]
    while stack:
        n = stack.pop()
        tree.dirty[n] = dirtiness
        tree.replacements[n] = 0
        stack.extend(tree.children[n])


def give_internal_node_names(tree: PhyloTree, node: int,
                             names_in_tree: Optional[list] = None,
                             replace_names: bool = True) -> None:
    """Name internal nodes in1, in2, ... (preorder with a stack, matching the
    reference's ordering) and initialize the alternativePlacements layer
    (reference giveInternalNodeNames :3030-3058)."""
    tree.alternativePlacements = [[] for _ in range(len(tree.children))]
    counter = 1
    stack = [node]
    while stack:
        n = stack.pop()
        if tree.children[n]:
            if names_in_tree is not None:
                if (not replace_names) and isinstance(tree.name[n], int):
                    pass
                elif tree.name[n] != "" and not replace_names:
                    names_in_tree.append(tree.name[n])
                    tree.name[n] = len(names_in_tree) - 1
                else:
                    tree.name[n] = len(names_in_tree)
                    names_in_tree.append("in" + str(len(names_in_tree)))
            else:
                if replace_names or tree.name[n] == "":
                    tree.name[n] = "in" + str(counter)
                counter += 1
        stack.extend(tree.children[n])


def calculate_ndesc(tree: PhyloTree, node: int) -> None:
    """Fill tree.nDesc with leaf counts (incl. minor sequences) per subtree
    (reference calculateNDesc :12023-12040)."""
    for i in range(len(tree.nDesc)):
        tree.nDesc[i] = 0
    stack = [node]
    while stack:
        n = stack.pop()
        if tree.children[n]:
            if tree.nDesc[tree.children[n][0]]:
                for c in tree.children[n]:
                    tree.nDesc[n] += tree.nDesc[c]
            else:
                stack.append(n)
                stack.extend(tree.children[n])
        else:
            tree.nDesc[n] = 1 + len(tree.minorSequences[n])


def calculate_ndesc0(tree: PhyloTree, root: int, eff0: float,
                     check_existing: bool = False) -> None:
    """Recompute effective-multifurcation sizes for HnZ (reference
    calculateNDesc0 :3063-3126)."""
    children = tree.children
    nDesc0 = tree.nDesc0
    dist = tree.dist
    node = root
    last_node = None
    direction = 0
    while node is not None:
        if direction == 0:
            if children[node]:
                node = children[node][0]
            else:
                expected = 1 + len(tree.minorSequences[node])
                if check_existing and nDesc0[node] != expected:
                    raise RuntimeError(f"nDesc0 tip mismatch at {node}")
                nDesc0[node] = expected
                last_node = node
                node = tree.up[node]
                direction = 1
        else:
            if last_node == children[node][0]:
                node = children[node][1]
                direction = 0
            else:
                old = nDesc0[node]
                nDesc0[node] = 0
                for c in children[node]:
                    nDesc0[node] += 1 if dist[c] > eff0 else nDesc0[c]
                if nDesc0[node] <= 0:
                    raise RuntimeError("non-positive nDesc0")
                if check_existing and old != nDesc0[node]:
                    raise RuntimeError(f"nDesc0 mismatch at {node}: {old} "
                                       f"vs {nDesc0[node]}")
                last_node = node
                node = tree.up[node]
                direction = 1


def count_dirty_nodes(tree: PhyloTree, root: int):
    num_dirty = 0
    total = 0
    stack = [root]
    while stack:
        n = stack.pop()
        total += 1
        if tree.dirty[n]:
            num_dirty += 1
        stack.extend(tree.children[n])
    return num_dirty, total
