"""A rooted tree as plain arrays, and a small Newick reader.

``Tree`` holds what the judge reads of a tree: ``children`` (a list per
node), ``dist`` (the branch length above each node), ``name`` (a leaf's
sample name, None inside), ``minors`` (the samples a leaf stands for as
well, MAPLE's minor sequences: identical to the leaf, or less informative)
``root`` and ``mutations``: for each node of the mutation-annotated tree
that holds a local reference, its (pos, upper nucleotide, lower
nucleotide) list against its parent's frame, else an empty list.
"""
from __future__ import annotations


class Tree:
    def __init__(self, children, dist, name, minors, root, mutations=None):
        self.children = children
        self.dist = dist
        self.name = name
        self.minors = minors
        self.root = root
        self.mutations = mutations or [[] for _ in children]
        self.up = [None] * len(children)
        for node, kids in enumerate(children):
            for kid in kids:
                self.up[kid] = node

    def frame_chain(self, node):
        """The nodes with a local reference from the root down to
        ``node``, in that order."""
        chain = []
        while node is not None:
            if self.mutations[node]:
                chain.append(node)
            node = self.up[node]
        chain.reverse()
        return chain

    def postorder(self):
        """Node ids, children before parents (iterative: deep trees)."""
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            out.append(node)
            stack.extend(self.children[node])
        out.reverse()
        return out

    def leaves(self):
        return [n for n in self.postorder() if not self.children[n]]


def read_newick(text):
    """A Newick tree, as a ``Tree``: a leaf's label is its sample name, an
    internal label is dropped, a length left out reads 0."""
    children, dist, name = [], [], []

    def new_node(parent):
        children.append([])
        dist.append(0.0)
        name.append(None)
        node = len(children) - 1
        if parent is not None:
            children[parent].append(node)
        return node

    text = text.strip().rstrip(";")
    root = cur = new_node(None)
    stack = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "(":
            stack.append(cur)
            cur = new_node(cur)
            i += 1
        elif ch == ",":
            cur = new_node(stack[-1])
            i += 1
        elif ch == ")":
            cur = stack.pop()
            i += 1
        elif ch == ":":
            j = i + 1
            while j < n and text[j] not in ",()":
                j += 1
            dist[cur] = float(text[i + 1:j])
            i = j
        else:
            j = i
            while j < n and text[j] not in ",():":
                j += 1
            name[cur] = text[i:j]
            i = j
    if stack:
        raise ValueError("unbalanced parentheses in a Newick tree")
    for node, kids in enumerate(children):
        if kids:
            name[node] = None
    return Tree(children, dist, name, [[] for _ in children], root)
