"""Nexus tree reader with per-node annotation dictionaries.

Parses a MAPLE-style nexus output (``begin trees;`` block, ``[&key=value,
key={k:v,...}]`` annotations) into a PhyloTree plus ``tree.featureDicts``
(one dict per node; values are floats, strings, or ``{name: float}``
dicts).  Reference readNexus :2015-2113 / assignNodeFeatures :1972-2012.
"""
from __future__ import annotations

from ..runtime.tree import PhyloTree


def _parse_features(annotation: str):
    st = annotation.replace("[", "").replace("]", "")
    features = {}
    index = 0
    while index < len(st):
        old = index
        while st[index] != "=":
            index += 1
        name = st[old:index].replace("&", "")
        index += 1
        if st[index] == "{":
            old = index
            while st[index] != "}":
                index += 1
            body = st[old:index].replace("{", "").replace("}", "")
            d = {}
            for el in body.split(","):
                if el != "":
                    kv = el.split(":")
                    if len(kv) == 2:
                        d[kv[0]] = float(kv[1])
                    else:
                        d[kv[0]] = None
            features[name] = d
            index += 1
        else:
            old = index
            while index < len(st) and st[index] != "}" and st[index] != ",":
                index += 1
            body = st[old:index]
            try:
                features[name] = float(body)
            except ValueError:
                features[name] = body
        if index < len(st) and st[index] == ",":
            index += 1
    return features


def read_nexus(path: str, dirtiness: bool = True):
    """Returns (tree, root); node names are kept as strings and
    ``tree.featureDicts[node]`` holds the parsed annotations."""
    with open(path) as f:
        line = f.readline()
        while line != "begin trees;\n":
            line = f.readline()
            if line == "":
                raise ValueError(f"no tree found in nexus file {path}")
        line = f.readline()
    nw = line.replace("\n", "").split()[4]

    tree = PhyloTree()
    feature_dicts = [None]
    tree.add_node(dirtiness=dirtiness)
    node = 0
    name = ""
    dist_str = ""
    annotation = ""
    made_up = 0
    root = None
    index = 0

    def finish_node(n):
        nonlocal name, dist_str, annotation, made_up
        if name != "":
            tree.name[n] = name
            name = ""
        else:
            made_up += 1
            tree.name[n] = "madeUpNodeName" + str(made_up)
        if dist_str:
            try:
                d = float(dist_str)
            except ValueError:
                d = 0.0
            tree.dist[n] = abs(d)
        dist_str = ""
        feature_dicts[n] = _parse_features(annotation)
        annotation = ""

    while index < len(nw):
        ch = nw[index]
        if ch == "(":
            tree.children[node].append(len(tree.up))
            tree.add_node(dirtiness=dirtiness)
            feature_dicts.append(None)
            tree.up[-1] = node
            node = len(tree.up) - 1
            index += 1
        elif ch == ";":
            finish_node(node)
            root = node
            break
        elif ch == "[":
            first = index
            while nw[index] != "]":
                index += 1
            annotation = nw[first:index + 1]
            index += 1
        elif ch == ":":
            index += 1
            while nw[index] != "," and nw[index] != ")" and nw[index] != ";":
                dist_str += nw[index]
                index += 1
        elif ch == ",":
            finish_node(node)
            node = tree.up[node]
            tree.children[node].append(len(tree.up))
            tree.add_node(dirtiness=dirtiness)
            feature_dicts.append(None)
            tree.up[-1] = node
            node = len(tree.up) - 1
            index += 1
        elif ch == ")":
            finish_node(node)
            index += 1
            node = tree.up[node]
        else:
            name += ch
            index += 1
    if root is None:
        raise ValueError(f"final ';' not found in newick string in {path}")
    tree.featureDicts = feature_dicts
    return tree, root
