"""Seconds a tree in the port's full recalculations of the tree's genome
lists and in its full-tree likelihoods (spans ``recalculate`` and
``tree_lk``), less their children's."""
from benchmark.metrics.spans import mean_exclusive


def read(rec):
    return mean_exclusive(rec, ("recalculate", "tree_lk"))
