"""Seconds a tree in the port's root search (spans ``root_search``:
``find_best_root``), less their children's."""
from benchmark.metrics.spans import mean_exclusive


def read(rec):
    return mean_exclusive(rec, ("root_search",))
