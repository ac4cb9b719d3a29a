"""Seconds a tree in the port's branch-length optimisation (spans
``blen``: ``optimize_branch_lengths`` and the SPR rounds' native loop),
less their children's."""
from benchmark.metrics.spans import mean_exclusive


def read(rec):
    return mean_exclusive(rec, ("blen",))
