"""Seconds a tree in the C++ engine's placement on the main thread (spans
``place.serial``: the warm-up placements and the model refreshes;
``place.seeded``: the seeded batched placement; ``place.export_tree``),
less their children's."""
from benchmark.metrics.spans import mean_exclusive


def read(rec):
    return mean_exclusive(rec, ("place.serial", "place.seeded", "place.export_tree"))
