"""Seconds a tree in which the placement's main loop waits on its threads
(spans ``place.wait.*``: the screen's results, the next batch, the pool's
sync, the placer's construction), less their children's."""
from benchmark.metrics.spans import mean_exclusive


def read(rec):
    return mean_exclusive(rec, prefix="place.wait.")
