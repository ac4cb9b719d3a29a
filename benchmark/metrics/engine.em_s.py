"""Seconds a tree in the port's EM of the rates (spans ``em``: every
call of ``expectation_maximization_rates``), less their children's."""
from benchmark.metrics.spans import mean_exclusive


def read(rec):
    return mean_exclusive(rec, ("em",))
