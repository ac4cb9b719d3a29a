"""Percent of a traced window of tree jobs in which no kernel, copy or
set ran on the card: 1 - busy / window, by ``torch.profiler``."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
