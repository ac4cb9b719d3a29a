"""The port's own spans (``maple_tpu_torch/runtime/phases.py``): the mean
exclusive seconds a tree of named spans, which the ``engine.*`` and
``place.*`` readers share.

Each ``Run.run`` of the port closes its tracer into ``phases.recent()``;
the window's tree jobs are its last n entries, n the tree jobs of the
window (the warm-up makes no ``Run``).  A port without the tracer, or with
fewer entries than jobs, gives nothing.
"""


def tracers(rec):
    """The tracers of the window's tree jobs, or None."""
    n = sum(1 for j in rec.jobs if j["kind"] == "tree")
    if not n:
        return None
    try:
        from maple_tpu_torch.runtime.phases import recent
    except ImportError:
        return None
    runs = recent()[-n:]
    return runs if len(runs) == n else None


def mean_exclusive(rec, names=(), prefix=None):
    """Seconds a tree in the spans named in ``names`` or starting with
    ``prefix``, less their children's; None where no tree has one."""
    runs = tracers(rec)
    if runs is None:
        return None
    total, found = 0.0, False
    for tr in runs:
        for name in tr.names():
            if name in names or (prefix and name.startswith(prefix)):
                total += tr.exclusive(name)
                found = True
    return total / len(runs) if found else None
