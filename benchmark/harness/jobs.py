"""The job kinds a traffic mix names (``kind``), each a job of the port's
``maple_tpu_torch.pipeline.Run`` on one alignment; one so far:

- ``tree``: the whole ``Run.run``, from loading to the written tree.

A kind gives ``warm`` (the set-up the cell's shapes need), ``run`` (one
job in the window: its counters, and the port's objects its output is
read from after the window) and ``output`` (the judged output, read after
the window: the tree, the log-likelihood and the rates that the port
reports).

A job's ``MapleConfig`` takes the configuration's ``model`` and its
``options`` (fields of the port's ``MapleConfig``, such as
``estimateErrors``), and the traffic mix's ``flags``; a field that both
the configuration and the mix set is an error.
"""
from __future__ import annotations

import gc
import os

import numpy as np
import torch

from ..reference.rates import read_subs
from ..reference.tree import Tree, read_newick

PLACER_FIELDS = ("steps", "time_place", "time_screen", "time_export",
                 "time_query_export", "time_device", "time_wait")
PASS_FIELDS = ("queries", "anchors", "chunks", "proposals", "collect_s",
               "pack_s", "decide_s", "apply_s", "device_s")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def config_for(cell, aln, out):
    from maple_tpu_torch.config import MapleConfig
    options = cell.config.get("options", {})
    flags = cell.traffic["flags"]
    both = sorted(set(options) & set(flags))
    if both:
        raise ValueError(f"{cell.name}: the configuration's options and "
                         f"the traffic's flags both set {', '.join(both)}")
    return MapleConfig(input=aln, output=out, model=cell.config["model"],
                       overwrite=True, **options, **flags)


def _features(rng, rows, D, F):
    return (rng.integers(0, D, (rows, F), dtype=np.int32),
            rng.random((rows, F), dtype=np.float32))


def warm(cell, aln, device, n_samples):
    """The first uses the cell's shapes need, as ``tools/bench.py``'s
    ``first_use`` pays them: the native library, one proxy step on a pool
    of the run's size through the placer's upload and readback, and for a
    mix that screens SPR moves on the device one ``spr_screen_step`` on a
    pool of the size its first pass takes."""
    from maple_tpu_torch.native import native_available
    from maple_tpu_torch.parallel import batch_spr
    from maple_tpu_torch.parallel.proxy_placer import ProxyPool, proxy_step
    from maple_tpu_torch.parallel.stacked_pool import to_host, upload
    if not native_available():
        raise RuntimeError("the port's native library did not build")
    rng = np.random.default_rng(0)
    cfg = config_for(cell, aln, os.devnull)
    pool = ProxyPool(n_samples * 2 + 64, device)
    K, R, F = cfg.device_proxy_batch, 512, 64
    aidx, aw = _features(rng, R, pool.D, F)
    qidx, qw = _features(rng, K, pool.D, F)
    with pool.on_stream():
        ts, ti = proxy_step(
            pool.AF, pool.valid, upload(np.arange(R), device),
            upload(aidx, device), upload(aw, device),
            upload(np.ones(R, bool), device), upload(qidx, device),
            upload(qw, device), topm=cfg.device_seed_topm)
        to_host(ts, ti)
    _sync(device)
    del pool
    if cfg.device_topology:
        cap = 1024
        while cap < n_samples * 2:
            cap *= 2
        D = batch_spr.D_HASH + batch_spr.G_BUCKETS
        AF = torch.zeros((cap, D), dtype=torch.float32, device=device)
        valid = torch.ones(cap, dtype=torch.bool, device=device)
        qidx, qw = _features(rng, batch_spr.PROXY_CHUNK, D, F)
        k = len(qidx)
        ts, ti = batch_spr.spr_screen_step(
            AF, valid, upload(np.zeros(cap, np.int32), device),
            upload(qidx, device), upload(qw, device),
            upload(np.zeros(k, np.int32), device),
            upload(np.ones(k, np.int32), device),
            upload(np.full((k, 2), -1, np.int32), device),
            topm=batch_spr.PROXY_TOPM)
        to_host(ts, ti)
        _sync(device)
        del AF, valid
    gc.collect()


class Job:
    """One job's counters, and the port's run its output is read from."""

    def __init__(self, kind, wall_s, samples, counters, run, out):
        self.kind = kind
        self.wall_s = wall_s
        self.samples = samples
        self.counters = counters
        self.run = run
        self.out = out


def run_tree(cell, aln, device, out, spans, clock):
    from maple_tpu_torch.parallel import batch_spr
    from maple_tpu_torch.pipeline import Run
    cfg = config_for(cell, aln, out)
    batch_spr.stats.reset()
    t0 = clock()
    with spans.span("job"):
        run = Run(cfg, device)
        run.run()
        _sync(device)
    wall = clock() - t0
    if run.proxy_placer is None or run.rt.kern.name != "native":
        raise RuntimeError("the tree job did not place on the proxy branch "
                           "on the native kernels")
    counters = {"timings": dict(run.timings),
                "spr_passes": [{k: float(getattr(p, k)) for k in PASS_FIELDS}
                               | {"branch": p.branch}
                               for p in batch_spr.stats.passes]}
    pl = run.proxy_placer
    counters.update({k: float(getattr(pl, k)) for k in PLACER_FIELDS})
    run.proxy_placer = None
    batch_spr.stats.reset()
    return Job("tree", wall, None, counters, run, out)


def _tree_of(run):
    """The port's tree as plain arrays (``reference.tree.Tree``): topology,
    branch lengths, leaf and minor-sequence names, and the mutation lists
    of the local references of its mutation-annotated tree."""
    tr = run.tree
    names = run.names_in_tree
    n = len(tr.children)
    tree = Tree([list(c) for c in tr.children], [float(d) for d in tr.dist],
                [None] * n, [[] for _ in range(n)], run.root,
                [list(m) for m in tr.mutations])
    for node in tree.leaves():
        tree.name[node] = names[tr.name[node]]
        tree.minors[node] = [names[m] for m in tr.minorSequences[node]]
    return tree


def output_tree(job):
    """The written ``_LK.txt``, ``_subs.txt`` (``reference.rates.Rates``)
    and ``_tree.tree``, and the port's tree they describe."""
    run = job.run
    if run.rt.native_session is not None:
        run.rt.native_session.sync_topology()
    with open(job.out + "_LK.txt") as f:
        lk = float(f.read())
    rates = read_subs(job.out + "_subs.txt")
    with open(job.out + "_tree.tree") as f:
        written = read_newick(f.read())
    return _tree_of(run), lk, rates, written


KINDS = {"tree": (run_tree, output_tree)}
