"""One group of N ``torch.distributed`` ranks running the production
device placement over a (1, N) mesh: the proxy screen with its pool sharded
over the candidate axis and the engine's replicated apply, on a synthetic
alignment.  The twin of the repository's ``scripts/multihost_worker.py``;
a rank is one process on one device (NCCL rank r on ``cuda:r``, gloo ranks
on the CPU), so the mesh of N ranks is (1, N).  ``benchmark_multihost``
runs it (``run_group``): the ranks are started by ``run_ranks``, not as
commands of their own.
"""
from __future__ import annotations

import os
import time

import torch

from ..parallel.ranks import run_ranks
from .common import RANK_TIMEOUT


def place_rank(rank, device, aln, outdir, cores):
    """One rank: the default ``--devicePlacement`` placement stage of
    ``aln`` (UNREST) over the mesh of all ranks; its walls, its LK and its
    tree's signature."""
    from ..config import MapleConfig
    from ..dryrun import tree_signature
    from ..parallel.mesh import make_mesh
    from ..pipeline import Run
    mesh = make_mesh(dp=1, device=device)
    nproc = mesh.size
    cfg = MapleConfig(input=aln,
                      output=os.path.join(outdir, f"mh{nproc}_p{rank}"),
                      model="UNREST", overwrite=True,
                      device_placement=True, numCores=cores)
    run = Run(cfg, device)
    run.load()
    t0 = time.time()
    run.build_initial_tree_device(mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    run.rt.recalculate_all(run.root)
    res = {"pid": rank, "nproc": nproc, "mesh": dict(mesh.shape),
           "wall_s": wall, "lk": run.rt.calculate_tree_likelihood(run.root),
           "finding_s": run.timings["finding"],
           "placing_s": run.timings["placing"],
           "signature": tree_signature(run)}
    placer = run.proxy_placer
    if placer is not None:
        # inside "finding": screen = the device round trips seen from the
        # host, export = feature extraction; the rest is the warmup,
        # terminal builds and glue
        res.update(screen_s=placer.time_screen,
                   export_s=placer.time_export + placer.time_query_export,
                   place_s=placer.time_place, steps=placer.steps,
                   device_s=placer.time_device)
    return res


def run_group(nproc, aln, outdir, cores, backend) -> dict:
    """Rank 0's ``place_rank`` result with the group's wall
    (``group_wall_s``); raises unless every rank landed the same LK on the
    same tree."""
    t0 = time.time()
    rows = run_ranks(place_rank, nproc, backend=backend, timeout=RANK_TIMEOUT,
                     args=(aln, outdir, cores))
    wall = time.time() - t0
    lks = {r["lk"] for r in rows}
    if len(lks) != 1 or len({r["signature"] for r in rows}) != 1:
        raise AssertionError(f"the {nproc} ranks disagree: LKs {lks}")
    return {**rows[0], "group_wall_s": wall}
