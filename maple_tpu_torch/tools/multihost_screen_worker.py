"""The proxy screen alone (K11, ``proxy_step_sharded``) over a (1, N) mesh
of N ``torch.distributed`` ranks, on a seeded synthetic pool: the twin of
the repository's ``scripts/multihost_screen_worker.py``.

Each rank holds ``rows / N`` rows of random features (made on its device
from the seed and its cand coordinate), scores the same ``k`` queries
against them, and the ranks merge their top-64 winners; the step is timed
on the host clock with its results copied to the host, as the placer reads
them.  Compute grows with N where every rank has a device of its own; on
one card only N = 1 runs under NCCL.  ``benchmark_multihost`` runs it
(``run_screen_group``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..parallel.ranks import run_ranks
from .common import RANK_TIMEOUT

TOPM = 64
Q_FEATURES = 64          # features a query carries (the smallest bucket)


def screen_rank(rank, device, rows, k, iters, seed):
    """One rank's mean step wall over ``iters`` steps, after one step that
    warms up."""
    from ..parallel.mesh import make_mesh
    from ..parallel.proxy_features import D
    from ..parallel.proxy_placer import proxy_step_sharded
    mesh = make_mesh(dp=1, device=device)
    nproc = mesh.shape["cand"]
    g = torch.Generator(device=device).manual_seed(
        seed + 1 + mesh.coords["cand"])
    AF = torch.randn((rows // nproc, D), generator=g, device=device)
    valid = torch.ones(rows // nproc, dtype=torch.bool, device=device)
    rng = np.random.default_rng(seed)     # the same queries on every rank
    q_fidx = torch.from_numpy(rng.integers(0, D, (k, Q_FEATURES))
                              .astype(np.int32)).to(device)
    q_fw = torch.from_numpy(rng.standard_normal((k, Q_FEATURES))
                            .astype(np.float32)).to(device)
    none = torch.zeros((0, 1), device=device)

    def step():
        ts, ti = proxy_step_sharded(
            mesh, AF, valid, none[:, 0].int(), none.int(), none,
            none[:, 0].bool(), q_fidx, q_fw, topm=TOPM, cap=rows)
        return ts.cpu(), ti.cpu()

    step()
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, _ = step()
    wall = (time.perf_counter() - t0) / iters
    return {"pid": rank, "nproc": nproc, "rows": rows, "k": k, "D": D,
            "screen_step_s": wall,
            "finite": bool(torch.isfinite(ts).all())}


def run_screen_group(nproc, rows, k, iters, backend, seed=7) -> dict:
    """Rank 0's ``screen_rank`` result with the slowest rank's step and the
    group's wall (``group_wall_s``); raises unless every rank's scores are
    finite."""
    t0 = time.time()
    out = run_ranks(screen_rank, nproc, backend=backend, timeout=RANK_TIMEOUT,
                    args=(rows, k, iters, seed))
    wall = time.time() - t0
    if not all(r["finite"] for r in out):
        raise AssertionError(f"screen nproc={nproc}: scores not finite")
    r0 = {**out[0], "screen_step_s": max(r["screen_step_s"] for r in out),
          "group_wall_s": wall}
    r0.pop("pid")
    return r0
