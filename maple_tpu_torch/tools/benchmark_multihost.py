"""Multi-rank benchmark of the device placement path: the twin of the
repository's ``scripts/benchmark_multihost.py`` on ``torch.distributed``
ranks (``parallel/ranks.py`` ``run_ranks``; no ``jax.distributed``, no
``taskset``).

Placement groups: the production proxy-screen placement of one synthetic
alignment over a (1, N) mesh of N ranks for each N of ``--procs``
(``multihost_worker``).  Every rank of a group must land the same
likelihood on the same tree, and every group the same likelihood: the
replicated-pipeline contract.  Screen groups: the sharded screen alone
(K11) on a ``--screen-rows`` pool for each N of ``--screen-procs``
(``multihost_screen_worker``).

A rank is one process on one device, so a group of N ranks is N devices
(the JAX script split a fixed mesh of 8 virtual devices over its
processes).  NCCL (the default) runs one rank a card and exits 2 without
enough cards; the CPU must be named with ``--backend gloo``:

    python3 -m maple_tpu_torch.tools.benchmark_multihost --samples 20000 \\
        --procs 1 --screen-procs 1 [--out result.json]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..parallel.ranks import backend_error
from .common import DEFAULT_WORKDIR, device_kind, ensure_dataset
from .multihost_screen_worker import run_screen_group
from .multihost_worker import run_group


def _counts(spec: str):
    return [int(x) for x in spec.split(",") if x]


def benchmark(samples, procs, screen_procs, *, backend, workdir=None,
              seed=1, cores=1, screen_rows=524288, screen_k=64,
              screen_iters=3, skip_placement=False) -> dict:
    """The benchmark's result (the fields of the JAX script's)."""
    res = {"samples": samples, "backend": backend,
           "device": device_kind(torch.device(
               "cuda" if backend == "nccl" else "cpu", 0)),
           "cores_per_proc": cores, "groups": []}
    workdir = workdir or DEFAULT_WORKDIR
    if not skip_placement:
        aln, _truth = ensure_dataset(workdir, samples, seed, 1.5, 0.2, 0.05)
        base = None
        for nproc in procs:
            row = run_group(nproc, aln, workdir, cores, backend)
            row["seq_per_s"] = samples / row["wall_s"]
            # one device a rank: what survives of one rank's throughput
            row["efficiency_vs_1proc"] = 1.0 if base is None \
                else base / row["wall_s"]
            base = base or row["wall_s"]
            res["groups"].append(row)
            print(json.dumps(row), flush=True)
        lks = {g["lk"] for g in res["groups"]}
        res["lk_identical_across_groups"] = len(lks) == 1
        if len(lks) != 1:
            raise AssertionError(f"the groups disagree: LKs {lks}")
    if screen_procs:
        res["screen_strong_scaling"] = []
        base_step = None
        for nproc in screen_procs:
            row = run_screen_group(nproc, screen_rows, screen_k,
                                   screen_iters, backend)
            row["speedup_vs_1proc"] = 1.0 if base_step is None \
                else base_step / row["screen_step_s"]
            base_step = base_step or row["screen_step_s"]
            res["screen_strong_scaling"].append(row)
            print(json.dumps(row), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.tools.benchmark_multihost",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cores", type=int, default=1)
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--screen-rows", type=int, default=524288,
                    help="pool rows for the screen scaling table")
    ap.add_argument("--screen-k", type=int, default=64)
    ap.add_argument("--screen-iters", type=int, default=3)
    ap.add_argument("--screen-procs", default="1,2,4",
                    help="rank counts for the screen table ('' skips it)")
    ap.add_argument("--skip-placement", action="store_true")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: rank r on cuda:r (the default); gloo: every "
                    "rank on the CPU")
    ap.add_argument("--out", default=None, help="write the result here")
    args = ap.parse_args(argv)
    procs = [] if args.skip_placement else _counts(args.procs)
    screen_procs = _counts(args.screen_procs)
    err = backend_error(args.backend, max(procs + screen_procs, default=1))
    if err:
        print(f"benchmark_multihost: {err}", file=sys.stderr)
        return 2
    res = benchmark(args.samples, procs, screen_procs, backend=args.backend,
                    workdir=args.workdir, seed=args.seed, cores=args.cores,
                    screen_rows=args.screen_rows, screen_k=args.screen_k,
                    screen_iters=args.screen_iters,
                    skip_placement=args.skip_placement)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
