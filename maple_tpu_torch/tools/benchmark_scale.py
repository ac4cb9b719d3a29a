"""Accuracy at scale: the twin of the repository's
``scripts/benchmark_scale.py``.

Simulates genomes along a known tree (``scripts/make_synthetic_alignment.py
--treeOut``), runs the port's inference at a ladder of sizes and reports
per size

  - placement throughput (seq/s) and phase timings,
  - the final tree's log-likelihood,
  - the Robinson-Foulds distance to the truth topology (the port's RF
    mode, ``analysis/rf.py``),

one JSON line per size appended to ``<workdir>/scale_results.jsonl``, and a
table on standard output.  The rows carry the JAX script's fields and the
device the run took (``device``: the card's name, or ``cpu``).

Poisson(mutRate) leaves about exp(-mutRate) of the truth branches without
a substitution; no method recovers those splits, so the normalised RF has
a floor above 0 that depends on the data.  The RFL column and comparisons
across sizes and flags are the readouts.

By default inference runs the ``--fast`` preset (the reference's advice
for very large trees); ``--full`` runs the default pipeline.  The device
is the card (``--device cuda``, the default; it exits 2 without one); the
CPU must be named (``--device cpu``).  The JAX script's ``--reference``
and ``--timeout`` are left out: they run the reference implementation,
which is not part of the repository.

    python3 -m maple_tpu_torch.tools.benchmark_scale --sizes 1000,10000 \\
        [--devicePlacement] [--full] [--seed 1] [--mutRate 1.5]
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import torch

from .common import (DEFAULT_WORKDIR, device_error, device_kind,
                     ensure_dataset, rf_between)


def run_one(aln, truth, out_prefix, fast, extra_flags, *,
            device: torch.device) -> dict:
    """Inference on ``aln`` on ``device``, scored against ``truth``."""
    from ..config import MapleConfig
    from ..pipeline import run_inference

    kwargs = dict(input=aln, output=out_prefix, model="UNREST",
                  overwrite=True)
    if fast:
        kwargs["fast"] = True
    kwargs.update(extra_flags)
    t0 = time.time()
    run = run_inference(MapleConfig(**kwargs), device)
    wall = time.time() - t0
    # placed samples = leaves + collapsed minor sequences
    tree = run.tree
    n_samples = sum(1 if not tree.children[n]
                    else 0 for n in range(len(tree.up)))
    n_samples += sum(len(m) for m in tree.minorSequences)
    with open(out_prefix + "_LK.txt") as f:
        lk = float(f.read().strip())
    rf = rf_between(truth, out_prefix + "_tree.tree", out_prefix + "_rf")

    place_time = run.timings["finding"] + run.timings["placing"]
    max_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    return {
        "samples": n_samples,
        "wall_s": round(wall, 2),
        # process-lifetime peak: exact for one size, an upper bound for
        # later rows of an ascending ladder
        "max_rss_mb": round(max_rss_mb, 1),
        "placement_s": round(place_time, 2),
        "placement_seq_per_s": round(n_samples / place_time, 1)
        if place_time else None,
        "topology_s": round(run.timings["topology"], 2),
        "phases_s": {k: round(v, 2)
                     for k, v in sorted(run.rt.phase_times.items())},
        "lk": lk,
        "rf": int(rf["RF"]),
        "normalised_rf": float(rf["normalisedRF"]),
        "rfl": float(rf["RFL"]),
        "device": device_kind(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.tools.benchmark_scale",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", default="1000,10000,20000,50000")
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mutRate", type=float, default=1.5)
    ap.add_argument("--nRate", type=float, default=0.2)
    ap.add_argument("--ambRate", type=float, default=0.05)
    ap.add_argument("--full", action="store_true",
                    help="run the default pipeline instead of --fast")
    ap.add_argument("--devicePlacement", action="store_true")
    ap.add_argument("--placementBudget", type=int, default=0,
                    help="best-first budgeted placement search "
                         "(0 = exact reference DFS)")
    ap.add_argument("--topologyBudget", type=int, default=0,
                    help="bounded SPR re-attachment crawl "
                         "(0 = exact reference stop rules)")
    ap.add_argument("--rootSearchBudget", type=int, default=0,
                    help="best-first bounded root-position crawl "
                         "(0 = exact reference stop rules)")
    ap.add_argument("--numCores", type=int, default=1,
                    help=">1 = engine-threaded search-parallel/"
                         "apply-serial SPR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    err = device_error(args.device)
    if err:
        print(f"benchmark_scale: {err}", file=sys.stderr)
        return 2
    device = torch.device(args.device)

    os.makedirs(args.workdir, exist_ok=True)
    results_path = os.path.join(args.workdir, "scale_results.jsonl")
    sizes = [int(s) for s in args.sizes.split(",")]
    extra = {}
    if args.devicePlacement:
        extra["device_placement"] = True
    if args.placementBudget:
        extra["placementBudget"] = args.placementBudget
    if args.topologyBudget:
        extra["topologyBudget"] = args.topologyBudget
    if args.rootSearchBudget:
        extra["rootSearchBudget"] = args.rootSearchBudget
    if args.numCores > 1:
        extra["numCores"] = args.numCores

    rows = []
    for n in sizes:
        aln, truth = ensure_dataset(args.workdir, n, args.seed,
                                    args.mutRate, args.nRate, args.ambRate)
        res = run_one(aln, truth, os.path.join(args.workdir, f"run_n{n}"),
                      fast=not args.full, extra_flags=extra, device=device)
        res.update({"mode": "full" if args.full else "fast",
                    "seed": args.seed, "mut_rate": args.mutRate,
                    "flags": extra, "ts": time.time()})
        rows.append(res)
        with open(results_path, "a") as f:
            f.write(json.dumps(res) + "\n")
        print(json.dumps(res), flush=True)

    print(f"\n{'n':>8} {'seq/s':>8} {'wall_s':>8} {'nRF':>8} {'RFL':>12} "
          f"{'LK':>16}")
    for r in rows:
        print(f"{r['samples']:>8} {r['placement_seq_per_s'] or '-':>8} "
              f"{r['wall_s']:>8} {r['normalised_rf']:>8.4f} "
              f"{r['rfl']:>12.6f} {r['lk']:>16.2f}")
    print(f"\nresults appended to {results_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
