"""Recall of the device SPR screens: the twin of the repository's
``scripts/benchmark_spr_recall.py``.

It builds the same starting tree (deterministic serial placement of one
synthetic alignment) once for each pass and runs, with the same
thresholds,

  (a) the engine's threaded serial SPR pass
      (``native.engine.run_native_spr_parallel``: search-parallel,
      apply-serial, the reference's contract), and
  (b) one device proxy-screen SPR pass (``parallel/batch_spr.py``),
  (c) with ``--exact``, one pass of the exhaustive screen (the pair kernel
      over every anchor, ``MAPLE_SPR_EXACT=1``),

and reports each pass's improvement, applied gain, moves and wall.  The
proxy pass's applied gain over the serial pass's is
``device_recall_of_serial_gain``; with ``--exact``, over the exhaustive
pass's it is ``proxy_recall_of_exact_gain``.

The device is the card (``--device cuda``, the default; it exits 2 without
one); the CPU must be named (``--device cpu``: the kernels' plain versions).

    python3 -m maple_tpu_torch.tools.benchmark_spr_recall --samples 20000 \\
        [--cores 4] [--mode both|serial|device] [--exact] [--out res.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .common import DEFAULT_WORKDIR, device_error, device_kind, \
    ensure_dataset


def build_tree(aln, out, cores, device, budget=0):
    from ..config import MapleConfig
    from ..pipeline import Run
    cfg = MapleConfig(input=aln, output=out, model="UNREST",
                      overwrite=True, numCores=cores,
                      placementBudget=budget)
    run = Run(cfg, device)
    run.load()
    t0 = time.time()
    run.build_initial_tree()
    run.rt.recalculate_all(run.root)
    lk = run.rt.calculate_tree_likelihood(run.root)
    return run, lk, time.time() - t0


def spr_params(run):
    cfg = run.cfg
    return (cfg.strictTopologyStopRules, cfg.allowedFailsTopology,
            run.dc.thresholdLogLKtopology, cfg.thresholdTopologyPlacement)


def run_serial(run, cores):
    from ..native.engine import run_native_spr_parallel
    from ..runtime.tree import set_all_dirty
    set_all_dirty(run.tree, run.root)
    strict, fails, thr, place = spr_params(run)
    t0 = time.time()
    res = run_native_spr_parallel(run.rt, run.root, cores, strict,
                                  fails, thr, place)
    wall = time.time() - t0
    if res is None:
        raise RuntimeError("the native SPR pass does not support this state")
    new_root, improvement = res
    if new_root is not None:
        run.root = new_root
    return improvement, wall


def run_device(run, device, exact=False):
    """One device-screened pass: the proxy screen, or the exhaustive one
    (``MAPLE_SPR_EXACT=1`` for the pass)."""
    from ..parallel.batch_spr import device_topology_update
    from ..runtime.tree import set_all_dirty
    from ..search.spr import SprCounters
    set_all_dirty(run.tree, run.root)
    counters = SprCounters()
    saved = os.environ.pop("MAPLE_SPR_EXACT", None)
    if exact:
        os.environ["MAPLE_SPR_EXACT"] = "1"
    try:
        t0 = time.time()
        new_root, improvement = device_topology_update(
            run.rt, run.root, spr_params(run), counters=counters,
            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.time() - t0
    finally:
        os.environ.pop("MAPLE_SPR_EXACT", None)
        if saved is not None:
            os.environ["MAPLE_SPR_EXACT"] = saved
    if new_root is not None:
        run.root = new_root
    return improvement, wall, counters.topology_updates


def _pass(run, lk0, improvement, wall, moves=None) -> dict:
    run.rt.recalculate_all(run.root)
    lk1 = run.rt.calculate_tree_likelihood(run.root)
    out = {"improvement": improvement, "wall_s": wall, "lk_after": lk1,
           "applied_gain": lk1 - lk0}
    if moves is not None:
        out["moves"] = moves
    return out


def _recall(gain, of):
    return gain / of if of > 0 else None


def benchmark(samples, *, device: torch.device, workdir=None, seed=1,
              mut_rate=1.5, cores=4, mode="both", exact=False,
              placement_budget=0, out=None) -> dict:
    """The benchmark's result; with ``out``, the serial pass's part is
    appended there as soon as it is known (a device pass that dies does
    not lose the denominator)."""
    workdir = workdir or DEFAULT_WORKDIR
    aln, _ = ensure_dataset(workdir, samples, seed, mut_rate, 0.2, 0.05)
    res = {"samples": samples, "mut_rate": mut_rate, "cores": cores,
           "device": device_kind(device)}

    def tree(tag):
        run, lk0, build_s = build_tree(
            aln, os.path.join(workdir, f"sprrec_{tag}"), cores, device,
            placement_budget)
        res.setdefault("start_lk", lk0)
        res.setdefault("build_s", build_s)
        if lk0 != res["start_lk"]:
            raise AssertionError(f"the starting trees differ: {lk0} and "
                                 f"{res['start_lk']}")
        return run, lk0

    if mode in ("both", "serial"):
        run, lk0 = tree("s")
        res["serial_pass"] = _pass(run, lk0, *run_serial(run, cores))
        del run
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(res) + "\n")
    if mode in ("both", "device"):
        run, lk0 = tree("d")
        res["device_screen_pass"] = _pass(run, lk0, *run_device(run, device))
        del run
        if exact:
            run, lk0 = tree("x")
            res["exact_screen_pass"] = _pass(
                run, lk0, *run_device(run, device, exact=True))
            del run
            res["proxy_recall_of_exact_gain"] = _recall(
                res["device_screen_pass"]["applied_gain"],
                res["exact_screen_pass"]["applied_gain"])
    if "serial_pass" in res and "device_screen_pass" in res:
        res["device_recall_of_serial_gain"] = _recall(
            res["device_screen_pass"]["applied_gain"],
            res["serial_pass"]["applied_gain"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.tools.benchmark_spr_recall",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mutRate", type=float, default=1.5)
    ap.add_argument("--cores", type=int, default=4)
    ap.add_argument("--mode", default="both",
                    choices=["both", "serial", "device"])
    ap.add_argument("--exact", action="store_true",
                    help="also run the exhaustive screen's pass")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--placementBudget", type=int, default=0,
                    help="build the starting tree with the budgeted crawl "
                    "(the same tree for every pass either way)")
    ap.add_argument("--out", default=None, help="append the result here")
    args = ap.parse_args(argv)
    err = device_error(args.device)
    if err:
        print(f"benchmark_spr_recall: {err}", file=sys.stderr)
        return 2
    res = benchmark(args.samples, device=torch.device(args.device),
                    workdir=args.workdir, seed=args.seed,
                    mut_rate=args.mutRate, cores=args.cores,
                    mode=args.mode, exact=args.exact,
                    placement_budget=args.placementBudget, out=args.out)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
