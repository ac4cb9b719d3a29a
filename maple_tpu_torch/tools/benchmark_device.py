"""Device placement against host placement on one synthetic alignment: the
twin of the repository's ``scripts/benchmark_device.py``.

It runs the serial host placement and the device placement (with default
flags the proxy screen feeding the C++ engine) on the same alignment and
reports, against the host run:

  - the placement wall and seq/s of both,
  - the post-placement log-likelihood delta,
  - the RF distance between the two trees, and of each to the truth tree,
  - with ``--spr``, one device SPR screen pass (moves, improvement, wall;
    the pass must not lower the LK).

The device is the card (``--device cuda``, the default; it exits 2 without
one); the CPU must be named (``--device cpu``: the kernels' plain versions).
``--mesh N`` runs the device stage over a mesh of N ranks (``run_ranks``:
NCCL rank r on ``cuda:r``, at most one rank a card; gloo ranks on the CPU),
and every rank must end on the same tree.  ``--pallas`` takes the pair
kernel where the run has a choice of scorer: the mesh SPR screen, and the
legacy placer under ``MAPLE_DEVICE_LEGACY=1``.

    python3 -m maple_tpu_torch.tools.benchmark_device --samples 20000 \\
        [--spr] [--mesh N] [--pallas] [--cores C] [--production] \\
        [--out result.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..parallel.ranks import backend_error
from .common import (DEFAULT_WORKDIR, RANK_TIMEOUT, device_error,
                     device_kind, ensure_dataset, rf_between)


def device_stage(rank, device, aln, output, flags, pallas, spr, mesh_size):
    """The device placement (and with ``spr`` one device SPR pass) of
    ``aln`` on ``device``; over a mesh of all ranks when ``mesh_size``.
    Rank 0 writes its tree to ``output + "_tree.tree"``."""
    from ..config import MapleConfig
    from ..dryrun import tree_signature
    from ..parallel.mesh import make_mesh
    from ..pipeline import Run
    mesh = make_mesh(mesh_size, device=device) if mesh_size else None
    cfg = MapleConfig(input=aln, output=output if rank == 0
                      else f"{output}_rank{rank}", model="UNREST",
                      overwrite=True, device_placement=True,
                      device_pallas=pallas, **flags)
    rd = Run(cfg, device)
    rd.load()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    rd.build_initial_tree_device(warmup=cfg.device_warmup,
                                 batch_size=cfg.device_batch_size, mesh=mesh)
    sync()
    res = {"device_placement_s": time.time() - t0,
           "placer": "proxy" if rd.proxy_placer is not None
           else "pipelined" if rd.pplacer is not None else "legacy"}
    rd.rt.recalculate_all(rd.root)
    res["device_lk"] = rd.rt.calculate_tree_likelihood(rd.root)
    res["signature"] = tree_signature(rd)
    if rank == 0:
        rd.write_tree("_tree.tree", rd.root)
    if spr:
        from ..parallel.batch_spr import device_topology_update
        from ..runtime.tree import set_all_dirty
        from ..search.spr import SprCounters
        set_all_dirty(rd.tree, rd.root)
        params = (cfg.strictTopologyStopRules, cfg.allowedFailsTopology,
                  rd.dc.thresholdLogLKtopology,
                  cfg.thresholdTopologyPlacement)
        counters = SprCounters()
        t0 = time.time()
        new_root, improvement = device_topology_update(
            rd.rt, rd.root, params, counters=counters, device=device,
            mesh=mesh, use_pallas=pallas)
        sync()
        res["device_spr_s"] = time.time() - t0
        res["device_spr_improvement"] = improvement
        res["device_spr_moves"] = counters.topology_updates
        if new_root is not None:
            rd.root = new_root
        rd.rt.recalculate_all(rd.root)
        lk = rd.rt.calculate_tree_likelihood(rd.root)
        res["device_lk_after_spr"] = lk
        if lk < res["device_lk"] - 1e-6:
            raise AssertionError(f"the SPR pass lowered the LK: "
                                 f"{res['device_lk']} -> {lk}")
        res["signature_after_spr"] = tree_signature(rd)
    return res


def benchmark(samples, *, device: torch.device, workdir=None, seed=1,
              mut_rate=1.5, mesh=0, pallas=False, cores=1, spr=False,
              production=False) -> dict:
    from ..config import MapleConfig
    from ..parallel.ranks import run_ranks
    from ..pipeline import Run
    workdir = workdir or DEFAULT_WORKDIR
    aln, truth = ensure_dataset(workdir, samples, seed, mut_rate, 0.2, 0.05)
    res = {"samples": samples, "device": device_kind(device),
           "mesh": mesh or None, "pallas": pallas, "device_cores": cores,
           "comparator": "production" if production else "serial"}

    # the host path: the 1-core exact serial engine (the reference's
    # strictly serial stepwise addition), or with --production the host's
    # fast preset (--fast --placementBudget 200 --numCores N)
    host_flags = dict(fast=True, placementBudget=200,
                      numCores=cores) if production else {}
    cfg_s = MapleConfig(input=aln, output=os.path.join(workdir, "dev_ser"),
                        model="UNREST", overwrite=True, **host_flags)
    rs = Run(cfg_s, device)
    rs.load()
    t0 = time.time()
    rs.build_initial_tree()
    res["serial_placement_s"] = time.time() - t0
    rs.rt.recalculate_all(rs.root)
    res["serial_lk"] = rs.rt.calculate_tree_likelihood(rs.root)
    res["serial_seq_per_s"] = samples / res["serial_placement_s"]
    rs.write_tree("_tree.tree", rs.root)
    del rs

    # the device path
    dev_out = os.path.join(workdir, "dev_dev")
    stage = (aln, dev_out, dict(numCores=cores, fast=production), pallas,
             spr, mesh)
    if mesh:
        backend = "nccl" if device.type == "cuda" else "gloo"
        ranks = run_ranks(device_stage, mesh, backend=backend,
                          timeout=RANK_TIMEOUT, args=stage)
        for key in ("signature", "signature_after_spr"):
            if len({r.get(key) for r in ranks}) != 1:
                raise AssertionError(f"the {mesh} ranks disagree ({key})")
        dev = ranks[0]
    else:
        dev = device_stage(0, device, *stage)
    dev.pop("signature", None)
    dev.pop("signature_after_spr", None)
    res.update(dev)
    res["device_seq_per_s"] = samples / res["device_placement_s"]
    res["lk_delta_device_minus_serial"] = res["device_lk"] - res["serial_lk"]

    # RF: the device tree against the serial tree, and both against truth
    ser_tree = cfg_s.output + "_tree.tree"
    dev_tree = dev_out + "_tree.tree"
    rf = rf_between(ser_tree, dev_tree, os.path.join(workdir, "dev_rf_ds"))
    res["rf_device_vs_serial"] = int(rf["RF"])
    res["nrf_device_vs_serial"] = float(rf["normalisedRF"])
    for tag, tree in (("serial", ser_tree), ("device", dev_tree)):
        r = rf_between(truth, tree, os.path.join(workdir, f"dev_rf_{tag}"))
        res[f"nrf_{tag}_vs_truth"] = float(r["normalisedRF"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.tools.benchmark_device",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mutRate", type=float, default=1.5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", type=int, default=0,
                    help="ranks of the device stage's mesh (0: one device)")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--cores", type=int, default=1,
                    help="host cores for the device path's engine phases")
    ap.add_argument("--spr", action="store_true",
                    help="also run one device SPR screen pass")
    ap.add_argument("--production", action="store_true",
                    help="compare against the host's production preset "
                    "(--fast --placementBudget 200 --numCores <cores>), "
                    "the device path on the fast-screen contract")
    ap.add_argument("--out", default=None, help="append the result here")
    args = ap.parse_args(argv)
    err = device_error(args.device) or (
        backend_error("nccl" if args.device == "cuda" else "gloo", args.mesh)
        if args.mesh else None)
    if err:
        print(f"benchmark_device: {err}", file=sys.stderr)
        return 2
    res = benchmark(args.samples, device=torch.device(args.device),
                    workdir=args.workdir, seed=args.seed,
                    mut_rate=args.mutRate, mesh=args.mesh,
                    pallas=args.pallas, cores=args.cores, spr=args.spr,
                    production=args.production)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
