"""SPRTA branch-support calibration: the twin of the repository's
``scripts/benchmark_support.py``.

Simulates an alignment along a known tree, infers with ``--SPRTA`` through
the port, classifies every supported branch of the inferred tree as
present or absent in the truth topology (Day-1985 interval tables) and
reports the fraction correct per support bin, appended as one JSON line
to ``<workdir>/support_calibration.jsonl``.  A calibrated support is
informative: higher bins hold a larger fraction of true branches.

SPRTA runs on the host engine; ``run_calibration(...,
extra_flags={"device_placement": True})`` takes the card's placement path
for the tree.  The device is the card (``--device cuda``, the default; it
exits 2 without one); the CPU must be named (``--device cpu``).

    python3 -m maple_tpu_torch.tools.benchmark_support --samples 2000 \\
        [--seed 1] [--mutRate 1.5] [--supportFor0Branches]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .common import DEFAULT_WORKDIR, device_error, device_kind, ensure_dataset


def run_calibration(aln, truth, out_prefix, extra_flags=None, *,
                    device: torch.device):
    """SPRTA inference on ``aln`` on ``device``, its supports calibrated
    against the ``truth`` newick.  Returns (table rows, supported
    branches)."""
    from ..analysis.rf import prepare_tree_comparison
    from ..analysis.support_calibration import calibration_table
    from ..config import MapleConfig
    from ..io.newick import read_newick
    from ..io.nexus import read_nexus
    from ..pipeline import run_inference

    kwargs = dict(input=aln, output=out_prefix, model="UNREST",
                  overwrite=True, SPRTA=True)
    kwargs.update(extra_flags or {})
    run_inference(MapleConfig(**kwargs), device)

    trees, names_in_tree, names_dict = read_newick(
        truth, create_dict=True, only_terminal_node_name=True)
    truth_tree, truth_root = trees[0]
    prep = prepare_tree_comparison(truth_tree, truth_root, names_in_tree,
                                   names_dict, rooted=False)
    leaf_name_dict, node_table, leaf_count = prep[:3]
    # the nexus-read inferred tree keeps leaf names as strings
    leaf_name_dict_str = {names_in_tree[k]: v
                          for k, v in leaf_name_dict.items()}

    inf_tree, inf_root = read_nexus(out_prefix + "_nexusTree.tree")
    inf_tree.support = [
        fd.get("support") if isinstance(fd, dict) else None
        for fd in inf_tree.featureDicts]
    rows = calibration_table(
        inf_tree, inf_root, (leaf_name_dict_str, node_table, leaf_count))
    return rows, sum(r[2] for r in rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.tools.benchmark_support",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--mutRate", type=float, default=1.5)
    ap.add_argument("--nRate", type=float, default=0.2)
    ap.add_argument("--ambRate", type=float, default=0.05)
    ap.add_argument("--supportFor0Branches", action="store_true",
                    help="also compute supports for zero-length "
                         "branches (populates the low-support bins "
                         "with genuinely ambiguous placements)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    err = device_error(args.device)
    if err:
        print(f"benchmark_support: {err}", file=sys.stderr)
        return 2
    device = torch.device(args.device)

    aln, truth = ensure_dataset(args.workdir, args.samples, args.seed,
                                args.mutRate, args.nRate, args.ambRate)
    tag = f"n{args.samples}_s{args.seed}_m{args.mutRate}"
    extra = {"supportFor0Branches": True} \
        if args.supportFor0Branches else None
    rows, n_supported = run_calibration(
        aln, truth, os.path.join(args.workdir, f"sup_run_{tag}"), extra,
        device=device)

    print(f"\n{'support bin':>16} {'branches':>9} {'frac correct':>13} "
          f"{'mean support':>13}")
    payload = []
    for lo, hi, n, frac, mean_s in rows:
        frac_s = f"{frac:.3f}" if frac == frac else "-"
        mean_s_str = f"{mean_s:.3f}" if mean_s == mean_s else "-"
        print(f"  [{lo:.2f}, {hi:.2f}) {n:>9} {frac_s:>13} "
              f"{mean_s_str:>13}")
        payload.append({"lo": lo, "hi": hi, "n": n,
                        "frac_correct": None if frac != frac else frac,
                        "mean_support": None if mean_s != mean_s
                        else mean_s})
    result = {"samples": args.samples, "seed": args.seed,
              "support_for_0branches": bool(args.supportFor0Branches),
              "mut_rate": args.mutRate, "n_rate": args.nRate,
              "amb_rate": args.ambRate, "n_supported": n_supported,
              "bins": payload, "device": device_kind(device),
              "ts": time.time()}
    out_path = os.path.join(args.workdir, "support_calibration.jsonl")
    with open(out_path, "a") as f:
        f.write(json.dumps(result) + "\n")
    print(json.dumps(result))
    print(f"\nresults appended to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
