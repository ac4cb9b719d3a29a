#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card: for
each seed one window of the cell, and for each judged output its numbers
(``names_bad``, ``lk_gap``, ``lk_short``), the float32 control's
``lk_gap`` (the reference in float32 put in the port's place) and, where
the port wrote site error rates, the ``lk_gap`` of the tree scored with
them dropped and with each multiplied by 10
(``session.judge_outputs``).  One process for all seeds: the set-up it
shares is paid once.  The faults planted in the port read from
``tests/test_bench_card.py``.  Not part of a benchmark run.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 1] [--out readings.jsonl]
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness.session import run_cell
    from benchmark.harness.spec import Cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = []
        result, _, _ = run_cell(cell, seed, args.seconds, False, device,
                                time.time(), readings=readings)
        for r in readings:
            rows.append({"cell": cell.name, "seed": seed,
                         "correct": result["correct"], **r})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
