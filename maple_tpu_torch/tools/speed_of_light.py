"""Placement-scorer speed-of-light analysis on one CUDA card.

How close the two batched appendProbNode scorers (the hot function of
placement, reference MAPLEv0.7.5.4.py:6505-6785) run to the bound of the
card they run on: the pair kernel (the merge walk of
``csrc/append_pairs.cu`` through ``ops.append_pairs``, row ``k1-cuda``;
beside it the kernel that visits the whole entry grid,
``csrc/append_pairs_grid.cu``, row ``k1-grid``: the yardstick, on no
path) and the interval-algebra scorer in torch ops (``ops.append_batch``,
row ``k8-torch``), on the same inputs.  The torch twin of the JAX
package's ``scripts/speed_of_light.py``.

    python3 -m maple_tpu_torch.tools.speed_of_light \\
        --configs "2048,64,64,64;8192,64,64,64;8192,128,128,128"

Work model.  A (candidate, query) score is a sum of log factors over the
entry pairs that contribute (overlapping, neither dead, not R/R, not the
same nucleotide); every other pair of the B1 x B2 entry grid adds nothing.
What a call must do is therefore data-dependent:

  contributing pairs   counted on these inputs (count_contributing_pairs)
  operations           contributing pairs * PAIR_FLOPS (about 100 float
                       operations a pair, the figure in csrc/append_pairs.cu)
  executed grid        K * N * B1 * B2_active, the pairs a kernel visits
                       when it walks the whole grid of live query entries
                       to find the contributing ones (``k1-grid`` does;
                       the merge walk takes at most L1 + L2 steps a
                       (query, candidate), L a list's entries)

Data model.  The function is the same for both scorers (packed candidate
and query genome lists, the model and its per-site tables in, scores out),
so both are held to one bound, the function's: each input read once in its
packed types and the output written once:

  function       the nine packed fields of both operands (33 bytes an
                 entry), both per-site tables, the model scalars,
                 scores [K, N] float32
  pair kernel's  what the pair kernel's own operand layout moves, printed
  layout         beside it (``layout_bytes``, ``layout_bound_ms``):
                 candidates [N, 16, B1], queries [K, B2 * 16], the
                 per-query parameters, the 4x4 matrix, the root
                 frequencies, scores [K, N]; all float32, 64 bytes an
                 entry (the per-site rate and error planes, the previous
                 end and an unused plane ride along)

Roofs (one NVIDIA H100 SXM, published): 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s of device memory.  The bound of a call is the
larger of operations over the first and bytes over the second;
``fraction_of_light`` is that bound over the measured time, and
``grid_over_contributing`` says how much of the distance the executed grid
explains.  Times are medians of CUDA events after a warm-up; the card's
name and power limit are printed with the rows, since a card set below its
maximum power runs slower.

Writes one JSON line per scorer and configuration, to standard output and,
with ``--out``, to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(HERE)), "tests",
                       "goldens", "example_sub80.maple")
PAIR_FLOPS = 100.0           # per contributing pair (csrc/append_pairs.cu)
F32_FLOPS = 67e12            # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
PACKED_ENTRY_BYTES = 33      # int8 type and value, int32 end, two float32
                             # lengths, three bool flags, four float32 probs


def build_inputs(n_candidates, n_queries, b1, b2, seed=0, input=EXAMPLE):
    """Packed candidate-upper and query batches with real entry
    statistics: tips of an alignment in the repository, tiled out to the
    requested batch sizes with per-copy branch-length jitter (so that
    repeated rows are not identical tensors; the entry structure, which
    drives the work, stays real).  Returns (refd, model, dc, P, C, mean
    live entries a query)."""
    from ..config import DerivedConfig, MapleConfig
    from ..core import kernels as K
    from ..core.genomelist import shorten, terminal_node_genome_list
    from ..io.maple_format import read_maple_alignment
    from ..ops import pack as OP
    from ..refdata import Model, RefData

    rng = np.random.default_rng(seed)
    ref, data = read_maple_alignment(input)
    refd = RefData.build(ref, model="GTR")
    model = Model.initial(refd, "GTR")
    cfg = MapleConfig()
    dc = DerivedConfig.build(cfg, refd.lRef)
    ctx = K.KernelCtx(refd, model, dc)
    tips = []
    for name in list(data):
        v = terminal_node_genome_list(refd, data[name])
        shorten(v, dc.thresholdProb)
        if len(v) <= min(b1, b2):
            tips.append(v)
    uppers = [K.root_vector_frame(ctx, v, dc.oneMutBLen * (1 + rng.random()),
                                  True) for v in tips]
    uppers = [u for u in uppers if len(u) <= b1]
    if not tips or not uppers:
        raise ValueError(f"no genome list of {input} fits B1={b1}, B2={b2}")
    cands = [uppers[i % len(uppers)] for i in range(n_candidates)]
    queries = [tips[i % len(tips)] for i in range(n_queries)]
    P = OP.pack_genome_lists(cands, refd.lRef, b1, False, np.float32)
    C = OP.pack_genome_lists(queries, refd.lRef, b2, False, np.float32)
    P.bl1 += (rng.random(P.bl1.shape) * P.has_bl1 * 1e-6).astype(np.float32)
    return refd, model, dc, P, C


def work_model(Pstk, Cflat, lRef: int) -> dict:
    """Counts of one call on these stacked inputs (module docstring):
    live query entries, contributing and executed pairs, operations, the
    function's bytes and bound (one for both scorers), and what the pair
    kernel's layout moves."""
    from ..ops import pack as OP
    from ..ops.append_pairs import count_contributing_pairs
    from ..ops.layout import F_TYPE, NFIELDS
    N, _, B1 = Pstk.shape
    K = Cflat.shape[0]
    B2 = Cflat.shape[-1] // NFIELDS
    types = Cflat.reshape(K, B2, NFIELDS)[..., F_TYPE]
    b2_active = float(((types != OP.TYPE_N) & (types != OP.TYPE_PAD))
                      .sum(-1).double().mean())
    pairs = count_contributing_pairs(Pstk, Cflat)
    t_ops = pairs * PAIR_FLOPS / F32_FLOPS

    def bound(nbytes):
        t_bytes = nbytes / HBM_BYTES_PER_S
        return {"bytes": nbytes, "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

    layout = bound(4 * (Pstk.numel() + Cflat.numel() + 4 * K + 16 + 4
                        + K * N))
    return {"b2_active": b2_active, "contributing_pairs": pairs,
            "executed_grid": round(K * N * B1 * b2_active),
            "operations": pairs * PAIR_FLOPS,
            **bound(PACKED_ENTRY_BYTES * (N * B1 + K * B2) + 2 * 4 * lRef
                    + 4 * (16 + 4 + 2) + 4 * K * N),
            "layout_bytes": layout["bytes"],
            "layout_bound_ms": layout["bound_ms"]}


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the current CUDA stream, by events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def run_config(n, k, b1, b2, reps, device: torch.device, use_k8=True,
               use_k1=True, input=EXAMPLE):
    """The rows of one configuration (N candidates, K queries, entry
    budgets B1 and B2) on ``device``, a CUDA card."""
    from ..ops import append_batch as AB
    from ..ops import append_pairs as AP
    if device.type != "cuda":
        raise RuntimeError(f"speed_of_light times on a CUDA card, not on "
                           f"{device}")
    refd, model, dc, P, C = build_inputs(n, k, b1, b2, input=input)
    dm = AB.device_model_from(model, dc, device=device,
                              dtype=torch.float32)
    P_dev = AB.to_device(P, device=device)
    C_dev = AB.to_device(C, device=device)
    blen = dc.oneMutBLen
    Pstk = AP.stack_fields(P_dev, dm.site_rates, dm.error_rates, -2)
    Cflat = AP.stack_fields(C_dev, dm.site_rates, dm.error_rates, -1) \
        .reshape(k, 1, -1)
    prm = torch.tensor([blen, 1.0, float(dm.global_tot_rate),
                        float(dm.tot_error)], dtype=torch.float32,
                       device=device).expand(k, 1, 4).contiguous()
    mm = dm.mut_matrix.reshape(1, 1, 16).contiguous()
    rf = dm.root_freqs.reshape(1, 1, 4).contiguous()
    work = work_model(Pstk, Cflat, refd.lRef)

    scorers = {}
    if use_k1:
        scorers["k1-cuda"] = lambda: AP.append_scores_prestacked(
            Pstk, Cflat, prm, mm, rf, uer=False)
        scorers["k1-grid"] = lambda: AP.append_scores_prestacked_grid(
            Pstk, Cflat, prm, mm, rf, uer=False)
    if use_k8:
        scorers["k8-torch"] = lambda: AB.grid_append_scores(
            P_dev, C_dev, blen, True, dm)
    rows, scores = [], {}
    for name, fn in scorers.items():
        scores[name] = fn()
        torch.cuda.reset_peak_memory_stats(device)
        ms = median_ms(fn, reps)
        rows.append({
            "kernel": name, "K": k, "N": n, "B1": b1, "B2": b2,
            "B2_active": round(work["b2_active"], 1), "ms": ms,
            "scores_per_s": round(k * n / (ms * 1e-3)),
            "contributing_pairs": work["contributing_pairs"],
            "executed_grid": work["executed_grid"],
            "grid_over_contributing": round(
                work["executed_grid"] / max(1, work["contributing_pairs"]),
                1),
            "bytes": work["bytes"], "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"],
            "fraction_of_light": work["bound_ms"] / ms,
            "times_above_bound": round(ms / work["bound_ms"], 1),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
        })
        if name.startswith("k1-"):
            rows[-1].update(layout_bytes=work["layout_bytes"],
                            layout_bound_ms=work["layout_bound_ms"])
        print(json.dumps(rows[-1]), flush=True)
    # the scorers must agree on what they time
    names = list(scores)
    for name in names[1:]:
        a, b = (scores[n].cpu().numpy() for n in (names[0], name))
        fin = np.isfinite(a)
        if not np.array_equal(fin, np.isfinite(b)) or not np.allclose(
                a[fin], b[fin], rtol=2e-4, atol=2e-3):
            raise RuntimeError(f"{names[0]} and {name} disagree on these "
                               f"inputs")
    return rows


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.tools.speed_of_light")
    ap.add_argument("--out", default=None, help="write JSON rows here")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--configs", default="2048,64,64,64;8192,64,64,64;"
                    "8192,128,128,128",
                    help="semicolon list of N,K,B1,B2")
    ap.add_argument("--no-k8", action="store_true",
                    help="skip the interval-algebra scorer")
    ap.add_argument("--no-k1", action="store_true",
                    help="skip the pair kernel")
    ap.add_argument("--input", default=EXAMPLE,
                    help="alignment in MAPLE format to take entries from")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("speed_of_light: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    print(f"# {card()}; torch {torch.__version__}", file=sys.stderr)
    all_rows = []
    for spec in args.configs.split(";"):
        n, k, b1, b2 = (int(x) for x in spec.split(","))
        all_rows += run_config(n, k, b1, b2, args.reps, device,
                               use_k8=not args.no_k8,
                               use_k1=not args.no_k1, input=args.input)
    if args.out:
        with open(args.out, "w") as f:
            for r in all_rows:
                f.write(json.dumps(r) + "\n")
    k1_rows = [r for r in all_rows if r["kernel"] == "k1-cuda"]
    if k1_rows:
        best = max(k1_rows, key=lambda r: r["fraction_of_light"])
        print(f"# best pair kernel: N={best['N']} B1={best['B1']}: "
              f"{best['scores_per_s']:,} scores/s, "
              f"{best['fraction_of_light']:.2%} of light "
              f"({best['bound_by']}-bound), executed grid "
              f"{best['grid_over_contributing']}x the contributing pairs",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
