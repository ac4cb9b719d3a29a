"""Smoke run of maple_tpu_torch on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: the CUDA kernels from csrc/ with nvcc, and the shared native
     host engine with g++;
  3. the main path: ``python -m maple_tpu_torch --devicePlacement`` on the
     3,000-genome B.1.429 subset (MAPLE_DEVICE_RT=1 selects the pipelined
     branch), in-process; the pair kernel's launch count must be
     positive, the tree and a finite LK must be written, and jax must not
     have been imported;
  4. the pair kernel against its plain PyTorch version on the card, on
     the anchor rows of the main path's own pool (tiled to n_prefix 1024
     and 8192), K=64 real queries with B2=128 entries, error model off and
     on, with CUDA-event times of both;
  5. placement parity: the port's device placement on b3000 against
     maple_tpu's pipelined placer on the same input (REF_B3000_*), and on
     example_sub80 against maple_tpu's serial placement (all samples
     placed, same minor count, LK within 1e-6).
The line before the last is the card's name and power limit, the one
before it the kernel report, and the last line the result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
B3000 = os.path.join(HERE, "tests", "data_b1429_3000.maple.gz")
SUB80 = os.path.join(HERE, "tests", "goldens", "example_sub80.maple")
N_SAMPLES = 3000
K_QUERIES, Q_BUDGET = 64, 128        # --deviceBatchSize, starting B2
PREFIXES = (1024, 8192)
PLACEMENT_LK_TOL = 1e-6              # maple_tpu's own device contract
F64_REL = 1e-9                       # kernel vs plain, both float64
F32_REL = 1e-4                       # float32 kernel vs float64 plain
# maple_tpu's PipelinedPlacer (MAPLE_DEVICE_RT=1, default flags, float32
# screens through its Pallas kernel in interpret mode on the CPU) on b3000:
# placement-stage LK and minor count.  Its serial placement gives
# -103224.17610397039 with 664 minors: batched placement misses the serial
# result at this size in both packages (ROADMAP.md Queue 3), so the port
# is held to its twin here and to the serial contract on example_sub80.
# The minor count follows the tie order of float32 screen scores.
REF_B3000_LK = -103220.79119954497
REF_B3000_MINORS = 606


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_environment(torch):
    from maple_tpu_torch.ops import _build
    print(f"[env] {smi()}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[env] nvcc: {nvcc.splitlines()[-1]}")


def phase_build():
    from maple_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.library()
    print(f"[build] {built.path.name}: nvcc {built.seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")
    # the shared host engine (g++, built once into maple_tpu/native/), so
    # that the main path's wall below holds no one-time build
    from maple_tpu.native import bridge
    t0 = time.perf_counter()
    check(bridge.native_available(),
          f"native host library: {bridge._load_error}")
    print(f"[build] host engine {os.path.basename(bridge._LIB)}: build and "
          f"load {time.perf_counter() - t0:.2f} s")


def median_ms(torch, fn, reps, warmup=2):
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


def phase_main_path(torch):
    """The CLI on b3000.  Returns (launches, the run it made)."""
    from maple_tpu_torch import cli
    from maple_tpu_torch import pipeline as TP
    from maple_tpu_torch.ops import append_pairs as AP
    runs = []
    run_inference = TP.run_inference

    def keep_run(cfg, device):   # the CLI's own call, the run kept
        runs.append(run_inference(cfg, device))
        return runs[-1]

    TP.run_inference = keep_run
    try:
        with tempfile.TemporaryDirectory(prefix="smoke_main_") as tmp:
            out = os.path.join(tmp, "b3000")
            AP.append_scores_prestacked.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["--input", B3000, "--output", out,
                           "--devicePlacement", "--overwrite"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = AP.append_scores_prestacked.launches
            check(rc == 0, f"cli.main returned {rc}")
            check(os.path.getsize(out + "_tree.tree") > 0, "no tree written")
            with open(out + "_LK.txt") as f:
                lk = float(f.read().strip())
    finally:
        TP.run_inference = run_inference
    check(launches > 0, "the main path launched no pair kernel")
    check(np.isfinite(lk), f"LK {lk} is not finite")
    check("jax" not in sys.modules, "jax was imported")
    run = runs[0]
    pp = run.pplacer
    t = run.timings
    print(f"[main] {N_SAMPLES} samples end to end in {wall:.2f} s "
          f"({N_SAMPLES / wall:.2f} seq/s), pair kernel launches "
          f"{launches}, final LK {lk}")
    print(f"[main] fused-step device time {pp.time_device:.3f} s "
          f"({100 * pp.time_device / wall:.2f}% of the run's wall); "
          f"placement finding {t['finding']:.2f} s, placing "
          f"{t['placing']:.2f} s, topology {t['topology']:.2f} s; "
          f"final pool B1={pp.pool.budget} cap={pp.pool.capacity} "
          f"rows={len(pp.pool.row_of)} B2={pp.q_budget}")
    return launches, run


def kernel_inputs(run, seed=7):
    """The live anchor rows of the main path's pool (float32 values, held
    in float64), tiled to the largest prefix, and K real query exports;
    plus a variant with the error model on (seeded site error rates in
    the eps planes, seeded flags on live entries, totError)."""
    from maple_tpu.io.maple_format import read_maple_alignment
    from maple_tpu.ops import pack as OP
    from maple_tpu_torch.ops.layout import (F_END, F_EPS, F_FLAG, F_TYPE,
                                            stack_fields_host)
    rt = run.rt
    pool = run.pplacer.pool
    live = pool.rows_host[:len(pool.row_of)][
        pool.valid_host[:len(pool.row_of)]].astype(np.float64)
    reps = -(-PREFIXES[-1] // len(live))
    rows = np.concatenate([live] * reps)[:PREFIXES[-1]]
    _, data = read_maple_alignment(B3000)
    names = sorted(data)
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(names), K_QUERIES, replace=False)
    queries = [rt.kern.export(rt.kern.terminal_vector(data[names[i]]))
               for i in pick]
    q_budget = Q_BUDGET
    while any(len(q) > q_budget for q in queries):
        q_budget *= 2
    packed = OP.pack_genome_lists(queries, rt.refd.lRef, q_budget, False)
    cstk = stack_fields_host(packed, None, None, axis=-1, dtype=np.float64)
    dc = rt.dc
    prm = np.tile([dc.oneMutBLen, 1.0, dc.globalTotRate, 0.0],
                  (K_QUERIES, 1)).reshape(K_QUERIES, 1, 4)
    mm = np.asarray(rt.model.mut_matrix, dtype=np.float64).reshape(1, 1, 16)
    rf = np.asarray(rt.refd.root_freqs, dtype=np.float64).reshape(1, 1, 4)
    err = rng.random(rt.refd.lRef) * 4e-4
    rows_e, cstk_e = rows.copy(), cstk.copy()
    for fld in (lambda i: rows_e[:, i, :], lambda i: cstk_e[..., i]):
        pos = np.maximum(fld(F_END).astype(np.int64) - 1, 0)
        fld(F_EPS)[...] = err[pos]
        is_live = fld(F_TYPE) < 5
        fld(F_FLAG)[...] = is_live & (rng.random(is_live.shape) < 0.3)
    prm_e = prm.copy()
    prm_e[:, 0, 3] = -err.sum()
    variants = {False: (rows, cstk, prm), True: (rows_e, cstk_e, prm_e)}
    return variants, mm, rf, len(live), pool.budget, q_budget


def phase_kernels(torch, run):
    from maple_tpu_torch.ops import append_pairs as AP
    dev = torch.device("cuda")
    variants, mm, rf, n_live, B1, B2 = kernel_inputs(run)
    print(f"[kernel] inputs: {n_live} live anchor rows of the main path's "
          f"pool tiled to {PREFIXES[-1]}, B1={B1}, K={K_QUERIES}, B2={B2}")
    report = {}
    max_abs32 = 0.0
    for uer in (False, True):
        rows, cstk, prm = variants[uer]
        for n_prefix in PREFIXES:
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=torch.float64, device=dev)
            args64 = [t(rows[:n_prefix]), t(cstk.reshape(K_QUERIES, 1, -1)),
                      t(prm), t(mm), t(rf)]
            args32 = [a.float() for a in args64]
            ref = AP.append_scores_prestacked_plain(*args64, uer=uer)
            k64 = AP.append_scores_prestacked(*args64, uer=uer)
            k32 = AP.append_scores_prestacked(*args32, uer=uer)
            torch.cuda.synchronize()
            ref_c, k64_c, k32_c = (x.double().cpu().numpy()
                                   for x in (ref, k64, k32))
            inf = np.isneginf(ref_c)
            check(np.array_equal(inf, np.isneginf(k64_c)),
                  "float64 kernel -inf placement differs from plain")
            check(np.array_equal(inf, np.isneginf(k32_c)),
                  "float32 kernel -inf placement differs from plain")
            fin = ~inf
            check(np.all(np.isfinite(k32_c[fin])), "non-finite scores")
            scale = np.maximum(1.0, np.abs(ref_c[fin]))
            rel64 = float((np.abs(k64_c[fin] - ref_c[fin]) / scale).max())
            abs32 = np.abs(k32_c[fin] - ref_c[fin])
            rel32 = float((abs32 / scale).max())
            max_abs32 = max(max_abs32, float(abs32.max()))
            check(rel64 <= F64_REL, f"float64 kernel rel err {rel64}")
            check(rel32 <= F32_REL, f"float32 kernel rel err {rel32}")
            ms_k32 = median_ms(torch, lambda: AP.append_scores_prestacked(
                *args32, uer=uer), reps=20)
            ms_k64 = median_ms(torch, lambda: AP.append_scores_prestacked(
                *args64, uer=uer), reps=10)
            ms_p32 = median_ms(torch,
                               lambda: AP.append_scores_prestacked_plain(
                                   *args32, uer=uer), reps=10, warmup=1)
            print(f"[kernel] uer={int(uer)} n_prefix={n_prefix}: "
                  f"f64 rel err {rel64:.3e} (<= {F64_REL}), f32 rel err "
                  f"{rel32:.3e} (<= {F32_REL}), f32 max abs err "
                  f"{abs32.max():.3e}, -inf cells {int(inf.sum())}; "
                  f"kernel f32 {ms_k32:.4f} ms, kernel f64 {ms_k64:.4f} "
                  f"ms, plain f32 {ms_p32:.4f} ms (median, CUDA events)")
            report[(uer, n_prefix)] = (ms_k32, ms_p32)
    ms, plain_ms = report[(False, PREFIXES[-1])]
    return {"max_abs_err": max_abs32, "ms": ms, "plain_ms": plain_ms}


def serial_placement(path, **flags):
    """maple_tpu's serial placement (native engine, jax-free)."""
    from maple_tpu.config import MapleConfig
    from maple_tpu.pipeline import Run
    out = tempfile.mkdtemp(prefix="smoke_serial_")
    run = Run(MapleConfig(input=path, output=os.path.join(out, "ser"),
                          overwrite=True, **flags))
    run.load()
    run.build_initial_tree()
    run.rt.recalculate_all(run.root)
    return run, run.rt.calculate_tree_likelihood(run.root)


def device_placement(torch, path, warmup, batch_size, **flags):
    """The port's pipelined placement on the card."""
    from maple_tpu.config import MapleConfig
    from maple_tpu_torch.pipeline import Run
    out = tempfile.mkdtemp(prefix="smoke_dev_")
    cfg = MapleConfig(input=path, output=os.path.join(out, "dev"),
                      overwrite=True, device_placement=True, **flags)
    run = Run(cfg, torch.device("cuda"))
    run.load()
    t0 = time.perf_counter()
    run.build_initial_tree_device(warmup=warmup, batch_size=batch_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run.rt.recalculate_all(run.root)
    return run, run.rt.calculate_tree_likelihood(run.root), wall


def phase_placement_parity(torch):
    from maple_tpu.config import MapleConfig
    cfg = MapleConfig()
    run, lk, wall = device_placement(torch, B3000, cfg.device_warmup,
                                     cfg.device_batch_size)
    ser, ser_lk = serial_placement(B3000)
    pp = run.pplacer
    placed = placed_count(run)
    print(f"[parity] b3000 device placement {wall:.2f} s "
          f"({N_SAMPLES / wall:.2f} seq/s), fused-step device time "
          f"{pp.time_device:.3f} s ({100 * pp.time_device / wall:.2f}% of "
          f"placement wall), host blocked on screens "
          f"{pp.time_scoring:.3f} s, fine {pp.time_fine:.2f} s, apply "
          f"{pp.time_apply:.2f} s")
    print(f"[parity] b3000 placed {placed}; minors {run.stats.num_minors_found}"
          f" (maple_tpu pipelined {REF_B3000_MINORS}, serial "
          f"{ser.stats.num_minors_found}); LK {lk} (maple_tpu pipelined "
          f"{REF_B3000_LK}, delta {lk - REF_B3000_LK:.3e}; serial {ser_lk}, "
          f"delta {lk - ser_lk:.3e})")
    check(placed == placed_count(ser) == N_SAMPLES,
          "b3000: samples not all placed")
    check(run.stats.num_minors_found == REF_B3000_MINORS,
          "b3000: minor count differs from maple_tpu's pipelined placer")
    check(abs(lk - REF_B3000_LK) <= PLACEMENT_LK_TOL,
          f"b3000: placement LK differs from maple_tpu's pipelined placer "
          f"by {lk - REF_B3000_LK}")
    # the serial contract of tests/test_device_placement.py:149-182
    run, lk, _ = device_placement(torch, SUB80, 16, 16, model="GTR")
    ser, ser_lk = serial_placement(SUB80, model="GTR")
    placed, placed_s = placed_count(run), placed_count(ser)
    print(f"[parity] sub80 placed device {placed} serial {placed_s}; minors "
          f"device {run.stats.num_minors_found} serial "
          f"{ser.stats.num_minors_found}; LK device {lk} serial {ser_lk} "
          f"(delta {lk - ser_lk:.3e}); pair kernel on the card: "
          f"{run.pplacer.pool.dev_pool.device}")
    check(placed == placed_s == 80, "sub80: samples not all placed")
    check(run.stats.num_minors_found == ser.stats.num_minors_found,
          "sub80: minor counts differ")
    check(abs(lk - ser_lk) <= PLACEMENT_LK_TOL,
          f"sub80: placement LK differs from serial by {lk - ser_lk}")


def placed_count(run):
    tree = run.tree

    def reachable(node):
        for _ in range(len(tree.up) + 1):
            if node == run.root:
                return True
            node = tree.up[node]
            if node is None:
                return False
        return False

    live = [n for n in range(len(tree.up)) if reachable(n)]
    return sum(1 for n in live if not tree.children[n]) + \
        sum(len(tree.minorSequences[n]) for n in live)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import maple_tpu_torch  # noqa: F401  (fails outside a checkout)
    os.environ["MAPLE_DEVICE_RT"] = "1"
    phase_environment(torch)
    phase_build()
    launches, run = phase_main_path(torch)
    kern = phase_kernels(torch, run)
    phase_placement_parity(torch)
    print(json.dumps({"kernels": [{
        "name": "append_pairs", "route": "cuda",
        "source": "maple_tpu_torch/csrc/append_pairs.cu",
        "replaces": "maple_tpu/ops/pallas_append.py:349",
        "launches": launches, **kern}]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
