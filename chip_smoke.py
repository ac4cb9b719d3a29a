"""Smoke run of maple_tpu_torch on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: the CUDA kernels from csrc/ with nvcc and the package's own
     native host engine with g++, both into maple_tpu_torch/_build/;
  3. the pipelined path: ``python -m maple_tpu_torch --devicePlacement`` on
     the 3,000-genome B.1.429 subset with MAPLE_DEVICE_RT=1, in-process;
     the pair kernel's launch count must be positive, the tree and a finite
     LK must be written, and neither jax nor maple_tpu may be loaded;
  4. the pair kernel against its plain PyTorch version on the card, on
     the anchor rows of phase 3's own pool (tiled to n_prefix 1024 and
     8192), K=64 real queries with B2=128 entries, error model off and
     on, with CUDA-event times of both and the kernel's bound;
  5. placement parity: the pipelined placement on b3000 against
     maple_tpu's pipelined placer on the same input (REF_B3000_*), and on
     example_sub80 against serial placement (all samples placed, same
     minor count, LK within 1e-6);
  6. the SPR path: ``--devicePlacement --deviceTopology`` on b3000 with
     MAPLE_DEVICE_RT=1 and MAPLE_SPR_EXACT=1 (the pair kernel in placement
     and in the SPR rounds; SPR launches, counted apart, must be positive),
     then ``--deviceTopology`` alone (host placement, the proxy screen);
     the stage walls, the SPR device time and each pass's counts are
     printed;
  7. SPR pass parity: one pass of each screen on the serial placement of
     b3000 against maple_tpu's own pass (REF_SPR): the same query and
     anchor counts and proposals, post-pass LK within 1e-6; a proposal of
     the exhaustive screen may differ only inside its float32 margin, one
     of the proxy screen only where re-scoring every anchor then agrees;
  8. the screen chunk (pair kernel, masks, top-1) against its plain
     version on the card, on phase 7's first full chunk: the same -inf
     rows, top-1 scores within 1e-9 (f64) and 1e-4 (f32), CUDA-event
     times of both;
  9. the main path: ``--devicePlacement`` on b3000 with default flags and
     no branch variable set, the whole pipeline: the proxy branch must have
     run (steps > 0, native kernels), all 3,000 placed, a finite LK;
 10. proxy parity: the placement stage alone on b3000 (UNREST) with the
     default float32 pool and with MAPLE_PROXY_BF16=1: LK within 1e-6 of
     serial engine placement and the same minor count; one mid-run
     ``proxy_step`` against a float64 version of the same arrays on the
     card (top-M score multisets within 1e-4 relative, the float32
     tolerance); the product alone, timed beside its bound;
 11. the proxy branch at 20,000 samples (scripts/make_synthetic_alignment.py
     --samples 20000 --seed 1, run as a subprocess), placement stage, default
     width: a 65,536 x 8,192 float32 pool on the card; all placed, LK
     finite, the LK difference to serial engine placement reported;
 12. the legacy branch: MAPLE_DEVICE_LEGACY=1 ``--devicePlacement
     --devicePallas``: on example_sub80 the placement stage within 1e-6 of
     serial with the same placed and minor counts; on b3000 the whole
     pipeline through the command line, its pair-kernel launches counted
     as the ``legacy`` path; its last launch's inputs through the kernel
     and its plain version, with times and bound.
The line before the last is the card's name and power limit, the one
before it the kernel report, and the last line the result.  In the
kernel report, ``launches_by_path`` holds the pair kernel's launches on
each path (placement and SPR of phase 6's exhaustive run, the legacy run
of phase 12), each counted from 0 within its own run; ``launches`` is
their sum; ``launches_by_run`` holds each CLI run's own count.
``bound_ms`` is the larger of the call's bytes (each input once, the
output once) over 3.35 TB/s and its operations (the entry pairs of these
inputs that contribute, at about 100 float operations each, the figure in
csrc/append_pairs.cu) over 67 TFLOP/s, the float32 peak outside the tensor
cores.  No single PyTorch call computes the pair kernel's function, so
``library_ms`` is null.

    python3 chip_smoke.py --profile-spr

runs phases 1 and 2, then torch.profiler around one SPR pass of each
screen on phase 7's b3000 tree (after a warm-up pass of each): the device's
busy share of the pass and its heaviest kernels.  It prints no result line.
"""
from __future__ import annotations

import contextlib
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
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, published
F32_FLOPS = 67e12                    # float32 outside the tensor cores
PAIR_FLOPS = 100                     # per contributing entry pair
                                     # (csrc/append_pairs.cu)
BRANCH_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
              "MAPLE_PROXY_D", "MAPLE_SPR_EXACT")
SYN_SAMPLES, SYN_SEED = 20000, 1
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
SPR_LK_TOL = 1e-6                    # post-pass LK, as the placement gate
SPR_MARGIN_REL = 1e-4                # float32 margin of a differing proposal
# maple_tpu's device_topology_update, one pass on b3000: maple_tpu's serial
# placement (the REF_B3000 note above), set_all_dirty, recalculate_all,
# then the first SPR round's params (True, 2, 61.834284532762645, -0.1),
# with JAX_PLATFORMS=cpu.  "exact": MAPLE_SPR_EXACT=1, the float32 screen
# through the Pallas kernel in interpret mode.  "proxy": the default,
# the product on XLA CPU; the same proposals come with topm 2**20 (every
# anchor re-scored).  "nodes": the proposals as handed to apply_spr_moves
# (ascending screened improvement, applied from the end), with their
# "improvements"; "improvement": what the pass returned; "lk": the LK
# after recalculate_all from the pass's root.
REF_SPR = {
    "exact": {
        "queries": 3426, "anchors": 2602,
        "nodes": [
            1397, 3104, 2665, 3951, 3290, 2407, 938, 2644, 1427,
            4581, 3789, 1231, 3266, 3086, 3579, 3880, 2194, 751,
            3078, 4447, 2671, 1291, 2202, 3470, 2573, 4607, 1370,
            4231, 3812, 4623, 1951, 1583, 2232, 4349, 2984, 1437,
            472, 147, 4052, 143, 50],
        "improvements": [
            0.1011066851, 0.1047512486, 0.1428261495,
            0.1472514229, 0.162489094, 0.2062892153, 0.2179765629,
            0.4041884042, 0.4142149923, 0.6502662523,
            0.6528279038, 0.6606668178, 0.9143880454,
            0.9155504748, 1.077434147, 1.098550491, 1.183884626,
            1.494637187, 1.617252231, 1.742621105, 2.003163929,
            2.512088766, 2.570305098, 3.939141371, 4.378513176,
            4.557200676, 5.118378763, 6.132966849, 6.133320576,
            6.848351909, 7.348953421, 7.348953613, 7.416452936,
            7.912881991, 7.912939227, 8.914342789, 9.30509788,
            9.382757694, 9.972120968, 10.2285535, 10.39160891],
        "improvement": 34.161791417722085, "lk": -103190.00153130965},
    "proxy": {
        "queries": 3426, "anchors": 2602,
        "nodes": [
            1397, 3104, 2665, 3951, 3290, 2407, 938, 2644, 1427,
            4581, 3789, 1231, 3266, 3086, 3579, 3880, 2194, 751,
            3078, 4447, 2671, 1291, 2202, 3470, 2573, 4607, 1370,
            4231, 3812, 4623, 1583, 1951, 2232, 4349, 2984, 1437,
            472, 147, 4052, 143, 50],
        "improvements": [
            0.1011067225, 0.1047515596, 0.1428276422,
            0.1472521243, 0.1624891849, 0.2062881982,
            0.2179765176, 0.4041884237, 0.4142155426,
            0.6502665972, 0.6528272432, 0.6606657143,
            0.9143870233, 0.9155500186, 1.077430903, 1.098549415,
            1.183886289, 1.494637241, 1.617252395, 1.742620607,
            2.003162651, 2.512086272, 2.570304527, 3.939137932,
            4.37851795, 4.557200824, 5.118377676, 6.132967652,
            6.133320487, 6.848354564, 7.34895352, 7.34895352,
            7.416452866, 7.912881998, 7.91293962, 8.91434295,
            9.305097928, 9.38275767, 9.972120907, 10.22855358,
            10.39160893],
        "improvement": 34.161791417722085, "lk": -103190.00153130965},
}


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
    # the package's own host engine (g++, into the same _build/), so that
    # the walls below hold no one-time build; a failed build fails here
    # and never turns a run onto the python kernels
    from maple_tpu_torch.native import bridge
    t0 = time.perf_counter()
    check(bridge.native_available(),
          f"native host library: {bridge._load_error}")
    check(os.path.dirname(os.path.abspath(bridge._LIB)) == str(
        _build.BUILD_DIR), "the host engine was not built into _build/")
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


@contextlib.contextmanager
def branch_env(**env):
    """The variables that select a branch: all unset, then ``env``."""
    saved = {k: os.environ.pop(k, None) for k in BRANCH_ENV}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in BRANCH_ENV:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


def no_foreign_modules():
    loaded = [m for m in sys.modules if m in ("jax", "maple_tpu")
              or m.startswith(("jax.", "maple_tpu."))]
    check(not loaded, f"loaded: {loaded}")


def pair_bound(AP, Pstk, Cflat, prm, mm, rf):
    """The least time the card could take for one pair-kernel call on
    these inputs (module docstring): {"bound_ms", "bound_by"}, and the
    count of contributing entry pairs."""
    K, N = Cflat.shape[0], Pstk.shape[0]
    pairs = AP.count_contributing_pairs(Pstk, Cflat)
    nbytes = Pstk.element_size() * (Pstk.numel() + Cflat.numel()
                                    + prm.numel() + mm.numel() + rf.numel()
                                    + K * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * PAIR_FLOPS / F32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}, pairs


def run_cli(torch, argv, **env):
    """``cli.main(argv)`` on b3000, in-process, under ``branch_env(**env)``,
    with the pair kernel's launch count set to 0 just before and read just
    after.  Returns (wall, launches, final LK, the run it made)."""
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
        with branch_env(**env), \
                tempfile.TemporaryDirectory(prefix="smoke_main_") as tmp:
            out = os.path.join(tmp, "b3000")
            AP.append_scores_prestacked.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(["--input", B3000, "--output", out, *argv,
                           "--overwrite"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = AP.append_scores_prestacked.launches
            check(rc == 0, f"cli.main returned {rc}")
            check(os.path.getsize(out + "_tree.tree") > 0, "no tree written")
            with open(out + "_LK.txt") as f:
                lk = float(f.read().strip())
    finally:
        TP.run_inference = run_inference
    check(np.isfinite(lk), f"LK {lk} is not finite")
    no_foreign_modules()
    check(runs[0].rt.kern.name == "native", "the run left the native kernels")
    return wall, launches, lk, runs[0]


def phase_pipelined_path(torch):
    """The CLI on b3000, pipelined branch.  Returns (launches, the run it
    made)."""
    wall, launches, lk, run = run_cli(torch, ["--devicePlacement"],
                                      MAPLE_DEVICE_RT="1")
    check(launches > 0, "the pipelined path launched no pair kernel")
    check(run.pplacer is not None and run.proxy_placer is None,
          "MAPLE_DEVICE_RT=1 did not take the pipelined branch")
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
    from maple_tpu_torch.io.maple_format import read_maple_alignment
    from maple_tpu_torch.ops import pack as OP
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
            bound, pairs = pair_bound(AP, *args32)
            print(f"[kernel] uer={int(uer)} n_prefix={n_prefix}: "
                  f"{pairs} contributing pairs of "
                  f"{K_QUERIES * n_prefix * B1 * B2} in the grid; bound "
                  f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}")
            report[(uer, n_prefix)] = {"ms": ms_k32, "plain_ms": ms_p32,
                                       **bound}
    return {"max_abs_err": max_abs32, **report[(False, PREFIXES[-1])],
            "library_ms": None,
            "n_prefix_1024": report[(False, PREFIXES[0])]}


def serial_placement(torch, path, **flags):
    """The port's serial placement (the native engine on the host)."""
    from maple_tpu_torch.config import MapleConfig
    from maple_tpu_torch.pipeline import Run
    out = tempfile.mkdtemp(prefix="smoke_serial_")
    run = Run(MapleConfig(input=path, output=os.path.join(out, "ser"),
                          overwrite=True, **flags), torch.device("cuda"))
    run.load()
    t0 = time.perf_counter()
    run.build_initial_tree()
    run.serial_wall = time.perf_counter() - t0
    check(run.rt.kern.name == "native", "serial run left the native kernels")
    run.rt.recalculate_all(run.root)
    return run, run.rt.calculate_tree_likelihood(run.root)


def device_placement(torch, path, warmup=None, batch_size=None, env=None,
                     **flags):
    """The port's device placement stage on the card, on the branch that
    ``env`` selects (none: the proxy branch)."""
    from maple_tpu_torch.config import MapleConfig
    from maple_tpu_torch.pipeline import Run
    out = tempfile.mkdtemp(prefix="smoke_dev_")
    cfg = MapleConfig(input=path, output=os.path.join(out, "dev"),
                      overwrite=True, device_placement=True, **flags)
    run = Run(cfg, torch.device("cuda"))
    run.load()
    with branch_env(**(env or {})):
        t0 = time.perf_counter()
        run.build_initial_tree_device(
            warmup=cfg.device_warmup if warmup is None else warmup,
            batch_size=cfg.device_batch_size if batch_size is None
            else batch_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(run.rt.kern.name == "native", "device run left the native kernels")
    run.rt.recalculate_all(run.root)
    return run, run.rt.calculate_tree_likelihood(run.root), wall


def phase_placement_parity(torch):
    rt_env = {"MAPLE_DEVICE_RT": "1"}
    run, lk, wall = device_placement(torch, B3000, env=rt_env)
    ser, ser_lk = serial_placement(torch, B3000)
    pp = run.pplacer
    placed = placed_count(run)
    b3000 = {"pipelined_lk": lk, "pipelined_minors":
             run.stats.num_minors_found, "serial_lk": ser_lk,
             "serial_minors": ser.stats.num_minors_found}
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
    run, lk, _ = device_placement(torch, SUB80, 16, 16, env=rt_env,
                                  model="GTR")
    ser, ser_lk = serial_placement(torch, SUB80, model="GTR")
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
    return b3000


def first_round_params(run):
    """The first SPR round's parameters (the fast initial search,
    maple_tpu/pipeline.py:1144-1148)."""
    cfg = run.cfg
    return (cfg.strictTopologyStopRulesInitial,
            cfg.allowedFailsTopologyInitial,
            run.dc.thresholdLogLKtopologyInitial,
            cfg.thresholdTopologyPlacementInitial)


def phase_spr_main_path(torch):
    """The CLI on b3000 with --deviceTopology: the exhaustive screen after
    device placement (the pair kernel in both stages), then the default
    proxy screen after host placement.  Returns the pair kernel's launches
    in each run (keyed by the run's flags), and the exhaustive run's split
    by path; every count is of one run, reset just before it."""
    from maple_tpu_torch.parallel import batch_spr as BS
    runs, by_path = {}, {}
    for name, argv, exact in (
            ("exact", ["--devicePlacement", "--deviceTopology"], True),
            ("proxy", ["--deviceTopology"], False)):
        env = {"MAPLE_DEVICE_RT": "1"}
        if exact:
            env["MAPLE_SPR_EXACT"] = "1"
        BS.stats.reset()
        wall, n, lk, run = run_cli(torch, argv, **env)
        passes = list(BS.stats.passes)
        spr = sum(p.kernel_launches for p in passes)
        check(passes, f"{name}: no device SPR screen ran")
        check(all(p.branch == name for p in passes),
              f"{name}: a pass took another screen")
        if exact:
            check(spr > 0, "the SPR rounds launched no pair kernel")
            check(n - spr > 0, "device placement launched no pair kernel")
            by_path = {"placement": n - spr, "spr_exact": spr}
        else:
            check(n == 0, f"the proxy run launched the pair kernel {n} times")
        runs[run_label(argv, exact)] = n
        t = run.timings
        dev_s = sum(p.device_s for p in passes)
        print(f"[spr-main] {name} screen ({' '.join(argv)}): {wall:.2f} s "
              f"end to end, final LK {lk}; pair kernel launches: "
              f"{n - spr} in placement, {spr} in SPR")
        print(f"[spr-main] {name}: placement finding {t['finding']:.2f} s, "
              f"placing {t['placing']:.2f} s, topology {t['topology']:.2f} "
              f"s; SPR device time {dev_s:.4f} s "
              f"({100 * dev_s / t['topology']:.2f}% of the topology wall) "
              f"over {len(passes)} passes")
        for i, p in enumerate(passes):
            print(f"[spr-main] {name} pass {i + 1}: {p.queries} queries x "
                  f"{p.anchors} anchors, {p.chunks} chunks, "
                  f"{p.kernel_launches} kernel launches, {p.proposals} "
                  f"proposals; host collect {p.collect_s:.3f} s, "
                  f"pack+queue {p.pack_s:.3f} s, decide {p.decide_s:.3f} s, "
                  f"apply {p.apply_s:.3f} s; device {p.device_s:.4f} s")
    return runs, by_path


def run_label(argv, exact=False, **env):
    if exact:
        env = {"MAPLE_DEVICE_RT": "1", "MAPLE_SPR_EXACT": "1"}
    return " ".join([*argv, *(f"{k}={v}" for k, v in sorted(env.items()))])


def spr_pass(torch, dev, path, exact, topm=None, capture=None,
             trace=contextlib.nullcontext):
    """One SPR pass of the port on the serial placement of ``path``
    (set_all_dirty, recalculate_all, the first round's params).
    With ``capture`` (a list), the exhaustive screen's first full chunk
    is kept there.  ``trace()`` is entered around the pass alone.
    Returns (ScreenPass, the proposals handed to apply_spr_moves, pass
    improvement, post-pass LK, wall, params)."""
    from maple_tpu_torch.parallel import batch_spr as BS
    from maple_tpu_torch.runtime.tree import set_all_dirty
    from maple_tpu_torch.search.spr import SprCounters
    run, _ = serial_placement(torch, path)
    set_all_dirty(run.tree, run.root)
    run.rt.recalculate_all(run.root)
    params = first_round_params(run)
    seen = []
    apply, chunk = BS.apply_spr_moves, BS.screen_chunk

    def record(rt, proposals, params, counters):
        seen.append(list(proposals))
        return apply(rt, proposals, params, counters)

    def keep_chunk(*args, **kw):
        if capture is not None and not capture \
                and args[3].shape[0] == BS.EXACT_CHUNK:
            capture.append((tuple(a.clone() for a in args), dict(kw)))
        return chunk(*args, **kw)

    BS.apply_spr_moves, BS.screen_chunk = record, keep_chunk
    BS.stats.reset()
    try:
        with branch_env(**({"MAPLE_SPR_EXACT": "1"} if exact else {})), \
                trace():
            t0 = time.perf_counter()
            if topm is None:
                new_root, imp = BS.device_topology_update(
                    run.rt, run.root, params, device=dev)
            else:
                new_root, imp = BS._screen_single_device(
                    run.rt, run.root, params, SprCounters(), time.time(),
                    device=dev, topm=topm)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        BS.apply_spr_moves, BS.screen_chunk = apply, chunk
    root = run.root if new_root is None else new_root
    run.rt.recalculate_all(root)
    lk = run.rt.calculate_tree_likelihood(root)
    (st,) = BS.stats.passes
    return st, (seen[0] if seen else []), imp, lk, wall, params


def spr_differences(name, st, props, ref, thresh):
    """The proposals that differ from maple_tpu's (membership, then apply
    order), printed node by node with their float32 margin.  Returns a
    list of (node, inside the margin)."""
    best = dict(zip(st.q_nodes.tolist(), zip(st.q_best, st.q_base)))
    mine = {p[0]: p[2] for p in props}
    theirs = dict(zip(ref["nodes"], ref["improvements"]))
    out = []
    for node in sorted(set(mine) ^ set(theirs)):
        b, base = (float(x) for x in best[node])
        margin = min(abs(b + thresh - base), abs(b - base))
        ok = bool(margin < SPR_MARGIN_REL * abs(b))
        print(f"[spr] {name}: node {node} proposed by "
              f"{'the port' if node in mine else 'maple_tpu'} only: "
              f"screened best {b!r}, current {base!r}, float32 margin "
              f"{margin:.3e} ({'inside' if ok else 'OUTSIDE'} "
              f"{SPR_MARGIN_REL}*|score|)")
        out.append((node, ok))
    common = [n for n in (p[0] for p in props) if n in theirs]
    ref_pos = {n: i for i, n in enumerate(ref["nodes"])}
    for i, a in enumerate(common):
        for b in common[i + 1:]:
            if ref_pos[a] > ref_pos[b]:   # applied in the other order
                gap = abs(mine[a] - mine[b])
                ok = bool(gap < SPR_MARGIN_REL * abs(best[a][0]))
                print(f"[spr] {name}: nodes {a} and {b} swap apply order: "
                      f"improvements {mine[a]!r} and {mine[b]!r}, gap "
                      f"{gap:.3e} ({'inside' if ok else 'OUTSIDE'} "
                      f"{SPR_MARGIN_REL}*|score|)")
                out.append((a, ok))
    return out


def report_spr_pass(name, st, props, imp, lk, wall, ref):
    print(f"[spr] {name}: {st.queries} queries x {st.anchors} anchors "
          f"(maple_tpu {ref['queries']} x {ref['anchors']}), {st.chunks} "
          f"chunks, {len(props)} proposals (maple_tpu "
          f"{len(ref['nodes'])}), pass improvement {imp!r} (maple_tpu "
          f"{ref['improvement']!r}), post-pass LK {lk!r} (maple_tpu "
          f"{ref['lk']!r}, delta {lk - ref['lk']:.3e}); pass wall "
          f"{wall:.2f} s, device {st.device_s:.4f} s")
    check(st.queries == ref["queries"] and st.anchors == ref["anchors"],
          f"{name}: screen size differs from maple_tpu's")


def phase_spr_parity(torch):
    """Both screens on b3000 against maple_tpu (REF_SPR).  Returns the
    exhaustive screen's first full chunk for phase 8."""
    dev = torch.device("cuda")
    captured = []
    ref = REF_SPR["exact"]
    st, props, imp, lk, wall, params = spr_pass(torch, dev, B3000, True,
                                                capture=captured)
    report_spr_pass("exact", st, props, imp, lk, wall, ref)
    diffs = spr_differences("exact", st, props, ref, params[3])
    check(all(ok for _, ok in diffs),
          "exact: a proposal differs from maple_tpu's outside the float32 "
          "margin")
    if not diffs:
        check(abs(lk - ref["lk"]) <= SPR_LK_TOL,
              f"exact: post-pass LK differs by {lk - ref['lk']}")
    check(captured, "exact: no full screen chunk was captured")

    ref = REF_SPR["proxy"]
    st, props, imp, lk, wall, params = spr_pass(torch, dev, B3000, False)
    report_spr_pass("proxy", st, props, imp, lk, wall, ref)
    if spr_differences("proxy", st, props, ref, params[3]):
        # a top-M tie: every anchor re-scored exactly, the two must agree
        st, props, imp, lk, wall, params = spr_pass(
            torch, dev, B3000, False, topm=st.anchors)
        report_spr_pass("proxy topm=all", st, props, imp, lk, wall, ref)
        check(not spr_differences("proxy topm=all", st, props, ref,
                                  params[3]),
              "proxy: proposals differ from maple_tpu's with every anchor "
              "re-scored")
    check(abs(lk - ref["lk"]) <= SPR_LK_TOL,
          f"proxy: post-pass LK differs by {lk - ref['lk']}")
    return captured[0]


def phase_screen_chunk(torch, captured):
    """The screen chunk through the kernel (f32, f64) against its plain
    version on the card, on phase 7's first full chunk."""
    from maple_tpu_torch.ops import append_pairs as AP
    from maple_tpu_torch.parallel import batch_spr as BS
    (pool, valid, a_tin, Cflat, prm, q_lo, q_hi, excl, mm, rf), kw = captured
    n_prefix, uer = kw["n_prefix"], kw["uer"]

    def plain(pool, Cflat, prm, mm, rf):
        scores = AP.append_scores_prestacked_plain(
            pool[:n_prefix], Cflat, prm, mm, rf, uer=uer)
        BS._mask_trivial_targets(scores, valid[:n_prefix],
                                 a_tin[:n_prefix], q_lo, q_hi, excl)
        return torch.topk(scores, 1, dim=1)

    def kernel(pool, Cflat, prm, mm, rf):
        return BS.screen_chunk(pool, valid, a_tin, Cflat, prm, q_lo, q_hi,
                               excl, mm, rf, n_prefix=n_prefix, uer=uer)

    f32 = (pool, Cflat, prm, mm, rf)
    f64 = tuple(x.double() for x in f32)
    ref, k64, k32 = (fn(*a)[0].double().cpu().numpy()[:, 0] for fn, a in
                     ((plain, f64), (kernel, f64), (kernel, f32)))
    inf = np.isneginf(ref)
    check(np.array_equal(inf, np.isneginf(k64)),
          "screen chunk: float64 kernel -inf rows differ from plain")
    check(np.array_equal(inf, np.isneginf(k32)),
          "screen chunk: float32 kernel -inf rows differ from plain")
    fin = ~inf
    scale = np.maximum(1.0, np.abs(ref[fin]))
    rel64 = float((np.abs(k64[fin] - ref[fin]) / scale).max())
    abs32 = np.abs(k32[fin] - ref[fin])
    rel32 = float((abs32 / scale).max())
    check(rel64 <= F64_REL, f"screen chunk: float64 rel err {rel64}")
    check(rel32 <= F32_REL, f"screen chunk: float32 rel err {rel32}")
    ms = median_ms(torch, lambda: kernel(*f32), reps=20)
    plain_ms = median_ms(torch, lambda: plain(*f32), reps=5, warmup=1)
    bound, _ = pair_bound(AP, pool[:n_prefix].contiguous(), Cflat, prm, mm,
                          rf)
    print(f"[chunk] K={Cflat.shape[0]} queries, n_prefix {n_prefix}, "
          f"B1={pool.shape[-1]}, B2={Cflat.shape[-1] // 16}, uer={int(uer)}: "
          f"top-1 f64 rel err {rel64:.3e} (<= {F64_REL}), f32 rel err "
          f"{rel32:.3e} (<= {F32_REL}), f32 max abs err {abs32.max():.3e}, "
          f"-inf rows {int(inf.sum())}; screen_chunk kernel f32 {ms:.4f} "
          f"ms, plain f32 {plain_ms:.4f} ms (median, CUDA events)")
    return {"max_abs_err": float(abs32.max()), "ms": ms,
            "plain_ms": plain_ms, **bound, "library_ms": None}


def same_inf_and_close(ref, got, rel, what):
    """-inf in the same places and finite values within ``rel`` relative
    (floor 1); returns the largest absolute difference."""
    inf = np.isneginf(ref)
    check(np.array_equal(inf, np.isneginf(got)),
          f"{what}: -inf placement differs")
    fin = ~inf
    check(np.all(np.isfinite(got[fin])), f"{what}: non-finite scores")
    diff = np.abs(got[fin] - ref[fin])
    err = float((diff / np.maximum(1.0, np.abs(ref[fin]))).max())
    check(err <= rel, f"{what}: rel err {err} > {rel}")
    return float(diff.max())


def phase_proxy_main_path(torch):
    """Phase 9: the CLI on b3000 with default flags takes the proxy
    branch."""
    wall, launches, lk, run = run_cli(torch, ["--devicePlacement"])
    pl = run.proxy_placer
    check(pl is not None and run.pplacer is None
          and run.legacy_placer is None,
          "default flags did not take the proxy branch")
    check(pl.steps > 0, "the proxy branch queued no step")
    check(launches == 0, "the proxy run launched the pair kernel")
    check(placed_count(run) == N_SAMPLES, "b3000: samples not all placed")
    place_wall = run.timings["finding"] + run.timings["placing"]
    print(f"[proxy-main] {N_SAMPLES} samples end to end in {wall:.2f} s "
          f"({N_SAMPLES / wall:.2f} seq/s), final LK {lk}; kernels "
          f"{run.rt.kern.name}")
    report_proxy("proxy-main", pl, place_wall, N_SAMPLES)
    return pl


def report_proxy(tag, pl, place_wall, n):
    pool = pl.pool
    print(f"[{tag}] placement stage {place_wall:.2f} s "
          f"({n / place_wall:.2f} seq/s incl. the serial warmup); "
          f"{pl.steps} proxy steps, pool {tuple(pool.AF.shape)} "
          f"{str(pool.AF.dtype).split('.')[1]} on {pool.AF.device}, "
          f"{len(pool.row_of)} rows assigned, topm {pl.topm}; device in "
          f"steps {pl.time_device:.4f} s "
          f"({100 * pl.time_device / place_wall:.2f}% of the stage), "
          f"{1e3 * pl.time_device / pl.steps:.3f} ms a step")
    print(f"[{tag}] host: time_screen {pl.time_screen:.3f} s, time_place "
          f"{pl.time_place:.3f} s, time_export {pl.time_export:.3f} s "
          f"(+ queries {pl.time_query_export:.3f} s), waits: fetch "
          f"{pl.time_wait:.3f} s, prep {pl.time_prep_wait:.3f} s, sync join "
          f"{pl.time_sync_join:.3f} s")


def time_product(torch, K, D, cap):
    """The screen's product alone at [K, D] x [D, cap] float32, full
    precision: median ms by CUDA events, beside its bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    QF = torch.rand((K, D), generator=g, device=dev)
    AF = torch.rand((cap, D), generator=g, device=dev)
    ms = median_ms(torch, lambda: QF @ AF.T, reps=10)
    t_ops = 2 * K * D * cap / F32_FLOPS
    t_bytes = 4 * (K * D + cap * D + K * cap) / HBM_BYTES_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[product] [{K}, {D}] x [{D}, {cap}] float32 "
          f"(matmul precision {torch.get_float32_matmul_precision()}): "
          f"{ms:.4f} ms (median of 10, CUDA events), "
          f"{2 * K * D * cap / ms / 1e9:.2f} TFLOP/s; bound "
          f"{1e3 * max(t_ops, t_bytes):.4f} ms by {by} "
          f"({F32_FLOPS / 1e12:.0f} TFLOP/s float32, "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    return ms


def phase_proxy_parity(torch):
    """Phase 10."""
    from maple_tpu_torch.parallel import proxy_placer as TP
    ser, ser_lk = serial_placement(torch, B3000, model="UNREST")
    check(placed_count(ser) == N_SAMPLES, "b3000 serial: not all placed")
    step, kept = TP.proxy_step, []

    def keep_step(AF, valid, *arrays, topm):
        keep = len(kept) == 0 and AF.dtype == torch.float32 \
            and keep_step.calls == 5
        keep_step.calls += 1
        before = (AF.clone(), valid.clone()) if keep else None
        out = step(AF, valid, *arrays, topm=topm)
        if keep:
            kept.append((before, arrays, topm, out[0].clone()))
        return out

    for env in ({}, {"MAPLE_PROXY_BF16": "1"}):
        keep_step.calls = 0
        TP.proxy_step = keep_step
        try:
            run, lk, wall = device_placement(torch, B3000, env=env,
                                             model="UNREST")
        finally:
            TP.proxy_step = step
        pl = run.proxy_placer
        tag = "proxy-parity " + ("bf16" if env else "f32")
        check(pl is not None and pl.steps > 0, f"{tag}: no proxy step")
        check(pl.pool.AF.dtype == (torch.bfloat16 if env
                                   else torch.float32),
              f"{tag}: pool dtype {pl.pool.AF.dtype}")
        print(f"[{tag}] b3000 UNREST: LK {lk} (serial {ser_lk}, delta "
              f"{lk - ser_lk:.3e}); minors {run.stats.num_minors_found} "
              f"(serial {ser.stats.num_minors_found}); placed "
              f"{placed_count(run)}")
        report_proxy(tag, pl, wall, N_SAMPLES)
        check(placed_count(run) == N_SAMPLES, f"{tag}: not all placed")
        check(abs(lk - ser_lk) <= PLACEMENT_LK_TOL,
              f"{tag}: LK differs from serial by {lk - ser_lk}")
        check(run.stats.num_minors_found == ser.stats.num_minors_found,
              f"{tag}: minor count differs from serial")
    # one mid-run step against float64 on the same arrays
    check(kept, "no proxy step was captured")
    (AF, valid), arrays, topm, ts = kept[0]
    upd_idx, upd_fidx, upd_fw, upd_valid, q_fidx, q_fw = arrays
    AF64 = AF.double()
    rows = torch.zeros((upd_idx.shape[0], AF.shape[1]), dtype=torch.float64,
                       device=AF.device)
    rows.scatter_add_(1, upd_fidx.long(), upd_fw.double())
    AF64.index_copy_(0, upd_idx.long(), rows)
    valid.index_copy_(0, upd_idx.long(), upd_valid)
    QF = torch.zeros((q_fidx.shape[0], AF.shape[1]), dtype=torch.float64,
                     device=AF.device)
    QF.scatter_add_(1, q_fidx.long(), q_fw.double())
    ref = QF @ AF64.T
    ref.masked_fill_(~valid[None, :], float("-inf"))
    ref = torch.topk(ref, min(topm, AF.shape[0]), dim=1)[0]
    torch.cuda.synchronize()
    a = np.sort(ts.double().cpu().numpy(), axis=1)
    b = np.sort(ref.cpu().numpy(), axis=1)
    worst = same_inf_and_close(b, a, F32_REL, "proxy_step vs float64")
    print(f"[proxy-step] step 6 of the f32 run: K={q_fidx.shape[0]} queries "
          f"(Fq {q_fidx.shape[1]}), {upd_idx.shape[0]} changed rows (Fa "
          f"{upd_fidx.shape[1]}), pool {tuple(AF.shape)}, top-{topm} score "
          f"multisets against float64: max abs diff {worst:.3e} (<= "
          f"{F32_REL} relative), -inf cells {int(np.isneginf(b).sum())}")
    del AF64, ref, QF, rows, kept
    time_product(torch, pl.batch_size, AF.shape[1], AF.shape[0])


def phase_proxy_20k(torch):
    """Phase 11."""
    with tempfile.TemporaryDirectory(prefix="smoke_syn_") as tmp:
        path = os.path.join(tmp, f"syn{SYN_SAMPLES}.maple")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable,
             os.path.join(HERE, "scripts", "make_synthetic_alignment.py"),
             "--samples", str(SYN_SAMPLES), "--seed", str(SYN_SEED),
             "--output", path], check=True)
        made = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        run, lk, wall = device_placement(torch, path)
        peak = torch.cuda.max_memory_allocated()
        ser, ser_lk = serial_placement(torch, path)
    pl = run.proxy_placer
    check(pl is not None and pl.steps > 0, "20k: no proxy step")
    check(np.isfinite(lk), f"20k: LK {lk}")
    check(placed_count(run) == placed_count(ser) == SYN_SAMPLES,
          "20k: samples not all placed")
    print(f"[proxy-20k] {SYN_SAMPLES} synthetic samples (seed {SYN_SEED}, "
          f"made in {made:.2f} s): LK {lk}, serial engine placement "
          f"{ser_lk} (delta {lk - ser_lk:.3e}, reported, not gated); minors "
          f"{run.stats.num_minors_found} (serial "
          f"{ser.stats.num_minors_found}); serial placement "
          f"{ser.serial_wall:.2f} s ({SYN_SAMPLES / ser.serial_wall:.2f} "
          f"seq/s); peak device memory {peak / 2**30:.3f} GiB")
    report_proxy("proxy-20k", pl, wall, SYN_SAMPLES)
    cap, D = pl.pool.AF.shape
    del run, ser
    time_product(torch, pl.batch_size, D, cap)


def phase_legacy(torch, b3000):
    """Phase 12.  Returns (the legacy path's launches on b3000, its run
    label, the report of its last launch against the plain version)."""
    from maple_tpu_torch.ops import append_pairs as AP
    env = {"MAPLE_DEVICE_LEGACY": "1"}
    run, lk, _ = device_placement(torch, SUB80, 16, 16, env=env,
                                  model="GTR", device_pallas=True)
    ser, ser_lk = serial_placement(torch, SUB80, model="GTR")
    check(run.legacy_placer is not None, "sub80: not the legacy branch")
    print(f"[legacy] sub80 placed {placed_count(run)} (serial "
          f"{placed_count(ser)}); minors {run.stats.num_minors_found} "
          f"(serial {ser.stats.num_minors_found}); LK {lk} (serial {ser_lk}, "
          f"delta {lk - ser_lk:.3e}); pool on "
          f"{run.legacy_placer.pool.dev_pool.device}")
    check(placed_count(run) == placed_count(ser) == 80,
          "sub80 legacy: samples not all placed")
    check(run.stats.num_minors_found == ser.stats.num_minors_found,
          "sub80 legacy: minor counts differ")
    check(abs(lk - ser_lk) <= PLACEMENT_LK_TOL,
          f"sub80 legacy: LK differs from serial by {lk - ser_lk}")

    wrapper, last = AP.append_scores_prestacked, []

    def keep_last(*args, uer):
        last[:] = [(tuple(a.clone() for a in args), uer)]
        return wrapper(*args, uer=uer)

    import maple_tpu_torch.parallel.batch_placement as BP
    BP.append_scores_prestacked = keep_last
    argv = ["--devicePlacement", "--devicePallas"]
    try:
        wall, launches, final_lk, run = run_cli(torch, argv, **env)
    finally:
        BP.append_scores_prestacked = wrapper
    pl = run.legacy_placer
    check(pl is not None and run.pplacer is None
          and run.proxy_placer is None, "b3000: not the legacy branch")
    check(launches > 0, "the legacy path launched no pair kernel")
    check(placed_count(run) == N_SAMPLES, "b3000 legacy: not all placed")
    t = run.timings
    print(f"[legacy] b3000 end to end {wall:.2f} s, final LK {final_lk}; "
          f"pair kernel launches {launches}; placement finding "
          f"{t['finding']:.2f} s (scoring {pl.time_scoring:.2f} s, fine "
          f"{pl.time_fine:.2f} s), placing {t['placing']:.2f} s, topology "
          f"{t['topology']:.2f} s; pool B1={pl.pool.budget} "
          f"cap={pl.pool.capacity} rows={len(pl.pool.row_of)} "
          f"B2={pl.q_budget}")
    # the placement stage alone, beside the pipelined placer's (phase 5)
    run, lk, wall = device_placement(torch, B3000, env=env,
                                     device_pallas=True)
    print(f"[legacy] b3000 placement stage {wall:.2f} s "
          f"({N_SAMPLES / wall:.2f} seq/s): LK {lk}, minors "
          f"{run.stats.num_minors_found}; pipelined placer LK "
          f"{b3000['pipelined_lk']}, minors {b3000['pipelined_minors']}; "
          f"serial LK {b3000['serial_lk']}, minors "
          f"{b3000['serial_minors']}")
    check(placed_count(run) == N_SAMPLES and np.isfinite(lk),
          "b3000 legacy placement: not all placed or LK not finite")
    # the last launch of the CLI run: kernel against plain, times, bound
    (args32, uer), = last
    args64 = tuple(a.double() for a in args32)
    ref = AP.append_scores_prestacked_plain(*args64, uer=uer)
    k32 = AP.append_scores_prestacked(*args32, uer=uer)
    k64 = AP.append_scores_prestacked(*args64, uer=uer)
    torch.cuda.synchronize()
    ref, k32, k64 = (x.double().cpu().numpy() for x in (ref, k32, k64))
    same_inf_and_close(ref, k64, F64_REL, "legacy launch, float64 kernel")
    worst = same_inf_and_close(ref, k32, F32_REL,
                               "legacy launch, float32 kernel")
    ms = median_ms(torch, lambda: AP.append_scores_prestacked(
        *args32, uer=uer), reps=20)
    plain_ms = median_ms(torch, lambda: AP.append_scores_prestacked_plain(
        *args32, uer=uer), reps=5, warmup=1)
    bound, pairs = pair_bound(AP, *args32)
    Pstk, Cflat = args32[:2]
    print(f"[legacy] last launch K={Cflat.shape[0]} N={Pstk.shape[0]} "
          f"B1={Pstk.shape[2]} B2={Cflat.shape[2] // 16} uer={int(uer)}: "
          f"f32 max abs err {worst:.3e} (<= {F32_REL} relative); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median, CUDA events); "
          f"{pairs} contributing pairs, bound {bound['bound_ms']:.5f} ms by "
          f"{bound['bound_by']}")
    return launches, run_label(argv, **env), {
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bound,
        "library_ms": None}


def phase_profile_spr(torch):
    """``--profile-spr``: torch.profiler (CPU and CUDA activities) around
    one pass of each screen on phase 7's b3000 tree, after a warm-up pass
    of each.  Prints the pass wall (profiled), the device's busy time (the
    traced kernels and copies on the card) and its share of the wall, and
    the heaviest device kernels; for the proxy screen, the products'
    rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from maple_tpu_torch.parallel.proxy_features import D
    dev = torch.device("cuda")
    for name, exact in (("exact", True), ("proxy", False)):
        spr_pass(torch, dev, B3000, exact)   # warm-up
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        st, _, _, _, wall, _ = spr_pass(torch, dev, B3000, exact,
                                        trace=lambda: prof)
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = kernels.get(e.name, (0, 0.0))
                kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(us for _, us in kernels.values()) / 1e6
        check(busy > 0, f"profile {name}: no device time traced")
        print(f"[profile] {name}: {st.queries} queries x {st.anchors} "
              f"anchors, {st.chunks} chunks; pass wall {wall:.4f} s "
              f"(profiled), device busy {busy:.4f} s "
              f"({100 * busy / wall:.2f}% of the pass), CUDA events "
              f"device_s {st.device_s:.4f} s")
        for kname, (n, us) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][1])[:8]:
            print(f"[profile] {name}: {us / 1e3:.3f} ms "
                  f"({100 * us / 1e6 / busy:.2f}% of busy), {n} launches, "
                  f"{us / n:.1f} us each: {kname[:100]}")
        gemm_us = sum(us for k, (_, us) in kernels.items() if "gemm" in k)
        if not exact and gemm_us:
            cap = max(1024, 1 << (st.anchors - 1).bit_length())
            rate = 2 * st.queries * D * cap / (gemm_us * 1e-6) / 1e12
            print(f"[profile] proxy: products {rate:.1f} TFLOP/s in full "
                  f"f32 ({st.queries} x {D} x {cap} over "
                  f"{gemm_us / 1e3:.3f} ms of GEMM kernels)")


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


def main(argv):
    import torch
    if argv not in ([], ["--profile-spr"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import maple_tpu_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    phase_environment(torch)
    phase_build()
    if argv:
        phase_profile_spr(torch)
        return 0
    launches, run = phase_pipelined_path(torch)
    kern = phase_kernels(torch, run)
    del run
    b3000 = phase_placement_parity(torch)
    runs, by_path = phase_spr_main_path(torch)
    chunk = phase_screen_chunk(torch, phase_spr_parity(torch))
    phase_proxy_main_path(torch)
    phase_proxy_parity(torch)
    phase_proxy_20k(torch)
    legacy_launches, legacy_label, legacy = phase_legacy(torch, b3000)
    # every count below is of one run, reset just before it
    by_path["legacy"] = legacy_launches
    check(all(n > 0 for n in by_path.values()),
          f"a path launched no pair kernel: {by_path}")
    runs = {run_label(["--devicePlacement"], MAPLE_DEVICE_RT="1"): launches,
            **runs, legacy_label: legacy_launches}
    no_foreign_modules()
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "append_pairs", "route": "cuda",
        "source": "maple_tpu_torch/csrc/append_pairs.cu",
        "replaces": "maple_tpu/ops/pallas_append.py:349",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_by_run": runs, **kern, "spr_screen_chunk": chunk,
        "legacy_batch": legacy}]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
