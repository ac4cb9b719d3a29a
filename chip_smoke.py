"""Smoke run of maple_tpu_torch on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: the CUDA kernels from csrc/ with nvcc and the package's own
     native host engine with g++, both into maple_tpu_torch/_build/; each
     kernel's registers, spills and static shared memory from the ptxas
     report (kept beside the library, so a run that finds it built prints
     the same);
  3. the pipelined path: ``python -m maple_tpu_torch --devicePlacement`` on
     the 3,000-genome B.1.429 subset with MAPLE_DEVICE_RT=1, in-process;
     the pair kernel's launch count must be positive, the tree and a finite
     LK must be written, and neither jax nor maple_tpu may be loaded;
  4. the pair kernel (the merge walk) against its plain PyTorch version
     and against the grid kernel (the yardstick, on no path) on the card,
     on the anchor rows of phase 3's own pool (tiled to n_prefix 1024 and
     8192), K=64 real queries with B2=128 entries, error model off and
     on, with CUDA-event times of all three and the kernel's bound; then
     the same checks on the pool as the run left it (its prefix with the
     rows never written, all zero, and the invalidated ones) against the
     queries packed at B2 = 128, 256 and 512, on K = 1 and K = 25 against
     1,000 rows (no multiple of a tile), and on rows too long for shared
     memory; the two CUDA kernels of a call timed apart by torch.profiler
     (not measured, and no failure, where it traces no device event);
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
     times of both and of the same chunk on the grid kernel;
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
     and its plain version, with times and bound;
 13. the interval-algebra scorer (torch ops) on the card, on phase 12's
     last batch: float64 against the same scorer on the CPU (1e-9, the
     first 8 queries) and against the pair kernel on the card (1e-9 in
     float64; rtol 2e-4, atol 2e-3 in float32; the same -inf cells); its
     time at that shape, its bound and its peak memory;
 14. the legacy branch on its default scorer: MAPLE_DEVICE_LEGACY=1
     ``--devicePlacement`` without ``--devicePallas``: example_sub80 within
     1e-6 of serial; b3000 through the command line: the legacy placer on
     the interval-algebra scorer, native kernels, 0 pair-kernel launches,
     all placed, a finite LK, printed beside the --devicePallas run's;
 15. the mesh: a process group of one NCCL rank, a 1 x 1 (dp x cand) mesh:
     ``dryrun_multichip`` on b3000 with the pair kernel (its launches
     counted as the ``mesh`` path; the placement LK within 1.0 of phase
     12's single-device placement on the same scorer), the mesh SPR pass
     on the interval-algebra scorer (must not lower the LK), the
     genome-sharded scorer on a 1 x 1 genome mesh against the dense one;
     one tile of each mesh scorer bitwise equal to the single-device
     scorer, on the operands of the run's own last placement call (a
     query chunk against the whole pool) and on phase 12's last batch.
     ``dryrun_multichip`` takes ``placer="legacy"`` here: its default is
     the proxy placer (phase 17).  One card shows that the mesh code runs
     on CUDA tensors through NCCL; tiles over several ranks are shown by
     the CPU tests (gloo, 4 ranks);
 16. ``maple_tpu_torch.tools.speed_of_light`` at N 8192, K 64, B1 = B2 =
     64: both scorers' rows; then the device functions that are torch ops
     (the anchor-row scatter, the proxy screen step, the legacy pool's row
     scatter) timed beside their bounds at the b3000 runs' shapes;
 17. the proxy pool sharded by candidate (K11, ``proxy_step_sharded``), on
     phase 15's group, right after it: (a) b3000 UNREST with default flags
     through ``build_initial_tree_device(mesh=...)`` on the 1 x 1 mesh:
     every step through K11, no pair-kernel launch, the LK and minors of
     phase 10's single-device float32 run exactly and serial's within
     1e-6, the same step count; (b) K11 alone at phase 11's shape (256
     queries, a 65,536 x 8,192 float32 pool, 512 changed rows, top-128)
     against ``proxy_step`` on the same seeded tensors: the same pool after
     the scatter and bitwise equal sorted scores, both timed (CUDA events)
     beside K11's bound and the product alone (``torch.matmul``, the
     library call); (c) ``dryrun_multichip`` with its default placer on
     b3000: the placement LK serial's within 1e-6; after phase 16, (d) the
     tools at 2,000 synthetic samples on the card: ``benchmark_multihost``
     (one NCCL rank, its own process), ``benchmark_device --spr`` and
     ``benchmark_spr_recall --exact``.  Its numbers are on ``[mesh-proxy]``
     and ``[tools]`` lines, K11's as one JSON object; K11 is torch ops and
     a collective, no hand kernel, and stays out of the kernel report.
The line before the last is the card's name and power limit, the one
before it the kernel report, and the last line the result.  In the
kernel report, ``ms`` is the merge-walk kernel's time (one wrapper call:
two CUDA kernels) and ``grid_ms`` the grid kernel's on the same operands
in the same run; ``launches_by_path`` holds the pair kernel's launches on
each path (placement and SPR of phase 6's exhaustive run, the legacy run
of phase 12, the mesh run of phase 15), each counted from 0 within its own
run; ``launches`` is their sum; ``launches_by_run`` holds each CLI run's
own count; ``interval_algebra`` holds phase 13's numbers for the scorer
that is torch ops, not a kernel.
``bound_ms`` is the larger of the function's bytes (each input once in its
packed types, 33 bytes a genome-list entry, the output once) over 3.35
TB/s and its operations (the entry pairs of these inputs that contribute,
at about 100 float operations each, the figure in csrc/append_pairs.cu)
over 67 TFLOP/s, the float32 peak outside the tensor cores: one bound for
the pair kernel and the interval-algebra scorer, which compute the same
function (``tools/speed_of_light.py`` ``work_model``).  ``layout_bound_ms``
is the same with the bytes of the pair kernel's own operands (16 float32
planes, 64 bytes an entry).  No single PyTorch call computes the
function, so ``library_ms`` is null.

    python3 chip_smoke.py --profile-spr

runs phases 1 and 2, then torch.profiler around one SPR pass of each
screen on phase 7's b3000 tree (after a warm-up pass of each): the device's
busy share of the pass and its heaviest kernels.

    python3 chip_smoke.py --profile-mesh

runs phases 1 and 2, then b3000 placement with default flags on one device
and over phase 15's 1 x 1 NCCL mesh, each warmed up, then plain and under
torch.profiler: the placer's device time between its step events beside
the host time that issues the steps and the device's busy time by kernel;
then K11 against ``proxy_step`` alone, timed and traced.
Neither mode prints a result line.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# the package lies beside this script: outside a checkout this import fails
from maple_tpu_torch.dryrun import placed as placed_count
from maple_tpu_torch.tools.speed_of_light import (F32_FLOPS,
                                                  HBM_BYTES_PER_S, card,
                                                  median_ms, work_model)

HERE = os.path.dirname(os.path.abspath(__file__))
B3000 = os.path.join(HERE, "tests", "data_b1429_3000.maple.gz")
SUB80 = os.path.join(HERE, "tests", "goldens", "example_sub80.maple")
N_SAMPLES = 3000
K_QUERIES, Q_BUDGET = 64, 128        # --deviceBatchSize, starting B2
PREFIXES = (1024, 8192)
PLACEMENT_LK_TOL = 1e-6              # maple_tpu's own device contract
BRANCH_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
              "MAPLE_PROXY_D", "MAPLE_SPR_EXACT")
SYN_SAMPLES, SYN_SEED = 20000, 1
TOOL_SAMPLES = 2000                  # synthetic samples of phase 17's tools
F64_REL = 1e-9                       # kernel vs plain, both float64
K8_F32_RTOL, K8_F32_ATOL = 2e-4, 2e-3  # float32 scores of two scorers
                                     # (tests/test_mesh_pallas.py:71-72)
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


def phase_environment(torch):
    from maple_tpu_torch.ops import _build
    print(f"[env] {card()}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[env] nvcc: {nvcc.splitlines()[-1]}")


def ptxas_report(log):
    """Each kernel's resources from nvcc's ``-Xptxas -v`` output: a list of
    {"kernel", "registers", "spill_stores", "spill_loads", "stack",
    "static_smem"} (bytes; dynamic shared memory is the launch's and not
    in the report)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"\d+(compact_rows|append_walk|append_pairs_kernel)"
                          r"I([fd])(?:Lb([01])E)?", name)
            if k:
                name = f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}" \
                    + (f", uer={k.group(3)}>" if k.group(3) else ">")
            cur = {"kernel": name, "registers": None, "spill_stores": 0,
                   "spill_loads": 0, "stack": 0, "static_smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def phase_build():
    """Returns the kernels' resources (``ptxas_report``)."""
    from maple_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.library()
    print(f"[build] {built.path.name}: nvcc {built.seconds:.2f} s"
          f"{'' if built.seconds else ' (found built)'}, load "
          f"{time.perf_counter() - t0:.2f} s")
    resources = ptxas_report(built.log)
    check(len(resources) >= 10 and all(r["registers"] for r in resources),
          f"no ptxas report for every kernel:\n{built.log}")
    for r in resources:
        print(f"[build] {r['kernel']}: {r['registers']} registers, spill "
              f"stores {r['spill_stores']} B, spill loads "
              f"{r['spill_loads']} B, stack {r['stack']} B, static shared "
              f"memory {r['static_smem']} B")
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
    return resources


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


def pair_bound(Pstk, Cflat):
    """The least time the card could take for one scorer call on these
    stacked inputs (module docstring): {"bound_ms", "bound_by",
    "layout_bound_ms"}, and the speed-of-light tool's work model they come
    from.  lRef is the end of a full row's last entry."""
    from maple_tpu_torch.ops.layout import F_END
    work = work_model(Pstk, Cflat, int(Pstk[:, F_END].max().item()))
    return {k: work[k] for k in ("bound_ms", "bound_by",
                                 "layout_bound_ms")}, work


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
    from maple_tpu_torch.parallel import pipelined_placer as PP
    step, shapes = PP.fused_step, []

    def keep_shapes(pool, valid, upd_idx, upd_rows, upd_valid, Cflat, *a,
                    n_prefix, **kw):
        shapes.append((upd_idx.shape[0], n_prefix, pool.shape[2],
                       Cflat.shape[0], Cflat.shape[2] // 16, kw["topk"]))
        return step(pool, valid, upd_idx, upd_rows, upd_valid, Cflat, *a,
                    n_prefix=n_prefix, **kw)

    PP.fused_step = keep_shapes
    try:
        wall, launches, lk, run = run_cli(torch, ["--devicePlacement"],
                                          MAPLE_DEVICE_RT="1")
    finally:
        PP.fused_step = step
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
    # the fused steps' bound by bytes: the pool prefix, the changed rows
    # (read, and written into the pool), the queries and the top-k out;
    # the pair kernel inside is bound by bytes at these shapes (phase 4)
    nbytes = sum(4 * (n * 16 * b1 + 2 * r * 16 * b1 + k * b2 * 16 + 4 * k
                      + 20 + 2 * k * topk) + n + 9 * r
                 for r, n, b1, k, b2, topk in shapes)
    print(f"[main] {len(shapes)} fused steps, {sum(s[0] for s in shapes)} "
          f"rows scattered in all: bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f}"
          f" ms by bytes for all steps ({nbytes} bytes) beside "
          f"{1e3 * pp.time_device:.1f} ms of device time")
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
    return variants, mm, rf, len(live), pool.budget, q_budget, queries, err


def compare_kernels(torch, args64, uer, what, plain_reps=0):
    """One input set (float64 tensors on the card) through the plain
    version, the merge-walk kernel and the grid kernel: float64 within
    F64_REL of plain, float32 within F32_REL, -inf in the same cells; the
    walk's float32 scores within F32_REL of the grid's.  Times by CUDA
    events: the medians of 20 (walk) and 10 (grid) calls; the plain
    version's float32 median of ``plain_reps`` calls, or with 0 the one
    float64 call that made the reference."""
    from maple_tpu_torch.ops import append_pairs as AP
    args32 = [a.float() for a in args64]
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    ref = AP.append_scores_prestacked_plain(*args64, uer=uer)
    t1.record()
    k64 = AP.append_scores_prestacked(*args64, uer=uer)
    k32 = AP.append_scores_prestacked(*args32, uer=uer)
    g64 = AP.append_scores_prestacked_grid(*args64, uer=uer)
    g32 = AP.append_scores_prestacked_grid(*args32, uer=uer)
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    ref, k64, k32, g64, g32 = (x.double().cpu().numpy()
                               for x in (ref, k64, k32, g64, g32))
    abs64 = same_inf_and_close(ref, k64, F64_REL, f"{what}: walk f64")
    abs32 = same_inf_and_close(ref, k32, F32_REL, f"{what}: walk f32")
    same_inf_and_close(ref, g64, F64_REL, f"{what}: grid f64")
    same_inf_and_close(ref, g32, F32_REL, f"{what}: grid f32")
    d_grid = same_inf_and_close(g32, k32, F32_REL,
                                f"{what}: walk f32 against grid f32")
    ms = median_ms(lambda: AP.append_scores_prestacked(*args32, uer=uer),
                   reps=20)
    ms64 = median_ms(lambda: AP.append_scores_prestacked(*args64, uer=uer),
                     reps=10)
    grid_ms = median_ms(lambda: AP.append_scores_prestacked_grid(
        *args32, uer=uer), reps=10)
    if plain_reps:
        plain_ms = median_ms(lambda: AP.append_scores_prestacked_plain(
            *args32, uer=uer), reps=plain_reps, warmup=1)
    bound, work = pair_bound(*args32[:2])
    Pstk, Cflat = args32[:2]
    K, N, B1, B2 = Cflat.shape[0], Pstk.shape[0], Pstk.shape[2], \
        Cflat.shape[2] // 16
    print(f"[kernel] {what}: K={K} N={N} B1={B1} B2={B2} uer={int(uer)}: "
          f"walk f64 max abs err {abs64:.3e} (<= {F64_REL} relative), f32 "
          f"{abs32:.3e} (<= {F32_REL} relative), walk f32 against grid f32 "
          f"max |d| {d_grid:.3e}, -inf cells {int(np.isneginf(ref).sum())}, "
          f"0 mismatched; walk f32 {ms:.4f} ms, walk f64 {ms64:.4f} ms, "
          f"grid f32 {grid_ms:.4f} ms, plain "
          f"{'f32' if plain_reps else 'f64, one call'} {plain_ms:.4f} ms "
          f"(CUDA events)")
    print(f"[kernel] {what}: {work['contributing_pairs']} contributing "
          f"pairs of {K * N * B1 * B2} in the grid; bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']} "
          f"({work['bytes']} bytes; the operands' own layout moves "
          f"{work['layout_bytes']}: {bound['layout_bound_ms']:.5f} ms); "
          f"walk {ms / bound['bound_ms']:.1f}x above the bound, grid "
          f"{grid_ms / bound['bound_ms']:.1f}x")
    return {"shape": {"K": K, "N": N, "B1": B1, "B2": B2, "uer": int(uer)},
            "ms": ms, "grid_ms": grid_ms, "plain_ms": plain_ms, **bound,
            "max_abs_err": abs32, "walk_vs_grid_max_abs": d_grid,
            "contributing_pairs": work["contributing_pairs"]}


def kernel_split(torch, args32, uer, what, reps=5):
    """The CUDA kernels of one wrapper call, counted and timed apart by
    torch.profiler (mean of ``reps`` calls, ms), the first pass beside its
    bound by bytes, the least it must move: in, the type field of every
    slot of both operands (it finds a row's count) and, for each entry up
    to the row's last that is no PAD, the 13 other fields ``pack_entry``
    reads (csrc/append_walk.cuh: neither prev nor the spare field); out, a
    count a row and a 4-byte walk word and a 12-value record an entry.

    Where the profiler traces no device event in two tries (CUPTI is not
    on every machine), the split is not measured: its times and its
    kernel count are None, and the call's whole time stays the one that
    ``compare_kernels`` took by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from maple_tpu_torch.ops import append_pairs as AP
    from maple_tpu_torch.ops.layout import F_TYPE
    from maple_tpu_torch.ops.pack import TYPE_PAD
    AP.append_scores_prestacked(*args32, uer=uer)
    torch.cuda.synchronize()
    seen = {}     # every device event of the profiled calls, by name
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                AP.append_scores_prestacked(*args32, uer=uer)
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = seen.get(e.name, (0, 0.0))
                seen[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if seen:
            break
    # a kernel launched once a call is seen at most ``reps`` times (the
    # profiler may drop an event; a mean is over those seen)
    check(all(n <= reps for n, _ in seen.values()),
          f"{what}: the profiler saw {seen} in {reps} calls")
    ms = {}
    for key in ("compact_rows", "append_walk"):
        found = [v for name, v in seen.items() if key in name]
        check(not seen or len(found) == 1,
              f"{what}: {key} among {sorted(seen)}")
        ms[key] = found[0][1] / found[0][0] / 1e3 if found else None
    Pstk, Cflat = args32[:2]
    K = Cflat.shape[0]
    size = Pstk.element_size()

    def entries(types):   # [rows, B] -> entries up to the last non-PAD
        B = types.shape[1]
        pos = torch.arange(1, B + 1, device=types.device)
        return int(((types != TYPE_PAD) * pos).amax(1).sum().item())

    n_entries = entries(Pstk[:, F_TYPE, :]) + entries(
        Cflat.reshape(K, -1, 16)[:, :, F_TYPE])
    slots = (Pstk.numel() + Cflat.numel()) // 16
    nbytes = size * (slots + 13 * n_entries) + 4 * (Pstk.shape[0] + K) \
        + (4 + 12 * size) * n_entries
    out = {"cuda_kernels_a_call": len(seen) or None,
           "compact_ms": ms["compact_rows"], "walk_ms": ms["append_walk"],
           "compact_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "compact_bytes": nbytes, "entries": n_entries}
    if not seen:
        print(f"[kernel] {what}: torch.profiler traced no device event in "
              f"two tries of {reps} calls: the split into compact_rows and "
              f"append_walk is not measured (compact_rows bound "
              f"{out['compact_bound_ms']:.5f} ms by bytes: {nbytes} bytes, "
              f"{n_entries} entries of {slots} slots)")
        return out
    print(f"[kernel] {what}: one call is {len(seen)} CUDA kernels "
          f"(torch.profiler, mean of {reps} calls): compact_rows "
          f"{out['compact_ms']:.4f} ms (bound {out['compact_bound_ms']:.5f} "
          f"ms by bytes: {nbytes} bytes, {n_entries} entries of {slots} "
          f"slots: {out['compact_ms'] / out['compact_bound_ms']:.2f}x above "
          f"it), append_walk {out['walk_ms']:.4f} ms")
    return out


def pad_entries(stk, entry_axis, budget, lRef):
    """A stacked tensor's entry axis grown to ``budget`` with PAD entries
    (type 7, end = prev = lRef, every other field 0), as packing at that
    budget would give: ``entry_axis`` -1 for candidates [N, 16, B], -2 for
    queries [K, B, 16]."""
    from maple_tpu_torch.ops.layout import F_END, F_PREV, F_TYPE
    from maple_tpu_torch.ops.pack import TYPE_PAD
    shape = list(stk.shape)
    old = shape[entry_axis]
    shape[entry_axis] = budget
    out = np.zeros(shape, dtype=stk.dtype)
    # both as [..., field, entry] views
    fields, src = (out, stk) if entry_axis == -1 else \
        (out.swapaxes(-1, -2), stk.swapaxes(-1, -2))
    fields[..., :old] = src
    fields[..., F_TYPE, old:] = TYPE_PAD
    fields[..., F_END, old:] = lRef
    fields[..., F_PREV, old:] = lRef
    return out


def phase_kernels(torch, run):
    from maple_tpu_torch.ops import pack as OP
    from maple_tpu_torch.ops.layout import (F_END, F_EPS, F_TYPE,
                                            stack_fields_host)
    dev = torch.device("cuda")
    variants, mm, rf, n_live, B1, B2, queries, err = kernel_inputs(run)
    lRef = run.rt.refd.lRef
    print(f"[kernel] inputs: {n_live} live anchor rows of the main path's "
          f"pool tiled to {PREFIXES[-1]}, B1={B1}, K={K_QUERIES}, B2={B2}")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)

    def operands(rows, cstk, prm):
        K = cstk.shape[0]
        return [t(rows), t(cstk.reshape(K, 1, -1)), t(prm[:K]), t(mm), t(rf)]

    report, cases, max_abs32 = {}, {}, 0.0
    for uer in (False, True):
        rows, cstk, prm = variants[uer]
        for n_prefix in PREFIXES:
            args64 = operands(rows[:n_prefix], cstk, prm)
            r = compare_kernels(torch, args64, uer, f"live rows tiled to "
                                f"{n_prefix}", plain_reps=3)
            if not uer:
                r["split"] = kernel_split(torch, [a.float() for a in args64],
                                          uer, f"live rows tiled to "
                                          f"{n_prefix}")
            max_abs32 = max(max_abs32, r["max_abs_err"])
            report[(uer, n_prefix)] = r

    # the pool as the run left it: its prefix with the rows never written
    # (all zero) and the invalidated ones, against the queries packed at
    # the starting budget, twice and four times it (B2 = 128, 256, 512)
    pool = run.pplacer.pool
    n_prefix = pool.n_prefix
    held = pool.dev_pool[:n_prefix]
    check(held.dtype == torch.float32 and held.device.type == "cuda",
          "the run's pool is not float32 on the card")
    n_zero = int((held.abs().amax((1, 2)) == 0).sum().item())
    n_invalid = int((~pool.dev_valid[:n_prefix]).sum().item()) - n_zero
    check(n_zero > 0, "the run's pool prefix holds no row of zeros")
    print(f"[kernel] the run's pool prefix: {n_prefix} rows, {n_zero} all "
          f"zero, {n_invalid} invalidated and still holding a list, B1="
          f"{pool.budget}")
    held64 = held.double().cpu().numpy()
    prm = variants[False][2]
    for b2 in (B2, 2 * B2, 4 * B2):
        cstk = stack_fields_host(
            OP.pack_genome_lists(queries, lRef, b2, False), None, None,
            axis=-1, dtype=np.float64)
        what = f"the run's pool, B2={b2}"
        cases[what] = compare_kernels(torch, operands(held64, cstk, prm),
                                      False, what)
        if b2 == 2 * B2:   # the error model on, on the same rows
            held_e, cstk_e = held64.copy(), cstk.copy()
            for fld in (lambda i: held_e[:, i, :], lambda i: cstk_e[..., i]):
                pos = np.maximum(fld(F_END).astype(np.int64) - 1, 0)
                fld(F_EPS)[...] = np.where(fld(F_TYPE) < 5, err[pos], 0.0)
            held_e[held64.reshape(n_prefix, -1).any(1) == 0] = 0.0
            what += ", error model on"
            cases[what] = compare_kernels(
                torch, operands(held_e, cstk_e, variants[True][2]), True,
                what)
    cases[f"the run's pool, B2={B2}"]["split"] = kernel_split(
        torch, [a.float() for a in operands(
            held64, variants[False][1], prm)], False, "the run's pool")
    max_abs32 = max([max_abs32] + [c["max_abs_err"] for c in cases.values()])
    counts = {r["split"]["cuda_kernels_a_call"]
              for r in [*report.values(), *cases.values()] if "split" in r}
    counts.discard(None)   # not traced
    check(len(counts) <= 1, f"CUDA kernels a call differ by shape: {counts}")

    # one query, 25 queries; a row count that is no multiple of a tile
    for uer in (False, True):
        rows, cstk, prm = variants[uer]
        for k in (1, 25):
            what = f"K={k}, 1000 rows"
            cases[f"{what}, uer={int(uer)}"] = compare_kernels(
                torch, operands(rows[:1000], cstk[:k], prm), uer, what)
    # rows too long for shared memory: the walk reads device memory
    rows, cstk, prm = variants[False]
    what = "rows beyond shared memory"
    cases[what] = compare_kernels(torch, operands(
        pad_entries(rows[:256], -1, 1536, lRef),
        pad_entries(cstk[:4], -2, 8192, lRef), prm), False, what)
    return {**report[(False, PREFIXES[-1])], "max_abs_err": max_abs32,
            "library_ms": None,
            "n_prefix_1024": report[(False, PREFIXES[0])],
            "error_model_on": {str(n): report[(True, n)] for n in PREFIXES},
            "cases": cases}


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
                     mesh=None, **flags):
    """The port's device placement stage on the card, on the branch that
    ``env`` selects (none: the proxy branch), over ``mesh`` if given."""
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
            else batch_size, mesh=mesh)
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

    def grid(pool, Cflat, prm, mm, rf):   # the same chunk on the yardstick
        scores = AP.append_scores_prestacked_grid(
            pool[:n_prefix], Cflat, prm, mm, rf, uer=uer)
        BS._mask_trivial_targets(scores, valid[:n_prefix],
                                 a_tin[:n_prefix], q_lo, q_hi, excl)
        return torch.topk(scores, 1, dim=1)

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
    g32 = grid(*f32)[0].double().cpu().numpy()[:, 0]
    d_grid = same_inf_and_close(g32, k32, F32_REL,
                                "screen chunk: walk f32 against grid f32")
    ms = median_ms(lambda: kernel(*f32), reps=20)
    grid_ms = median_ms(lambda: grid(*f32), reps=10)
    plain_ms = median_ms(lambda: plain(*f32), reps=3, warmup=1)
    bound, _ = pair_bound(pool[:n_prefix].contiguous(), Cflat)
    print(f"[chunk] K={Cflat.shape[0]} queries, n_prefix {n_prefix}, "
          f"B1={pool.shape[-1]}, B2={Cflat.shape[-1] // 16}, uer={int(uer)}: "
          f"top-1 f64 rel err {rel64:.3e} (<= {F64_REL}), f32 rel err "
          f"{rel32:.3e} (<= {F32_REL}), f32 max abs err {abs32.max():.3e}, "
          f"-inf rows {int(inf.sum())}; screen_chunk kernel f32 {ms:.4f} "
          f"ms, the same chunk on the grid kernel {grid_ms:.4f} ms (top-1 "
          f"max |d| {d_grid:.3e}), plain f32 {plain_ms:.4f} ms (median, "
          f"CUDA events); bound {bound['bound_ms']:.5f} ms by "
          f"{bound['bound_by']}")
    return {"max_abs_err": float(abs32.max()), "ms": ms, "grid_ms": grid_ms,
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
    ms = median_ms(lambda: QF @ AF.T, reps=10)
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
    """Phase 10.  Returns the float32 run's placement LK, minors and steps,
    and serial's."""
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
        if not env:
            f32 = {"lk": lk, "minors": run.stats.num_minors_found,
                   "steps": pl.steps, "serial_lk": ser_lk,
                   "serial_minors": ser.stats.num_minors_found}
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
    return f32


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
    g32 = AP.append_scores_prestacked_grid(*args32, uer=uer) \
        .double().cpu().numpy()
    d_grid = same_inf_and_close(g32, k32, F32_REL,
                                "legacy launch, walk f32 against grid f32")
    ms = median_ms(lambda: AP.append_scores_prestacked(
        *args32, uer=uer), reps=20)
    grid_ms = median_ms(lambda: AP.append_scores_prestacked_grid(
        *args32, uer=uer), reps=10)
    plain_ms = median_ms(lambda: AP.append_scores_prestacked_plain(
        *args32, uer=uer), reps=5, warmup=1)
    Pstk, Cflat = args32[:2]
    bound, work = pair_bound(Pstk, Cflat)
    print(f"[legacy] last launch K={Cflat.shape[0]} N={Pstk.shape[0]} "
          f"B1={Pstk.shape[2]} B2={Cflat.shape[2] // 16} uer={int(uer)}: "
          f"f32 max abs err {worst:.3e} (<= {F32_REL} relative), against "
          f"the grid kernel max |d| {d_grid:.3e}; kernel {ms:.4f} ms, grid "
          f"kernel {grid_ms:.4f} ms, plain {plain_ms:.4f} ms (median, CUDA "
          f"events); "
          f"{work['contributing_pairs']} contributing pairs, bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']} (the kernel's "
          f"own layout: {bound['layout_bound_ms']:.5f} ms)")
    stage = {"lk": lk, "minors": run.stats.num_minors_found,
             "final_lk": final_lk}
    return launches, run_label(argv, **env), {
        "max_abs_err": worst, "ms": ms, "grid_ms": grid_ms,
        "plain_ms": plain_ms, **bound, "library_ms": None}, \
        (args32, uer), stage


def k8_inputs(torch, args32):
    """The stacked inputs of a pair-kernel launch as the interval-algebra
    scorer's operands: views of the pool rows and of the queries, the
    branch length, and a DeviceModel with the same matrix and scalars
    (site rates 1, no error model, as that launch had)."""
    from maple_tpu_torch.ops import append_batch as AB
    from maple_tpu_torch.ops.layout import NFIELDS, fields_view
    Pstk, Cflat, prm, mm, rf = args32
    lRef = int(Pstk[0, 11].max().item())      # F_END of a full row
    one = torch.ones(lRef, dtype=Pstk.dtype, device=Pstk.device)
    dm = AB.DeviceModel(mm.reshape(4, 4), rf.reshape(4), one,
                        torch.zeros_like(one), prm[0, 0, 2], prm[0, 0, 3],
                        False, False)
    P = fields_view(Pstk, -2)
    C = fields_view(Cflat.reshape(Cflat.shape[0], -1, NFIELDS), -1)
    return P, C, float(prm[0, 0, 0]), dm, lRef


def phase_interval_algebra(torch, last):
    """Phase 13."""
    from maple_tpu_torch.ops import append_batch as AB
    from maple_tpu_torch.ops import append_pairs as AP
    args32, uer = last
    check(not uer, "phase 13 expects the legacy run without an error model")
    args64 = tuple(a.double() for a in args32)
    P32, C32, blen, dm32, lRef = k8_inputs(torch, args32)
    P64, C64, _, dm64, _ = k8_inputs(torch, args64)
    k8_32 = AB.grid_append_scores(P32, C32, blen, True, dm32)
    k8_64 = AB.grid_append_scores(P64, C64, blen, True, dm64)
    k1_32 = AP.append_scores_prestacked(*args32, uer=False)
    k1_64 = AP.append_scores_prestacked(*args64, uer=False)
    torch.cuda.synchronize()
    check(k8_32.device.type == "cuda", "the scorer left the card")
    k8_32, k8_64, k1_32, k1_64 = (x.double().cpu().numpy() for x in
                                  (k8_32, k8_64, k1_32, k1_64))
    worst64 = same_inf_and_close(k1_64, k8_64, F64_REL,
                                 "interval algebra vs pair kernel, float64")
    inf = np.isneginf(k1_32)
    check(np.array_equal(inf, np.isneginf(k8_32)),
          "interval algebra vs pair kernel, float32: -inf cells differ")
    check(np.allclose(k8_32[~inf], k1_32[~inf], rtol=K8_F32_RTOL,
                      atol=K8_F32_ATOL),
          "interval algebra vs pair kernel, float32: outside tolerance")
    worst32 = float(np.abs(k8_32[~inf] - k1_32[~inf]).max())
    # the same scorer on the CPU, float64, the first 8 queries
    cpu = torch.device("cpu")
    n_q = min(8, C64["types"].shape[0])
    on_cpu = AB.grid_append_scores(
        {k: v.to(cpu) for k, v in P64.items()},
        {k: v[:n_q].to(cpu) for k, v in C64.items()}, blen, True,
        dm64._replace(**{n: getattr(dm64, n).to(cpu) for n in (
            "mut_matrix", "root_freqs", "site_rates", "error_rates",
            "global_tot_rate", "tot_error")})).numpy()
    worst_cpu = same_inf_and_close(on_cpu, k8_64[:n_q], F64_REL,
                                   "interval algebra, card vs CPU, float64")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms = median_ms(lambda: AB.grid_append_scores(
        P32, C32, blen, True, dm32), reps=10)
    peak = torch.cuda.max_memory_allocated() - before
    k1_ms = median_ms(lambda: AP.append_scores_prestacked(
        *args32, uer=False), reps=10)
    Pstk, Cflat = args32[:2]
    K, N, B1, B2 = Cflat.shape[0], Pstk.shape[0], Pstk.shape[2], \
        Cflat.shape[2] // 16
    bound, work = pair_bound(Pstk, Cflat)
    print(f"[k8] K={K} N={N} B1={B1} B2={B2} (phase 12's last batch): "
          f"float64 against the pair kernel max abs {worst64:.3e} (<= "
          f"{F64_REL} relative), against the CPU max abs {worst_cpu:.3e}; "
          f"float32 against the pair kernel max abs {worst32:.3e} (rtol "
          f"{K8_F32_RTOL}, atol {K8_F32_ATOL}), -inf cells {int(inf.sum())}")
    print(f"[k8] interval algebra f32 {ms:.4f} ms, pair kernel f32 "
          f"{k1_ms:.4f} ms (median of 10, CUDA events); "
          f"{work['contributing_pairs']} contributing pairs, "
          f"{K * N * (B1 + B2)} segment elements in "
          f"{-(-K * N * (B1 + B2) // AB._BLOCK_ELEMS)} blocks; bound "
          f"{bound['bound_ms']:.5f} ms by {bound['bound_by']} "
          f"({work['bytes']} bytes, the pair kernel's bound on these inputs "
          f"too); peak memory above the inputs "
          f"{peak / 2**20:.1f} MiB")
    return {"ms": ms, "pair_kernel_ms": k1_ms, "max_abs_err": worst32,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, "peak_memory_bytes": int(peak),
            "shape": {"K": K, "N": N, "B1": B1, "B2": B2}}


def phase_legacy_default_scorer(torch, b3000, pallas_stage):
    """Phase 14.  Returns the run's label and the count of scorer
    calls."""
    import maple_tpu_torch.parallel.batch_placement as BP
    env = {"MAPLE_DEVICE_LEGACY": "1"}
    run, lk, _ = device_placement(torch, SUB80, 16, 16, env=env,
                                  model="GTR")
    ser, ser_lk = serial_placement(torch, SUB80, model="GTR")
    pl = run.legacy_placer
    check(pl is not None and not pl.use_pallas and pl.dm is not None,
          "sub80: not the legacy placer on the interval-algebra scorer")
    print(f"[legacy-k8] sub80 placed {placed_count(run)} (serial "
          f"{placed_count(ser)}); minors {run.stats.num_minors_found} "
          f"(serial {ser.stats.num_minors_found}); LK {lk} (serial {ser_lk}, "
          f"delta {lk - ser_lk:.3e}); model on {pl.dm.mut_matrix.device}")
    check(placed_count(run) == placed_count(ser) == 80,
          "sub80 legacy-k8: samples not all placed")
    check(run.stats.num_minors_found == ser.stats.num_minors_found,
          "sub80 legacy-k8: minor counts differ")
    check(abs(lk - ser_lk) <= PLACEMENT_LK_TOL,
          f"sub80 legacy-k8: LK differs from serial by {lk - ser_lk}")

    scorer, calls = BP.grid_append_scores, []

    def counted(P, C, blen, tip, dm):
        check(P["types"].device.type == "cuda", "the scorer left the card")
        calls.append((C["types"].shape[0], P["types"].shape[0]))
        return scorer(P, C, blen, tip, dm)

    BP.grid_append_scores = counted
    argv = ["--devicePlacement"]
    try:
        wall, launches, final_lk, run = run_cli(torch, argv, **env)
    finally:
        BP.grid_append_scores = scorer
    pl = run.legacy_placer
    check(pl is not None and run.pplacer is None
          and run.proxy_placer is None, "b3000: not the legacy branch")
    check(not pl.use_pallas, "b3000: the legacy placer took the pair kernel")
    check(launches == 0, f"the run launched the pair kernel {launches} times")
    check(calls, "the legacy placer never called the interval-algebra "
          "scorer")
    check(placed_count(run) == N_SAMPLES, "b3000 legacy-k8: not all placed")
    t = run.timings
    print(f"[legacy-k8] b3000 end to end {wall:.2f} s, final LK {final_lk} "
          f"(--devicePallas run {pallas_stage['final_lk']}); "
          f"{len(calls)} scorer calls (largest K x N "
          f"{max(calls, key=lambda c: c[0] * c[1])}), pair kernel launches "
          f"{launches}; placement finding {t['finding']:.2f} s (scoring "
          f"{pl.time_scoring:.2f} s, fine {pl.time_fine:.2f} s), placing "
          f"{t['placing']:.2f} s, topology {t['topology']:.2f} s")
    run, lk, wall = device_placement(torch, B3000, env=env)
    print(f"[legacy-k8] b3000 placement stage {wall:.2f} s "
          f"({N_SAMPLES / wall:.2f} seq/s): LK {lk}, minors "
          f"{run.stats.num_minors_found}; --devicePallas run LK "
          f"{pallas_stage['lk']}, minors {pallas_stage['minors']}; serial "
          f"LK {b3000['serial_lk']}, minors {b3000['serial_minors']}")
    check(placed_count(run) == N_SAMPLES and np.isfinite(lk),
          "b3000 legacy-k8 placement: not all placed or LK not finite")
    return run_label(argv, **env), len(calls)


def mesh_tiles(torch, mesh, pool_g, q_g, blen, dm, what):
    """One call of each mesh placement scorer on these operands (the pool
    laid out over ``cand``, the queries over ``dp``) against the
    single-device scorer on the same tensors: bit for bit.  Then the call
    as the placer makes it (tile, gather, host copy), timed beside its
    bound: the function's bytes and operations, and for the gather the
    tile read, the matrix written and read once more."""
    from maple_tpu_torch.ops import append_batch as AB
    from maple_tpu_torch.ops import append_pairs as AP
    from maple_tpu_torch.ops.layout import NFIELDS, fields_view
    from maple_tpu_torch.parallel import mesh as TM
    Pstk, Cflat = pool_g.local, q_g.local
    K, N = Cflat.shape[0], Pstk.shape[0]
    dm = TM.replicate_model(mesh, dm)
    prm = torch.stack([torch.full_like(dm.global_tot_rate, blen),
                       torch.ones_like(dm.global_tot_rate),
                       dm.global_tot_rate, dm.tot_error]) \
        .expand(K, 1, 4).contiguous()
    n0 = AP.append_scores_prestacked.launches
    tile_k1 = TM.placement_scores_pallas(mesh, pool_g, q_g, blen, dm)
    one_k1 = AP.append_scores_prestacked(
        Pstk, Cflat, prm, dm.mut_matrix.reshape(1, 1, 16).contiguous(),
        dm.root_freqs.reshape(1, 1, 4).contiguous(),
        uer=dm.using_error_rate)
    check(AP.append_scores_prestacked.launches == n0 + 2,
          "the mesh tile did not launch the pair kernel")
    tile_k8 = TM.placement_scores(mesh, pool_g, q_g, blen, dm)
    one_k8 = AB.grid_append_scores(
        fields_view(Pstk, -2),
        fields_view(Cflat.reshape(K, -1, NFIELDS), -1), blen, True, dm)
    torch.cuda.synchronize()
    for name, tile, one in (("placement_scores_pallas", tile_k1, one_k1),
                            ("placement_scores", tile_k8, one_k8)):
        full = TM.host_fetch(tile)
        check(tile.local.device.type == "cuda" and full.shape == (K, N)
              and np.array_equal(full, one.cpu().numpy(), equal_nan=True)
              and np.array_equal(full, tile.local.cpu().numpy(),
                                 equal_nan=True),
              f"{name}, {what}: the tile differs from the single-device "
              f"scorer")
    print(f"[mesh] {what}: placement_scores_pallas and placement_scores "
          f"tiles ({K}, {N}) equal the single-device scorers bit for bit")
    _, work = pair_bound(Pstk, Cflat)
    out = {}
    for name, scorer in (
            ("placement_scores_pallas", TM.placement_scores_pallas),
            ("placement_scores", TM.placement_scores)):
        ms = median_ms(lambda: TM.host_fetch(
            scorer(mesh, pool_g, q_g, blen, dm)), reps=10)
        t_b = (work["bytes"] + 3 * 4 * K * N) / HBM_BYTES_PER_S
        t_o = work["operations"] / F32_FLOPS
        out[name] = {"ms": ms, "bound_ms": 1e3 * max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "library_ms": None, "shape": {"K": K, "N": N}}
        print(f"[mesh] {name} + host_fetch, tile ({K}, {N}): {ms:.4f} ms "
              f"(median of 10, CUDA events); bound "
              f"{out[name]['bound_ms']:.5f} ms by {out[name]['bound_by']}")
    # the same mesh call with the grid kernel in the pair kernel's place
    # (this script's doing, for the time beside it: no mesh function
    # reaches the grid kernel)
    TM.append_scores_prestacked = AP.append_scores_prestacked_grid
    try:
        grid_ms = median_ms(lambda: TM.host_fetch(TM.placement_scores_pallas(
            mesh, pool_g, q_g, blen, dm)), reps=10)
    finally:
        TM.append_scores_prestacked = AP.append_scores_prestacked
    out["placement_scores_pallas"]["grid_ms"] = grid_ms
    print(f"[mesh] placement_scores_pallas + host_fetch with the grid "
          f"kernel in its place: {grid_ms:.4f} ms")
    return out


@contextlib.contextmanager
def one_rank_mesh(torch):
    """A process group of one NCCL rank and its 1 x 1 (dp x cand) mesh, for
    phases 15 and 17; the group is destroyed on the way out."""
    import torch.distributed as dist
    from maple_tpu_torch.parallel import mesh as TM
    from maple_tpu_torch.parallel.ranks import free_port, init_group
    dev = init_group("nccl", 0, 1, free_port(), timeout=600.0)
    try:
        mesh = TM.make_mesh(device=dev)
        check(dist.get_backend(mesh.group) == "nccl" and mesh.size == 1
              and mesh.shape == {"dp": 1, "cand": 1},
              f"not a 1 x 1 NCCL mesh: {mesh.shape}")
        yield mesh
    finally:
        dist.destroy_process_group()


def phase_mesh(torch, mesh, last, pallas_stage):
    """Phase 15.  Returns the pair kernel's launches of the mesh run, the
    count of mesh scorer calls, and the time of one mesh call of each
    placement scorer beside its bound, at the mesh run's own shape and at
    phase 12's."""
    from maple_tpu_torch import dryrun
    from maple_tpu_torch.ops import append_pairs as AP
    from maple_tpu_torch.parallel import mesh as TM
    from maple_tpu_torch.parallel import batch_spr as BS
    dev = mesh.device
    calls = {"placement_scores_pallas": 0, "spr_screen_scores": 0,
             "host_fetch": 0}
    saved = {name: getattr(TM, name) for name in calls}
    own = []     # the operands of the run's last placement call

    def counting(name):
        def call(*a, **kw):
            calls[name] += 1
            if name == "placement_scores_pallas":
                own[:] = [a[1:]]
            return saved[name](*a, **kw)
        return call

    for name in calls:
        setattr(TM, name, counting(name))
    BS.stats.reset()
    AP.append_scores_prestacked.launches = 0
    t0 = time.perf_counter()
    try:
        with branch_env():
            out = dryrun.dryrun_multichip(
                mesh, input=B3000, use_pallas=True, warmup=256,
                batch_size=64, reference_lk=pallas_stage["lk"],
                placer="legacy")
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(TM, name, fn)
    wall = time.perf_counter() - t0
    launches = AP.append_scores_prestacked.launches
    (st,) = BS.stats.passes
    check(launches > 0 and launches == out["launches"]
          == calls["placement_scores_pallas"],
          f"mesh placement: {launches} launches, "
          f"{calls['placement_scores_pallas']} scorer calls")
    check(st.branch == "mesh" and st.chunks
          == calls["spr_screen_scores"] > 0,
          "the mesh SPR screen did not run on spr_screen_scores")
    check(calls["host_fetch"] >= launches + st.chunks,
          "a tile was read without the gather")
    check(out["placed"] == N_SAMPLES, "mesh: samples not all placed")
    check(out["genome_max_abs_diff"] <= 1e-4, "mesh: genome scorer")
    print(f"[mesh] 1 x 1 mesh over a 1-rank NCCL group on {dev}: "
          f"dryrun_multichip on b3000 in {wall:.2f} s; placement LK "
          f"{out['lk_placement']}, held within {dryrun.PLACEMENT_TOL} of "
          f"the single-device --devicePallas placement's "
          f"{pallas_stage['lk']} (delta "
          f"{out['lk_placement'] - pallas_stage['lk']:.3e}; serial "
          f"{out['lk_serial']}), minors {out['minors']} (single-device "
          f"{pallas_stage['minors']}, serial {out['minors_serial']}); "
          f"{launches} pair-kernel launches in "
          f"{calls['placement_scores_pallas']} mesh scorer calls; SPR "
          f"pass {st.queries} queries x {st.anchors} anchors in "
          f"{st.chunks} chunks (interval algebra), {st.proposals} "
          f"proposals, LK {out['lk_spr']}; genome mesh "
          f"{out['genome_mesh']} max |d| "
          f"{out['genome_max_abs_diff']:.3e}; {calls['host_fetch']} "
          f"gathers")
    print(f"[mesh] SPR pass host collect {st.collect_s:.3f} s, score "
          f"{st.pack_s:.3f} s, decide {st.decide_s:.3f} s, apply "
          f"{st.apply_s:.3f} s")
    # the run's own last placement call (a chunk of queries against
    # the whole pool), then phase 12's last batch
    (pool_g, q_g, blen, dm), = own
    tiles = {"mesh_run": mesh_tiles(torch, mesh, pool_g, q_g, blen, dm,
                                    "the mesh run's last call")}
    Pstk, Cflat = last[0][:2]
    _, _, blen, dm, _ = k8_inputs(torch, last[0])
    tiles["legacy_batch"] = mesh_tiles(
        torch, mesh, TM.put_global(mesh, Pstk, ("cand",)),
        TM.put_global(mesh, Cflat, ("dp",)), blen, dm,
        "phase 12's last batch")
    return launches, sum(calls.values()) - calls["host_fetch"], tiles


def k11_inputs(torch, dev, K=256, D=8192, cap=65536, R=512, F=64, seed=13):
    """One proxy step's operands at the 20,000-sample run's shape (phase
    11: 256 queries against a 65,536 x 8,192 float32 pool), seeded on the
    card: the pool, its valid mask, R changed rows and K queries of F
    features each."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(shape, high):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=torch.int32)

    AF = torch.rand((cap, D), generator=g, device=dev)
    valid = torch.rand(cap, generator=g, device=dev) < 0.9
    arrays = (torch.randperm(cap, generator=g, device=dev)[:R].int(),
              ints((R, F), D), torch.rand((R, F), generator=g, device=dev),
              torch.rand(R, generator=g, device=dev) < 0.9,
              ints((K, F), D), torch.rand((K, F), generator=g, device=dev))
    return AF, valid, arrays


def k11_bound(K, D, cap, R, F, M, cand):
    """The least time for one K11 step on one rank: the local product's
    operations over the float32 rate, or the bytes it must move (the
    slice, its valid mask and the changed rows read and written once, the
    update and query arrays, the local and gathered winners and the
    result, 12 bytes a winner) over the memory rate, whichever is
    larger."""
    rows = cap // cand
    t_ops = 2.0 * K * D * rows / F32_FLOPS
    nbytes = (rows * (4 * D + 1) + R * (4 + 8 * F + 1 + 4 * D + 1)
              + K * 8 * F + 12 * K * M * (2 + cand))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": 2 * K * D * rows}


def phase_mesh_proxy(torch, mesh, f32):
    """Phase 17 (a)-(c), on phase 15's 1 x 1 mesh; K11's numbers on one
    ``[mesh-proxy]`` line of JSON."""
    from maple_tpu_torch import dryrun
    from maple_tpu_torch.ops import append_pairs as AP
    from maple_tpu_torch.parallel import proxy_placer as TP
    import torch.distributed as dist
    dev = mesh.device
    # NCCL makes a group's communicator at its first collective: make the
    # cand group's here, timed, so that the run's steps below do not hold it
    t0 = time.perf_counter()
    x = torch.zeros(1, device=dev)
    dist.all_gather([torch.empty_like(x)], x, group=mesh.axis_groups["cand"])
    torch.cuda.synchronize()
    print(f"[mesh-proxy] the cand group's first collective (its NCCL "
          f"communicator made): {time.perf_counter() - t0:.3f} s")
    # (a) b3000 UNREST, default flags, through the placer over the mesh
    k11, calls = TP.proxy_step_sharded, []

    def counted(*args, **kw):
        calls.append(1)
        return k11(*args, **kw)

    TP.proxy_step_sharded = counted
    AP.append_scores_prestacked.launches = 0
    try:
        run, lk, wall = device_placement(torch, B3000, mesh=mesh,
                                         model="UNREST")
    finally:
        TP.proxy_step_sharded = k11
    pl = run.proxy_placer
    check(pl is not None and pl.pool.mesh is mesh and run.pplacer is None
          and run.legacy_placer is None,
          "mesh-proxy: default flags over the mesh did not take the proxy "
          "placer on the mesh")
    check(len(calls) == pl.steps == f32["steps"] > 0,
          f"mesh-proxy: {len(calls)} K11 steps, the placer counted "
          f"{pl.steps}, phase 10's run {f32['steps']}")
    check(AP.append_scores_prestacked.launches == 0,
          "mesh-proxy: the proxy run launched the pair kernel")
    check(placed_count(run) == N_SAMPLES, "mesh-proxy: not all placed")
    print(f"[mesh-proxy] b3000 UNREST over the 1 x 1 NCCL mesh: LK {lk} "
          f"(phase 10's single-device float32 run {f32['lk']}, delta "
          f"{lk - f32['lk']:.3e}; serial {f32['serial_lk']}, delta "
          f"{lk - f32['serial_lk']:.3e}); minors "
          f"{run.stats.num_minors_found} (single device {f32['minors']}, "
          f"serial {f32['serial_minors']}); {len(calls)} K11 steps "
          f"({f32['steps']} single-device); pool "
          f"{tuple(pl.pool.AF.shape)} of {pl.pool.capacity} rows on "
          f"{pl.pool.AF.device}")
    report_proxy("mesh-proxy", pl, wall, N_SAMPLES)
    check(lk == f32["lk"] and run.stats.num_minors_found == f32["minors"],
          "mesh-proxy: the 1 x 1 mesh run differs from the single-device "
          "run")
    check(abs(lk - f32["serial_lk"]) <= PLACEMENT_LK_TOL
          and run.stats.num_minors_found == f32["serial_minors"],
          "mesh-proxy: the mesh run differs from serial placement")
    del run

    # (b) K11 alone at the 20,000-sample run's shape against proxy_step
    K, D, cap, R, F, M = 256, 8192, 65536, 512, 64, 128
    AF, valid, arrays = k11_inputs(torch, dev, K, D, cap, R, F)
    AF1, valid1 = AF.clone(), valid.clone()
    ts1, ti1 = TP.proxy_step(AF1, valid1, *arrays, topm=M)
    # the updates this rank holds, numbered from its first row: on the
    # 1 x 1 mesh all of them, as they are
    arrays = (*TP.local_updates(mesh, cap, *arrays[:4]), *arrays[4:])
    ts, ti = TP.proxy_step_sharded(mesh, AF, valid, *arrays, topm=M, cap=cap)
    torch.cuda.synchronize()
    check(torch.equal(AF, AF1) and torch.equal(valid, valid1),
          "K11: the pool after the scatter differs from proxy_step's")
    a, b = (np.sort(x.cpu().numpy(), axis=1) for x in (ts, ts1))
    check(np.array_equal(a, b), "K11: sorted top-M scores differ from "
          "proxy_step's")
    rows_equal = bool(torch.equal(ti, ti1))
    del AF1, valid1
    ms = median_ms(lambda: TP.proxy_step_sharded(
        mesh, AF, valid, *arrays, topm=M, cap=cap), reps=10)
    step_ms = median_ms(lambda: TP.proxy_step(AF, valid, *arrays, topm=M),
                        reps=10)
    QF = torch.rand((K, D), device=dev)
    product_ms = median_ms(lambda: QF @ AF.T, reps=10)
    bound = k11_bound(K, D, cap, R, F, M, mesh.shape["cand"])
    report = {"name": "proxy_step_sharded", "route": "torch ops + NCCL",
              "source": "maple_tpu_torch/parallel/proxy_placer.py",
              "replaces": "maple_tpu/parallel/proxy_placer.py:105-154 "
              "(on P('cand', None)); scripts/multihost_screen_worker.py:72-94",
              "steps_b3000": len(calls), "shape": {
                  "K": K, "D": D, "cap": cap, "R": R, "F": F, "M": M,
                  "cand": mesh.shape["cand"]},
              "max_abs_err": float(np.max(np.abs(a - b), initial=0.0,
                                          where=np.isfinite(b))),
              "rows_equal": rows_equal, "ms": ms, "proxy_step_ms": step_ms,
              "library_ms": product_ms, **bound}
    print(f"[mesh-proxy] K11 at K {K}, D {D}, cap {cap}, {R} changed rows, "
          f"top-{M}, 1 x 1 NCCL mesh: sorted scores bitwise equal to "
          f"proxy_step's (rows equal: {rows_equal}); {ms:.4f} ms against "
          f"proxy_step's {step_ms:.4f} ms (median of 10, CUDA events); the "
          f"product alone (torch.matmul) {product_ms:.4f} ms; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}")
    del AF, valid, arrays, QF

    # (c) the dry run with its default placer, the proxy screen's
    t0 = time.perf_counter()
    with branch_env():
        out = dryrun.dryrun_multichip(mesh, input=B3000, warmup=256,
                                      batch_size=64)
    torch.cuda.synchronize()
    check(out["placer"] == "proxy" and out["placed"] == N_SAMPLES,
          "mesh-proxy: the dry run did not place all on the proxy placer")
    check(abs(out["lk_placement"] - out["lk_serial"]) <= PLACEMENT_LK_TOL
          and out["minors"] == out["minors_serial"],
          f"mesh-proxy: the dry run's placement LK {out['lk_placement']} "
          f"differs from serial's {out['lk_serial']}")
    check(out["genome_max_abs_diff"] <= 1e-4, "mesh-proxy: genome scorer")
    print(f"[mesh-proxy] dryrun_multichip(placer='proxy') on b3000 in "
          f"{time.perf_counter() - t0:.2f} s: placement LK "
          f"{out['lk_placement']} (serial {out['lk_serial']}, delta "
          f"{out['lk_placement'] - out['lk_serial']:.3e}), minors "
          f"{out['minors']} (serial {out['minors_serial']}); SPR pass LK "
          f"{out['lk_spr']}; genome mesh max |d| "
          f"{out['genome_max_abs_diff']:.3e}")
    print(f"[mesh-proxy] {json.dumps(report)}")


def phase_tools(torch):
    """Phase 17 (d): the benchmark tools at TOOL_SAMPLES synthetic samples on
    the card (their in-tool assertions raise)."""
    from maple_tpu_torch.tools import benchmark_device as BD
    from maple_tpu_torch.tools import benchmark_multihost as BM
    from maple_tpu_torch.tools import benchmark_spr_recall as BR
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="smoke_tools_") as work:
        t0 = time.perf_counter()
        mh = BM.benchmark(TOOL_SAMPLES, [1], [1], backend="nccl",
                          workdir=work, screen_rows=65536)
        check(mh["lk_identical_across_groups"]
              and np.isfinite(mh["groups"][0]["lk"])
              and mh["screen_strong_scaling"][0]["finite"],
              "benchmark_multihost: no finite result")
        print(f"[tools] benchmark_multihost, 1 NCCL rank, "
              f"{time.perf_counter() - t0:.2f} s: {json.dumps(mh)}")
        t0 = time.perf_counter()
        bd = BD.benchmark(TOOL_SAMPLES, device=dev, workdir=work, spr=True)
        check(bd["placer"] == "proxy" and np.isfinite(bd["device_lk"]),
              "benchmark_device: no proxy placement")
        print(f"[tools] benchmark_device --spr, "
              f"{time.perf_counter() - t0:.2f} s: {json.dumps(bd)}")
        t0 = time.perf_counter()
        br = BR.benchmark(TOOL_SAMPLES, device=dev, workdir=work, cores=4,
                          exact=True)
        check(all(k in br for k in ("serial_pass", "device_screen_pass",
                                    "exact_screen_pass")),
              "benchmark_spr_recall: a pass is missing")
        print(f"[tools] benchmark_spr_recall --exact, "
              f"{time.perf_counter() - t0:.2f} s: {json.dumps(br)}")


def phase_speed_of_light(torch):
    """Phase 16."""
    from maple_tpu_torch.tools import speed_of_light as SOL
    rows = SOL.run_config(8192, 64, 64, 64, 5, torch.device("cuda", 0))
    check([r["kernel"] for r in rows] == ["k1-cuda", "k1-grid", "k8-torch"]
          and all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows),
          "speed_of_light: not its three rows")
    return rows


def phase_torch_op_bounds(torch):
    """The device functions that are torch ops, at the shapes the b3000
    runs give them, on seeded tensors: time (median, CUDA events) beside
    the bound (the larger of bytes over the memory rate and operations
    over the float32 rate).  ``scatter_only`` and ``spr_screen_step`` at
    the proxy SPR pass's shapes (2,602 anchor rows of 192 features into a
    4,096 x 8,192 float32 pool; chunks of 256 queries of 64 features,
    top-128), the legacy pool's row scatter (``index_copy_`` of 64 stacked
    rows, B1 128, into 8,192 rows)."""
    from maple_tpu_torch.parallel import batch_spr as BS
    from maple_tpu_torch.parallel.proxy_features import D, scatter_only
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    def ints(shape, high):
        return torch.randint(0, high, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def report(name, ms, nbytes, flops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        print(f"[bounds] {name}: {ms:.4f} ms (median, CUDA events); bound "
              f"{1e3 * max(t_b, t_o):.5f} ms by "
              f"{'bytes' if t_b >= t_o else 'operations'} ({nbytes} bytes, "
              f"{flops:.3e} operations)")

    cap, R, Fa, K, Fq, topm = 4096, 2602, 192, 256, 64, 128
    AF = torch.zeros((cap, D), device=dev)
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev, dtype=torch.int32)
    fidx, fw = ints((R, Fa), D), torch.rand((R, Fa), generator=g, device=dev)
    ok = torch.ones(R, dtype=torch.bool, device=dev)
    ms = median_ms(lambda: scatter_only(AF, valid, rows, fidx, fw, ok),
                   reps=10)
    report(f"scatter_only, {R} rows x {Fa} features into [{cap}, {D}] f32",
           ms, R * (Fa * 8 + D * 4 + 5 + 1), R * Fa)
    a_tin = ints((cap,), cap)
    q_fidx, q_fw = ints((K, Fq), D), torch.rand((K, Fq), generator=g,
                                                device=dev)
    q_lo = ints((K,), cap)
    excl = ints((K, 2), cap)
    ms = median_ms(lambda: BS.spr_screen_step(
        AF, valid, a_tin, q_fidx, q_fw, q_lo, q_lo + 8, excl, topm=topm),
        reps=10)
    report(f"spr_screen_step, [{K}, {D}] x [{D}, {cap}] f32, top-{topm}", ms,
           cap * (4 * D + 1 + 4) + K * (Fq * 8 + 16 + topm * 12),
           2.0 * K * D * cap)
    R, B1 = 64, 128
    pool = torch.zeros((8192, 16, B1), device=dev)
    idx = torch.arange(0, 2 * R, 2, device=dev)
    new = torch.rand((R, 16, B1), generator=g, device=dev)
    ms = median_ms(lambda: pool.index_copy_(0, idx, new), reps=20)
    report(f"legacy pool row scatter, index_copy_ of {R} rows [16, {B1}] f32",
           ms, R * (2 * 16 * B1 * 4 + 8), 0.0)


def device_events(prof):
    """{name: (count, microseconds)} of the device events (kernels and
    copies on the card) that a torch.profiler run traced."""
    from torch.autograd import DeviceType
    events = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = events.get(e.name, (0, 0.0))
            events[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return events


def phase_profile_spr(torch):
    """``--profile-spr``: torch.profiler (CPU and CUDA activities) around
    one pass of each screen on phase 7's b3000 tree, after a warm-up pass
    of each.  Prints the pass wall (profiled), the device's busy time (the
    traced kernels and copies on the card) and its share of the wall, and
    the heaviest device kernels; for the proxy screen, the products'
    rate."""
    from torch.profiler import ProfilerActivity, profile
    from maple_tpu_torch.parallel.proxy_features import D
    dev = torch.device("cuda")
    for name, exact in (("exact", True), ("proxy", False)):
        spr_pass(torch, dev, B3000, exact)   # warm-up
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        st, _, _, _, wall, _ = spr_pass(torch, dev, B3000, exact,
                                        trace=lambda: prof)
        kernels = device_events(prof)
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


def phase_profile_mesh(torch):
    """``--profile-mesh``: b3000 UNREST placement with default flags on one
    device, then over the 1 x 1 mesh of a 1-rank NCCL group (every step
    through K11), each run three times: to warm up (the ``cand`` group's
    communicator is made there), plain, and under torch.profiler (CPU and
    CUDA activities).  For the plain and the profiled run: the steps, the
    placer's device time between its events (``time_device``), the host
    time spent in the step function on the screen thread (the issue of the
    step's device work); for the profiled run also the device's busy time
    (the kernels and copies traced on the card), by name.  Then K11 and
    ``proxy_step`` alone at phase 17's shape: five alternating rounds of
    CUDA-event medians, and the device events of ten calls of each."""
    from torch.profiler import ProfilerActivity, profile
    from maple_tpu_torch.parallel import proxy_placer as TP
    with one_rank_mesh(torch) as mesh:
        for label, m, name in (("single device", None, "proxy_step"),
                               ("1 x 1 mesh", mesh, "proxy_step_sharded")):
            step, issue = getattr(TP, name), []

            def timed(*a, **kw):
                t0 = time.perf_counter()
                out = step(*a, **kw)
                issue.append(time.perf_counter() - t0)
                return out

            setattr(TP, name, timed)
            try:
                device_placement(torch, B3000, mesh=m, model="UNREST")
                for profiled in (False, True):
                    issue.clear()
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) \
                        if profiled else contextlib.nullcontext()
                    with prof:
                        run, lk, wall = device_placement(
                            torch, B3000, mesh=m, model="UNREST")
                    pl = run.proxy_placer
                    check(pl is not None and pl.steps == len(issue) > 0
                          and (pl.pool.mesh is m),
                          f"profile {label}: the steps did not go through "
                          f"{name}")
                    n = pl.steps
                    print(f"[profile-mesh] {label}"
                          f"{' (profiled)' if profiled else ''}: {n} steps, "
                          f"stage {wall:.4f} s, LK {lk}; time_device "
                          f"{pl.time_device:.4f} s "
                          f"({1e3 * pl.time_device / n:.4f} ms a step); "
                          f"host in {name} {sum(issue):.4f} s "
                          f"({1e3 * sum(issue) / n:.4f} ms a step, max "
                          f"{1e3 * max(issue):.4f} ms); time_screen "
                          f"{pl.time_screen:.4f} s")
                    del run
            finally:
                setattr(TP, name, step)
            kernels = device_events(prof)
            busy = sum(us for _, us in kernels.values()) / 1e6
            check(busy > 0, f"profile {label}: no device time traced")
            print(f"[profile-mesh] {label} (profiled): device busy "
                  f"{busy:.4f} s ({1e3 * busy / n:.4f} ms a step); inside "
                  f"the steps' events and not busy "
                  f"{pl.time_device - busy:.4f} s")
            for kname, (k, us) in sorted(kernels.items(),
                                         key=lambda kv: -kv[1][1])[:10]:
                print(f"[profile-mesh] {label}: {us / 1e3:.4f} ms, {k} "
                      f"launches, {us / k:.2f} us each: {kname[:100]}")
        K, D, cap, R, F, M = 256, 8192, 65536, 512, 64, 128
        AF, valid, arrays = k11_inputs(torch, mesh.device, K, D, cap, R, F)
        steps = {
            "proxy_step": lambda: TP.proxy_step(AF, valid, *arrays, topm=M),
            "proxy_step_sharded": lambda: TP.proxy_step_sharded(
                mesh, AF, valid, *arrays, topm=M, cap=cap)}
        rounds = {name: [] for name in steps}
        for _ in range(5):
            for name, fn in steps.items():
                rounds[name].append(median_ms(fn, reps=10))
        for name, ms in rounds.items():
            print(f"[profile-mesh] {name} at K {K}, D {D}, cap {cap}, {R} "
                  f"changed rows, top-{M}: medians of 10 by CUDA events, "
                  f"five alternating rounds: "
                  f"{', '.join(f'{t:.4f}' for t in ms)} ms")
        for name, fn in steps.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            events = device_events(prof)
            busy = sum(us for _, us in events.values()) / 10
            print(f"[profile-mesh] {name}: device busy {busy / 1e3:.4f} ms "
                  f"a call (ten calls traced)")
            for ename, (k, us) in sorted(events.items(),
                                         key=lambda kv: -kv[1][1]):
                print(f"[profile-mesh] {name}: {us / 10e3:.4f} ms a call, "
                      f"{k / 10:g} launches a call: {ename[:100]}")


def main(argv):
    import torch
    if argv not in ([], ["--profile-spr"], ["--profile-mesh"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import maple_tpu_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    phase_environment(torch)
    resources = phase_build()
    if argv == ["--profile-spr"]:
        phase_profile_spr(torch)
        return 0
    if argv == ["--profile-mesh"]:
        phase_profile_mesh(torch)
        return 0
    launches, run = phase_pipelined_path(torch)
    kern = phase_kernels(torch, run)
    del run
    b3000 = phase_placement_parity(torch)
    runs, by_path = phase_spr_main_path(torch)
    chunk = phase_screen_chunk(torch, phase_spr_parity(torch))
    phase_proxy_main_path(torch)
    f32 = phase_proxy_parity(torch)
    phase_proxy_20k(torch)
    legacy_launches, legacy_label, legacy, last, pallas_stage = \
        phase_legacy(torch, b3000)
    k8 = phase_interval_algebra(torch, last)
    k8_label, k8["calls_legacy_run"] = phase_legacy_default_scorer(
        torch, b3000, pallas_stage)
    with one_rank_mesh(torch) as mesh:
        mesh_launches, k8["mesh_scorer_calls"], tiles = phase_mesh(
            torch, mesh, last, pallas_stage)
        del last
        phase_mesh_proxy(torch, mesh, f32)
    sol = phase_speed_of_light(torch)
    phase_torch_op_bounds(torch)
    phase_tools(torch)
    # every count below is of one run, reset just before it
    by_path["legacy"] = legacy_launches
    by_path["mesh"] = mesh_launches
    check(all(n > 0 for n in by_path.values()),
          f"a path launched no pair kernel: {by_path}")
    runs = {run_label(["--devicePlacement"], MAPLE_DEVICE_RT="1"): launches,
            **runs, legacy_label: legacy_launches, k8_label: 0}
    no_foreign_modules()
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "append_pairs", "route": "cuda",
        "source": "maple_tpu_torch/csrc/append_pairs.cu",
        "replaces": "maple_tpu/ops/pallas_append.py:349",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "launches_by_run": runs,
        "cuda_kernels_a_call": kern["split"]["cuda_kernels_a_call"],
        "yardstick": "maple_tpu_torch/csrc/append_pairs_grid.cu (grid_ms)",
        "resources": resources, **kern, "spr_screen_chunk": chunk,
        "legacy_batch": legacy, "interval_algebra": k8,
        "mesh_tiles": tiles,
        "speed_of_light": sol}]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
