"""The merge walk of the pair kernel, on the CPU.

``csrc/append_walk.cuh`` holds the per-(query, candidate) walk and the
per-pair factor that the CUDA kernel runs; ``csrc/append_walk_host.cpp``
loops the same functions over (query, candidate) on the same operand
layout, and ``ops/_build.py`` builds it with g++.  Here its scores are held
against the port's plain PyTorch version and against the JAX package's
Pallas kernel in interpret mode (float64, x64 on), on numpy-seeded random
lists under every model mode, on rows written to trip a walk, and on real
pool rows; its step counts are held to O(B1 + B2).  Only tests call the
loop: a CPU tensor given to the wrapper still takes the plain version.
"""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maple_tpu.ops import pallas_append as PA

from maple_tpu_torch.ops import _build
from maple_tpu_torch.ops import append_batch as TAB
from maple_tpu_torch.ops import append_pairs as TAP
from maple_tpu_torch.ops import pack as TOP
from maple_tpu_torch.ops.layout import (F_END, F_PREV, F_TYPE, NFIELDS)

from test_torch_append_pairs import (MODES, REL_JAX, SUB80,  # noqa: F401
                                     assert_same_scores, model_for,
                                     pool_and_queries, random_genome_list,
                                     sub80_ref, sub80_tree, x64)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "maple_tpu_torch")
# float64 walk against float64 plain: the same terms in the same order,
# products rounded once in both (g++ -ffp-contract=off, torch on the CPU)
REL_F64 = 1e-9
# float32 walk against float64 plain
REL_F32 = 1e-4


def host_walk(P, C, prm, mm, rf, *, uer, dtype=np.float64):
    """The host loop on stacked operands (numpy, any float type): scores
    [K, N] in ``dtype``, steps and contributing pairs of every walk
    [K, N], and the rows' entry counts [N], [K]."""
    lib = _build.host_walk()
    fn = lib.append_walk_host_f64 if dtype == np.float64 \
        else lib.append_walk_host_f32
    arrays = [np.ascontiguousarray(a, dtype=dtype)
              for a in (P, C, prm, mm, rf)]
    N, F, B1 = arrays[0].shape
    K = arrays[1].shape[0]
    B2 = arrays[1].shape[-1] // NFIELDS
    assert F == NFIELDS
    out = np.empty((K, N), dtype=dtype)
    steps = np.empty((K, N), dtype=np.int64)
    pairs = np.empty((K, N), dtype=np.int64)
    n_p = np.empty(N, dtype=np.int32)
    n_c = np.empty(K, dtype=np.int32)
    rc = fn(*(a.ctypes.data for a in arrays), out.ctypes.data,
            steps.ctypes.data, pairs.ctypes.data, n_p.ctypes.data,
            n_c.ctypes.data, N, K, B1, B2, int(uer))
    assert rc == 0
    return out, steps, pairs, n_p, n_c


def operands(cands, queries, lRef, B1, B2, blens, tips, model, dc):
    """Stacked float64 operands (numpy) of hand-made or random genome
    lists, through the port's own packing and stacking."""
    uer = model.using_error_rate
    dm = TAB.device_model_from(model, dc, device=CPU, dtype=torch.float64)
    Pp = TOP.pack_genome_lists(cands, lRef, B1, uer)
    Qp = TOP.pack_genome_lists(queries, lRef, B2, uer)
    Pstk = TAP.stack_fields(TAB.to_device(Pp, device=CPU,
                                          dtype=torch.float64),
                            dm.site_rates, dm.error_rates, -2)
    Cstk = TAP.stack_fields(TAB.to_device(Qp, device=CPU,
                                          dtype=torch.float64),
                            dm.site_rates, dm.error_rates, -1)
    K = len(queries)
    prm = np.stack([np.broadcast_to(np.asarray(blens, np.float64), (K,)),
                    np.broadcast_to(np.asarray(tips, np.float64), (K,)),
                    np.full(K, float(dm.global_tot_rate)),
                    np.full(K, float(dm.tot_error))], -1).reshape(K, 1, 4)
    return (Pstk.numpy(), Cstk.reshape(K, 1, B2 * NFIELDS).numpy(), prm,
            dm.mut_matrix.reshape(1, 1, 16).numpy(),
            dm.root_freqs.reshape(1, 1, 4).numpy())


def plain_scores(ops, uer):
    return TAP.append_scores_prestacked_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in ops),
        uer=uer).numpy()


def pallas_scores(ops, uer):
    """The JAX package's kernel in interpret mode, the candidates padded to
    its 128 lanes with copies of row 0."""
    P = ops[0]
    n = P.shape[0]
    pad = (-n) % 128
    P = np.concatenate([P, np.repeat(P[:1], pad, axis=0)])
    out = PA.pallas_scores_prestacked(
        jnp.asarray(P), *(jnp.asarray(a) for a in ops[1:]), uer=uer,
        interpret=True)
    return np.asarray(out)[:, :n]


def check_walk(ops, uer, *, pallas=True, what=""):
    """The walk in float64 against plain (and Pallas), in float32 against
    plain float64; the O(B1 + B2) bound on every walk.  Returns (scores,
    steps, pairs)."""
    ref = plain_scores(ops, uer)
    w64, steps, pairs, n_p, n_c = host_walk(*ops, uer=uer)
    assert_same_scores(w64, ref, REL_F64, f"{what} f64 vs plain")
    if pallas:
        assert_same_scores(w64, pallas_scores(ops, uer), REL_JAX,
                           f"{what} f64 vs pallas")
    w32 = host_walk(*ops, uer=uer, dtype=np.float32)[0]
    assert w32.dtype == np.float32
    assert_same_scores(w32, ref, REL_F32, f"{what} f32 vs plain")
    assert np.all(steps <= np.maximum(n_c[:, None] + n_p[None, :] - 1, 0))
    return w64, steps, pairs


def contributing_pairs(ops):
    """[K, N] counts of contributing entry pairs, by numpy on the whole
    B1 x B2 grid (the definition, independent of any walk)."""
    P, C = ops[0], ops[1]
    K = C.shape[0]
    C = C.reshape(K, -1, NFIELDS)
    tP, eP, pP = P[:, F_TYPE], P[:, F_END], P[:, F_PREV]       # [N, B1]
    tC, eC, pC = C[..., F_TYPE], C[..., F_END], C[..., F_PREV]  # [K, B2]

    def live(t):
        return (t != TOP.TYPE_N) & (t != TOP.TYPE_PAD)

    def g(p, c):  # [K, N, B1, B2]
        return p[None, :, :, None], c[:, None, None, :]
    a, b = g(eP, eC)
    lo_a, lo_b = g(pP, pC)
    tp, tc = g(tP, tC)
    lp, lc = g(live(tP), live(tC))
    ok = (np.minimum(a, b) - np.maximum(lo_a, lo_b) > 0.5) & lp & lc \
        & ~((tp == TOP.TYPE_R) & (tc == TOP.TYPE_R)) \
        & ~((tp < 3.5) & (tp == tc))
    return ok.sum((2, 3))


# ----------------------------------------------------------------------
# random lists under every model mode

@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_walk_matches_plain_and_pallas(x64, sub80_ref, model_name, rate_var,
                                       error_mode):
    refd, model, dc = model_for(sub80_ref, model_name, rate_var, error_mode,
                                seed=29)
    uer = model.using_error_rate
    rng = np.random.default_rng(43)
    cands = [random_genome_list(rng, refd.lRef, uer, upper=True)
             for _ in range(13)]
    queries = [random_genome_list(rng, refd.lRef, uer) for _ in range(4)]
    B = TOP.budget_for(cands + queries)
    ops = operands(cands, queries, refd.lRef, B, B,
                   [0.0, 3.3e-5, 1e-4, 7.7e-4], [1, 0, 1, 0], model, dc)
    _, _, pairs = check_walk(ops, uer, what=model_name)
    assert pairs.sum() > 50
    np.testing.assert_array_equal(pairs, contributing_pairs(ops))


# ----------------------------------------------------------------------
# rows written to trip a walk

def _mutations(lRef, positions, nuc_of=lambda p: (p % 3 + 1, 0), tail=True):
    """R runs with a nucleotide entry (nuc, ref) at each position."""
    out, pos = [], 0
    for p in positions:
        if p - 1 > pos:
            out.append((4, p - 1))
        out.append(nuc_of(p))
        pos = p
    if tail and pos < lRef:
        out.append((4, lRef))
    return out


def _special_rows(case, lRef, rng):
    """(candidates, queries, B1, B2) of one case."""
    vec = [0.6, 0.3, 0.05, 0.05]
    base_c = _mutations(lRef, [100, 2000, 15000])
    base_q = _mutations(lRef, [100, 2500, 15000],
                        nuc_of=lambda p: ((p % 3 + 2) % 4, 0))
    if case == "single_R":
        return [[(4, lRef)], base_c], [[(4, lRef)], base_q], 24, 128
    if case == "full_budget":
        # both lists fill their budgets to the last slot: no PAD entry
        c = _mutations(lRef, [int(x) for x in
                              np.linspace(50, lRef, 12).round()], tail=False)
        q = _mutations(lRef, [int(x) for x in
                              np.linspace(70, lRef, 64).round()], tail=False,
                       nuc_of=lambda p: ((p % 3 + 2) % 4, 0))
        assert len(c) == 24 and len(q) == 128
        return [c, base_c], [q, base_q], 24, 128
    if case == "n_runs":
        # N runs at the start, in the middle and at the end of either list,
        # with the other list's mutations inside and beside them
        c = [(5, 30), (4, 499), (1, 0), (4, 900), (5, 1000), (4, 1100),
             (6, 2, vec), (4, lRef - 40), (5, lRef)]
        q = [(5, 10), (2, 0), (4, 499), (3, 0), (4, 949), (2, 0), (4, 1050),
             (5, 1200), (4, lRef - 60), (1, 0), (4, lRef - 20), (5, lRef)]
        return [c, base_c, q], [q, base_q, c[:6] + [(4, lRef)]], 24, 128
    if case == "ties":
        # both lists end an entry at 100, 101, 200, 230 and lRef
        c = [(4, 100), (1, 0), (4, 200), (5, 230), (4, 5000), (2, 0, 1e-4),
             (4, lRef)]
        q = [(4, 100), (3, 0), (4, 200), (6, 1, vec), (4, 230), (4, 5000),
             (3, 0), (4, lRef)]
        return [c, q, base_c], [q, c[:3] + [(4, lRef)], base_q], 24, 128
    if case == "k1":
        return ([random_genome_list(rng, lRef, False, upper=True,
                                    max_entries=10) for _ in range(7)],
                [random_genome_list(rng, lRef, False)], 24, 128)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["single_R", "full_budget", "n_runs",
                                  "ties", "k1"])
def test_walk_special_rows(x64, sub80_ref, case):
    refd, model, dc = model_for(sub80_ref, "GTR", True, "none", seed=7)
    rng = np.random.default_rng(3)
    cands, queries, B1, B2 = _special_rows(case, refd.lRef, rng)
    K = len(queries)
    ops = operands(cands, queries, refd.lRef, B1, B2,
                   np.linspace(0.0, 2e-4, K), np.arange(K) % 2, model, dc)
    scores, steps, pairs = check_walk(ops, False, what=case)
    assert scores.shape == (K, len(cands))
    np.testing.assert_array_equal(pairs, contributing_pairs(ops))
    if case == "single_R":   # R against R: one step, nothing to add
        assert steps[0, 0] == 1 and pairs[0, 0] == 0
        assert scores[0, 0] == ops[2][0, 0, 0] * ops[2][0, 0, 2]
    if case == "full_budget":
        _, _, _, n_p, n_c = host_walk(*ops, uer=False)
        assert n_p[0] == B1 and n_c[0] == B2


def test_walk_zero_and_stale_rows(x64, sub80_ref):
    """A pool prefix as a run holds it: live rows, rows that were never
    written (all zero: type 0, end 0) and a row that still holds a list it
    held before.  A row of zeros overlaps nothing and scores blen * rate;
    the walk stays inside it."""
    refd, model, dc = model_for(sub80_ref, "GTR", False, "global", seed=11)
    rng = np.random.default_rng(17)
    cands = [random_genome_list(rng, refd.lRef, True, upper=True)
             for _ in range(6)]
    queries = [random_genome_list(rng, refd.lRef, True) for _ in range(3)]
    B1 = 40
    P, C, prm, mm, rf = operands(cands, queries, refd.lRef, B1, 128,
                                 [1e-4, 0.0, 3e-5], [1, 1, 0], model, dc)
    P = np.concatenate([P[:2], np.zeros_like(P[:1]), P[2:4],
                        np.zeros_like(P[:2]), P[4:]])
    zero_rows = [2, 5, 6]
    ops = (P, C, prm, mm, rf)
    scores, steps, pairs = check_walk(ops, True, what="zero rows")
    want = prm[:, 0, 0] * prm[:, 0, 2] + prm[:, 0, 1] * prm[:, 0, 3]
    for n in zero_rows:
        np.testing.assert_array_equal(scores[:, n], want)
        assert np.all(pairs[:, n] == 0) and np.all(steps[:, n] == B1)
    np.testing.assert_array_equal(pairs, contributing_pairs(ops))


@pytest.mark.parametrize("B1", [24, 96, 216])
@pytest.mark.parametrize("B2", [128, 256, 512])
def test_walk_budgets(x64, sub80_ref, B1, B2):
    """The budgets of the snug ladder and the doubled query budgets; the
    Pallas kernel beside the plain version on the diagonal."""
    refd, model, dc = model_for(sub80_ref, "UNREST", True, "site", seed=5)
    rng = np.random.default_rng(B1 * 1000 + B2)
    cands = [random_genome_list(rng, refd.lRef, True, upper=True,
                                max_entries=B1 // 2 - 2) for _ in range(5)]
    queries = [random_genome_list(rng, refd.lRef, True,
                                  max_entries=min(B2 // 2 - 2, 100))
               for _ in range(2)]
    ops = operands(cands, queries, refd.lRef, B1, B2, [5e-5, 0.0], [1, 0],
                   model, dc)
    diagonal = (B1, B2) in ((24, 128), (96, 256), (216, 512))
    _, _, pairs = check_walk(ops, True, pallas=diagonal,
                             what=f"B1={B1} B2={B2}")
    np.testing.assert_array_equal(pairs, contributing_pairs(ops))


def test_walk_real_pool_rows(x64, sub80_tree):
    """Real anchor rows and query exports of a tree built serially on
    example_sub80, the pool's unused rows (all zero) included."""
    rt = sub80_tree.rt
    pool, n, queries, Cflat = pool_and_queries(sub80_tree)
    Npad = -(-n // 128) * 128
    assert n > 20 and Npad > n
    K = len(queries)
    prm = np.tile(np.array([rt.dc.oneMutBLen, 1.0, rt.dc.globalTotRate,
                            0.0]), (K, 1)).reshape(K, 1, 4)
    mm = np.asarray(rt.model.mut_matrix, dtype=np.float64).reshape(1, 1, 16)
    rf = np.asarray(rt.refd.root_freqs, dtype=np.float64).reshape(1, 1, 4)
    ops = (pool.rows_host[:Npad], Cflat, prm, mm, rf)
    assert not ops[0][n:].any()      # the unused rows of the prefix
    _, steps, pairs = check_walk(ops, False, what="sub80 pool")
    assert int(pairs.sum()) == TAP.count_contributing_pairs(
        torch.from_numpy(ops[0]), torch.from_numpy(Cflat))


def test_walk_steps_are_linear_and_pairs_are_counted(sub80_ref):
    """The O(B1 + B2) claim: every walk takes at most L1 + L2 steps, L the
    entries of a list up to its last one that is no PAD, where the grid has
    B1 x B2 cells; and the pairs it evaluates are the contributing pairs of
    ``count_contributing_pairs``, no more and no fewer."""
    refd, model, dc = model_for(sub80_ref, "GTR", False, "none", seed=1)
    rng = np.random.default_rng(101)
    cands = [random_genome_list(rng, refd.lRef, False, upper=True,
                                max_entries=int(m))
             for m in rng.integers(0, 60, 40)]
    queries = [random_genome_list(rng, refd.lRef, False, max_entries=int(m))
               for m in rng.integers(0, 40, 6)]
    B1, B2 = 216, 128
    ops = operands(cands, queries, refd.lRef, B1, B2, 1e-4, 1, model, dc)
    _, steps, pairs, n_p, n_c = host_walk(*ops, uer=False)
    L1 = np.array([len(c) for c in cands])
    L2 = np.array([len(q) for q in queries])
    np.testing.assert_array_equal(n_p, L1)
    np.testing.assert_array_equal(n_c, L2)
    assert np.all(steps <= L2[:, None] + L1[None, :])
    assert np.all(steps >= np.maximum(L2[:, None], L1[None, :]))
    assert steps.max() < B1 + B2 < B1 * B2
    np.testing.assert_array_equal(pairs, contributing_pairs(ops))
    assert int(pairs.sum()) == TAP.count_contributing_pairs(
        torch.from_numpy(ops[0]), torch.from_numpy(ops[1]))


# ----------------------------------------------------------------------
# guards

def _port_sources(*relative):
    for rel in relative:
        path = os.path.join(PORT, rel)
        if os.path.isfile(path):
            yield path
        for root, _, files in os.walk(path):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def test_host_loop_is_on_no_path():
    """No placer, screen, mesh, pipeline or command-line module names the
    walk's host loop."""
    scanned = list(_port_sources("parallel", "pipeline.py", "dryrun.py",
                                 "cli.py", "__main__.py", "search",
                                 "runtime", "native"))
    assert len(scanned) > 10
    for path in scanned:
        with open(path) as f:
            text = f.read()
        for name in ("host_walk", "append_walk_host"):
            assert name not in text, f"{path} names {name}"
    # the wrapper itself reaches the walk kernel only
    import inspect
    src = inspect.getsource(TAP.append_scores_prestacked)
    assert "host_walk" not in src


def test_every_c_function_has_its_argtypes():
    """ctypes cuts an undeclared pointer to 32 bits: every extern "C"
    function of csrc/ is declared in ops/_build.py with as many argument
    types as the C function has parameters."""
    declared = {**_build._KERNEL_FUNCTIONS, **_build._HOST_FUNCTIONS}
    found = {}
    for name in sorted(os.listdir(_build.CSRC)):
        if not name.endswith((".cu", ".cpp")):
            continue
        with open(os.path.join(_build.CSRC, name)) as f:
            text = f.read()
        block = text[text.index('extern "C" {'):]
        for m in re.finditer(r"^[\w \*]+?\b(\w+)\(([^)]*)\)\s*\{", block,
                             re.M):
            found[m.group(1)] = len([p for p in m.group(2).split(",")
                                     if p.strip()])
    assert set(found) == set(declared), (sorted(found), sorted(declared))
    for name, n_params in found.items():
        argtypes, _ = declared[name]
        assert len(argtypes) == n_params, name
    bound = _build.host_walk()
    for name in _build._HOST_FUNCTIONS:
        fn = getattr(bound, name)
        assert fn.argtypes[0] is ctypes.c_void_p
        assert list(fn.argtypes) == _build._HOST_FUNCTIONS[name][0]
