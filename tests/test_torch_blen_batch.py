"""The port's batched branch-length optimiser (K10) against the JAX
package's and against the host kernel.

``maple_tpu_torch.ops.blen_batch.batched_optimize_blen`` (golden section on
the port's interval-algebra scorer, torch ops) and
``maple_tpu.ops.blen_batch.batched_optimize_blen`` (the same search on
the JAX scorer) get the same packed arrays, in float64 with x64 on, on the
CPU.  On a flat optimum the two scorers' rounding can step the bracket
apart, so the port's length must equal JAX's within ``4 * sens`` or
score no worse by the host kernel ``append_prob_node``; where the lengths
are equal, so are the scores within 1e-9 relative.  Both are held to the
host kernel's bisection (``estimate_branch_length``) by the criterion of
tests/test_blen_batch.py: the lengths agree to bracket tolerance or the
device point scores at least as well.
"""
import numpy as np
import pytest
import torch

from maple_tpu.core import kernels as K
from maple_tpu.ops import blen_batch as BB
from maple_tpu.ops import pack as OP

from maple_tpu_torch.ops import append_batch as TAB
from maple_tpu_torch.ops import blen_batch as TBB

from test_torch_append_batch import both, models
from test_torch_append_pairs import (MODES, model_for,  # noqa: F401
                                     random_genome_list, sub80_ref, x64)

REL_JAX = 1e-9           # float64 scores of two scorers (summation order)
HOST_LK_TOL = 1e-7       # tests/test_blen_batch.py:83
PORT_LK_TOL = 1e-9       # the port's length against JAX's, by the host


def random_pairs(refd, uer, seed, n):
    """``n`` (upper, lower, tip) triples from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [(random_genome_list(rng, refd.lRef, uer, upper=True),
             random_genome_list(rng, refd.lRef, uer), bool(rng.random() < 0.5))
            for _ in range(n)]


def contradicting_pairs(refd, seed, n):
    """Pairs that score -inf at t = 0 without the error model: the upper
    vector and the child each hold a different nucleotide, with no branch
    length, at one or two positions of an otherwise reference genome."""
    rng = np.random.default_rng(seed)
    lRef, out = refd.lRef, []
    for i in range(n):
        positions = np.sort(rng.choice(np.arange(2, lRef), 1 + i % 2,
                                       replace=False)).tolist()
        up, low, pos = [], [], 1
        for p in positions:
            ref = int(rng.integers(0, 4))
            a, b = rng.choice([x for x in range(4) if x != ref], 2,
                              replace=False).tolist()
            if p > pos:
                up.append((4, p - 1))
                low.append((4, p - 1))
            up.append((a, ref))
            low.append((b, ref))
            pos = p + 1
        up.append((4, lRef))
        low.append((4, lRef))
        out.append((up, low, bool(i % 2)))
    return out


def run_both(refd, model, dc, triples, tips=None):
    """The same packed pairs through both packages' K10: (JAX t, JAX
    score, port t, port score), numpy float64."""
    uer = model.using_error_rate
    uppers = [u for u, _, _ in triples]
    lowers = [c for _, c, _ in triples]
    B = OP.budget_for(uppers + lowers)
    (Pj, Pt), (Cj, Ct) = (both(OP.pack_genome_lists(v, refd.lRef, B, uer))
                          for v in (uppers, lowers))
    dm_j, dm_t = models(model, dc)
    if tips is None:
        tips = np.array([tp for _, _, tp in triples])
    sens = dc.minBLenSensitivity
    tj, sj = BB.batched_optimize_blen(Pj, Cj, tips, dm_j, sens)
    tt, st = TBB.batched_optimize_blen(Pt, Ct, tips, dm_t, sens)
    assert tt.dtype == st.dtype == torch.float64
    assert tt.shape == st.shape == (len(triples),)
    return (np.asarray(tj), np.asarray(sj), tt.numpy(), st.numpy())


def check_against_jax_and_host(ctx, triples, tips, tj, sj, tt, st, sens):
    """The criteria of the module docstring; returns how many host optima
    are interior."""
    same = tt == tj
    err = np.abs(st[same] - sj[same]) / np.maximum(1.0, np.abs(sj[same]))
    assert np.array_equal(np.isneginf(st[same]), np.isneginf(sj[same]))
    fin = np.isfinite(sj[same])
    assert err[fin].size == 0 or err[fin].max() <= REL_JAX, err.max()
    interior = 0
    for i, (up, low, _) in enumerate(triples):
        tip = bool(tips if np.ndim(tips) == 0 else tips[i])
        lk_port = K.append_prob_node(ctx, up, low, tip, float(tt[i]))
        if abs(tt[i] - tj[i]) >= 4 * sens:
            lk_jax = K.append_prob_node(ctx, up, low, tip, float(tj[i]))
            assert lk_port >= lk_jax - PORT_LK_TOL, \
                (i, float(tj[i]), float(tt[i]), lk_jax, lk_port)
        t_host = K.estimate_branch_length(ctx, up, low, tip)
        t_host = 0.0 if t_host is False else t_host
        lk_host = K.append_prob_node(ctx, up, low, tip, t_host)
        for t_dev in (tt[i], tj[i]):
            lk_dev = K.append_prob_node(ctx, up, low, tip, float(t_dev))
            assert (abs(t_dev - t_host) < 4 * sens
                    or lk_dev >= lk_host - HOST_LK_TOL), \
                (i, t_host, float(t_dev), lk_host, lk_dev)
        interior += t_host not in (0.0, BB.T_MAX)
    return interior


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_blen_matches_jax_and_host(x64, sub80_ref, model_name, rate_var,
                                   error_mode):
    """24 random pairs, half of them tips, under every model mode."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var, error_mode,
                                seed=37)
    triples = random_pairs(refd, model.using_error_rate, 53, 24)
    tips = np.array([tp for _, _, tp in triples])
    assert 0 < tips.sum() < len(tips)
    out = run_both(refd, model, dc, triples)
    ctx = K.KernelCtx(refd, model, dc)
    interior = check_against_jax_and_host(ctx, triples, tips, *out,
                                          dc.minBLenSensitivity)
    assert interior >= 3


def test_blen_chunked_scorer(x64, sub80_ref, monkeypatch):
    """K8's chunked path: blocks of 8 pairs, with a tail of 3."""
    refd, model, dc = model_for(sub80_ref, *MODES[3], seed=41)
    triples = random_pairs(refd, model.using_error_rate, 59, 19)
    uppers = [u for u, _, _ in triples]
    lowers = [c for _, c, _ in triples]
    S = 2 * OP.budget_for(uppers + lowers)
    monkeypatch.setattr(TAB, "_BLOCK_ELEMS", 8 * S)
    tips = np.array([tp for _, _, tp in triples])
    out = run_both(refd, model, dc, triples)
    ctx = K.KernelCtx(refd, model, dc)
    assert check_against_jax_and_host(ctx, triples, tips, *out,
                                      dc.minBLenSensitivity) >= 3


@pytest.mark.parametrize("model_name,rate_var,error_mode",
                         [MODES[0], MODES[2]])
def test_blen_minus_inf_at_zero(x64, sub80_ref, model_name, rate_var,
                                error_mode):
    """Pairs whose score is -inf at t = 0 (a nucleotide against another,
    no length between them), mixed with random pairs."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var, error_mode,
                                seed=43)
    triples = contradicting_pairs(refd, 61, 8) \
        + random_pairs(refd, False, 67, 8)
    tips = np.array([tp for _, _, tp in triples])
    uppers = [u for u, _, _ in triples]
    lowers = [c for _, c, _ in triples]
    B = OP.budget_for(uppers + lowers)
    _, Pt = both(OP.pack_genome_lists(uppers, refd.lRef, B, False))
    _, Ct = both(OP.pack_genome_lists(lowers, refd.lRef, B, False))
    _, dm_t = models(model, dc)
    at_zero = TAB.paired_append_scores(Pt, Ct, 0.0, tips, dm_t).numpy()
    assert np.isneginf(at_zero[:8]).all()
    tj, sj, tt, st = run_both(refd, model, dc, triples)
    assert (tt[:8] > 0).all() and np.isfinite(st[:8]).all()
    ctx = K.KernelCtx(refd, model, dc)
    check_against_jax_and_host(ctx, triples, tips, tj, sj, tt, st,
                               dc.minBLenSensitivity)


def test_blen_scalar_tips(x64, sub80_ref):
    """One tip flag for every pair (a scalar), with the error model, where
    the flag changes the score."""
    refd, model, dc = model_for(sub80_ref, *MODES[4], seed=47)
    triples = random_pairs(refd, model.using_error_rate, 71, 16)
    out = run_both(refd, model, dc, triples, tips=True)
    ctx = K.KernelCtx(refd, model, dc)
    assert check_against_jax_and_host(ctx, triples, True, *out,
                                      dc.minBLenSensitivity) >= 3


def test_iteration_count_matches_jax():
    """31 iterations at lRef 29,903 (36 scorer calls a call), and the
    same count as JAX's at other precisions."""
    assert TBB._iters_for(0.001 / 29903) == 31
    for sens in (1e-3, 1e-5, 3.3e-8, 1e-12):
        assert TBB._iters_for(sens) == BB._iters_for(sens)
    assert TBB.T_MAX == BB.T_MAX


def test_paired_work_model_is_the_grid_diagonal(sub80_ref):
    """K10's bound counts the contributing entry pairs of each (upper i,
    child i) pair: the diagonal of the grid count, 36 scorer calls a call."""
    from maple_tpu_torch.ops import append_pairs as TAP
    from maple_tpu_torch.tools.speed_of_light import (PAIR_FLOPS,
                                                      paired_work_model)
    refd, model, dc = model_for(sub80_ref, *MODES[0], seed=37)
    triples = random_pairs(refd, False, 73, 12)
    uppers = [u for u, _, _ in triples]
    lowers = [c for _, c, _ in triples]
    B = OP.budget_for(uppers + lowers)
    _, Pt = both(OP.pack_genome_lists(uppers, refd.lRef, B, False))
    _, Ct = both(OP.pack_genome_lists(lowers, refd.lRef, B, False))
    _, dm = models(model, dc)
    Pstk = TAP.stack_fields(Pt, dm.site_rates, dm.error_rates, -2)
    Cstk = TAP.stack_fields(Ct, dm.site_rates, dm.error_rates, -2)
    Cflat = TAP.stack_fields(Ct, dm.site_rates, dm.error_rates, -1)
    diagonal = [TAP.count_contributing_pairs(
        Pstk[i:i + 1], Cflat[i].reshape(1, 1, -1)) for i in range(12)]
    assert min(diagonal) > 0
    calls = TBB._iters_for(dc.minBLenSensitivity) + 5
    work = paired_work_model(Pstk, Cstk, refd.lRef, calls)
    assert work["contributing_pairs"] == sum(diagonal)
    assert work["operations"] == calls * sum(diagonal) * PAIR_FLOPS
    assert work["bytes"] == (9 + 6 * 8) * 12 * 2 * B + 12 \
        + 8 * (2 * refd.lRef + 22 + 24)
    assert work["bound_ms"] > 0 and work["bound_by"] in ("bytes",
                                                         "operations")
