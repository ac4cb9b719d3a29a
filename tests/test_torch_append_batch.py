"""The port's interval-algebra scorer against the JAX package's.

``maple_tpu_torch.ops.append_batch`` (searchsorted and gather, case factors
on the contributing segments only) against ``maple_tpu.ops.append_batch``
(one-hot contraction, dense case factors) in float64 with x64 on, on the
same packed arrays: one block, the chunked form with a tail that is not a
multiple of the block, per-pair branch lengths and tip flags, the grid
entry points, every model mode, and genome-slice partial sums.  Then
against the port's own pair scorer (the plain version of the CUDA kernel)
in float64 and float32, on random lists and on the stacked anchor rows of
a real tree read through ``fields_view``.
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maple_tpu.ops import append_batch as AB
from maple_tpu.ops import pack as OP

from maple_tpu_torch.ops import append_batch as TAB
from maple_tpu_torch.ops import append_pairs as TAP
from maple_tpu_torch.ops.layout import NFIELDS, fields_view

from test_torch_append_pairs import (MODES, REL_JAX,  # noqa: F401
                                     assert_same_scores, model_for,
                                     pool_and_queries, random_genome_list,
                                     sub80_ref, sub80_tree, x64)
from test_torch_mesh import _rand_list

CPU = torch.device("cpu")
# float32 against float32 of another scorer: other summation order
# (tests/test_mesh_pallas.py:71-72)
F32_RTOL, F32_ATOL = 2e-4, 2e-3


def both(packed, dtype="float64"):
    """One PackedBatch as the JAX dict and as the port's dict."""
    return (AB.to_device(packed, dtype=getattr(jnp, dtype)),
            TAB.to_device(packed, device=CPU, dtype=getattr(torch, dtype)))


def models(model, dc, dtype="float64"):
    return (AB.device_model_from(model, dc, dtype=getattr(jnp, dtype)),
            TAB.device_model_from(model, dc, device=CPU,
                                  dtype=getattr(torch, dtype)))


def packed_lists(refd, uer, seed, n_cands, n_queries):
    rng = np.random.default_rng(seed)
    cands = [random_genome_list(rng, refd.lRef, uer, upper=True)
             for _ in range(n_cands)]
    queries = [random_genome_list(rng, refd.lRef, uer)
               for _ in range(n_queries)]
    B = OP.budget_for(cands + queries)
    return (OP.pack_genome_lists(cands, refd.lRef, B, uer),
            OP.pack_genome_lists(queries, refd.lRef, B, uer))


def jax_args(dm):
    return (dm.mut_matrix, dm.root_freqs, dm.site_rates, dm.error_rates,
            dm.global_tot_rate, dm.tot_error, dm.using_error_rate)


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_block_matches_jax(x64, sub80_ref, model_name, rate_var,
                           error_mode):
    """One dense block: pairwise C [N, B2] with a vector of branch lengths
    and tip flags, and one shared query C [B2] with scalars."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var, error_mode,
                                seed=23)
    uer = model.using_error_rate
    N = 11
    Pp, Qp = packed_lists(refd, uer, 41, N, N)
    (Pj, Pt), (Qj, Qt) = both(Pp), both(Qp)
    dm_j, dm_t = models(model, dc)
    rng = np.random.default_rng(3)
    blens = rng.choice([0.0, 3.3e-5, 1e-4, 7.7e-4], N)
    tips = rng.random(N) < 0.5
    want = np.asarray(AB._append_scores_block(
        Pj, Qj, jnp.asarray(blens), jnp.asarray(tips), *jax_args(dm_j)))
    got = TAB._append_scores_block(
        Pt, Qt, torch.from_numpy(blens), torch.from_numpy(tips),
        *TAB._model_args(dm_t)).numpy()
    assert got.shape == (N,)
    assert_same_scores(got, want, REL_JAX, "pairwise")
    one_j = {k: v[2] for k, v in Qj.items()}
    one_t = {k: v[2] for k, v in Qt.items()}
    want = np.asarray(AB.batched_append_scores(Pj, one_j, 3.3e-5, True,
                                               dm_j))
    got = TAB.batched_append_scores(Pt, one_t, 3.3e-5, True, dm_t).numpy()
    assert_same_scores(got, want, REL_JAX, "one query")


@pytest.mark.parametrize("model_name,rate_var,error_mode",
                         [MODES[0], MODES[3], MODES[4]])
def test_chunked_pairs_match_jax(x64, sub80_ref, monkeypatch, model_name,
                                 rate_var, error_mode):
    """N = 300 pairs: the JAX package maps two blocks of 256 (the second
    padded); the port cuts 300 rows into blocks of 64 with a tail of 44.
    Vector and scalar blen / tips."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var, error_mode,
                                seed=29)
    uer = model.using_error_rate
    N = 300
    Pp, Qp = packed_lists(refd, uer, 43, N, N)
    (Pj, Pt), (Qj, Qt) = both(Pp), both(Qp)
    dm_j, dm_t = models(model, dc)
    S = Pp.budget + Qp.budget
    monkeypatch.setattr(TAB, "_BLOCK_ELEMS", 64 * S)
    rng = np.random.default_rng(5)
    blens = rng.choice([0.0, 3.3e-5, 1e-4, 7.7e-4], N)
    tips = rng.random(N) < 0.5
    for bl, tp in ((blens, tips), (1e-4, True), (blens, False)):
        want = np.asarray(AB.paired_append_scores(Pj, Qj, bl, tp, dm_j))
        got = TAB.paired_append_scores(Pt, Qt, bl, tp, dm_t).numpy()
        assert got.shape == (N,)
        assert_same_scores(got, want, REL_JAX)
    # the blocks carry no state: one block gives the same bits
    whole = TAB._append_scores_block(Pt, Qt, blens, tips,
                                     *TAB._model_args(dm_t)).numpy()
    np.testing.assert_array_equal(
        whole, TAB.paired_append_scores(Pt, Qt, blens, tips, dm_t).numpy())


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_grid_matches_jax(x64, sub80_ref, monkeypatch, model_name, rate_var,
                          error_mode):
    """grid_append_scores and grid_append_scores_var, in one block and cut
    along queries and candidates."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var, error_mode,
                                seed=31)
    uer = model.using_error_rate
    Pp, Qp = packed_lists(refd, uer, 77, 9, 4)
    (Pj, Pt), (Qj, Qt) = both(Pp), both(Qp)
    dm_j, dm_t = models(model, dc)
    blens = np.array([0.0, 3.3e-5, 1e-4, 7.7e-4])
    tips = np.array([True, False, True, False])
    want = np.asarray(AB.grid_append_scores(Pj, Qj, 3.3e-5, True, dm_j))
    want_var = np.asarray(AB.grid_append_scores_var(Pj, Qj, blens, tips,
                                                    dm_j))
    S = Pp.budget + Qp.budget
    for block in (TAB._BLOCK_ELEMS, 2 * 9 * S, 4 * S):
        monkeypatch.setattr(TAB, "_BLOCK_ELEMS", block)
        got = TAB.grid_append_scores(Pt, Qt, 3.3e-5, True, dm_t).numpy()
        assert got.shape == (4, 9)
        assert_same_scores(got, want, REL_JAX, f"grid, block {block}")
        got = TAB.grid_append_scores_var(Pt, Qt, blens, tips, dm_t).numpy()
        assert_same_scores(got, want_var, REL_JAX, f"var, block {block}")


@pytest.mark.parametrize("gen", [2, 3])
def test_genome_slices_add_up(x64, sub80_ref, gen):
    """Partial sums over ``gen`` genome slices (tables cut and padded as
    the mesh scorer cuts them) equal the JAX partial sums slice by slice,
    and add up to the unsharded score."""
    refd, model, dc = model_for(sub80_ref, "UNREST", True, "site", seed=37)
    Pp, Qp = packed_lists(refd, True, 79, 9, 9)
    (Pj, Pt), (Qj, Qt) = both(Pp), both(Qp)
    dm_j, dm_t = models(model, dc)
    lRef = refd.lRef
    span = -(-lRef // gen)
    pad = span * gen - lRef
    sr = np.pad(np.asarray(dm_j.site_rates), (0, pad), constant_values=1.0)
    er = np.pad(np.asarray(dm_j.error_rates), (0, pad))
    total = torch.zeros(9, dtype=torch.float64)
    for g in range(gen):
        cut = slice(g * span, (g + 1) * span)
        want = np.asarray(AB._append_scores_block(
            Pj, Qj, jnp.asarray(1e-4), True, dm_j.mut_matrix,
            dm_j.root_freqs, jnp.asarray(sr[cut]), jnp.asarray(er[cut]),
            dm_j.global_tot_rate, dm_j.tot_error, True,
            gen_offset=g * span))
        part = TAB._append_scores_impl(
            Pt, Qt, 1e-4, True, dm_t.mut_matrix, dm_t.root_freqs,
            torch.from_numpy(sr[cut]), torch.from_numpy(er[cut]),
            dm_t.global_tot_rate, dm_t.tot_error, True,
            gen_offset=g * span)
        assert_same_scores(part.numpy(), want, REL_JAX, f"slice {g}")
        total += part
    whole = TAB.paired_append_scores(Pt, Qt, 1e-4, True, dm_t)
    total = total + 1e-4 * dm_t.global_tot_rate + dm_t.tot_error
    assert_same_scores(total.numpy(), whole.numpy(), REL_JAX)
    assert np.isfinite(whole.numpy()).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model_name,rate_var,error_mode",
                         [MODES[0], MODES[4]])
def test_grid_matches_pair_scorer(sub80_ref, dtype, model_name, rate_var,
                                  error_mode):
    """The two scorer families of the port on the same packed dicts: the
    interval algebra against the pair kernel's plain version."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var, error_mode,
                                seed=53)
    uer = model.using_error_rate
    Pp, Qp = packed_lists(refd, uer, 83, 24, 6)
    Pt = TAB.to_device(Pp, device=CPU, dtype=getattr(torch, dtype))
    Qt = TAB.to_device(Qp, device=CPU, dtype=getattr(torch, dtype))
    dm = TAB.device_model_from(model, dc, device=CPU,
                               dtype=getattr(torch, dtype))
    blens = np.array([0.0, 3.3e-5, 1e-4, 7.7e-4, 1e-4, 0.0])
    tips = np.array([True, False, True, False, True, True])
    k8 = TAB.grid_append_scores_var(Pt, Qt, blens, tips, dm).numpy()
    k1 = TAP.grid_append_scores_var(Pt, Qt, blens, tips, dm).numpy()
    assert k8.dtype == k1.dtype == np.dtype(dtype)
    assert np.array_equal(np.isneginf(k8), np.isneginf(k1))
    fin = np.isfinite(k1)
    assert fin.sum() > 100
    if dtype == "float64":
        assert_same_scores(k8, k1, REL_JAX)
    else:
        np.testing.assert_allclose(k8[fin], k1[fin], rtol=F32_RTOL,
                                   atol=F32_ATOL)


def test_stacked_rows_view_scores_like_pair_scorer(sub80_tree):
    """The bridge from the pools' stacked layout: ``fields_view`` of real
    anchor rows [N, F, B1] and of stacked queries [K, B2, F] are views, and
    the interval algebra on them equals the pair scorer on the stacked
    tensors; zero rows (unassigned pool rows) score like there too."""
    run = sub80_tree
    rt = run.rt
    pool, n, queries, Cflat = pool_and_queries(run)
    rows = torch.from_numpy(pool.rows_host[:n + 3])        # 3 zero rows
    Cstk = torch.from_numpy(Cflat).reshape(len(queries), -1, NFIELDS)
    P, C = fields_view(rows, -2), fields_view(Cstk, -1)
    for name, v in P.items():
        assert v.untyped_storage().data_ptr() == \
            rows.untyped_storage().data_ptr(), name
        assert v.shape[:2] == (n + 3, pool.budget)
    assert C["probs"].shape == (len(queries), Cstk.shape[1], 4)
    dm = TAB.device_model_from(rt.model, rt.dc, device=CPU,
                               dtype=torch.float64)
    k8 = TAB.grid_append_scores(P, C, rt.dc.oneMutBLen, True, dm).numpy()
    K_ = len(queries)
    prm = torch.tensor([rt.dc.oneMutBLen, 1.0, rt.dc.globalTotRate, 0.0],
                       dtype=torch.float64).expand(K_, 1, 4).contiguous()
    k1 = TAP.append_scores_prestacked(
        rows, torch.from_numpy(Cflat), prm,
        dm.mut_matrix.reshape(1, 1, 16), dm.root_freqs.reshape(1, 1, 4),
        uer=False).numpy()
    assert k8.shape == k1.shape == (K_, n + 3)
    assert_same_scores(k8, k1, REL_JAX)
    # a zero row overlaps nothing: only the position-independent term
    np.testing.assert_allclose(k8[:, n:],
                               rt.dc.oneMutBLen * rt.dc.globalTotRate)


def test_pad_and_mesh_list_generator(x64):
    """The 'acgt' lists of the mesh tests (long R runs, point mutations):
    grid scores equal the JAX scorer's in float32 within the mesh tests'
    tolerance, the -inf mask included."""
    from maple_tpu.config import DerivedConfig, MapleConfig
    from maple_tpu.refdata import Model, RefData
    refd = RefData.build("acgt" * 2500, model="GTR")
    model = Model.initial(refd, "GTR")
    dc = DerivedConfig.build(MapleConfig(model="GTR"), refd.lRef)
    rng = random.Random(17)
    cands = [_rand_list(rng, refd.lRef) for _ in range(16)]
    queries = [_rand_list(rng, refd.lRef) for _ in range(4)]
    B = OP.budget_for(cands + queries)
    Pp = OP.pack_genome_lists(cands, refd.lRef, B, False, dtype=np.float32)
    Qp = OP.pack_genome_lists(queries, refd.lRef, B, False,
                              dtype=np.float32)
    (Pj, Pt), (Qj, Qt) = both(Pp, "float32"), both(Qp, "float32")
    dm_j, dm_t = models(model, dc, "float32")
    want = np.asarray(AB.grid_append_scores(Pj, Qj, dc.oneMutBLen, True,
                                            dm_j))
    got = TAB.grid_append_scores(Pt, Qt, dc.oneMutBLen, True, dm_t).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 16)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_speed_of_light_work_model():
    """The tool's work model on CPU tensors: one bound for both scorers
    from the function's packed bytes, the pair kernel's layout bytes beside
    it, and the counts it reports."""
    from maple_tpu_torch.tools import speed_of_light as SOL
    n, k, b1, b2 = 64, 4, 64, 64
    refd, model, dc, P, C = SOL.build_inputs(n, k, b1, b2)
    dm = TAB.device_model_from(model, dc, device=CPU, dtype=torch.float32)
    Pstk = TAP.stack_fields(TAB.to_device(P, device=CPU), dm.site_rates,
                            dm.error_rates, -2)
    Cflat = TAP.stack_fields(TAB.to_device(C, device=CPU), dm.site_rates,
                             dm.error_rates, -1).reshape(k, 1, -1)
    work = SOL.work_model(Pstk, Cflat, refd.lRef)
    live = np.sum((C.types != OP.TYPE_N) & (C.types != OP.TYPE_PAD), axis=-1)
    assert work["b2_active"] == pytest.approx(float(live.mean()))
    assert work["contributing_pairs"] == TAP.count_contributing_pairs(
        Pstk, Cflat) > 0
    assert work["executed_grid"] == round(k * n * b1 * live.mean())
    assert work["bytes"] == 33 * (n * b1 + k * b2) + 8 * refd.lRef + 88 \
        + 4 * k * n
    assert work["layout_bytes"] == 4 * (16 * (n * b1 + k * b2) + 4 * k + 20
                                        + k * n)
    # (at this size the per-site tables, which the layout folds into its
    # planes, outweigh the entries: neither bound is the larger by rule)
    assert work["layout_bound_ms"] > 0 and work["bound_ms"] > 0
    assert work["bound_by"] in ("bytes", "operations")


@pytest.mark.parametrize("module", ["tools.speed_of_light", "dryrun"])
def test_entry_points_want_the_card(module, capsys):
    """With no argument the port's entry points run on the card: without
    one they say so and return non-zero (the CPU must be asked for)."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"maple_tpu_torch.{module}")
    assert mod.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
