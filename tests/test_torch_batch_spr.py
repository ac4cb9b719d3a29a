"""The port's device SPR screen against the JAX package.

Units on seeded numpy arrays: the anchor-row scatter against JAX
``_scatter_only``, the proxy step against ``_get_spr_screen_step()`` (f32
and bf16 pools) and the exhaustive screen chunk against
``_screen_chunk_impl`` (Pallas interpret, float64).  Passes: one
``device_topology_update`` of each package on two identical trees, each
built by its own package's serial placement on example_sub80, for the
exhaustive screen, the proxy screen and python kernels; the proposals each
package hands to ``apply_spr_moves`` must agree.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import maple_tpu.config
import maple_tpu.pipeline
import maple_tpu.runtime.tree
from maple_tpu.parallel import batch_spr as JB
from maple_tpu.parallel.proxy_placer import _scatter_only

import maple_tpu_torch.config
import maple_tpu_torch.pipeline
import maple_tpu_torch.runtime.tree
from maple_tpu_torch.parallel import batch_spr as TB
from maple_tpu_torch.parallel import proxy_features as TF
from maple_tpu_torch.parallel.proxy_features import scatter_only

from test_torch_append_pairs import (SUB80, pool_and_queries,  # noqa: F401
                                     sub80_tree, x64)

CPU = torch.device("cpu")
REL_F64 = 1e-9      # float64, only the summation order differs
REL_F32 = 1e-6      # float32 products summed in another order
IMPROVEMENT_TOL = 1e-4   # float32 screen scores of the exhaustive screen
LK_TOL = 1e-6
NO_TIN = np.iinfo(np.int32).max


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_only_matches_jax(dtype):
    """Rows densified with repeated feature indices (which add), written
    over live rows; weights are multiples of 1/8 so that every sum is
    exact in any order."""
    rng = np.random.default_rng(1)
    cap, width, R, F = 64, 40, 12, 9
    af = (rng.integers(-16, 17, (cap, width)) / 8).astype(np.float32)
    valid = rng.random(cap) < 0.5
    upd_idx = rng.choice(cap, R, replace=False).astype(np.int32)
    upd_fidx = rng.integers(0, 6, (R, F)).astype(np.int32)  # many repeats
    upd_fw = (rng.integers(-32, 33, (R, F)) / 8).astype(np.float32)
    upd_valid = rng.random(R) < 0.7
    assert any(len(set(r)) < F for r in upd_fidx.tolist())
    j_af, j_valid = _scatter_only(
        jnp.asarray(af).astype(dtype), jnp.asarray(valid),
        jnp.asarray(upd_idx), jnp.asarray(upd_fidx), jnp.asarray(upd_fw),
        jnp.asarray(upd_valid))
    p_af = t(af).to(getattr(torch, dtype))
    p_valid = t(valid)
    scatter_only(p_af, p_valid, t(upd_idx), t(upd_fidx), t(upd_fw),
                 t(upd_valid))
    np.testing.assert_array_equal(p_af.float().numpy(),
                                  np.asarray(j_af.astype(jnp.float32)))
    np.testing.assert_array_equal(p_valid.numpy(), np.asarray(j_valid))


def screen_masks(rng, cap, K, n_live):
    """Anchor Euler entries and per-query intervals and parent/sibling
    rows: some subtrees empty, some holding anchors, one holding all."""
    a_tin = np.full(cap, NO_TIN, dtype=np.int32)
    a_tin[:n_live] = rng.permutation(n_live)
    q_lo = rng.integers(0, n_live, K).astype(np.int32)
    q_hi = (q_lo + rng.integers(0, 12, K)).astype(np.int32)
    q_lo[0], q_hi[0] = 0, NO_TIN          # every anchor in its subtree
    excl = rng.integers(-1, n_live, (K, 2)).astype(np.int32)
    return a_tin, q_lo, q_hi, excl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spr_screen_step_matches_jax(monkeypatch, dtype):
    """A bf16 pool is upcast in row blocks (here 100 rows: three blocks,
    the last ragged)."""
    monkeypatch.setattr(TF, "UPCAST_ROWS", 100)
    rng = np.random.default_rng(2)
    cap, width, K, F, n_live, topm = 256, 96, 24, 10, 200, 40
    af = np.zeros((cap, width), dtype=np.float32)
    for r in range(n_live):  # sparse rows: a bias and a few features
        af[r, 0] = -rng.integers(1, 8)
        cols = rng.choice(np.arange(1, width), rng.integers(1, 9))
        af[r, cols] += rng.random(len(cols)).astype(np.float32) * 2
    valid = np.zeros(cap, dtype=bool)
    valid[:n_live] = rng.random(n_live) < 0.9
    q_fidx = rng.integers(0, width, (K, F)).astype(np.int32)
    q_fw = rng.random((K, F)).astype(np.float32)
    a_tin, q_lo, q_hi, excl = screen_masks(rng, cap, K, n_live)
    step = JB._get_spr_screen_step()
    j_ts, _ = step(jnp.asarray(af).astype(dtype), jnp.asarray(valid),
                   jnp.asarray(a_tin), jnp.asarray(q_fidx),
                   jnp.asarray(q_fw), jnp.asarray(q_lo), jnp.asarray(q_hi),
                   jnp.asarray(excl), topm=topm)
    ts, ti = TB.spr_screen_step(
        t(af).to(getattr(torch, dtype)), t(valid), t(a_tin), t(q_fidx),
        t(q_fw), t(q_lo), t(q_hi), t(excl), topm=topm)
    assert ts.dtype == torch.float32 and ts.shape == (K, topm)
    j_ts = np.asarray(j_ts)
    ts = ts.numpy()
    # top-M score multisets (torch.topk and lax.top_k order ties apart)
    a, b = np.sort(ts, axis=1), np.sort(j_ts, axis=1)
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    assert np.all(np.isneginf(ts[0]))     # query 0 masks every anchor
    fin = ~np.isneginf(b)
    assert fin.sum() > K * topm // 2
    err = np.abs(a[fin] - b[fin]) / np.maximum(1.0, np.abs(b[fin]))
    assert err.max() <= REL_F32
    # the rows returned are live, outside the subtree, not parent/sibling
    for k in range(1, K):
        rows = ti.numpy()[k][np.isfinite(ts[k])]
        assert valid[rows].all()
        assert not ((a_tin[rows] >= q_lo[k]) & (a_tin[rows] < q_hi[k])).any()
        assert not np.isin(rows, excl[k]).any()


def test_spr_screen_step_refuses_reduced_precision(monkeypatch):
    monkeypatch.setattr(torch, "get_float32_matmul_precision",
                        lambda: "high")
    z = torch.zeros(4, 8)
    i = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="full float32"):
        TB.spr_screen_step(z, torch.ones(4, dtype=torch.bool),
                           torch.zeros(4, dtype=torch.int32), i,
                           torch.zeros(2, 3), i[:, 0], i[:, 0], i[:, :2],
                           topm=2)


def test_screen_chunk_matches_jax(x64, sub80_tree):
    """Real sub80 pool rows and query exports in float64.  The best row
    of query 1 lies in its own subtree, of query 2 is its parent, of
    query 3 its sibling; query 4's subtree holds every anchor."""
    run = sub80_tree
    rt = run.rt
    dc = rt.dc
    pool, n, queries, Cflat = pool_and_queries(run)
    K_ = len(queries)
    n_prefix = 128
    rows = pool.rows_host[:pool.capacity]
    valid = pool.valid_host[:pool.capacity].copy()
    prm = np.tile(np.array([dc.oneMutBLen, 1.0, dc.globalTotRate, 0.0]),
                  (K_, 1)).reshape(K_, 1, 4)
    prm[1::2, 0, 1] = 0.0  # internal-node queries (no tip)
    prm[:, 0, 0] *= np.arange(1, K_ + 1)
    mm = np.asarray(rt.model.mut_matrix, dtype=np.float64).reshape(1, 1, 16)
    rf = np.asarray(rt.refd.root_freqs, dtype=np.float64).reshape(1, 1, 4)
    rng = np.random.default_rng(4)
    a_tin = np.full(pool.capacity, NO_TIN, dtype=np.int32)
    a_tin[:n] = rng.permutation(n)
    q_lo = np.full(K_, NO_TIN, dtype=np.int32)   # empty subtrees
    q_hi = np.full(K_, NO_TIN, dtype=np.int32)
    excl = np.full((K_, 2), -1, dtype=np.int32)

    def port(q_lo, q_hi, excl):
        ts, ti = TB.screen_chunk(t(rows), t(valid), t(a_tin), t(Cflat),
                                 t(prm), t(q_lo), t(q_hi), t(excl), t(mm),
                                 t(rf), n_prefix=n_prefix, uer=False)
        return ts.numpy(), ti.numpy()

    _, best = port(q_lo, q_hi, excl)
    best = best[:, 0]
    q_lo[1] = a_tin[best[1]]
    q_hi[1] = q_lo[1] + 1
    excl[2, 0] = best[2]
    excl[3, 1] = best[3]
    q_lo[4], q_hi[4] = 0, NO_TIN
    ts, ti = port(q_lo, q_hi, excl)
    j_ts, j_ti = JB._get_screen_chunk()(
        jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(a_tin),
        jnp.asarray(Cflat), jnp.asarray(prm), jnp.asarray(q_lo),
        jnp.asarray(q_hi), jnp.asarray(excl), jnp.asarray(mm),
        jnp.asarray(rf), n_prefix=n_prefix, uer=False, interpret=True)
    j_ts = np.asarray(j_ts)
    assert ts.shape == j_ts.shape == (K_, 1)
    assert np.array_equal(np.isneginf(ts), np.isneginf(j_ts))
    assert np.isneginf(ts[4, 0]) and np.isfinite(ts[[0, 1, 2, 3], 0]).all()
    fin = ~np.isneginf(j_ts)
    err = np.abs(ts[fin] - j_ts[fin]) / np.maximum(1.0, np.abs(j_ts[fin]))
    assert err.max() <= REL_F64
    for k in (1, 2, 3):  # the mask moved each query off its best row
        assert ti[k, 0] != best[k] and j_ti[k, 0] != best[k]


def serial_tree(tmp_path, pkg, **flags):
    """A serial placement of example_sub80 by package ``pkg`` (maple_tpu
    or maple_tpu_torch), all dirty, and the first SPR round's params."""
    cfg = pkg.config.MapleConfig(input=SUB80, output=str(tmp_path / "ser"),
                                 overwrite=True, **flags)
    run = pkg.pipeline.Run(cfg) if pkg is maple_tpu \
        else pkg.pipeline.Run(cfg, CPU)
    run.load()
    run.build_initial_tree()
    pkg.runtime.tree.set_all_dirty(run.tree, run.root)
    run.rt.recalculate_all(run.root)
    cfg = run.cfg
    params = (cfg.strictTopologyStopRulesInitial,
              cfg.allowedFailsTopologyInitial,
              run.dc.thresholdLogLKtopologyInitial,
              cfg.thresholdTopologyPlacementInitial)
    return run, params


def recording(monkeypatch, module):
    """The proposals ``module`` hands to apply_spr_moves, recorded."""
    seen = []
    apply = module.apply_spr_moves

    def record(rt, proposals, params, counters):
        seen.append(list(proposals))
        return apply(rt, proposals, params, counters)

    monkeypatch.setattr(module, "apply_spr_moves", record)
    return seen


def post_pass_lk(run, new_root):
    root = run.root if new_root is None else new_root
    run.rt.recalculate_all(root)
    return run.rt.calculate_tree_likelihood(root)


@pytest.mark.parametrize("branch", ["exact", "proxy", "python"])
def test_device_topology_pass_matches_jax(tmp_path, monkeypatch, branch):
    monkeypatch.delenv("MAPLE_SPR_EXACT", raising=False)
    if branch == "exact":
        monkeypatch.setenv("MAPLE_SPR_EXACT", "1")
    flags = {"kernel_backend": "python"} if branch == "python" else {}
    j_seen = recording(monkeypatch, JB)
    t_seen = recording(monkeypatch, TB)
    run_j, params = serial_tree(tmp_path, maple_tpu, **flags)
    run_t, _ = serial_tree(tmp_path, maple_tpu_torch, **flags)
    assert run_j.rt.kern.name == ("python" if branch == "python"
                                  else "native")
    root_j, imp_j = JB.device_topology_update(run_j.rt, run_j.root, params)
    TB.stats.reset()
    root_t, imp_t = TB.device_topology_update(run_t.rt, run_t.root, params,
                                              device=CPU)
    (st,) = TB.stats.passes
    assert st.branch == ("proxy" if branch == "proxy" else "exact")
    assert st.queries == len(st.q_nodes) > 50 and st.anchors > 40
    assert st.chunks == -(-st.queries // (TB.PROXY_CHUNK if branch == "proxy"
                                          else TB.EXACT_CHUNK))
    (props_j,), (props_t,) = j_seen, t_seen
    assert st.proposals == len(props_t) > 0
    assert [p[0] for p in props_t] == [p[0] for p in props_j]
    for (_, _, a), (_, _, b) in zip(props_t, props_j):
        assert abs(a - b) <= IMPROVEMENT_TOL * max(1.0, abs(b))
    assert abs(imp_t - imp_j) <= LK_TOL
    assert (root_t is None) == (root_j is None)
    lk_j = post_pass_lk(run_j, root_j)
    lk_t = post_pass_lk(run_t, root_t)
    assert abs(lk_t - lk_j) <= LK_TOL, (lk_t, lk_j)


def test_proxy_chunks_and_scatter_spills(tmp_path, monkeypatch):
    """Small scatter spills and query chunks give the same proposals as
    the defaults (the spill and chunk loops carry no state)."""
    monkeypatch.delenv("MAPLE_SPR_EXACT", raising=False)
    seen = recording(monkeypatch, TB)
    run_a, params = serial_tree(tmp_path, maple_tpu_torch)
    run_b, _ = serial_tree(tmp_path, maple_tpu_torch)
    TB.device_topology_update(run_a.rt, run_a.root, params, device=CPU)
    monkeypatch.setattr(TB, "SCATTER_ROWS", 7)
    TB.stats.reset()
    TB._screen_single_device(run_b.rt, run_b.root, params,
                             TB.SprCounters(), 0.0, device=CPU, chunk=5)
    assert TB.stats.passes[0].chunks == -(-TB.stats.passes[0].queries // 5)
    assert [p[0] for p in seen[0]] == [p[0] for p in seen[1]]
    assert [p[2] for p in seen[0]] == [p[2] for p in seen[1]]
