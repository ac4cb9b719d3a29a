"""The port's proxy-screen placement against the JAX package.

Units: ``proxy_step`` against JAX ``_proxy_step`` from one pool state (f32
and bf16 pools, the default and the fast feature width), the feature-space
helpers and ``ProxyPool.assign_rows`` against their twins, and the feature
export of the port's engine copy against maple_tpu's on the same tree.
Placement: the port's proxy branch on example_sub80 and on the 3,000-sample
B.1.429 subset against serial placement (the exact-parity contract of
tests/test_proxy_placer.py) and against maple_tpu's own proxy placement.
Each side builds its tree with its own package from the same file.
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maple_tpu.parallel import proxy_placer as JP

from maple_tpu_torch.parallel import proxy_features as TF
from maple_tpu_torch.parallel import proxy_placer as TP

HERE = os.path.dirname(os.path.abspath(__file__))
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
B3000 = os.path.join(HERE, "data_b1429_3000.maple.gz")
CPU = torch.device("cpu")
LK_TOL = 1e-6       # the proxy path's exact-parity contract
REL_F32 = 1e-5      # float32 products of a float32 pool, other sum order
REL_BF16 = 1e-6     # bf16-rounded inputs, float32 products and sums
PROXY_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
             "MAPLE_PROXY_D")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in PROXY_ENV:
        monkeypatch.delenv(name, raising=False)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def pkg(name):
    """The modules of one package that build a run."""
    return {m: importlib.import_module(f"{name}.{m}") for m in
            ("config", "pipeline", "native.engine", "runtime.partials",
             "runtime.tree")}


def make_run(name, tmp_path, **flags):
    p = pkg(name)
    cfg = p["config"].MapleConfig(output=str(tmp_path / name),
                                  overwrite=True, **flags)
    run = p["pipeline"].Run(cfg) if name == "maple_tpu" \
        else p["pipeline"].Run(cfg, CPU)
    run.load()
    return run


def placement_lk(run):
    run.rt.recalculate_all(run.root)
    return run.rt.calculate_tree_likelihood(run.root)


# ----------------------------------------------------------------------
# units

def step_inputs(rng, pool_j, eighths, R=40, K=24, Fa=20, Fq=30):
    """A live pool state and one step's arrays.  ``eighths``: weights are
    small multiples of 1/8, exact in bf16 and in any summation order."""
    cap, D = pool_j.capacity, pool_j.D

    def weights(shape):
        if eighths:
            return (rng.integers(-16, 17, shape) / 8).astype(np.float32)
        return (rng.random(shape) * 4 - 2).astype(np.float32)

    n_live = 700
    af = np.zeros((cap, D), dtype=np.float32)
    for r in range(n_live):
        cols = rng.choice(np.arange(1, D), rng.integers(1, 12))
        af[r, cols] = weights(len(cols))
        af[r, 0] = -float(len(cols))
    valid = np.zeros(cap, dtype=bool)
    valid[:n_live] = rng.random(n_live) < 0.9
    upd_idx = rng.choice(n_live + 30, R, replace=False).astype(np.int32)
    upd_fidx = rng.integers(0, D, (R, Fa)).astype(np.int32)
    upd_fidx[:, 1] = upd_fidx[:, 0]              # repeats add up
    upd_fw = weights((R, Fa))
    upd_valid = rng.random(R) < 0.8
    q_fidx = rng.integers(0, D, (K, Fq)).astype(np.int32)
    q_fidx[:, :8] = rng.integers(1, 40, (K, 8))  # shared low buckets
    af[:n_live, 1:40] = weights((n_live, 39)) * (rng.random((n_live, 39))
                                                 < 0.2)
    q_fw = weights((K, Fq))
    return af, valid, (upd_idx, upd_fidx, upd_fw, upd_valid, q_fidx, q_fw)


@pytest.mark.parametrize("eighths", [True, False], ids=["eighths", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", [False, True], ids=["D8192", "D2048"])
def test_proxy_step_matches_jax(monkeypatch, fast, dtype, eighths):
    """Both packages' pools start from one state (``pool_from_numpy``) and
    take one step on the same arrays."""
    if dtype == "bfloat16":
        monkeypatch.setenv("MAPLE_PROXY_BF16", "1")
    monkeypatch.setattr(TF, "UPCAST_ROWS", 300)   # four blocks, one ragged
    rng = np.random.default_rng(7)
    pool_j = JP.ProxyPool(900, fast=fast)
    assert pool_j.capacity == 1024 and pool_j.D == (2048 if fast else 8192)
    assert pool_j.AF.dtype == jnp.dtype(dtype)
    af, valid, arrays = step_inputs(rng, pool_j, eighths)
    nodes = rng.permutation(5000)[:700]
    assert pool_j.assign_rows(nodes) is not None
    pool_j.AF = jnp.asarray(af).astype(pool_j.AF.dtype)
    pool_j.valid = jnp.asarray(valid)
    pool_t = TP.pool_from_numpy(
        np.asarray(pool_j.AF.astype(jnp.float32)), np.asarray(pool_j.valid),
        pool_j.row_of, pool_j.node_arr, device=CPU,
        dtype=getattr(torch, dtype), d_hash=pool_j.d_hash,
        g_buckets=pool_j.g_buckets)
    assert pool_t.capacity == 1024 and pool_t.D == pool_j.D
    assert pool_t.row_of == pool_j.row_of
    topm = 48
    j_af, j_valid, j_ts, j_ti = JP._proxy_step(
        pool_j.AF, pool_j.valid, *(jnp.asarray(a) for a in arrays),
        topm=topm)
    ts, ti = TP.proxy_step(pool_t.AF, pool_t.valid, *(t(a) for a in arrays),
                           topm=topm)
    # the scatter: exactly the same pool afterwards
    np.testing.assert_array_equal(pool_t.AF.float().numpy(),
                                  np.asarray(j_af.astype(jnp.float32)))
    np.testing.assert_array_equal(pool_t.valid.numpy(), np.asarray(j_valid))
    assert ts.dtype == torch.float32 and ts.shape == (24, topm)
    ts, j_ts = ts.numpy(), np.asarray(j_ts)
    # top-M score multisets (torch.topk and lax.top_k order ties apart)
    a, b = np.sort(ts, axis=1), np.sort(j_ts, axis=1)
    assert np.isfinite(b).all()
    if eighths:
        np.testing.assert_array_equal(a, b)
    else:
        rel = REL_F32 if dtype == "float32" else REL_BF16
        err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
        assert err.max() <= rel
    # the rows returned are valid rows carrying the returned scores
    valid_after = pool_t.valid.numpy()
    assert valid_after[ti.numpy()].all()
    # both pools go on assigning the same rows
    more = np.arange(6000, 6040)
    np.testing.assert_array_equal(pool_t.assign_rows(more),
                                  pool_j.assign_rows(more))
    np.testing.assert_array_equal(pool_t.node_arr, pool_j.node_arr)


def test_proxy_step_without_updates_and_small_pool():
    """No changed row scatters nothing; topm is cut to the pool size."""
    af = torch.zeros(8, 16)
    af[:, 0] = torch.arange(8.0)
    valid = torch.ones(8, dtype=torch.bool)
    valid[7] = False
    none = torch.zeros((0, 4))
    ts, ti = TP.proxy_step(af, valid, none[:, 0].int(), none.int(), none,
                           none[:, 0].bool(), torch.zeros((2, 3)).int(),
                           torch.ones(2, 3), topm=64)
    assert ts.shape == (2, 8)
    assert ti[:, 0].tolist() == [6, 6] and ts[:, 0].tolist() == [18.0, 18.0]
    assert np.isneginf(ts[:, -1].numpy()).all() and ti[:, -1].tolist() == [7, 7]


@pytest.mark.parametrize("cap,fast,env", [
    (1024, False, None), (1 << 19, False, None), (1 << 20, False, None),
    (1 << 21, False, None), (1024, True, None), (1 << 20, True, None),
    (1024, False, "4096"), (1024, True, "1024")])
def test_feature_dims_match_jax(monkeypatch, cap, fast, env):
    if env:
        monkeypatch.setenv("MAPLE_PROXY_D", env)
    assert TF.feature_dims(cap, fast) == JP.feature_dims(cap, fast)


def test_feature_constants_and_buckets_match_jax():
    for name in ("D_HASH", "G_BUCKETS", "D", "FMAX_ANCHOR", "FMAX_QUERY",
                 "_F_BUCKETS"):
        assert getattr(TF, name) == getattr(JP, name), name
    for fmax in (192, 384, 448, 896):
        for nf in range(0, 900, 7):
            assert TF._f_bucket(nf, fmax) == JP._f_bucket(nf, fmax)


@pytest.mark.parametrize("expected,cap", [(10, 1024), (1025, 2048),
                                          (6064, 8192)])
def test_pool_shape_and_dtype_match_jax(monkeypatch, expected, cap):
    for bf16 in (False, True):
        if bf16:
            monkeypatch.setenv("MAPLE_PROXY_BF16", "1")
        for fast in (False, True):
            pj = JP.ProxyPool(expected, fast=fast)
            pt = TP.ProxyPool(expected, CPU, fast=fast)
            assert pt.capacity == pj.capacity == cap
            assert tuple(pt.AF.shape) == tuple(pj.AF.shape)
            assert str(pt.AF.dtype).split(".")[1] == str(pj.AF.dtype)
            assert pt.AF.dtype == (torch.bfloat16 if bf16
                                   else torch.float32)
    forced = TP.ProxyPool(10, CPU, force_bf16=True)
    assert forced.AF.dtype == torch.bfloat16
    full = TP.ProxyPool(10, CPU)
    assert full.assign_rows(np.arange(1024)) is not None
    assert full.assign_rows(np.array([5000])) is None   # capacity exhausted


def test_assign_rows_matches_jax():
    rng = np.random.default_rng(3)
    pj, pt = JP.ProxyPool(3000), TP.ProxyPool(3000, CPU)
    for _ in range(6):
        nodes = rng.integers(0, 2500, 400)
        np.testing.assert_array_equal(pt.assign_rows(nodes),
                                      pj.assign_rows(nodes))
    assert pt.row_of == pj.row_of
    np.testing.assert_array_equal(pt.node_arr, pj.node_arr)


def engine_after(name, tmp_path, n_placed):
    """An engine of package ``name`` with the first ``n_placed`` samples of
    example_sub80 placed; also the run and the remaining samples."""
    p = pkg(name)
    run = make_run(name, tmp_path, input=SUB80, model="GTR")
    distances = run.sorted_distances()
    _, first = distances.pop()
    tree = p["runtime.tree"].PhyloTree(use_hnz=False)
    tree.add_node()
    tree.name[-1] = 0
    run.tree = tree
    run.rt = p["runtime.partials"].TreeRuntime(tree, run.refd, run.model,
                                               run.dc, run.cfg)
    eng = p["native.engine"].NativePlacementEngine(run.rt, run.data[first])
    num = 1
    while distances and num < n_placed:
        _, s = distances.pop()
        eng.place(run.data[s], num)
        num += 1
    return run, eng, distances


def test_feature_export_matches_maple_tpu(tmp_path):
    """The port's engine copy (its own build of the native library) exports
    the features maple_tpu's does, anchors and queries, fingerprints
    included."""
    out = {}
    for name in ("maple_tpu", "maple_tpu_torch"):
        run, eng, distances = engine_after(name, tmp_path, 50)
        n_nodes = int(eng.lib.engine_node_count(eng.h))
        nodes = np.arange(n_nodes, dtype=np.int32)
        first = eng.export_feats(nodes, TF.D_HASH, TF.G_BUCKETS,
                                 TF.FMAX_ANCHOR, use_fp=True)
        again = eng.export_feats(nodes, TF.D_HASH, TF.G_BUCKETS,
                                 TF.FMAX_ANCHOR, use_fp=True)
        rest = [run.data[s] for _, s in distances]
        vids = eng.terminal_vids_batch(rest)
        q = eng.export_query_feats(vids, 1984, 64, TF.FMAX_QUERY)
        out[name] = (n_nodes, first, again, q)
    (n_j, first_j, again_j, q_j), (n_t, first_t, again_t, q_t) = \
        out["maple_tpu"], out["maple_tpu_torch"]
    assert n_j == n_t > 40
    idx_j, w_j, valid_j, nf_j, skip_j = first_j
    idx_t, w_t, valid_t, nf_t, skip_t = first_t
    assert nf_j == nf_t and valid_t.sum() > 10 and not skip_t.any()
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_array_equal(idx_t[valid_t], idx_j[valid_j])
    np.testing.assert_array_equal(w_t[valid_t], w_j[valid_j])
    # unchanged rows are skipped on the second export, on both sides
    np.testing.assert_array_equal(again_t[4], again_j[4])
    assert again_t[4][valid_t].all()
    for a, b in zip(q_t, q_j):
        np.testing.assert_array_equal(a, b)


def test_query_features_cover_mutations(tmp_path):
    """Every concrete mutation in a query emits a hash feature
    (tests/test_proxy_placer.py:48-89 on the port's engine)."""
    run, eng, _ = engine_after("maple_tpu_torch", tmp_path, 1)
    letters = "acgt"
    m1 = letters[(run.refd.ref_indices[99] + 1) % 4]
    m2 = letters[(run.refd.ref_indices[28999] + 1) % 4]
    diffs = [(m1, 100), ("n", 2000, 500), (m2, 29000)]
    vid = eng.terminal_vid(diffs)
    idx, w, max_nf = eng.export_query_feats(
        np.asarray([vid], np.int64), TF.D_HASH, TF.G_BUCKETS, TF.FMAX_QUERY)
    live = w[0] != 0
    li, lw = idx[0][live], w[0][live]
    assert li[0] == 0 and lw[0] == 1.0                       # bias
    muts = [(i, x) for i, x in zip(li, lw) if 1 <= i < TF.D_HASH]
    assert len(muts) == 2 and all(x == 2.0 for _, x in muts)
    cov = [(i, x) for i, x in zip(li, lw) if i >= TF.D_HASH]
    width = run.refd.lRef / TF.G_BUCKETS
    assert sum(x for _, x in cov) == pytest.approx(500 / width, rel=0.1)


def test_anchor_features_match_query(tmp_path):
    """A placed clade's anchor rows share hash buckets with a query that
    carries the same mutations: through ``proxy_step`` the best row scores
    above the bias-only level (tests/test_proxy_placer.py:92-137)."""
    run, eng, distances = engine_after("maple_tpu_torch", tmp_path, 60)
    n_nodes = int(eng.lib.engine_node_count(eng.h))
    nodes = np.arange(n_nodes, dtype=np.int32)
    aidx, aw, avalid, _, _ = eng.export_feats(nodes, TF.D_HASH, TF.G_BUCKETS,
                                              TF.FMAX_ANCHOR)
    assert avalid.sum() > 10
    pool = TP.ProxyPool(n_nodes, CPU)
    rows = pool.assign_rows(nodes)
    _, s = distances.pop()
    vid = eng.terminal_vid(run.data[s])
    qidx, qw, _ = eng.export_query_feats(
        np.asarray([vid], np.int64), TF.D_HASH, TF.G_BUCKETS, TF.FMAX_QUERY)
    ts, ti = TP.proxy_step(pool.AF, pool.valid, t(rows), t(aidx), t(aw),
                           t(avalid), t(qidx), t(qw), topm=4)
    assert float(ts[0, 0]) > 0.5
    assert avalid[pool.node_arr[int(ti[0, 0])]]


# ----------------------------------------------------------------------
# placement

def proxy_placement(name, tmp_path, path, **flags):
    run = make_run(name, tmp_path, input=path, device_placement=True,
                   **flags)
    run.build_initial_tree_device(warmup=run.cfg.device_warmup)
    return run, placement_lk(run)


def serial_placement(name, tmp_path, path, **flags):
    run = make_run(name, tmp_path, input=path, **flags)
    run.build_initial_tree()
    return run, placement_lk(run)


SMALL = dict(device_warmup=16, device_proxy_batch=32)


@pytest.mark.parametrize("model", ["GTR", "UNREST"])
def test_proxy_placement_matches_serial_and_jax(tmp_path, model):
    run, lk = proxy_placement("maple_tpu_torch", tmp_path, SUB80,
                              model=model, **SMALL)
    placer = run.proxy_placer
    assert run.rt.kern.name == "native"
    assert placer.steps == 2 and placer.pool.AF.dtype == torch.float32
    assert placer.pool.AF.shape == (1024, 8192) and placer.topm == 128
    ser, ser_lk = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                                   model=model)
    jax_run, jax_lk = proxy_placement("maple_tpu", tmp_path, SUB80,
                                      model=model, **SMALL)
    assert abs(lk - ser_lk) <= LK_TOL, (lk, ser_lk)
    assert abs(lk - jax_lk) <= LK_TOL, (lk, jax_lk)
    assert run.stats.num_minors_found == ser.stats.num_minors_found \
        == jax_run.stats.num_minors_found
    assert len(run.names_in_tree) == 80


def test_proxy_placement_bf16_pool(tmp_path, monkeypatch):
    """MAPLE_PROXY_BF16: a bf16 pool and the deepened seed list."""
    monkeypatch.setenv("MAPLE_PROXY_BF16", "1")
    run, lk = proxy_placement("maple_tpu_torch", tmp_path, SUB80,
                              model="UNREST", **SMALL)
    assert run.proxy_placer.pool.AF.dtype == torch.bfloat16
    assert run.proxy_placer.topm == 192
    ser, ser_lk = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                                   model="UNREST")
    jax_run, jax_lk = proxy_placement("maple_tpu", tmp_path, SUB80,
                                      model="UNREST", **SMALL)
    assert jax_run.proxy_placer.pool.AF.dtype == jnp.bfloat16
    assert abs(lk - ser_lk) <= LK_TOL and abs(lk - jax_lk) <= LK_TOL
    assert run.stats.num_minors_found == ser.stats.num_minors_found \
        == jax_run.stats.num_minors_found


def test_proxy_placement_fast_contract(tmp_path):
    """cfg.fast: D 2048, a bf16 pool, 32 seeds, seed budget 16.  The port's
    top-k is exact where maple_tpu's is approximate under this contract, a
    difference in recall only; on this input the two placements agree to
    LK_TOL."""
    run, lk = proxy_placement("maple_tpu_torch", tmp_path, SUB80,
                              model="GTR", fast=True, device_warmup=16,
                              device_proxy_batch=32)
    placer = run.proxy_placer
    assert placer.pool.AF.dtype == torch.bfloat16
    assert placer.pool.AF.shape == (1024, 2048)
    assert placer.topm == 32 and placer.seed_budget == 16
    assert run.cfg.placementBudget == 200
    jax_run, jax_lk = proxy_placement("maple_tpu", tmp_path, SUB80,
                                      model="GTR", fast=True,
                                      device_warmup=16,
                                      device_proxy_batch=32)
    assert abs(lk - jax_lk) <= LK_TOL, (lk, jax_lk)
    assert run.stats.num_minors_found == jax_run.stats.num_minors_found


def test_feature_budget_doubles_on_saturation(tmp_path, monkeypatch):
    """A budget below the widest row is detected through the export's
    largest count and doubled until no row is cut; the placement is
    unchanged."""
    monkeypatch.setattr(TP, "FMAX_ANCHOR", 4)
    monkeypatch.setattr(TP, "FMAX_QUERY", 4)
    run, lk = proxy_placement("maple_tpu_torch", tmp_path, SUB80,
                              model="GTR", **SMALL)
    assert run.proxy_placer.fmax_anchor > 4
    assert run.proxy_placer.fmax_query > 4
    _, ser_lk = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                                 model="GTR")
    assert abs(lk - ser_lk) <= LK_TOL


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_proxy_placement_b3000_matches_serial(tmp_path, monkeypatch, bf16):
    """Default knobs on the real 3,000-sample data, where near-ties are
    frequent (tests/test_proxy_placer.py:174-224)."""
    if bf16:
        monkeypatch.setenv("MAPLE_PROXY_BF16", "1")
    run, lk = proxy_placement("maple_tpu_torch", tmp_path, B3000,
                              model="UNREST")
    placer = run.proxy_placer
    assert placer.pool.AF.dtype == (torch.bfloat16 if bf16
                                    else torch.float32)
    assert placer.pool.AF.shape == (8192, 8192)
    assert placer.steps == -(-(3000 - 256) // 256)
    ser, ser_lk = serial_placement("maple_tpu_torch", tmp_path, B3000,
                                   model="UNREST")
    assert abs(lk - ser_lk) <= LK_TOL, (lk, ser_lk)
    assert run.stats.num_minors_found == ser.stats.num_minors_found
    assert len(run.names_in_tree) == 3000
