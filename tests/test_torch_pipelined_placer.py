"""The port's pipelined device placer against the JAX package.

``fused_step`` is held against JAX ``_fused_step`` in interpret mode
(float64) on the same pool, update and query arrays; the whole pipelined
placement (``MAPLE_DEVICE_RT=1``) on the CPU is held against maple_tpu's
serial placement, the contract of tests/test_device_placement.py:149-182.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maple_tpu.config import MapleConfig
from maple_tpu.parallel import pipelined_placer as JPP
from maple_tpu.pipeline import Run as SerialRun

from maple_tpu_torch.config import MapleConfig as PortConfig
from maple_tpu_torch.ops.layout import F_END, F_EPS, F_FLAG, F_TYPE
from maple_tpu_torch.parallel import pipelined_placer as PP
from maple_tpu_torch.parallel import stacked_pool as SP
from maple_tpu_torch.pipeline import Run

from test_torch_append_pairs import (SUB80, pool_and_queries,  # noqa: F401
                                     sub80_tree, x64)

CPU = torch.device("cpu")
REL_JAX = 1e-9        # float64, only the summation order differs
PLACEMENT_TOL = 1e-6  # placement-stage LK vs serial


def with_error_model(rows, cstk, prm, lRef, seed):
    """Seeded eps planes, flags on live entries and totError."""
    rng = np.random.default_rng(seed)
    err = rng.random(lRef) * 4e-4
    rows, cstk, prm = rows.copy(), cstk.copy(), prm.copy()
    for fld in (lambda i: rows[:, i, :], lambda i: cstk[..., i]):
        pos = np.maximum(fld(F_END).astype(np.int64) - 1, 0)
        fld(F_EPS)[...] = err[pos]
        live = fld(F_TYPE) < 5
        fld(F_FLAG)[...] = live & (rng.random(live.shape) < 0.3)
    prm[:, 0, 3] = -err.sum()
    return rows, cstk, prm


@pytest.mark.parametrize("uer", [False, True])
def test_fused_step_matches_jax(x64, sub80_tree, uer):
    run = sub80_tree
    rt = run.rt
    dc = rt.dc
    pool, n, queries, Cflat = pool_and_queries(run)
    rows = pool.rows_host
    K_ = len(queries)
    prm = np.tile(np.array([dc.oneMutBLen, 1.0, dc.globalTotRate, 0.0]),
                  (K_, 1)).reshape(K_, 1, 4)
    if uer:
        rows, Cflat, prm = with_error_model(rows, Cflat, prm,
                                            rt.refd.lRef, seed=11)
    valid = pool.valid_host.copy()
    rng = np.random.default_rng(3)
    # scatter: rewrite some live rows with other rows' content, append two
    # rows past the live prefix, invalidate two
    upd_idx = np.array([1, 5, n - 1, n, n + 1, 9, 17], dtype=np.int64)
    upd_rows = rows[rng.choice(n, len(upd_idx), replace=False)].copy()
    upd_valid = np.array([True, True, True, True, True, False, False])
    mm = np.asarray(rt.model.mut_matrix, dtype=np.float64).reshape(1, 1, 16)
    rf = np.asarray(rt.refd.root_freqs, dtype=np.float64).reshape(1, 1, 4)
    n_prefix, topk = 128, 40
    j_pool, j_valid, j_ts, _ = JPP._fused_step(
        jnp.asarray(rows), jnp.asarray(valid),
        jnp.asarray(upd_idx.astype(np.int32)), jnp.asarray(upd_rows),
        jnp.asarray(upd_valid), jnp.asarray(Cflat), jnp.asarray(prm),
        jnp.asarray(mm), jnp.asarray(rf), n_prefix=n_prefix, uer=uer,
        topk=topk, interpret=True)
    t = torch.from_numpy
    t_pool, t_valid = t(rows.copy()), t(valid.copy())
    ts, ti = PP.fused_step(t_pool, t_valid, t(upd_idx), t(upd_rows),
                           t(upd_valid), t(Cflat), t(prm), t(mm), t(rf),
                           n_prefix=n_prefix, uer=uer, topk=topk)
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(j_pool))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    j_ts = np.asarray(j_ts)
    ts = ts.numpy()
    assert ts.shape == j_ts.shape == (K_, topk)
    # top-k score multisets (tie order differs between torch.topk and
    # lax.top_k): sorted rows, -inf in the same places
    a, b = np.sort(ts, axis=1), np.sort(j_ts, axis=1)
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    fin = ~np.isneginf(b)
    assert fin.sum() > K_ * 20
    err = np.abs(a[fin] - b[fin]) / np.maximum(1.0, np.abs(b[fin]))
    assert err.max() <= REL_JAX
    # the returned rows carry the returned scores
    t_valid_np = t_valid.numpy()
    assert np.all(t_valid_np[ti.numpy()[np.isfinite(ts)]])


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


@pytest.fixture(scope="module")
def serial_sub80(tmp_path_factory):
    out = tmp_path_factory.mktemp("ser") / "ser"
    run = SerialRun(MapleConfig(input=SUB80, output=str(out), model="GTR",
                                overwrite=True))
    run.load()
    run.build_initial_tree()
    run.rt.recalculate_all(run.root)
    return run, run.rt.calculate_tree_likelihood(run.root)


def run_port(tmp_path, warmup=16, batch_size=16):
    cfg = PortConfig(input=SUB80, output=str(tmp_path / "dev"),
                     model="GTR", overwrite=True, device_placement=True)
    run = Run(cfg, CPU)
    run.load()
    run.build_initial_tree_device(warmup=warmup, batch_size=batch_size)
    run.rt.recalculate_all(run.root)
    return run, run.rt.calculate_tree_likelihood(run.root)


def assert_matches_serial(run_d, lk_d, serial):
    run_s, lk_s = serial
    assert placed_count(run_d) == placed_count(run_s) == 80
    assert run_d.stats.num_minors_found == run_s.stats.num_minors_found
    assert abs(lk_d - lk_s) <= PLACEMENT_TOL, (lk_d, lk_s)


def test_pipelined_placement_matches_serial(tmp_path, monkeypatch,
                                            serial_sub80):
    monkeypatch.setenv("MAPLE_DEVICE_RT", "1")
    run_d, lk_d = run_port(tmp_path)
    assert run_d.pplacer is not None and run_d.pplacer.n_total == 80
    assert_matches_serial(run_d, lk_d, serial_sub80)


def test_pipelined_placement_scatter_and_rebuild(tmp_path, monkeypatch,
                                                 serial_sub80):
    """Both pool sync paths: incremental row scatters, then a run where
    every batch forces a full rebuild."""
    monkeypatch.setenv("MAPLE_DEVICE_RT", "1")
    orig = PP.StackedDevicePool.make_update
    counts = {"scatter": 0, "rebuild": 0}

    def counting(self, changed):
        upd = orig(self, changed)
        if upd is None:
            counts["rebuild"] += 1
        elif len(upd[0]):
            counts["scatter"] += 1
        return upd

    monkeypatch.setattr(PP.StackedDevicePool, "make_update", counting)
    run_d, lk_d = run_port(tmp_path)
    assert counts["scatter"] > 0, "incremental scatter never exercised"
    assert_matches_serial(run_d, lk_d, serial_sub80)

    rebuilds = [0]
    orig_rebuild = PP.StackedDevicePool.full_rebuild

    def counting_rebuild(self):
        rebuilds[0] += 1
        return orig_rebuild(self)

    monkeypatch.setattr(PP.StackedDevicePool, "make_update",
                        lambda self, changed: None)
    monkeypatch.setattr(PP.StackedDevicePool, "full_rebuild",
                        counting_rebuild)
    run_r, lk_r = run_port(tmp_path)
    assert rebuilds[0] == -(-(80 - 16) // 16)  # one per batch
    assert_matches_serial(run_r, lk_r, serial_sub80)


def test_make_update_rebuilds_past_row_limit(sub80_tree, monkeypatch):
    """More changed rows than REBUILD_ROWS asks for a full rebuild."""
    pool = PP.StackedDevicePool(sub80_tree.rt, CPU)
    n = pool.full_rebuild()
    nodes = [int(x) for x in pool.node_arr[:n]]
    assert pool.make_update(nodes) is not None
    monkeypatch.setattr(SP, "REBUILD_ROWS", n - 1)
    assert pool.make_update(nodes) is None
