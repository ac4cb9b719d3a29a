"""The port's legacy batch placer (``MAPLE_DEVICE_LEGACY=1``, with and
without ``--devicePallas``) against the JAX package.

The anchor pool on the device against maple_tpu's ``DeviceTreePool`` on the
same tree (refresh and incremental update), ``batched_append_scores``
against ``pallas_batched_append_scores`` (Pallas interpret, float64), and
the placement on example_sub80 against serial placement, the contract of
tests/test_device_placement.py:115-146, and against maple_tpu's own legacy
``--devicePallas`` run (:185-203).  Each side builds its tree with its own
package.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from maple_tpu.ops import append_batch as AB
from maple_tpu.ops import pack as OP
from maple_tpu.ops import pallas_append as PA
from maple_tpu.parallel import batch_placement as JBP

from maple_tpu_torch.ops import append_batch as TAB
from maple_tpu_torch.ops import append_pairs as TAP
from maple_tpu_torch.ops.layout import stack_fields_host
from maple_tpu_torch.parallel import batch_placement as TBP

from test_torch_append_pairs import (REL_JAX, SUB80,  # noqa: F401
                                     assert_same_scores, pool_and_queries,
                                     sub80_tree, x64)
from test_torch_pipelined_placer import placed_count
from test_torch_proxy_placer import (make_run, placement_lk,
                                     serial_placement)

CPU = torch.device("cpu")
PLACEMENT_TOL = 1e-6   # placement-stage LK vs serial
SCORER_TOL = 0.01      # vs maple_tpu's legacy run: float32 screens of two
                       # kernels, decisions in float64 on the host
                       # (tests/test_device_placement.py:201-203)


@pytest.fixture(autouse=True)
def legacy_env(monkeypatch):
    for name in ("MAPLE_DEVICE_RT", "MAPLE_PROXY_BF16"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPLE_DEVICE_LEGACY", "1")


def legacy_placement(name, tmp_path, device_pallas=True, **flags):
    run = make_run(name, tmp_path, input=SUB80, model="GTR",
                   device_placement=True, device_pallas=device_pallas,
                   **flags)
    run.build_initial_tree_device(warmup=16, batch_size=16)
    return run, placement_lk(run)


def test_pool_rows_match_maple_tpu(tmp_path):
    """refresh: the same anchors in the same rows, and the port's stacked
    rows are maple_tpu's packed pool in the kernel layout; update: both
    pools take the same changed nodes to the same rows."""
    runs = {}
    for name in ("maple_tpu", "maple_tpu_torch"):
        runs[name], _ = serial_placement(name, tmp_path, SUB80, model="GTR")
    rt_j, rt_t = runs["maple_tpu"].rt, runs["maple_tpu_torch"].rt
    pj = JBP.DeviceTreePool(rt_j, n_pad_hint=200)
    pt = TBP.DeviceTreePool(rt_t, CPU, n_pad_hint=200)
    n = pt.refresh()
    assert n == pj.refresh() > 40
    assert pt.anchor_ids == pj.anchor_ids and pt.node_at == pj.node_at
    assert pt.capacity == pj.capacity == 256 and pt.budget == pj.budget
    assert pt.n_prefix == (64 if n <= 64 else 128)
    np.testing.assert_array_equal(pt.valid, pj.valid)

    class Packed:   # maple_tpu's packed dict as a PackedBatch-like object
        def __init__(self, d):
            for k, v in d.items():
                setattr(self, k, np.asarray(v))

    want = stack_fields_host(Packed(pj.pool), None, None, axis=-2)
    np.testing.assert_array_equal(pt.dev_pool.numpy()[:n], want[:n])
    # update: one ineligible node (the root), some live anchors again
    changed = [runs["maple_tpu"].root] + pt.anchor_ids[:5]
    before = pt.dev_pool.clone()
    assert pt.update(changed) and pj.update(changed)
    assert pt.row_of == pj.row_of
    np.testing.assert_array_equal(pt.valid, pj.valid)
    np.testing.assert_array_equal(pt.dev_pool.numpy(), before.numpy())
    # a vector longer than the entry budget asks for a full refresh
    pt.budget = 1
    assert not pt.update(changed)


def test_batched_append_scores_matches_pallas(x64, sub80_tree):
    """One packed query against the packed anchors of a real tree."""
    run = sub80_tree
    rt = run.rt
    pool, n, queries, _ = pool_and_queries(run)
    vecs = [pool.eligible_vec(int(a)) for a in pool.node_arr[:n]]
    Pp = OP.pack_genome_lists(vecs, rt.refd.lRef,
                              OP.budget_for(vecs, 64), False)
    for q in queries[:3]:
        Qp = OP.pack_genome_list(q, rt.refd.lRef, 128, False)
        want = np.asarray(PA.pallas_batched_append_scores(
            AB.to_device(Pp, dtype=jnp.float64),
            AB.to_device(Qp, dtype=jnp.float64), rt.dc.oneMutBLen, True,
            AB.device_model_from(rt.model, rt.dc, dtype=jnp.float64),
            interpret=True))
        got = TAP.batched_append_scores(
            TAB.to_device(Pp, device=CPU, dtype=torch.float64),
            TAB.to_device(Qp, device=CPU, dtype=torch.float64),
            rt.dc.oneMutBLen, True,
            TAB.device_model_from(rt.model, rt.dc, device=CPU,
                                  dtype=torch.float64)).numpy()
        assert got.shape == (n,)
        assert_same_scores(got, want[:n], REL_JAX)


def test_legacy_placement_matches_serial(tmp_path):
    run_s, lk_s = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                                   model="GTR")
    run_d, lk_d = legacy_placement("maple_tpu_torch", tmp_path)
    placer = run_d.legacy_placer
    assert placer is not None and placer.pool.dev_pool is not None
    assert placed_count(run_d) == placed_count(run_s) == 80
    assert run_d.stats.num_minors_found == run_s.stats.num_minors_found
    assert abs(lk_d - lk_s) <= PLACEMENT_TOL, (lk_d, lk_s)


def test_legacy_placement_incremental_pool(tmp_path, monkeypatch):
    """A forced-low refresh threshold exercises the incremental pool path
    (persistent rows, device row scatter, host validity mask): decisions
    stay exactly serial."""
    run_s, lk_s = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                                   model="GTR")
    orig_init = TBP.BatchedPlacer.__init__
    orig_update = TBP.DeviceTreePool.update
    n_updates = [0]

    def low_threshold(self, *a, **k):
        orig_init(self, *a, **k)
        self.refresh_threshold = 24

    def counting(self, changed):
        ok = orig_update(self, changed)
        n_updates[0] += bool(ok)
        return ok

    monkeypatch.setattr(TBP.BatchedPlacer, "__init__", low_threshold)
    monkeypatch.setattr(TBP.DeviceTreePool, "update", counting)
    run_d, lk_d = legacy_placement("maple_tpu_torch", tmp_path)
    assert n_updates[0] > 0, "incremental path never exercised"
    assert placed_count(run_d) == placed_count(run_s) == 80
    assert run_d.stats.num_minors_found == run_s.stats.num_minors_found
    assert abs(lk_d - lk_s) <= PLACEMENT_TOL, (lk_d, lk_s)


def test_legacy_placement_matches_maple_tpu(tmp_path):
    """maple_tpu's legacy placer with --devicePallas (its Pallas kernel in
    interpret mode) on the same input."""
    run_j, lk_j = legacy_placement("maple_tpu", tmp_path)
    run_t, lk_t = legacy_placement("maple_tpu_torch", tmp_path)
    assert placed_count(run_t) == placed_count(run_j) == 80
    assert abs(lk_t - lk_j) <= SCORER_TOL, (lk_t, lk_j)


def test_legacy_default_scorer_matches_serial(tmp_path):
    """Without --devicePallas the legacy placer scores with the
    interval-algebra scorer, read from the stacked pool through views."""
    run_s, lk_s = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                                   model="GTR")
    launches = TAP.append_scores_prestacked.launches
    run_d, lk_d = legacy_placement("maple_tpu_torch", tmp_path,
                                   device_pallas=False)
    placer = run_d.legacy_placer
    assert placer is not None and not placer.use_pallas
    assert placer.dm is not None and placer.mm_dev is None
    assert TAP.append_scores_prestacked.launches == launches
    assert placed_count(run_d) == placed_count(run_s) == 80
    assert run_d.stats.num_minors_found == run_s.stats.num_minors_found
    assert abs(lk_d - lk_s) <= PLACEMENT_TOL, (lk_d, lk_s)


def test_legacy_default_scorer_matches_maple_tpu(tmp_path):
    """maple_tpu's legacy placer on its XLA interval-algebra scorer, the
    same input and arguments."""
    run_j, lk_j = legacy_placement("maple_tpu", tmp_path,
                                   device_pallas=False)
    run_t, lk_t = legacy_placement("maple_tpu_torch", tmp_path,
                                   device_pallas=False)
    assert placed_count(run_t) == placed_count(run_j) == 80
    assert abs(lk_t - lk_j) <= SCORER_TOL, (lk_t, lk_j)


def test_legacy_scorers_agree_on_a_batch(tmp_path):
    """One batch's score matrix by both scorers of the placer, from the
    same pool: float32 of two summation orders
    (tests/test_mesh_pallas.py:71-72), -inf in the same cells."""
    run, _ = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                              model="GTR")
    rt = run.rt
    placer = TBP.BatchedPlacer(rt, run.stats, CPU)
    n = placer.pool.refresh()
    vecs = [placer.pool.eligible_vec(a) for a in placer.pool.anchor_ids[:9]]
    Cflat, prm = placer._query_arrays(vecs)
    rows = placer.pool.dev_pool[:placer.pool.n_prefix]
    dm = placer._device_model()
    k1 = TAP.append_scores_prestacked(
        rows, torch.from_numpy(Cflat), torch.from_numpy(prm),
        dm.mut_matrix.reshape(1, 1, 16), dm.root_freqs.reshape(1, 1, 4),
        uer=False).numpy()[:, :n]
    from maple_tpu_torch.ops.layout import NFIELDS, fields_view
    k8 = TAB.grid_append_scores(
        fields_view(rows, -2),
        fields_view(torch.from_numpy(Cflat).reshape(9, -1, NFIELDS), -1),
        rt.dc.oneMutBLen, True, dm).numpy()[:, :n]
    assert np.array_equal(np.isneginf(k1), np.isneginf(k8))
    fin = np.isfinite(k1)
    assert fin.sum() > 100
    np.testing.assert_allclose(k8[fin], k1[fin], rtol=2e-4, atol=2e-3)
