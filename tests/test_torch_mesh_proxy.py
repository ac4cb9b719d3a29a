"""The proxy screen's pool sharded by candidate (K11) on gloo ranks, against
the single-device ``proxy_step`` and, end to end, against serial placement
and the JAX package's sharded proxy placement.

``run_ranks`` starts fresh processes (one time limit for all ranks of a
run).  The functions the ranks run are at the top of this file and import
neither jax nor maple_tpu: a rank imports this module, so everything of
JAX is imported inside the tests.  Inputs are made with numpy from a seed,
in the ranks and in the test alike.
"""
import hashlib
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from maple_tpu_torch.parallel import mesh as TM
from maple_tpu_torch.parallel import proxy_features as TF
from maple_tpu_torch.parallel import proxy_placer as TP
from maple_tpu_torch.parallel.ranks import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
RANK_TIMEOUT = 240.0     # seconds for all ranks of one run
CAP, N_LIVE, K = 1024, 900, 32
# float32 products over a slice of the pool against the whole pool: a GEMM
# may sum a dot product in another order (relative to max(1, |score|))
REL = 1e-6
LK_TOL = 1e-6            # the proxy path's exact-parity contract
# (dp, cand) meshes; the last step asks for more winners than a slice of
# 1024 / 4 rows holds
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
TOPMS = (64, 64, 64, 384)
# maple_tpu's own proxy placement of example_sub80 over its virtual
# make_mesh(4, dp=2), device_warmup 16, device_proxy_batch 16, JAX on the CPU
JAX_MESH_LK = {"UNREST": -42842.66526658852, "GTR": -42882.96431815886}
JAX_MESH_MINORS = 30
BRANCH_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
              "MAPLE_PROXY_D")


# ----------------------------------------------------------------------
# inputs (numpy, from a seed)

def pool_state(seed=11):
    """A pool of CAP rows over D: N_LIVE live rows of sparse features,
    about 90% of them valid."""
    rng = np.random.default_rng(seed)
    af = np.zeros((CAP, TF.D), np.float32)
    for r in range(N_LIVE):
        cols = rng.choice(np.arange(1, TF.D), rng.integers(1, 12))
        af[r, cols] = rng.random(len(cols)) * 4 - 2
        af[r, 0] = -float(len(cols))
    af[:N_LIVE, 1:40] += (rng.random((N_LIVE, 39)) * 4 - 2) \
        * (rng.random((N_LIVE, 39)) < 0.2)
    valid = np.zeros(CAP, bool)
    valid[:N_LIVE] = rng.random(N_LIVE) < 0.9
    return af, valid


def step_arrays(seed=12):
    """Four steps of (updates, queries): rows of every shard rewritten, new
    rows appended, one step with no update, and a last step that
    invalidates most of the pool (fewer valid rows than its 384 winners)."""
    rng = np.random.default_rng(seed)
    steps = []
    for i, topm in enumerate(TOPMS):
        if i == 2:
            R = 0
        elif i == 3:
            R = 800
        else:
            R = 60
        upd_idx = rng.choice(CAP, R, replace=False).astype(np.int32)
        Fa = 20
        upd_fidx = rng.integers(0, TF.D, (R, Fa)).astype(np.int32)
        upd_fidx[:, 1] = upd_fidx[:, 0]               # repeats add up
        upd_fw = (rng.random((R, Fa)) * 4 - 2).astype(np.float32)
        upd_valid = rng.random(R) < (0.1 if i == 3 else 0.8)
        q_fidx = rng.integers(0, TF.D, (K, 30)).astype(np.int32)
        q_fidx[:, :8] = rng.integers(1, 40, (K, 8))   # shared low buckets
        q_fw = (rng.random((K, 30)) * 4 - 2).astype(np.float32)
        steps.append(((upd_idx, upd_fidx, upd_fw, upd_valid, q_fidx, q_fw),
                      topm))
    return steps


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# ----------------------------------------------------------------------
# what the ranks run (no jax, no maple_tpu)

def k11_rank(rank, device, dp):
    """K11 on this rank's slice of the seeded pool through the four steps;
    then the pool gathered over ``cand``."""
    mesh = TM.make_mesh(dp=dp, device=device)
    af, valid = pool_state()
    pool = TP.pool_from_numpy(af, valid, {}, np.full(CAP, -1),
                              device=device, dtype=torch.float32,
                              d_hash=TF.D_HASH, g_buckets=TF.G_BUCKETS,
                              mesh=mesh)
    out = {"coords": dict(mesh.coords), "local_rows": pool.AF.shape[0],
           "steps": []}
    for arrays, topm in step_arrays():
        # the updates this rank holds (as the placer cuts them), the queries
        arrays = (*TP.local_updates(mesh, CAP, *arrays[:4]), *arrays[4:])
        ts, ti = TP.proxy_step_sharded(
            mesh, pool.AF, pool.valid,
            *(torch.from_numpy(a).to(device) for a in arrays), topm=topm,
            cap=CAP)
        out["steps"].append((ts.numpy(), ti.numpy()))
    cand = mesh.shape["cand"]
    parts = [torch.empty_like(pool.AF) for _ in range(cand)]
    vparts = [torch.empty_like(pool.valid) for _ in range(cand)]
    dist.all_gather(parts, pool.AF, group=mesh.axis_groups["cand"])
    dist.all_gather(vparts, pool.valid, group=mesh.axis_groups["cand"])
    AF, valid = torch.cat(parts).numpy(), torch.cat(vparts).numpy()
    out["pool_digest"] = digest(AF, valid)
    if rank == 0:
        out["AF"], out["valid"] = AF, valid
    return out


def placement_rank(rank, device, models):
    """The proxy placement of example_sub80 on a 2 x 2 mesh, default flags,
    once for each model."""
    from maple_tpu_torch.config import MapleConfig
    from maple_tpu_torch.dryrun import placed, tree_signature
    from maple_tpu_torch.pipeline import Run
    for name in BRANCH_ENV:
        os.environ.pop(name, None)
    mesh = TM.make_mesh(4, dp=2, device=device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="mesh_proxy_") as tmp:
        for model in models:
            run = Run(MapleConfig(input=SUB80, output=os.path.join(
                tmp, f"{model}{rank}"), model=model, overwrite=True,
                device_placement=True, device_warmup=16,
                device_proxy_batch=16), device)
            run.load()
            run.build_initial_tree_device(warmup=16, mesh=mesh)
            pl = run.proxy_placer
            run.rt.recalculate_all(run.root)
            out[model] = {
                "lk": run.rt.calculate_tree_likelihood(run.root),
                "minors": run.stats.num_minors_found, "placed": placed(run),
                "signature": tree_signature(run), "steps": pl.steps,
                "on_mesh": pl.pool.mesh is mesh,
                "legacy": run.legacy_placer is not None
                or run.pplacer is not None,
                "pool": (pl.pool.capacity, tuple(pl.pool.AF.shape))}
    return out


# ----------------------------------------------------------------------
# the single device, and the runs

def single_device():
    """proxy_step through the same steps on the whole pool: each step's
    result, the full masked score matrix after its scatter, and the pool
    at the end."""
    af, valid = pool_state()
    pool = TP.pool_from_numpy(af, valid, {}, np.full(CAP, -1),
                              device=torch.device("cpu"),
                              dtype=torch.float32, d_hash=TF.D_HASH,
                              g_buckets=TF.G_BUCKETS)
    steps = []
    for arrays, topm in step_arrays():
        t = [torch.from_numpy(a) for a in arrays]
        ts, ti = TP.proxy_step(pool.AF, pool.valid, *t, topm=topm)
        full = TF.proxy_scores(pool.AF, t[4], t[5])
        full.masked_fill_(~pool.valid[None, :], float("-inf"))
        steps.append((ts.numpy(), ti.numpy(), full.numpy()))
    return steps, pool.AF.numpy(), pool.valid.numpy()


def jax_sharded_steps(dp, cand):
    """maple_tpu's ``_proxy_step`` through the same steps on its virtual
    ``make_mesh(dp * cand, dp=dp)``, the pool laid out ``P("cand", None)``
    (``valid`` ``P("cand")``) and the updates and queries replicated, as its
    ``ProxyPool`` and ``_submit`` place them: each step's (scores, rows)."""
    from jax.sharding import PartitionSpec as P
    from maple_tpu.parallel.mesh import host_fetch, make_mesh, put_global
    from maple_tpu.parallel.proxy_placer import _proxy_step
    mesh = make_mesh(dp * cand, dp=dp)
    af, valid = pool_state()
    AF = put_global(mesh, af, P("cand", None))
    V = put_global(mesh, valid, P("cand"))
    steps = []
    for arrays, topm in step_arrays():
        up = [put_global(mesh, a, P(*([None] * a.ndim))) for a in arrays]
        AF, V, ts, ti = _proxy_step(AF, V, *up, topm=topm)
        steps.append((host_fetch(ts), host_fetch(ti)))
    return steps


@pytest.fixture(scope="module")
def single():
    return single_device()


@pytest.fixture(scope="module", params=list(MESHES))
def k11_ranks(request):
    dp, cand = MESHES[request.param]
    return request.param, run_ranks(k11_rank, dp * cand, backend="gloo",
                                     timeout=RANK_TIMEOUT, args=(dp,))


def rel_err(got, want):
    return np.abs(got - want) / np.maximum(1.0, np.abs(want))


def test_k11_matches_single_device(k11_ranks, single):
    """Merged top-M scores against proxy_step's (sorted per query: tie
    order is not fixed), rows that carry their scores, the pool after the
    scatters, and the same bits on every rank."""
    name, ranks = k11_ranks
    dp, cand = MESHES[name]
    steps, AF1, valid1 = single
    assert [r["coords"] for r in ranks] == [
        {"dp": i, "cand": j} for i in range(dp) for j in range(cand)]
    assert {r["local_rows"] for r in ranks} == {CAP // cand}
    for s, ((ts1, ti1, full), topm) in enumerate(zip(steps, TOPMS)):
        ts, ti = ranks[0]["steps"][s]
        assert ts.dtype == np.float32 and ti.dtype == np.int64
        assert ts.shape == ti.shape == (K, min(topm, CAP))
        for r in ranks[1:]:   # all ranks, the same bits
            np.testing.assert_array_equal(r["steps"][s][0], ts)
            np.testing.assert_array_equal(r["steps"][s][1], ti)
        a, b = np.sort(ts, axis=1), np.sort(ts1, axis=1)
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
        if cand == 1:   # the same shapes: the same bits, rows included
            np.testing.assert_array_equal(ts, ts1)
            np.testing.assert_array_equal(ti, ti1)
        fin = np.isfinite(b)
        assert rel_err(a[fin], b[fin]).max() <= REL
        # every returned row is a row whose single-device score is that
        # score; a -inf winner is a pad (-1) or an invalid row
        q = np.arange(K)[:, None].repeat(ts.shape[1], 1)
        fin = np.isfinite(ts)
        assert (ti[fin] >= 0).all()
        assert rel_err(ts[fin], full[q[fin], ti[fin]]).max() <= REL
        pads = ti[~fin]
        assert ((pads == -1)
                | np.isneginf(full[q[~fin], np.maximum(pads, 0)])).all()
        assert (ts[:, :-1] >= ts[:, 1:]).all()   # in descending order
    # the last step keeps fewer valid rows than its 384 winners (on 1 x 4,
    # more than a slice of 256 rows holds: each pads its winners)
    assert np.isneginf(steps[-1][0]).any()
    # the gathered pool after the same scatters, bit for bit
    np.testing.assert_array_equal(ranks[0]["AF"], AF1)
    np.testing.assert_array_equal(ranks[0]["valid"], valid1)
    assert {r["pool_digest"] for r in ranks} == {digest(AF1, valid1)}


def test_k11_matches_jax_sharded_step(k11_ranks, single):
    """maple_tpu's own sharded step on a virtual mesh of the same (dp, cand)
    and the same inputs: the port's merged top-M scores are its scores
    (sorted per query, relative 1e-6) with the same -inf cells, and the rows
    the JAX step returns carry their single-device scores, the top-384 step
    over 256-row slices included."""
    name, ranks = k11_ranks
    dp, cand = MESHES[name]
    steps = single[0]
    jax_steps = jax_sharded_steps(dp, cand)
    assert len(jax_steps) == len(TOPMS)
    for s, (ts_j, ti_j) in enumerate(jax_steps):
        ts, _ = ranks[0]["steps"][s]
        full = steps[s][2]
        assert ts_j.shape == ti_j.shape == ts.shape
        a, b = np.sort(ts, axis=1), np.sort(ts_j, axis=1)
        np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
        fin = np.isfinite(b)
        assert rel_err(a[fin], b[fin]).max() <= REL
        q = np.arange(K)[:, None].repeat(ts_j.shape[1], 1)
        fin = np.isfinite(ts_j)
        assert rel_err(ts_j[fin], full[q[fin], ti_j[fin]]).max() <= REL
        assert np.isneginf(full[q[~fin], ti_j[~fin]]).all()
    assert np.isneginf(jax_steps[-1][0]).any()


def test_k11_refuses_a_pool_that_does_not_divide():
    class OneByThree:
        shape = {"dp": 1, "cand": 3}
        coords = {"dp": 0, "cand": 0}

    class OneByTwo:
        shape = {"dp": 1, "cand": 2}
        coords = {"dp": 0, "cand": 0}
    with pytest.raises(ValueError, match="does not divide"):
        TP.ProxyPool(900, torch.device("cpu"), mesh=OneByThree())
    AF = torch.zeros(300, 16)
    none = torch.zeros((0, 4))
    args = (AF, AF[:, 0] > 0, none[:, 0].int(), none.int(), none,
            none[:, 0].bool(), torch.zeros((2, 3)).int(), torch.ones(2, 3))
    with pytest.raises(ValueError, match="does not divide"):
        TP.proxy_step_sharded(OneByThree(), *args, topm=8, cap=1024)
    with pytest.raises(ValueError, match="300 local rows: a pool of 1024 "
                       "over 2 cand ranks holds 512"):
        TP.proxy_step_sharded(OneByTwo(), *args, topm=8, cap=1024)
    upd = np.array([3, 700, 511, 512], np.int32)
    idx, fidx, fw, ok = TP.local_updates(
        type("Second", (OneByTwo,), {"coords": {"dp": 0, "cand": 1}}),
        1024, upd, upd[:, None] * 2, upd[:, None] * 0.5, upd > 600)
    np.testing.assert_array_equal(idx, [188, 0])
    np.testing.assert_array_equal(fidx[:, 0], [1400, 1024])
    np.testing.assert_array_equal(ok, [True, False])


@pytest.fixture(scope="module")
def placement_ranks():
    return run_ranks(placement_rank, 4, backend="gloo", timeout=RANK_TIMEOUT,
                     args=(("GTR", "UNREST"),))


@pytest.mark.parametrize("model", ["GTR", "UNREST"])
def test_mesh_proxy_placement_2x2(placement_ranks, model, tmp_path,
                                  monkeypatch):
    """example_sub80 on 2 x 2 gloo ranks with default flags takes the proxy
    placer over the mesh; every rank ends on one tree, whose LK is the
    port's serial placement's and maple_tpu's own sharded run's."""
    from maple_tpu.parallel.mesh import make_mesh
    from test_torch_proxy_placer import make_run, placement_lk, \
        serial_placement
    for name in BRANCH_ENV:
        monkeypatch.delenv(name, raising=False)
    res = [r[model] for r in placement_ranks]
    assert len({r["signature"] for r in res}) == 1
    ser, ser_lk = serial_placement("maple_tpu_torch", tmp_path, SUB80,
                                   model=model)
    run_j = make_run("maple_tpu", tmp_path, input=SUB80, model=model,
                     device_placement=True, device_warmup=16,
                     device_proxy_batch=16)
    run_j.build_initial_tree_device(warmup=16, mesh=make_mesh(4, dp=2))
    jax_lk = placement_lk(run_j)
    assert abs(jax_lk - JAX_MESH_LK[model]) <= LK_TOL
    assert run_j.stats.num_minors_found == JAX_MESH_MINORS
    for r in res:
        assert r["on_mesh"] and not r["legacy"]
        assert r["steps"] == 4 and r["placed"] == 80
        assert r["pool"] == (1024, (512, TF.D))   # cand 2: half the rows
        assert abs(r["lk"] - ser_lk) <= LK_TOL, (r["lk"], ser_lk)
        assert abs(r["lk"] - jax_lk) <= LK_TOL, (r["lk"], jax_lk)
        assert r["minors"] == ser.stats.num_minors_found \
            == run_j.stats.num_minors_found
