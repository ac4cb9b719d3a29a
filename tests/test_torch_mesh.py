"""The port's (dp x cand) mesh on ``torch.distributed`` against the JAX
package's virtual mesh and against the single-device scorers.

Four gloo ranks on the CPU as a 2 x 2 mesh (``run_ranks``: fresh processes,
one time limit for all, no process left behind).  The functions the ranks
run are at the top of this file and import neither jax nor maple_tpu: a
rank imports this module, so everything of JAX is imported inside the
tests.  Every rank returns what it computed; the tests hold it against the
single-device scorers (bitwise), against the other ranks (bitwise) and
against the JAX package on its virtual CPU mesh (float32 tolerance).
"""
import os
import random

import numpy as np
import pytest
import torch

from maple_tpu_torch.ops import append_batch as TAB
from maple_tpu_torch.ops import append_pairs as TAP
from maple_tpu_torch.parallel import mesh as TM
from maple_tpu_torch.parallel.ranks import run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
RANK_TIMEOUT = 240.0     # seconds for all ranks of one run: a deadlock
                         # fails one test, not the suite
# float32 scores of two scorers or two summation orders
# (tests/test_mesh_pallas.py:71-72)
F32_RTOL, F32_ATOL = 2e-4, 2e-3
PLACEMENT_TOL = 1e-6     # placement LK vs serial
                         # (tests/jax_distributed_pipeline_worker.py:78)
SCORER_TOL = 0.01        # vs maple_tpu's run of the same branch: float32
                         # screens of two programs, decisions in float64
N_CANDS, N_QUERIES = 64, 8
FIELDS = ("types", "ends", "vals", "bl1", "bl2", "has_bl1", "has_bl2",
          "flags", "probs")


def _rand_list(rng, lRef):
    """Random genome list over the 'acgt'*N reference: R runs broken by
    point mutations whose value field carries the local-reference
    nucleotide (a copy of tests/test_mesh_pallas.py:15-30)."""
    entries, pos = [], 0
    while pos < lRef:
        end = min(pos + rng.randint(200, 2000), lRef)
        entries.append((4, end))
        pos = end
        if pos < lRef:
            ref_nuc = pos % 4  # ref is 'acgt' repeating
            nuc = rng.choice([n for n in range(4) if n != ref_nuc])
            entries.append((nuc, ref_nuc))
            pos += 1
    return entries


# ----------------------------------------------------------------------
# what the ranks run (no jax, no maple_tpu)

def _tensors(fields: dict, device):
    return {k: torch.from_numpy(v).to(device) for k, v in fields.items()}


def _model(payload, device):
    return TAB.model_from_numpy(*payload["model"], device=device,
                                dtype=torch.float32)


def cand_mesh_rank(rank, device, payload):
    """Every scorer of a 2 x 2 (dp x cand) mesh on this rank, with what a
    single device computes for the same inputs."""
    mesh = TM.make_mesh(4, dp=2, device=device)
    dm = _model(payload, device)
    P, Q = payload["pool"], payload["queries"]
    blen, blens, tips = payload["blen"], payload["blens"], payload["tips"]
    pool_g, q_g = TM.shard_batch(mesh, P, Q)
    out = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}

    def both(x):
        return {"tile": x.local.cpu().numpy(), "full": TM.host_fetch(x)}

    out["xla"] = both(TM.placement_scores(mesh, pool_g, q_g, blen, dm))
    # full arrays in place of shards: the scorer shards them itself
    out["xla_from_full"] = both(TM.placement_scores(mesh, P, Q, blen, dm))
    out["pallas"] = both(TM.placement_scores_pallas(mesh, pool_g, q_g, blen,
                                                    dm))
    out["spr"] = both(TM.spr_screen_scores(
        mesh, pool_g, q_g, TM.put_global(mesh, blens, ("dp",)),
        TM.put_global(mesh, tips, ("dp",)), dm))
    # the placers' layout: pool and queries stacked, sharded as they are
    Pt, Qt = _tensors(P, device), _tensors(Q, device)
    Pstk = TAP.stack_fields(Pt, dm.site_rates, dm.error_rates, -2)
    Cflat = TAP.stack_fields(Qt, dm.site_rates, dm.error_rates, -1) \
        .reshape(N_QUERIES, 1, -1)
    pool_s = TM.put_global(mesh, Pstk, ("cand",))
    q_s = TM.put_global(mesh, Cflat, ("dp",))
    out["xla_stacked"] = both(TM.placement_scores(mesh, pool_s, q_s, blen,
                                                  dm))
    out["pallas_stacked"] = both(TM.placement_scores_pallas(
        mesh, pool_s, q_s, blen, dm))
    idx, score, evidence = TM.placement_step(mesh, pool_g, q_g, blen, dm)
    out["step"] = {"idx": TM.host_fetch(idx), "score": TM.host_fetch(score),
                   "evidence": float(evidence)}
    # ties: two copies of one candidate in different cand shards
    tied = {k: np.concatenate([v[:32], v[:32]]) for k, v in P.items()}
    idx, score, _ = TM.placement_step(mesh, tied, Q, blen, dm)
    out["tied_idx"] = TM.host_fetch(idx)
    # single device, same inputs
    out["single"] = {
        "xla": TAB.grid_append_scores(Pt, Qt, blen, True, dm).numpy(),
        "pallas": TAP.grid_append_scores(Pt, Qt, blen, True, dm).numpy(),
        "spr": TAB.grid_append_scores_var(Pt, Qt, blens, tips, dm).numpy()}
    # an array round trip, and a dimension that does not divide
    arr = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    out["roundtrip"] = [TM.host_fetch(TM.put_global(mesh, arr, spec))
                        for spec in (("dp", "cand"), ("cand",), (None, "dp"),
                                     ())]
    try:
        TM.put_global(mesh, np.zeros((5, 4)), ("dp",))
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    # the genome mesh over the same four ranks
    gmesh = TM.make_genome_mesh(4, device=device)
    out["gen_shape"] = dict(gmesh.shape)
    out["gen"] = TM.host_fetch(TM.placement_scores_genome_sharded(
        gmesh, P, Q, blen, dm))
    return out


def genome_mesh_rank(rank, device, payload):
    """The genome-sharded scorer on a 1 x 2 (dp x gen) mesh of two
    ranks."""
    gmesh = TM.make_genome_mesh(device=device)
    dm = _model(payload, device)
    P, Q = payload["pool"], payload["queries"]
    return {"gen_shape": dict(gmesh.shape),
            "gen": TM.host_fetch(TM.placement_scores_genome_sharded(
                gmesh, P, Q, payload["blen"], dm))}


def dryrun_rank(rank, device, use_pallas):
    from maple_tpu_torch.dryrun import dryrun_multichip
    mesh = TM.make_mesh(4, dp=2, device=device)
    return dryrun_multichip(mesh, input=SUB80, use_pallas=use_pallas)


# ----------------------------------------------------------------------
# inputs and runs

def make_payload(seed, position_varying):
    """Packed 'acgt' lists and model arrays as numpy (float32); with
    ``position_varying`` the rate and error tables vary along the genome
    and the error model is on (tests/test_mesh_pallas.py:99-108)."""
    from maple_tpu.config import DerivedConfig, MapleConfig
    from maple_tpu.ops import pack as OP
    from maple_tpu.refdata import Model, RefData
    refd = RefData.build("acgt" * 2500, model="GTR")
    model = Model.initial(refd, "GTR")
    dc = DerivedConfig.build(MapleConfig(model="GTR"), refd.lRef)
    rng = random.Random(seed)
    cands = [_rand_list(rng, refd.lRef) for _ in range(N_CANDS)]
    queries = [_rand_list(rng, refd.lRef) for _ in range(N_QUERIES)]
    B = OP.budget_for(cands + queries)
    uer = bool(position_varying)
    packed = [OP.pack_genome_lists(v, refd.lRef, B, False, dtype=np.float32)
              for v in (cands, queries)]
    pool, Q = ({k: getattr(p, k) for k in FIELDS} for p in packed)
    rng_np = np.random.default_rng(seed)
    if position_varying:
        site_rates = rng_np.uniform(0.2, 3.0, refd.lRef)
        error_rates = rng_np.uniform(0.0, 0.01, refd.lRef)
        tot_error = -0.05
    else:
        site_rates, error_rates = np.ones(refd.lRef), np.zeros(refd.lRef)
        tot_error = 0.0
    model_arrays = [np.asarray(a, dtype=np.float32) for a in (
        model.mut_matrix, refd.root_freqs, site_rates, error_rates,
        dc.globalTotRate, tot_error)] + [uer, uer]
    return {"pool": pool, "queries": Q, "model": model_arrays,
            "blen": float(dc.oneMutBLen),
            "blens": rng_np.choice([0.0, 3.3e-5, 1e-4, 7.7e-4],
                                   N_QUERIES).astype(np.float32),
            "tips": rng_np.random(N_QUERIES) < 0.5}


def jax_inputs(payload):
    import jax.numpy as jnp
    from maple_tpu.ops.append_batch import DeviceModel
    m = payload["model"]
    dm = DeviceModel(*(jnp.asarray(a) for a in m[:6]), m[6], m[7])
    pool = {k: jnp.asarray(v) for k, v in payload["pool"].items()}
    Q = {k: jnp.asarray(v) for k, v in payload["queries"].items()}
    return pool, Q, dm


@pytest.fixture(scope="module")
def payload():
    return make_payload(17, position_varying=False)


@pytest.fixture(scope="module")
def varying_payload():
    return make_payload(29, position_varying=True)


@pytest.fixture(scope="module")
def cand_ranks(payload):
    return run_ranks(cand_mesh_rank, 4, backend="gloo",
                     timeout=RANK_TIMEOUT, args=(payload,))


@pytest.fixture(scope="module")
def varying_ranks(varying_payload):
    return run_ranks(cand_mesh_rank, 4, backend="gloo",
                     timeout=RANK_TIMEOUT, args=(varying_payload,))


def close_f32(got, want):
    assert got.shape == want.shape
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=F32_RTOL,
                               atol=F32_ATOL)


# ----------------------------------------------------------------------
# tests

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_factors_match_jax(n):
    from maple_tpu.parallel.mesh import make_genome_mesh, make_mesh
    j = make_mesh(n)
    assert TM.mesh_factors(n) == j.devices.shape
    g = make_genome_mesh(n)
    assert TM.genome_mesh_factors(n) == g.devices.shape
    if n % 2 == 0:
        assert TM.mesh_factors(n, dp=2) == make_mesh(n, dp=2).devices.shape
        assert TM.genome_mesh_factors(n, dp=2) == \
            make_genome_mesh(n, dp=2).devices.shape


def test_mesh_layout(cand_ranks):
    assert [r["shape"] for r in cand_ranks] == [{"dp": 2, "cand": 2}] * 4
    assert [r["coords"] for r in cand_ranks] == [
        {"dp": 0, "cand": 0}, {"dp": 0, "cand": 1},
        {"dp": 1, "cand": 0}, {"dp": 1, "cand": 1}]
    assert cand_ranks[0]["gen_shape"] == {"dp": 2, "gen": 2}


@pytest.mark.parametrize("scorer,single", [
    ("xla", "xla"), ("xla_from_full", "xla"), ("xla_stacked", "xla"),
    ("pallas", "pallas"), ("pallas_stacked", "pallas"), ("spr", "spr")])
@pytest.mark.parametrize("tables", ["flat", "varying"])
def test_tiles_equal_single_device_bitwise(cand_ranks, varying_ranks,
                                           tables, scorer, single):
    """Each rank's tile is the single-device matrix's block at its
    coordinates, the gathered matrix is the single-device matrix, and it
    is the same on every rank: all bit for bit."""
    ranks = cand_ranks if tables == "flat" else varying_ranks
    for r in ranks:
        want = r["single"][single]
        assert want.shape == (N_QUERIES, N_CANDS)
        i, j = r["coords"]["dp"], r["coords"]["cand"]
        k, n = N_QUERIES // 2, N_CANDS // 2
        np.testing.assert_array_equal(
            r[scorer]["tile"], want[i * k:(i + 1) * k, j * n:(j + 1) * n])
        np.testing.assert_array_equal(r[scorer]["full"], want)
        np.testing.assert_array_equal(r[scorer]["full"],
                                      ranks[0][scorer]["full"])
    assert np.isfinite(ranks[0][scorer]["full"]).any()


@pytest.mark.parametrize("tables", ["flat", "varying"])
def test_scores_match_jax_mesh(cand_ranks, varying_ranks, payload,
                               varying_payload, tables):
    """placement_scores, placement_scores_pallas and spr_screen_scores
    against the JAX package on its virtual 2 x 2 mesh."""
    import jax.numpy as jnp
    from maple_tpu.parallel import mesh as JM
    ranks, pl = (cand_ranks, payload) if tables == "flat" \
        else (varying_ranks, varying_payload)
    pool, Q, dm = jax_inputs(pl)
    mesh = JM.make_mesh(4, dp=2)
    pool_dev, q_dev = JM.shard_batch(mesh, pool, Q)
    got = ranks[0]
    close_f32(got["xla"]["full"], np.asarray(JM.placement_scores(
        mesh, pool_dev, q_dev, pl["blen"], dm)))
    close_f32(got["pallas"]["full"], np.asarray(JM.placement_scores_pallas(
        mesh, pool_dev, q_dev, pl["blen"], dm, interpret=True)))
    close_f32(got["spr"]["full"], np.asarray(JM.spr_screen_scores(
        mesh, pool_dev, q_dev, jnp.asarray(pl["blens"]),
        jnp.asarray(pl["tips"]), dm)))
    # the two scorer families agree with each other as well
    close_f32(got["pallas"]["full"], got["xla"]["full"])


def test_placement_step_matches_jax(cand_ranks, payload):
    from maple_tpu.parallel import mesh as JM
    pool, Q, dm = jax_inputs(payload)
    mesh = JM.make_mesh(4, dp=2)
    pool_dev, q_dev = JM.shard_batch(mesh, pool, Q)
    idx, score, evidence = JM.placement_step(mesh, pool_dev, q_dev,
                                             payload["blen"], dm)
    for r in cand_ranks:
        step = r["step"]
        np.testing.assert_array_equal(step["idx"], np.asarray(idx))
        np.testing.assert_allclose(step["score"], np.asarray(score),
                                   rtol=F32_RTOL, atol=F32_ATOL)
        assert abs(step["evidence"] - float(evidence)) \
            <= F32_RTOL * abs(float(evidence))
        # the step is the argmax of the gathered matrix
        full = r["xla"]["full"]
        np.testing.assert_array_equal(step["idx"], full.argmax(-1))
        np.testing.assert_array_equal(step["score"], full.max(-1))
        # a tie between the two cand shards goes to the lower index
        assert (r["tied_idx"] < N_CANDS // 2).all()


def test_put_global_round_trip_and_divisibility(cand_ranks):
    arr = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    for r in cand_ranks:
        for got in r["roundtrip"]:
            np.testing.assert_array_equal(got, arr)
        assert "does not divide" in r["indivisible"]


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_genome_mesh_matches_dense(varying_ranks, varying_payload, shape):
    """Per-site tables sharded over ``gen`` against the dense scorer, with
    rate variation and the error model on so that the tables vary along
    the genome; the JAX dense scorer as the second witness."""
    from maple_tpu.ops.append_batch import grid_append_scores
    if shape == "2x2":
        ranks = varying_ranks
    else:
        ranks = run_ranks(genome_mesh_rank, 2, backend="gloo",
                          timeout=RANK_TIMEOUT, args=(varying_payload,))
        assert ranks[0]["gen_shape"] == {"dp": 1, "gen": 2}
    dense = varying_ranks[0]["single"]["xla"]
    pool, Q, dm = jax_inputs(varying_payload)
    jax_dense = np.asarray(grid_append_scores(pool, Q,
                                              varying_payload["blen"], True,
                                              dm))
    for r in ranks:
        close_f32(r["gen"], dense)
        close_f32(r["gen"], jax_dense)
        np.testing.assert_array_equal(r["gen"], ranks[0]["gen"])


@pytest.fixture(scope="module")
def serial_lk(tmp_path_factory):
    from test_torch_proxy_placer import serial_placement
    run, lk = serial_placement("maple_tpu_torch",
                               tmp_path_factory.mktemp("ser"), SUB80,
                               model="GTR")
    return lk, run.stats.num_minors_found


@pytest.mark.parametrize("use_pallas", [False, True], ids=["k8", "k1"])
def test_dryrun_multichip_2x2(use_pallas, serial_lk, monkeypatch,
                              tmp_path):
    """The slice as a whole on 2 x 2 gloo ranks on example_sub80: every
    rank ends on the same tree, the placement LK is serial's, the mesh SPR
    pass does not lower it, the genome-sharded scorer agrees, and the LK
    is maple_tpu's own legacy mesh run's on its virtual 2 x 2 mesh."""
    results = run_ranks(dryrun_rank, 4, backend="gloo",
                        timeout=RANK_TIMEOUT, args=(use_pallas,))
    lk_ser, minors_ser = serial_lk
    assert len({r["signature"] for r in results}) == 1
    assert len({r["placement_signature"] for r in results}) == 1
    for rank, r in enumerate(results):
        assert r["rank"] == rank and r["mesh"] == {"dp": 2, "cand": 2}
        assert r["placed"] == 80 and r["minors"] == minors_ser
        assert abs(r["lk_placement"] - lk_ser) <= PLACEMENT_TOL
        assert abs(r["lk_serial"] - lk_ser) <= PLACEMENT_TOL
        assert r["lk_spr"] >= r["lk_placement"] - 1e-6
        assert r["genome_mesh"] == {"dp": 2, "gen": 2}
        assert r["genome_max_abs_diff"] <= 1e-4
        # on CPU tensors the pair kernel's wrapper runs its plain version
        assert r["launches"] == 0
    # maple_tpu's legacy placer over its virtual mesh, the same arguments
    from maple_tpu.parallel.mesh import make_mesh
    from test_torch_proxy_placer import make_run, placement_lk
    monkeypatch.setenv("MAPLE_DEVICE_LEGACY", "1")
    run_j = make_run("maple_tpu", tmp_path, input=SUB80, model="GTR",
                     device_placement=True, device_pallas=use_pallas)
    run_j.build_initial_tree_device(warmup=48, batch_size=16,
                                    mesh=make_mesh(4, dp=2))
    assert abs(results[0]["lk_placement"] - placement_lk(run_j)) \
        <= SCORER_TOL


def test_rank_failure_and_timeout_are_reported():
    """A rank that raises fails the run with its traceback; ranks that
    never answer are cut at the time limit and none is left running."""
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        run_ranks(_failing_rank, 2, backend="gloo", timeout=60.0)
    with pytest.raises(TimeoutError, match="within 8.0 s"):
        run_ranks(_stuck_rank, 2, backend="gloo", timeout=8.0)


def _failing_rank(rank, device):
    raise ValueError(f"rank {rank} on {device} fails on purpose")


def _stuck_rank(rank, device):
    # rank 1 never joins the collective that rank 0 waits in
    import time
    import torch.distributed as dist
    if rank == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(60)
