"""The port's appendProbNode pair scoring against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version.  It is held
against the JAX Pallas kernel in interpret mode (float64, x64 on) and
against the host kernels.  Inputs are real anchor rows and query exports
from a tree built serially on tests/goldens/example_sub80.maple, plus
random genome lists made from a numpy seed under every model mode.
"""
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maple_tpu.config import DerivedConfig, MapleConfig
from maple_tpu.core import genomelist as gl
from maple_tpu.core import kernels as K
from maple_tpu.io.maple_format import read_maple_alignment
from maple_tpu.ops import append_batch as AB
from maple_tpu.ops import pack as OP
from maple_tpu.ops import pallas_append as PA
from maple_tpu.pipeline import Run as SerialRun
from maple_tpu.refdata import Model, RefData

from maple_tpu_torch.ops import append_batch as TAB
from maple_tpu_torch.ops import append_pairs as TAP
from maple_tpu_torch.ops.layout import NFIELDS, stack_fields_host
from maple_tpu_torch.parallel.pipelined_placer import StackedDevicePool

HERE = os.path.dirname(__file__)
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
CPU = torch.device("cpu")

# plain float64 vs Pallas interpret in x64: the same terms, summed in
# another order (the tolerance of tests/test_pallas_append.py:82)
REL_JAX = 1e-9
# vs the host kernels, which multiply factors with carry rescue instead
# of summing logs (tests/test_pallas_append.py:76)
REL_HOST = 1e-6


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def assert_same_scores(got, want, rel, what=""):
    """Equal within ``rel`` relative (floor 1), -inf in the same places."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    inf_g, inf_w = np.isneginf(got), np.isneginf(want)
    assert np.array_equal(inf_g, inf_w), f"{what}: -inf placement differs"
    fin = ~inf_w
    assert np.all(np.isfinite(got[fin])), f"{what}: non-finite scores"
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.size == 0 or err.max() <= rel, \
        f"{what}: max relative error {err.max()} > {rel}"


def random_genome_list(rng, lRef, uer, upper=False, max_entries=14):
    """A structurally valid random genome list from a numpy Generator.

    Lower lists carry at most one branch length per entry; upper lists
    may carry root-crossing (two-length) entries.  O vectors are
    normalized; with the error model, entries with lengths carry a flag."""
    n_special = int(rng.integers(0, max_entries + 1))
    positions = np.sort(rng.choice(np.arange(1, lRef + 1), n_special,
                                   replace=False))
    out = []
    pos = 1  # next uncovered position

    def rand_bl():
        r = rng.random()
        if r < 0.4:
            return None
        return float([0.0, rng.random() * 3e-4,
                      rng.random() * 3e-3][rng.integers(0, 3)])

    def nuc_fields():
        bl1 = rand_bl()
        fields = ()
        if bl1 is not None:
            fields = (bl1,)
            if upper and rng.random() < 0.35:
                fields = (bl1, float([0.0, rng.random() * 3e-4]
                                     [rng.integers(0, 2)]))
        if uer and fields:
            fields = fields + (bool(rng.random() < 0.5),)
        return fields

    for p in positions.tolist():
        if p < pos:
            continue  # already covered by a previous N run
        if p > pos:
            out.append((4, p - 1) + nuc_fields())
            pos = p
        kind = rng.random()
        if kind < 0.3:
            end = min(lRef, p + int(rng.integers(0, 31)))
            out.append((5, end))
            pos = end + 1
        elif kind < 0.75:
            ref_nuc = int(rng.integers(0, 4))
            nuc = int(rng.choice([x for x in range(4) if x != ref_nuc]))
            out.append((nuc, ref_nuc) + nuc_fields())
            pos = p + 1
        else:
            vec = rng.random(4)
            if rng.random() < 0.5:
                vec[2:] *= 1e-3  # concentrate on 2 states
            vec = (vec / vec.sum()).tolist()
            ref_nuc = int(rng.integers(0, 4))
            if rng.random() < 0.5:
                out.append((6, ref_nuc, vec))
            else:
                out.append((6, ref_nuc, float(rng.random() * 3e-4), vec))
            pos = p + 1
    if pos <= lRef:
        out.append((4, lRef) + nuc_fields())
    assert gl.genome_list_length_check(lRef, out)
    return out


@pytest.fixture(scope="module")
def sub80_ref():
    ref, _ = read_maple_alignment(SUB80)
    return ref


def model_for(ref, model_name, rate_var, error_mode, seed):
    """(refd, model, dc) with state drawn from ``seed``: a substitution
    matrix from random pseudo-counts, site rates, and error rates."""
    rng = np.random.default_rng(seed)
    refd = RefData.build(ref, model=model_name)
    model = Model.initial(refd, model_name)
    model.pseudo_counts = (rng.random((4, 4)) * 50 + 1).tolist()
    model.update_from_pseudo_counts()
    if rate_var:
        model.site_rates = (0.2 + 1.6 * rng.random(refd.lRef)).tolist()
        model.refresh_cumulative_rate()
    if error_mode == "global":
        model.set_error_rates(2e-4, None)
    elif error_mode == "site":
        model.set_error_rates(2e-4, (rng.random(refd.lRef) * 4e-4).tolist())
    dc = DerivedConfig.build(MapleConfig(model=model_name), refd.lRef)
    return refd, model, dc


MODES = [("GTR", False, "none"), ("UNREST", False, "none"),
         ("GTR", True, "none"), ("GTR", False, "global"),
         ("UNREST", True, "site")]


@pytest.mark.parametrize("model_name,rate_var,error_mode", MODES)
def test_grid_scores_match_pallas_and_host(x64, sub80_ref, model_name,
                                           rate_var, error_mode):
    """Random candidate uppers (two-length and O entries included) and
    queries; scalar (blen, tip) per call."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var,
                                error_mode, seed=23)
    uer = model.using_error_rate
    ctx = K.KernelCtx(refd, model, dc)
    dm_j = AB.device_model_from(model, dc, dtype=jnp.float64)
    dm_t = TAB.device_model_from(model, dc, device=CPU, dtype=torch.float64)
    rng = np.random.default_rng(41)
    n_checked = 0
    for trial in range(3):
        cands = [random_genome_list(rng, refd.lRef, uer, upper=True)
                 for _ in range(9)]
        queries = [random_genome_list(rng, refd.lRef, uer)
                   for _ in range(3)]
        blen = [0.0, 3.3e-5, 1e-4][trial]
        tip = trial != 1
        B = OP.budget_for(cands + queries)
        Pp = OP.pack_genome_lists(cands, refd.lRef, B, uer)
        Qp = OP.pack_genome_lists(queries, refd.lRef, B, uer)
        jax_s = np.asarray(PA.pallas_grid_append_scores(
            AB.to_device(Pp, dtype=jnp.float64),
            AB.to_device(Qp, dtype=jnp.float64), blen, tip, dm_j,
            interpret=True))
        port = TAP.grid_append_scores(
            TAB.to_device(Pp, device=CPU, dtype=torch.float64),
            TAB.to_device(Qp, device=CPU, dtype=torch.float64),
            blen, tip, dm_t).numpy()
        assert_same_scores(port, jax_s, REL_JAX, f"trial {trial}")
        host = np.array([[K.append_prob_node(ctx, c, q, tip, blen)
                          for c in cands] for q in queries])
        fin = ~np.isneginf(host)
        assert np.all(np.isneginf(port[~fin]) | (port[~fin] < -1e250))
        err = np.abs(port[fin] - host[fin]) \
            / np.maximum(1.0, np.abs(host[fin]))
        assert err.max() <= REL_HOST, err.max()
        n_checked += host.size
    assert n_checked == 81


@pytest.mark.parametrize("model_name,rate_var,error_mode",
                         [MODES[0], MODES[-1]])
def test_grid_scores_var_params(x64, sub80_ref, model_name, rate_var,
                                error_mode):
    """A branch length and a tip flag per query (the SPR screen's call
    shape)."""
    refd, model, dc = model_for(sub80_ref, model_name, rate_var,
                                error_mode, seed=31)
    uer = model.using_error_rate
    ctx = K.KernelCtx(refd, model, dc)
    rng = np.random.default_rng(77)
    cands = [random_genome_list(rng, refd.lRef, uer, upper=True)
             for _ in range(9)]
    queries = [random_genome_list(rng, refd.lRef, uer) for _ in range(4)]
    blens = np.array([0.0, 3.3e-5, 1e-4, 7.7e-4])
    tips = np.array([True, False, True, False])
    B = OP.budget_for(cands + queries)
    Pp = OP.pack_genome_lists(cands, refd.lRef, B, uer)
    Qp = OP.pack_genome_lists(queries, refd.lRef, B, uer)
    jax_s = np.asarray(PA.pallas_grid_append_scores_var(
        AB.to_device(Pp, dtype=jnp.float64),
        AB.to_device(Qp, dtype=jnp.float64), blens, tips,
        AB.device_model_from(model, dc, dtype=jnp.float64), interpret=True))
    port = TAP.grid_append_scores_var(
        TAB.to_device(Pp, device=CPU, dtype=torch.float64),
        TAB.to_device(Qp, device=CPU, dtype=torch.float64), blens, tips,
        TAB.device_model_from(model, dc, device=CPU,
                              dtype=torch.float64)).numpy()
    assert_same_scores(port, jax_s, REL_JAX)
    host = np.array([[K.append_prob_node(ctx, c, q, bool(tips[i]),
                                         float(blens[i]))
                      for c in cands] for i, q in enumerate(queries)])
    fin = ~np.isneginf(host)
    err = np.abs(port[fin] - host[fin]) / np.maximum(1.0, np.abs(host[fin]))
    assert err.max() <= REL_HOST


@pytest.fixture(scope="module")
def sub80_tree(tmp_path_factory):
    """A tree built serially (native engine) on example_sub80."""
    out = tmp_path_factory.mktemp("sub80") / "ser"
    run = SerialRun(MapleConfig(input=SUB80, output=str(out), model="GTR",
                                overwrite=True))
    run.load()
    run.build_initial_tree()
    run.rt.recalculate_all(run.root)
    return run


def pool_and_queries(run, n_queries=8, q_budget=128, seed=5):
    """Real stacked anchor rows (float64) and stacked query exports."""
    rt = run.rt
    pool = StackedDevicePool(rt, CPU, dtype=np.float64)
    n = pool.full_rebuild()
    _, data = read_maple_alignment(SUB80)
    names = sorted(data)
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(names), n_queries, replace=False)
    queries = [rt.kern.export(rt.kern.terminal_vector(data[names[i]]))
               for i in pick]
    packed = OP.pack_genome_lists(queries, rt.refd.lRef, q_budget,
                                  rt.model.using_error_rate)
    Cflat = stack_fields_host(packed, pool.site_rates, pool.error_rates,
                              axis=-1, dtype=np.float64
                              ).reshape(n_queries, 1, -1)
    return pool, n, queries, Cflat


def test_real_pool_rows_match_pallas_and_host(x64, sub80_tree):
    run = sub80_tree
    rt = run.rt
    dc = rt.dc
    pool, n, queries, Cflat = pool_and_queries(run)
    assert n > 20
    Npad = -(-n // 128) * 128
    Pstk = pool.rows_host[:Npad]
    K_ = len(queries)
    prm = np.tile(np.array([dc.oneMutBLen, 1.0, dc.globalTotRate, 0.0]),
                  (K_, 1)).reshape(K_, 1, 4)
    mm = np.asarray(rt.model.mut_matrix, dtype=np.float64).reshape(1, 1, 16)
    rf = np.asarray(rt.refd.root_freqs, dtype=np.float64).reshape(1, 1, 4)
    jax_s = np.asarray(PA.pallas_scores_prestacked(
        jnp.asarray(Pstk), jnp.asarray(Cflat), jnp.asarray(prm),
        jnp.asarray(mm), jnp.asarray(rf), uer=False, interpret=True))
    t = torch.from_numpy
    port = TAP.append_scores_prestacked(
        t(Pstk), t(Cflat), t(prm), t(mm), t(rf), uer=False).numpy()
    assert port.shape == (K_, Npad)
    assert_same_scores(port[:, :n], jax_s[:, :n], REL_JAX)
    # every anchor row against the host kernel on the same vectors
    kern = rt.kern
    anchors = pool.node_arr[:n]
    for qi, q in enumerate(queries):
        qv = kern.import_tuples(q)
        for row in range(0, n, 3):
            vec = pool.eligible_vec(int(anchors[row]))
            h = kern.append_prob_node(kern.import_tuples(vec), qv, True,
                                      dc.oneMutBLen)
            d = port[qi, row]
            if math.isinf(h):
                assert math.isinf(d) or d < -1e250, (h, d)
            else:
                assert abs(h - d) <= REL_HOST * max(1.0, abs(h)), (h, d)


def test_model_from_numpy_matches_device_model_from(sub80_ref):
    refd, model, dc = model_for(sub80_ref, "UNREST", True, "site", seed=3)
    dm_j = AB.device_model_from(model, dc, dtype=jnp.float32)
    arrays = [np.asarray(a) for a in dm_j[:6]]
    from_np = TAB.model_from_numpy(*arrays, dm_j.use_rate_variation,
                                   dm_j.using_error_rate, device=CPU,
                                   dtype=torch.float32)
    direct = TAB.device_model_from(model, dc, device=CPU,
                                   dtype=torch.float32)
    for name, a in zip(AB.DeviceModel._fields[:6], arrays):
        for dm in (from_np, direct):
            got = getattr(dm, name)
            assert got.dtype == torch.float32 and got.device == CPU
            np.testing.assert_array_equal(got.numpy(), a, err_msg=name)
    assert from_np.use_rate_variation is direct.use_rate_variation is True
    assert from_np.using_error_rate is direct.using_error_rate is True


def test_wrapper_dispatches_by_device():
    """CPU tensors take the plain version; a device without a kernel
    raises instead of falling back; bad inputs to the kernel path raise
    before any launch."""
    rng = np.random.default_rng(0)
    P = torch.from_numpy(rng.random((4, NFIELDS, 8)))
    C = torch.from_numpy(rng.random((2, 1, 8 * NFIELDS)))
    prm = torch.zeros(2, 1, 4, dtype=torch.float64)
    mm = torch.zeros(1, 1, 16, dtype=torch.float64)
    rf = torch.full((1, 1, 4), 0.25, dtype=torch.float64)
    launches = TAP.append_scores_prestacked.launches
    out = TAP.append_scores_prestacked(P, C, prm, mm, rf, uer=False)
    assert out.shape == (2, 4)
    assert TAP.append_scores_prestacked.launches == launches
    with pytest.raises(ValueError, match="no kernel"):
        TAP.append_scores_prestacked(P.to("meta"), C.to("meta"),
                                     prm.to("meta"), mm.to("meta"),
                                     rf.to("meta"), uer=False)
    with pytest.raises(TypeError):
        TAP._check_inputs(P.float(), C, prm, mm, rf)
    with pytest.raises(ValueError, match="contiguous"):
        TAP._check_inputs(P.transpose(0, 2).contiguous().transpose(0, 2),
                          C, prm, mm, rf)
    with pytest.raises(ValueError, match="prm"):
        TAP._check_inputs(P, C, prm[:1], mm, rf)
