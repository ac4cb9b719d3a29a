"""The device SPR pass inside a live engine session against the host pass
it replaces.

Inside a ``--deviceTopology`` run's engine session the proxy pass runs in
the session (``parallel/batch_spr.py`` ``_screen_session``): the engine
collects the queries and anchors from the resident tree, the store packs
their lists in the pair kernel's stacked layout, each query's screened
top-128 is re-scored in float64 by the pair kernel's gathered entry
(``spr_rescore``), and the engine applies the proposals.  Outside a
session (``native_session_eligible`` patched to False) the host pass
collects from ``rt.tree``, re-scores with the native appendProbNode
(``store.append_grid``) and applies with the copied ``apply_spr_moves``.

On the first pass of a run on 1,000 of the real B.1.429 genomes, with the
session live: the pair kernel's plain float64 versions and the gathered
entry's host walk (what CPU tensors run) against ``store.append_grid`` on
the pass's own pairs; the session's decision against the host's on the
same screened rows.  Whole runs on 1,000 and 3,000 genomes: the session
pass against the host pass, pass by pass.
"""
import numpy as np
import pytest
import torch

from maple_tpu_torch.config import MapleConfig
from maple_tpu_torch.native import engine as E
from maple_tpu_torch.ops import append_pairs as TAP
from maple_tpu_torch.ops import pack as OP
from maple_tpu_torch.ops.layout import stack_fields_host
from maple_tpu_torch.parallel import batch_spr as TB
from maple_tpu_torch.pipeline import run_inference

from test_torch_engine_session import assert_same_tree, flags_for
from test_torch_pipeline import read_lk

CPU = torch.device("cpu")
# Re-scores of one pair, float64, relative (floor 1): the pair kernel sums
# log factors entry pair by entry pair, the native appendProbNode multiplies
# the factors and takes the log of the product when it runs low, so the two
# part at the last bits.  On this pass (scores 0.82 to 231 in size) the
# largest gap is 8.5e-14 (8.5e-16 relative) for the walk and both plain
# versions; the same walk in float32 is 4.3e-5 off (5.5e-7 relative).
# 1e-11 lies between, with room both ways.
SCORE_TOL = 1e-11
# proposals' improvements: differences of such scores
IMPROVEMENT_TOL = 1e-11
PLAIN_DENSE_QUERIES = 48      # queries the dense plain version scores
PLAIN_GATHERED_QUERIES = 256  # queries the gathered plain version scores


def _host_decide(c, host, ti, placement_thresh):
    """The host pass's decision (``_screen_single_device``): each query's
    first argmax over its re-scored rows, then ``_accept``."""
    proposals = []
    for k in range(host.shape[0]):
        j = int(np.argmax(host[k]))
        best = float(host[k, j])
        if np.isfinite(best):
            TB._accept(proposals, int(c["q_node"][k]),
                       int(c["a_node"][int(ti[k, j])]), best,
                       float(c["q_base"][k]), placement_thresh)
    return proposals


@pytest.fixture(scope="module")
def first_pass(tmp_path_factory):
    """The state of the first device pass of a b1000 run, taken inside the
    live session: the collection, the screened rows, the native re-score
    of them, and the pair kernel's stacked operands."""
    tmp = tmp_path_factory.mktemp("b1000")
    box = {}
    real = TB._screen_session

    def probe(rt, ses, root, params, counters, t0, *, device, **kw):
        if not box:
            placement_thresh = params[3]
            c = ses.spr_collect(root, placement_thresh)
            store = rt.kern.store
            try:
                kept = []

                def keep(ts, ti):
                    kept.append((ts, ti))
                    return ts[:, 0], ti[:, 0]

                TB._queue_screen(
                    TB.ScreenPass("probe"), store, device, c["a_vid"],
                    c["q_vid"], c["a_tin"], c["q_lo"], c["q_hi"],
                    c["q_excl"], chunk=TB.PROXY_CHUNK, topm=TB.PROXY_TOPM,
                    rescore=keep)
                (ts, ti), = kept
                N = len(c["a_vid"])
                rows = torch.where((ti < N) & torch.isfinite(ts), ti,
                                   torch.full_like(ti, -1))
                r = rows.numpy()
                vP = np.where(r >= 0, c["a_vid"][np.maximum(r, 0)], -1)
                host = store.append_grid(vP, c["q_vid"], c["q_blen"],
                                         c["q_tip"])
                K = len(c["q_vid"])
                lRef = rt.refd.lRef
                box["py_P"], box["py_Q"] = (stack_fields_host(
                    OP.pack_genome_lists(
                        [store.to_tuples(int(v)) for v in vids[:64]], lRef,
                        int(lens.max()), False), None, None, axis=axis,
                    dtype=np.float64)
                    for vids, lens, axis in (
                        (c["a_vid"], c["a_len"], -2),
                        (c["q_vid"], c["q_len"], -1)))
                prm = np.stack([c["q_blen"], c["q_tip"].astype(np.float64),
                                np.full(K, float(rt.dc.globalTotRate)),
                                np.zeros(K)], axis=-1).reshape(K, 1, 4)
                box.update(
                    c={k: v.copy() for k, v in c.items()}, ts=ts, ti=ti,
                    rows=rows, host=host, thresh=placement_thresh,
                    P=TB._stacked(store, c["a_vid"], c["a_len"], False,
                                  device).clone(),
                    Q=TB._stacked(store, c["q_vid"], c["q_len"], True,
                                  device).reshape(K, 1, -1).clone(),
                    prm=torch.from_numpy(prm),
                    mm=torch.tensor(np.asarray(rt.model.mut_matrix,
                                               np.float64).reshape(1, 1, 16)),
                    rf=torch.tensor(np.asarray(rt.refd.root_freqs,
                                               np.float64).reshape(1, 1, 4)))
            finally:
                ses.spr_release()
        return real(rt, ses, root, params, counters, t0, device=device, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(TB, "_screen_session", probe)
    try:
        flags = flags_for(tmp, "b1000", True)
        run_inference(MapleConfig(output=str(tmp / "run"), **flags), CPU)
    finally:
        mp.undo()
    assert box, "no device pass ran in the session"
    return box


def assert_scores_match(got, host, what):
    got = np.asarray(got, np.float64)
    fin = np.isfinite(host)
    assert np.array_equal(np.isfinite(got), fin), f"{what}: -inf differs"
    assert fin.sum() > 1000, what
    gap = np.abs(got[fin] - host[fin]) / np.maximum(1.0, np.abs(host[fin]))
    assert gap.max() <= SCORE_TOL, f"{what}: largest gap {gap.max()}"


def test_pass_is_collected_from_the_session(first_pass):
    """The collection and the stacked operands of a real pass: every query
    gets 128 rows, most of them anchors, and the packed lists are the
    store's."""
    c, ti, P, Q = (first_pass[k] for k in ("c", "ti", "P", "Q"))
    K, N = len(c["q_node"]), len(c["a_node"])
    assert K > 900 and N > 700
    assert tuple(ti.shape) == (K, TB.PROXY_TOPM)
    assert (first_pass["rows"] >= 0).float().mean() > 0.9
    assert P.shape[:2] == (N, 16) and P.shape[2] == c["a_len"].max()
    assert Q.shape == (K, 1, 16 * c["q_len"].max())
    assert (c["q_lo"] < c["q_hi"]).all()
    assert ((c["q_excl"] >= -1) & (c["q_excl"] < N)).all()
    # the store's packing is the host's packing of the lists' tuples
    assert np.array_equal(P[:64].numpy(), first_pass["py_P"])
    assert np.array_equal(Q[:64].reshape(64, -1, 16).numpy(),
                          first_pass["py_Q"])


def test_plain_dense_kernel_matches_native(first_pass):
    """``append_scores_prestacked_plain`` of a slice of the queries against
    every anchor, read at each query's screened rows."""
    k = PLAIN_DENSE_QUERIES
    fp = first_pass
    dense = TAP.append_scores_prestacked_plain(
        fp["P"], fp["Q"][:k].contiguous(), fp["prm"][:k].contiguous(),
        fp["mm"], fp["rf"], uer=False)
    rows = fp["rows"][:k]
    got = torch.where(rows >= 0, dense.gather(1, rows.clamp(min=0)),
                      torch.full(rows.shape, float("-inf"),
                                 dtype=torch.float64))
    assert_scores_match(got, fp["host"][:k], "dense plain")


def test_plain_gathered_kernel_matches_native(first_pass):
    """``append_scores_gathered_plain`` on the screened rows themselves."""
    k = PLAIN_GATHERED_QUERIES
    fp = first_pass
    got = TAP.append_scores_gathered_plain(
        fp["P"], fp["Q"][:k].contiguous(), fp["prm"][:k].contiguous(),
        fp["mm"], fp["rf"], fp["rows"][:k].contiguous(), uer=False)
    assert_scores_match(got, fp["host"][:k], "gathered plain")


def test_gathered_walk_matches_native(first_pass):
    """The gathered entry on CPU tensors (the host build of the kernel's
    walk) on every screened row of the pass."""
    fp = first_pass
    got = TAP.append_scores_gathered(fp["P"], fp["Q"], fp["prm"], fp["mm"],
                                     fp["rf"], fp["rows"].contiguous(),
                                     uer=False)
    assert_scores_match(got, fp["host"], "gathered walk")


def test_session_decide_matches_host_decide(first_pass):
    """``spr_rescore`` and ``_proposals`` against the host's argmax and
    ``_accept`` on the same screened rows: the same proposals."""
    fp = first_pass
    c = fp["c"]
    best, row = TB.spr_rescore(fp["P"], fp["Q"], fp["prm"], fp["mm"],
                               fp["rf"], fp["ts"], fp["ti"], len(c["a_vid"]))
    got = TB._proposals(c["q_node"], c["a_node"], best.numpy(), row.numpy(),
                        c["q_base"], fp["thresh"])
    want = _host_decide(c, fp["host"], fp["ti"].numpy(), fp["thresh"])
    assert len(want) > 0
    assert [p[:2] for p in got] == [p[:2] for p in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        assert abs(a - b) <= IMPROVEMENT_TOL * max(1.0, abs(b))


def _recorded_run(tmp_path, monkeypatch, flags, name, session):
    """A whole run; each pass's sorted proposals and what its apply
    returned and moved."""
    passes = []
    real = TB._apply

    def record(rt, root, proposals, params, counters, *args, **kw):
        before = counters.topology_updates
        # the order _apply sorts them in (the host apply empties the list)
        props = sorted(proposals, key=lambda p: p[2])
        out = real(rt, root, proposals, params, counters, *args, **kw)
        passes.append((props, out, counters.topology_updates - before))
        return out

    with monkeypatch.context() as m:
        m.setattr(TB, "_apply", record)
        if not session:
            m.setattr(E, "native_session_eligible", lambda rt: False)
        out = str(tmp_path / name)
        run = run_inference(MapleConfig(output=out, **flags), CPU)
    with open(out + "_tree.tree") as f:
        newick = f.read()
    return run, passes, newick, read_lk(out)


@pytest.mark.parametrize("data", ["b1000", "b3000"])
def test_session_pass_equals_host_pass(tmp_path, monkeypatch, data):
    """The same proposals, pass by pass, the same moves applied with the
    same improvement, and the same tree and log-likelihood; every re-score
    of the session's run on the gathered entry, every one of the host
    run's on the host."""
    flags = flags_for(tmp_path, data, True)
    ses, p_ses, nwk_s, lk_s = _recorded_run(tmp_path, monkeypatch, flags,
                                            "session", True)
    host, p_host, nwk_h, lk_h = _recorded_run(tmp_path, monkeypatch, flags,
                                              "host", False)
    assert len(p_ses) == len(p_host) == ses.tracer.calls("spr.pass") >= 2
    for (props_s, out_s, moved_s), (props_h, out_h, moved_h) in zip(
            p_ses, p_host):
        assert [p[:2] for p in props_s] == [p[:2] for p in props_h]
        for a, b in zip(props_s, props_h):
            assert abs(a[2] - b[2]) <= IMPROVEMENT_TOL * max(1.0, abs(b[2]))
        assert moved_s == moved_h
        assert out_s[0] == out_h[0]
        assert abs(out_s[1] - out_h[1]) <= 1e-9
    assert sum(m for _, _, m in p_ses) > 0
    assert_same_tree(nwk_s, nwk_h)
    assert abs(lk_s - lk_h) <= 1e-9, (lk_s, lk_h)
    tr, tr_h = ses.tracer, host.tracer
    assert tr.counter("spr.native_passes") == len(p_ses)
    assert tr.counter("engine.suspends") == 0
    assert tr.counter("spr.rescored_host") == 0
    assert tr.counter("spr.rescored_device") \
        == tr_h.counter("spr.rescored_host") \
        == TB.PROXY_TOPM * tr.counter("spr.queries")
    assert tr.counter("spr.applied") == tr_h.counter("spr.applied")


def test_gathered_pair_count_is_the_dense_count(first_pass):
    """The gathered entry's work count: with every anchor as each query's
    rows, the dense count of ``count_contributing_pairs``."""
    fp = first_pass
    k, N = 8, fp["P"].shape[0]
    Q = fp["Q"][:k].contiguous()
    rows = torch.arange(N).repeat(k, 1)
    rows[0, :3] = -1                          # dead rows count nothing
    dense = TAP.count_contributing_pairs(fp["P"], Q)
    dead = TAP.count_contributing_pairs(fp["P"][:3], Q[:1])
    assert dense > 0 and dead > 0
    assert TAP.count_gathered_contributing_pairs(fp["P"], Q, rows) \
        == dense - dead
