"""The engine session of ``--deviceTopology`` runs (``native/engine.py``
``NativeSession``), against the one-shot engine phases it replaces.

Under ``--deviceTopology`` each stage (post-placement, root search,
re-root, SPR rounds) keeps the tree resident in one C++ engine.  The
device proxy SPR pass runs in the session (``parallel/batch_spr.py``
``_screen_session``: collected and applied by the engine, re-scored by the
pair kernel's gathered entry); a pass that reads the host tree (the
exhaustive screen, rate variation) suspends the session around itself
(``device_topology_update``).  With ``native_session_eligible`` patched to
False every engine phase imports and exports the tree on its own, and the
pass runs on the host tree (collected in Python, re-scored by
``store.append_grid``, applied by the copied ``apply_spr_moves``).  Both
must give the same tree: the same topology, names and lengths, the same
log-likelihood and the same applied SPR moves.  A session marks the
tree mutated only where a phase changed it; host-SPR runs, which held
sessions before, give the same tree under that rule as with the
recalculation gate off, as with a bump at every close, root search and
SPR pass, and as one-shot.
"""
import gzip
import os
import re

import pytest
import torch

from maple_tpu_torch.config import MapleConfig
from maple_tpu_torch.native import engine as E
from maple_tpu_torch.pipeline import run_inference

from test_torch_pipeline import SUB80, read_lk

B3000 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "data_b1429_3000.maple.gz")
CPU = torch.device("cpu")
TOL = 1e-9
SUB80_FLAGS = dict(input=SUB80, model="GTR", device_warmup=16,
                   device_batch_size=16, device_proxy_batch=32)
# the first samples of the 3,000 real B.1.429 genomes; at 1,000 the
# device passes apply SPR moves
SLICES = {"b300": 300, "b1000": 1000, "b3000": 3000}


@pytest.fixture(autouse=True)
def _default_branches(monkeypatch):
    for name in ("MAPLE_SPR_EXACT", "MAPLE_DEVICE_RT",
                 "MAPLE_DEVICE_LEGACY"):
        monkeypatch.delenv(name, raising=False)


def slice_alignment(path, n):
    """The reference and the first ``n`` samples of ``B3000``."""
    with gzip.open(B3000, "rt") as f:
        lines = f.read().splitlines(keepends=True)
    headers = [i for i, line in enumerate(lines) if line.startswith(">")]
    end = headers[n + 1] if n + 1 < len(headers) else len(lines)
    with open(path, "w") as f:
        f.writelines(lines[:end])
    return str(path)


def flags_for(tmp_path, data, device_placement, device_topology=True):
    if data == "sub80":
        flags = dict(SUB80_FLAGS)
    else:
        aln = slice_alignment(tmp_path / f"{data}.maple", SLICES[data])
        flags = dict(input=aln, model="UNREST")
    if not device_placement:
        flags = {k: v for k, v in flags.items()
                 if not k.startswith("device_")}
    return dict(flags, device_placement=device_placement,
                device_topology=device_topology, overwrite=True)


def run_tree(tmp_path, monkeypatch, flags, name, sessions=True):
    """Run the pipeline into ``tmp_path/name``; one-shot engine phases
    throughout where ``sessions`` is False."""
    with monkeypatch.context() as m:
        if not sessions:
            m.setattr(E, "native_session_eligible", lambda rt: False)
        out = str(tmp_path / name)
        run = run_inference(MapleConfig(output=out, **flags), CPU)
    with open(out + "_tree.tree") as f:
        newick = f.read()
    return run, newick, read_lk(out)


def assert_same_tree(a, b):
    """Same topology and names, lengths within ``TOL``."""
    ta = re.split(r"([(),:;])", a)
    tb = re.split(r"([(),:;])", b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        if x != y:
            assert ta[i - 1] == ":", (i, x, y)
            assert abs(float(x) - float(y)) <= TOL, (i, x, y)


def armed(tree) -> bool:
    return all(v is None or v.vid >= 0
               for arr in (tree.probVect, tree.probVectUpRight,
                           tree.probVectUpLeft, tree.probVectTotUp)
               for v in arr)


@pytest.mark.parametrize("data,device_placement,screen", [
    ("sub80", True, "proxy"), ("sub80", False, "proxy"),
    ("b300", True, "proxy"), ("b300", False, "proxy"),
    ("b1000", True, "proxy"), ("sub80", True, "exact")])
def test_session_tree_equals_one_shot(tmp_path, monkeypatch, data,
                                      device_placement, screen):
    """The proxy screen in the session, and the exhaustive one
    (``MAPLE_SPR_EXACT``) with the session suspended around it."""
    if screen == "exact":
        monkeypatch.setenv("MAPLE_SPR_EXACT", "1")
    flags = flags_for(tmp_path, data, device_placement)
    ses, nwk_s, lk_s = run_tree(tmp_path, monkeypatch, flags, "session")
    one, nwk_o, lk_o = run_tree(tmp_path, monkeypatch, flags, "oneshot",
                                sessions=False)
    assert_same_tree(nwk_s, nwk_o)
    assert abs(lk_s - lk_o) <= TOL, (lk_s, lk_o)
    for name in ("spr.applied", "spr.proposals"):
        assert ses.tracer.counter(name) == one.tracer.counter(name), name
    passes = ses.tracer.calls("spr.pass")
    assert passes == one.tracer.calls("spr.pass") > 0
    assert ses.tracer.counter("engine.sessions") > 0
    in_session = 0 if screen == "exact" else passes
    assert ses.tracer.counter("spr.native_passes") == in_session
    assert ses.tracer.counter("engine.suspends") == passes - in_session
    assert one.tracer.counter("engine.sessions") == 0
    assert one.tracer.counter("spr.native_passes") == 0
    if data == "b1000":
        assert ses.tracer.counter("spr.applied") > 0


def restore_epoch_bumps(m):
    """Bump the recalculation gate's epoch at every session close (and
    so suspend), root search and SPR pass, as sessions did before they
    marked only the phases that change the tree."""
    for name in ("close", "root_search", "spr_pass"):
        real = getattr(E.NativeSession, name)

        def bumped(self, *args, _real=real, **kw):
            if self.h is not None:
                self.rt.mark_mutated()
            return _real(self, *args, **kw)
        m.setattr(E.NativeSession, name, bumped)


@pytest.mark.parametrize("reference", ["gate_off", "every_bump",
                                       "one_shot"])
@pytest.mark.parametrize("data", ["sub80", "b1000"])
def test_host_spr_session_gate(tmp_path, monkeypatch, data, reference):
    """Host SPR (no ``--deviceTopology``) keeps its sessions; the epoch
    rule of a session changes only which full recomputes the gate skips,
    never the tree."""
    flags = flags_for(tmp_path, data, False, device_topology=False)
    ses, nwk_s, lk_s = run_tree(tmp_path, monkeypatch, flags, "session")
    with monkeypatch.context() as m:
        if reference == "gate_off":
            m.setenv("MAPLE_NO_RECALC_SKIP", "1")
        elif reference == "every_bump":
            restore_epoch_bumps(m)
        ref, nwk_r, lk_r = run_tree(tmp_path, monkeypatch, flags, "ref",
                                    sessions=reference != "one_shot")
    assert_same_tree(nwk_s, nwk_r)
    assert abs(lk_s - lk_r) <= TOL, (lk_s, lk_r)
    assert ses.tracer.counter("engine.sessions") > 0
    assert ses.tracer.counter("engine.suspends") == 0
    assert ses.tracer.calls("spr.pass") == 0
    assert (ref.tracer.counter("engine.sessions") > 0) \
        == (reference != "one_shot")
    assert ses.rt.native_session is None
    assert armed(ses.rt.tree)


def test_one_shot_spr_pass_marks_moves(tmp_path, monkeypatch):
    """``--estimateMAT`` keeps every engine phase one-shot, host SPR
    passes included.  A pass that moves the tree marks it mutated, so the
    full recompute after it runs: the tree is the one with the
    recalculation gate off (on 3,000 genomes a skipped recompute left two
    branch lengths some 1e-16 apart)."""
    flags = dict(flags_for(tmp_path, "b3000", False, device_topology=False),
                 estimateMAT=True)
    run, nwk, lk = run_tree(tmp_path, monkeypatch, flags, "gate")
    with monkeypatch.context() as m:
        m.setenv("MAPLE_NO_RECALC_SKIP", "1")
        _, nwk_off, lk_off = run_tree(tmp_path, monkeypatch, flags, "off")
    assert run.tracer.counter("engine.sessions") == 0
    assert run.tracer.counter("engine.transfers") > 0
    assert nwk == nwk_off
    assert lk == lk_off


@pytest.mark.parametrize("data,count,one_shot,fold", [
    ("sub80", 12, 67, 5), ("b300", 8, 60, 7), ("b1000", 8, 62, 7)])
def test_session_counters(tmp_path, monkeypatch, data, count, one_shot,
                          fold):
    """The device passes run in the session: no suspend, and ``count``
    transfers a tree: two a session (open, close: post-placement, root
    search, the re-root on sub80, the rounds) and two for each one-shot
    recalculation outside a session (the counting one before
    post-placement's session; on sub80 also the one after the re-root).
    One-shot phases take ``one_shot``, ``fold`` times as many or more."""
    flags = flags_for(tmp_path, data, True)
    run, _, _ = run_tree(tmp_path, monkeypatch, flags, "session")
    one, _, _ = run_tree(tmp_path, monkeypatch, flags, "oneshot",
                         sessions=False)
    tr = run.tracer
    passes = tr.calls("spr.pass")
    assert passes > 0
    assert tr.counter("spr.native_passes") == passes
    assert tr.counter("engine.suspends") == 0
    assert tr.calls("engine.suspend") == tr.calls("engine.resume") == 0
    transfers = tr.counter("engine.transfers")
    one_transfers = one.tracer.counter("engine.transfers")
    assert (transfers, one_transfers) == (count, one_shot)
    assert fold * transfers <= one_transfers
    assert one.tracer.counter("engine.suspends") == 0
    assert run.rt.native_session is None
    assert armed(run.rt.tree)


def test_failed_resume_goes_on_one_shot(tmp_path, monkeypatch):
    """A resume whose import finds the transfer unsafe leaves the rest of
    the rounds one-shot, with the same tree.  Rate variation keeps the
    device pass on the host tree, so the session is suspended around it."""
    flags = dict(flags_for(tmp_path, "b1000", True), rateVariation=True)
    real_import, real_resume = E._import_engine, E.NativeSession.resume
    failing = []

    def import_engine(rt, root, transfer):
        return None if failing else real_import(rt, root, transfer)

    def resume(self, root):
        failing.append(root)
        try:
            ok = real_resume(self, root)
        finally:
            failing.pop()
        assert not ok
        return ok

    with monkeypatch.context() as m:
        m.setattr(E, "_import_engine", import_engine)
        m.setattr(E.NativeSession, "resume", resume)
        run, nwk, lk = run_tree(tmp_path, monkeypatch, flags, "fallback")
    one, nwk_o, lk_o = run_tree(tmp_path, monkeypatch, flags, "oneshot",
                                sessions=False)
    assert run.tracer.counter("engine.suspends") == 1
    assert run.tracer.calls("spr.pass") > 1
    assert run.rt.native_session is None
    assert armed(run.rt.tree)
    assert_same_tree(nwk, nwk_o)
    assert abs(lk - lk_o) <= TOL, (lk, lk_o)
    assert run.tracer.counter("spr.applied") \
        == one.tracer.counter("spr.applied")
