"""The ``MAPLE_DEBUG_DEVBATCH`` stage profile of the port's three placers
against maple_tpu's, on example_sub80 and on 600 synthetic samples.

With the variable set, each package's placer runs on the same input: the
port's proxy placer counts in its run's tracer (``runtime/phases.py``) the
changed and dedup-skipped rows that maple_tpu's placer counts in
``_n_changed`` and ``_n_skipped`` (the same tree trajectory exports the
same rows), and records its stages as spans on the threads that run them;
the pipelined and legacy placers record the same stage keys.  The port's
placement is the same with and without the variable (LK, minors and
counts), and without it the tracer keeps no timeline and the rt-based
placers no ``_prof``.  Each side builds its tree with its own package.
"""
import pytest

import maple_tpu.parallel.batch_placement as JBP
import maple_tpu.parallel.pipelined_placer as JPP

from maple_tpu_torch.tools.common import ensure_dataset

from test_torch_proxy_placer import SUB80, make_run, placement_lk

PROFILE = "MAPLE_DEBUG_DEVBATCH"
BRANCH_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
              "MAPLE_PROXY_D", "MAPLE_SPR_EXACT")
# the port's proxy spans -> the thread that records them (name prefix)
PROXY_SPANS = {"place.pool_init": "place.init", "proxy.sync": "proxy.sync",
               "prep.batch": "proxy.prep",
               "proxy.query_export": "proxy.screen",
               "proxy.upload": "proxy.screen",
               "proxy.dispatch": "proxy.screen",
               "proxy.fetch": "proxy.screen",
               "place.wait.screen": "MainThread",
               "place.wait.prep": "MainThread",
               "place.wait.sync": "MainThread",
               "place.seeded": "MainThread", "place.serial": "MainThread"}
# the port's counters -> maple_tpu's attributes
PROXY_COUNTS = {"proxy.rows_changed": "_n_changed",
                "proxy.rows_skipped": "_n_skipped"}
PIPELINED_KEYS = {"export_queries", "pool_sync", "pack_queries", "dispatch",
                  "block", "host"}
LEGACY_KEYS = {"sync_pool", "model_warm", "score_readback", "mask",
               "host_apply"}
# input -> (run flags, build_initial_tree_device warmup and batch size of
# the rt-based placers)
INPUTS = {
    "sub80": (dict(model="GTR"), 16, 16),
    "synth600": (dict(model="UNREST"), 256, 64),
}
SMALL_PROXY = dict(device_warmup=16, device_proxy_batch=32)  # sub80


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in BRANCH_ENV + (PROFILE,):
        monkeypatch.delenv(name, raising=False)
    # the JAX proxy placer's stall fallback would place a slow screen's
    # batch unseeded: wait for every screen
    monkeypatch.setenv("MAPLE_SCREEN_TIMEOUT_S", "0")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("synth"))
    return {"sub80": SUB80,
            "synth600": ensure_dataset(work, 600, 1, 1.5, 0.2, 0.05)[0]}


def kept_placers(monkeypatch, module, cls_name):
    """maple_tpu's Run keeps no rt-based placer: record each one made."""
    kept = []
    base = getattr(module, cls_name)

    class Kept(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    monkeypatch.setattr(module, cls_name, Kept)
    return kept


def proxy_run(name, tmp_path, path, which):
    flags = dict(INPUTS[which][0], **(SMALL_PROXY if which == "sub80"
                                       else {}))
    run = make_run(name, tmp_path, input=path, device_placement=True,
                   **flags)
    run.build_initial_tree_device(warmup=run.cfg.device_warmup)
    assert run.proxy_placer is not None
    return run, placement_lk(run)


def rt_run(name, tmp_path, path, which):
    flags, warmup, batch = INPUTS[which]
    run = make_run(name, tmp_path, input=path, device_placement=True,
                   **flags)
    run.build_initial_tree_device(warmup=warmup, batch_size=batch)
    return run, placement_lk(run)


@pytest.mark.parametrize("which", sorted(INPUTS))
def test_proxy_profile_matches_maple_tpu(tmp_path, monkeypatch, capsys,
                                         inputs, which):
    path = inputs[which]
    run0, lk0 = proxy_run("maple_tpu_torch", tmp_path, path, which)
    tr0 = run0.tracer
    assert not tr0.traced and tr0.timeline() == []
    monkeypatch.setenv(PROFILE, "1")
    capsys.readouterr()
    run, lk = proxy_run("maple_tpu_torch", tmp_path, path, which)
    out = capsys.readouterr().out
    jax_run, _ = proxy_run("maple_tpu", tmp_path, path, which)
    pl, jpl, tr = run.proxy_placer, jax_run.proxy_placer, run.tracer
    assert tr.traced and jpl._prof
    assert lk == lk0
    assert run.stats.num_minors_found == run0.stats.num_minors_found
    for name, twin in PROXY_COUNTS.items():
        assert tr.counter(name) == getattr(jpl, twin) \
            == tr0.counter(name), name
    assert tr.counter("proxy.rows_changed") > 0
    threads = {}
    for name, thread, count, incl, excl in tr.rows():
        threads.setdefault(name, set()).add(thread)
        assert count > 0 and 0.0 <= excl <= incl, name
    kept = {name for name, *_ in tr.timeline()}
    for name, thread in PROXY_SPANS.items():
        assert any(t.startswith(thread) for t in threads[name]), \
            (name, threads.get(name))
        assert name in kept, name
    # the placer's counters are read from its spans
    assert pl.time_wait == pytest.approx(tr.inclusive("place.wait.screen"))
    assert pl.time_place == pytest.approx(tr.inclusive("place.seeded"))
    assert pl.time_screen == pytest.approx(
        tr.inclusive("proxy.upload") + tr.inclusive("proxy.dispatch")
        + tr.inclusive("proxy.fetch"))
    assert out.count("[proxy] nf query p50=") == 1
    assert pl.stage_split().startswith("[upload ")
    assert pl.stage_split().endswith(
        f" rows {tr.counter('proxy.rows_changed')} skip "
        f"{tr.counter('proxy.rows_skipped')}]")


@pytest.mark.parametrize("which", sorted(INPUTS))
@pytest.mark.parametrize("branch,module,cls_name,placer,keys", [
    ("MAPLE_DEVICE_RT", JPP, "PipelinedPlacer", "pplacer", PIPELINED_KEYS),
    ("MAPLE_DEVICE_LEGACY", JBP, "BatchedPlacer", "legacy_placer",
     LEGACY_KEYS)], ids=["pipelined", "legacy"])
def test_rt_placer_profile_keys_match_maple_tpu(
        tmp_path, monkeypatch, inputs, which, branch, module, cls_name,
        placer, keys):
    path = inputs[which]
    monkeypatch.setenv(branch, "1")
    run0, lk0 = rt_run("maple_tpu_torch", tmp_path, path, which)
    assert getattr(run0, placer)._prof is None
    monkeypatch.setenv(PROFILE, "1")
    run, lk = rt_run("maple_tpu_torch", tmp_path, path, which)
    kept = kept_placers(monkeypatch, module, cls_name)
    rt_run("maple_tpu", tmp_path, path, which)
    prof = getattr(run, placer)._prof
    assert set(prof) == set(kept[-1]._prof) == keys
    assert all(v >= 0.0 for v in prof.values())
    assert lk == lk0
    assert run.stats.num_minors_found == run0.stats.num_minors_found


def test_legacy_profile_prints_every_40_batches(tmp_path, monkeypatch,
                                                capsys):
    """The legacy placer's ``[devbatch]`` line: one every 40 scored
    batches (batches of one sample on example_sub80)."""
    monkeypatch.setenv("MAPLE_DEVICE_LEGACY", "1")
    monkeypatch.setenv(PROFILE, "1")
    run = make_run("maple_tpu_torch", tmp_path, input=SUB80, model="GTR",
                   device_placement=True)
    run.build_initial_tree_device(warmup=16, batch_size=1)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[devbatch] ")]
    batches = run.legacy_placer._prof_batches
    assert batches >= 40 and len(lines) == batches // 40
    assert set(eval(lines[0][len("[devbatch] "):])) == LEGACY_KEYS
