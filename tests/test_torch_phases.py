"""The phase tracer of ``maple_tpu_torch`` (``runtime/phases.py``): nested
spans opened as blocks and reported after the fact, spans on several
threads at once, the bounded timeline, the trace switch, the clock of the
profiler's trace, one tracer in ``recent()`` per ``Run.run``, and the
benchmark's readers of the tracer on a small tree job on the CPU.
"""
import json
import os
import statistics
import sys
import threading
import time

import pytest
import torch

from maple_tpu_torch.config import MapleConfig
from maple_tpu_torch.pipeline import Run
from maple_tpu_torch.runtime import phases
from maple_tpu_torch.runtime.phases import PHASES, TRACE_ENV, Tracer

from benchmark.harness import jobs
from benchmark.harness.session import Records
from benchmark.harness.spec import Cell

HERE = os.path.dirname(os.path.abspath(__file__))
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
CELL = "b1429.tree-devspr"
READERS = ("engine.em_s", "engine.blen_s", "engine.recalc_s",
           "engine.root_search_s", "place.engine_s", "place.wait_s")
CPU = torch.device("cpu")


class FakeClock:
    """``time`` for the tracer: ``time_ns`` reads ``now``."""

    def __init__(self):
        self.now = 0

    def time_ns(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(phases, "time", fake)
    return fake


@pytest.fixture(autouse=True)
def switch_off(monkeypatch):
    monkeypatch.delenv(TRACE_ENV, raising=False)


def stats(tr):
    """{name: (count, inclusive ns, exclusive ns)} of one thread."""
    return {name: (c, round(i * 1e9), round(x * 1e9))
            for name, _, c, i, x in tr.rows()}


def test_nested_blocks(clock):
    tr = Tracer()
    clock.now = 0
    with tr.span("outer") as outer:
        clock.now = 10
        with tr.span("inner"):
            clock.now = 40
        clock.now = 50
        with tr.span("inner"):
            clock.now = 60
            with tr.span("leaf"):
                clock.now = 65
        clock.now = 100
    assert outer.seconds == pytest.approx(100e-9)
    assert stats(tr) == {"outer": (1, 100, 55), "inner": (2, 45, 40),
                         "leaf": (1, 5, 5)}


def test_nested_after_the_fact(clock):
    """add() takes as children the closed spans of its thread that ended
    after it began, inside an open block as at the thread's root."""
    tr = Tracer()
    with tr.span("outer"):
        clock.now = 10
        with tr.span("child"):
            clock.now = 20
        clock.now = 30
        tr.add("phase", 25e-9)          # [5, 30]: holds child
        clock.now = 35
        tr.add("late", 2e-9)            # [33, 35]: holds nothing
        clock.now = 100
    clock.now = 110
    with tr.span("b"):
        clock.now = 120
    clock.now = 200
    tr.add("root_phase", 95e-9)         # [105, 200]: holds b
    assert stats(tr) == {"outer": (1, 100, 73), "child": (1, 10, 10),
                         "phase": (1, 25, 15), "late": (1, 2, 2),
                         "b": (1, 10, 10), "root_phase": (1, 95, 85)}
    # phase_times-style view: inclusive seconds by name
    view = tr.totals(names=("phase", "late", "absent"))
    assert dict(view) == {"phase": pytest.approx(25e-9),
                          "late": pytest.approx(2e-9)}
    assert tr.totals(prefix="ro") == {"ot_phase": pytest.approx(95e-9)}


def test_same_name_inside_is_part_of_its_span(clock):
    tr = Tracer()
    with tr.span("write"):
        clock.now = 5
        with tr.span("write") as inner:
            clock.now = 8
        clock.now = 10
    assert inner.seconds == pytest.approx(3e-9)
    assert stats(tr) == {"write": (1, 10, 10)}


def test_phase_times_is_a_view_of_the_tracer(clock):
    from maple_tpu_torch.runtime.partials import TreeRuntime
    rt = TreeRuntime.__new__(TreeRuntime)
    rt.tracer = Tracer()
    rt.phase_times = rt.tracer.totals(PHASES)
    clock.now = 100
    rt.add_phase_time("tree_lk", 30e-9)
    clock.now = 200
    rt.add_phase_time("recalculate", 150e-9)   # holds tree_lk
    with rt.tracer.span("not_a_phase"):
        clock.now = 300
    assert dict(rt.phase_times) == {"tree_lk": pytest.approx(30e-9),
                                    "recalculate": pytest.approx(150e-9)}
    assert rt.tracer.exclusive("recalculate") == pytest.approx(120e-9)


def test_spans_on_three_threads():
    tr = Tracer()
    barrier = threading.Barrier(3)
    errors = []

    def work(k):
        try:
            barrier.wait(timeout=10)
            with tr.span("outer"):
                for _ in range(k + 1):
                    with tr.span("inner"):
                        time.sleep(0.01)
                    tr.count("n")
                t0 = time.time()
                time.sleep(0.005)
                tr.add("late", time.time() - t0)
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,), name=f"w{k}")
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    rows = {(name, thread): (c, i, x) for name, thread, c, i, x in tr.rows()}
    assert {t for _, t in rows} == {"w0", "w1", "w2"}
    for k in range(3):
        c, i, x = rows[("outer", f"w{k}")]
        ci, ii, xi = rows[("inner", f"w{k}")]
        cl, il, xl = rows[("late", f"w{k}")]
        assert (c, ci, cl) == (1, k + 1, 1)
        assert xi == pytest.approx(ii) and xl == pytest.approx(il)
        assert x == pytest.approx(i - ii - il, abs=1e-8)
        assert 0 <= x < 0.005
    assert tr.counter("n") == 6
    assert tr.calls("inner") == 6


def test_no_update_lost_under_many_threads():
    """More threads than cores, switching often: every span and count of
    every thread is kept."""
    tr = Tracer(traced=True)
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with tr.span("s"):
                    tr.add("t", 0.0)
                tr.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_spans
    assert tr.calls("s") == tr.calls("t") == tr.counter("n") == total
    assert len(tr.timeline()) == 2 * total and tr.dropped == 0


def test_bounded_timeline_counts_its_drops():
    tr = Tracer(traced=True, timeline_cap=4)
    for k in range(10):
        with tr.span(f"s{k}"):
            pass
    kept = tr.timeline()
    assert [name for name, *_ in kept] == ["s6", "s7", "s8", "s9"]
    assert tr.dropped == 6
    for name, thread, start, end in kept:
        assert thread == threading.current_thread().name
        assert 0 < start <= end
    assert tr.calls("s0") == 1            # the aggregates keep every span


def test_switch_off_keeps_no_timeline_and_opens_no_profiler_range(
        monkeypatch):
    opened = []

    class Recorded:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(phases, "profiler_range", Recorded)
    tr = Tracer()
    assert not tr.traced
    with tr.span("a"):
        tr.add("b", 0.0)
    assert tr.timeline() == [] and tr.dropped == 0 and opened == []
    assert tr.calls("a") == tr.calls("b") == 1
    monkeypatch.setenv(TRACE_ENV, "1")
    tr = Tracer()
    assert tr.traced
    with tr.span("a"):
        tr.add("b", 0.0)
    assert opened == ["a"]
    assert [name for name, *_ in tr.timeline()] == ["b", "a"]


def test_spans_on_the_profilers_clock(tmp_path):
    """A span's start_ns and its profiler range in the exported trace
    (ts * 1000 + baseTimeNanoseconds) are one clock."""
    tr = Tracer(traced=True)
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(100):
            with tr.span(f"clock.{k}"):
                pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    events = {ev["name"]: ev for ev in trace["traceEvents"]
              if ev.get("ph") == "X" and ev["name"].startswith("clock.")}
    gaps = [abs(float(events[name]["ts"]) * 1000 + base - start)
            for name, _, start, _ in tr.timeline()]
    assert len(gaps) == 100
    assert statistics.median(gaps) <= 20_000


# ----------------------------------------------------------------------
# a run, the warm-up of the benchmark, the readers

def tree_job(tmp_path):
    """A small tree job on the CPU with the flags of the benchmark's tree
    cell, the placer's batches cut to the 80 samples."""
    cfg = MapleConfig(input=SUB80, output=str(tmp_path / "sub80"),
                      model="UNREST", overwrite=True, device_placement=True,
                      device_topology=True, device_warmup=16,
                      device_proxy_batch=32)
    run = Run(cfg, CPU)
    t0 = time.time()
    run.run()
    return run, time.time() - t0


def test_one_tracer_a_run_and_none_from_the_warm_up(tmp_path, capsys):
    before = phases.recent()
    run, _ = tree_job(tmp_path)
    after = phases.recent()
    assert after[-1] is run.tracer and run.tracer.closed
    assert len(after) == min(len(before) + 1, phases.RECENT_CAP)
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("Phase breakdown")]
    assert len(line) == 1 and " run=" in line[0] \
        and "spr.queries=" in line[0]
    tr = run.tracer
    assert tr.calls("run") == 1 and tr.calls("spr.round") == 2
    for name in ("load", "place", "post_placement", "write", "spr.pass",
                 "spr.collect", "spr.pack", "spr.decide", "spr.apply",
                 "place.seeded", "place.wait.screen", "proxy.dispatch"):
        assert tr.calls(name) > 0, name
    # the phases keep their names and their inclusive seconds
    assert set(run.rt.phase_times) == set(PHASES)
    for name, seconds in run.rt.phase_times.items():
        assert seconds == pytest.approx(tr.inclusive(name))
    jobs.warm(Cell(CELL), SUB80, CPU, 80)
    assert phases.recent()[-1] is run.tracer
    assert len(phases.recent()) == len(after)


def test_readers_of_the_tracer_on_a_tree_job(tmp_path):
    run, wall = tree_job(tmp_path)
    rec = Records([{"kind": "tree", "wall_s": wall, "samples": None,
                    "timings": dict(run.timings)}], wall, 0.0)
    cell = Cell(CELL)
    assert {m["name"] for m in cell.per_layer} >= set(READERS)
    tr = run.tracer
    for name in READERS:
        value = cell.reader(name)(rec)
        assert isinstance(value, float) and value >= 0.0, name
    assert cell.reader("engine.em_s")(rec) == pytest.approx(
        tr.exclusive("em"))
    assert cell.reader("place.wait_s")(rec) == pytest.approx(sum(
        tr.exclusive(n) for n in tr.names() if n.startswith("place.wait.")))
    # a window of more tree jobs than tracers gives nothing
    two = Records(rec.jobs * (len(phases.recent()) + 1), wall, 0.0)
    assert all(cell.reader(name)(two) is None for name in READERS)
