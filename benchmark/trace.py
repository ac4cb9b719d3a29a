"""The benchmark's own spans around calls into the port, and the reading of
a ``torch.profiler`` trace of the window.

Spans: ``Spans.span(name)`` times a block on the host clock, on any
thread; in a traced run it also opens
``torch.profiler.record_function("bench:<name>")`` (the profiler keeps
those of the thread that started it; the spans both hold put the others
on the trace's clock).  ``wrap_port`` puts such spans around the port's
stages (``load``, ``place_stage``, ``post_placement``, ``root_search``,
``spr_rounds``, ``write``) and around the two device steps the rooflines
read (``proxy_step``, ``spr_screen_step``), by replacing the module
attributes that the port's callers look up at call time; ``unwrap``
restores them.  In a traced run each device step also queues, after its
span, the counts its roofline needs (real queries, rows holding anchors)
and the features' fill (nonzero weights of the queries and of the
changed anchor rows): no host wait inside the window.

The trace: the pattern of ``chip_smoke.py``'s ``device_events``
(``torch.profiler.profile`` with CPU and CUDA activities), exported as a
Chrome trace and reduced here: the device's busy intervals (kernels,
copies, sets; their union), the device time of the kernels launched inside
each benchmark span (by the time of their runtime call), the device
operations that took most time, and the idle time, labelled by the
latest-begun benchmark span open through it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench:"


class Spans:
    """Host spans of the benchmark; with ``profiled`` also in the trace."""

    def __init__(self, profiled=False):
        self.profiled = profiled
        self.records = []          # (name, start, end) on the host clock

    @contextlib.contextmanager
    def span(self, name):
        rf = (torch.profiler.record_function(PREFIX + name)
              if self.profiled else contextlib.nullcontext())
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))

    def total(self, name, since=0):
        """Seconds in spans called ``name`` among records[since:]."""
        return sum(t1 - t0 for n, t0, t1 in self.records[since:]
                   if n == name)


class StepWork:
    """What one device step's roofline needs: its shapes, and counts
    queued on its stream after its span (rows holding anchors, real
    queries, nonzero feature weights), read once the window has closed."""

    def __init__(self, kind, AF, rows, queries, q_fidx, changed, a_fidx,
                 topm, row_mask_bytes, q_nnz, a_nnz):
        self.kind = kind
        self.rows = rows
        self.queries = queries
        self.nnz = (q_nnz, a_nnz)           # device scalars: fill
        self.shape = {
            "D": int(AF.shape[1]), "elem": AF.element_size(),
            "q_feats": int(q_fidx.shape[1]),
            "q_index_bytes": q_fidx.element_size(), "changed": changed,
            "a_feats": 0 if a_fidx is None else int(a_fidx.shape[1]),
            "a_index_bytes": 0 if a_fidx is None else a_fidx.element_size(),
            "topm": topm, "row_mask_bytes": row_mask_bytes}

    def resolve(self):
        """The record ``benchmark/metrics/roofline.py`` counts."""
        q_nnz, a_nnz = self.nnz
        return {"kind": self.kind, "rows": int(self.rows.item()),
                "queries": int(self.queries.item()),
                "q_nnz": int(q_nnz.item()),
                "a_nnz": 0 if a_nnz is None else int(a_nnz.item()),
                **self.shape}


def _queries(q_fw):
    return (q_fw != 0).any(dim=1).sum()


def wrap_port(spans, work):
    """Put ``spans`` around the port's stages and device steps; in a
    traced run append each step's ``StepWork`` to ``work``.  Returns the
    list of (owner, attribute, original) to hand to ``unwrap``."""
    from maple_tpu_torch import pipeline
    from maple_tpu_torch.parallel import batch_spr, proxy_placer
    from maple_tpu_torch.search import rootsearch, spr

    saved = []

    def patch(owner, attr, make):
        orig = getattr(owner, attr)
        saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def around(name):
        def make(fn):
            def wrapped(*args, **kwargs):
                with spans.span(name):
                    return fn(*args, **kwargs)
            return wrapped
        return make

    for owner, attr, name in ((pipeline.Run, "load", "load"),
                              (pipeline.Run, "build_initial_tree_device",
                               "place_stage"),
                              (pipeline.Run, "post_placement",
                               "post_placement"),
                              (pipeline.Run, "write_outputs", "write"),
                              (rootsearch, "find_best_root", "root_search"),
                              (spr, "run_spr_rounds", "spr_rounds")):
        patch(owner, attr, around(name))

    def proxy(fn):
        def wrapped(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid, q_fidx,
                    q_fw, *, topm):
            with spans.span("proxy_step"):
                out = fn(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid,
                         q_fidx, q_fw, topm=topm)
            if spans.profiled:
                work.append(StepWork(
                    "proxy_step", AF, valid.sum(), _queries(q_fw), q_fidx,
                    int(upd_idx.shape[0]), upd_fidx, int(out[0].shape[1]),
                    valid.element_size(), (q_fw != 0).sum(),
                    (upd_fw != 0).sum()))
            return out
        return wrapped

    def screen(fn):
        def wrapped(AF, valid, a_tin, q_fidx, q_fw, q_lo, q_hi, excl, *,
                    topm):
            with spans.span("spr_screen_step"):
                out = fn(AF, valid, a_tin, q_fidx, q_fw, q_lo, q_hi, excl,
                         topm=topm)
            if spans.profiled:
                work.append(StepWork(
                    "spr_screen_step", AF, valid.sum(), _queries(q_fw),
                    q_fidx, 0, None, int(out[0].shape[1]),
                    valid.element_size() + a_tin.element_size(),
                    (q_fw != 0).sum(), None))
            return out
        return wrapped

    patch(proxy_placer, "proxy_step", proxy)
    patch(batch_spr, "spr_screen_step", screen)
    return saved


def unwrap(saved):
    for owner, attr, orig in reversed(saved):
        setattr(owner, attr, orig)


@contextlib.contextmanager
def profile(folder):
    """Profile the block; yields a dict that holds, after the block, the
    path of the exported Chrome trace under ``folder``."""
    from torch.profiler import ProfilerActivity
    out = {}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield out
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=folder)
    os.close(fd)
    prof.export_chrome_trace(path)
    out["path"] = path


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def _timeline(spans):
    """Consecutive (start, end, name) pieces of time, each labelled by the
    latest-begun of ``spans`` ((start, end, name)) open through it, or
    None where none is."""
    cuts = sorted({t for a, b, _ in spans for t in (a, b)})
    ordered = sorted(spans)
    out = []
    active = []
    j = 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(ordered) and ordered[j][0] <= a:
            active.append(ordered[j])
            j += 1
        active = [s for s in active if s[1] > a]
        out.append((a, b, active[-1][2] if active else None))
    return out


def _label_at(timeline, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and timeline[i][0] <= t < timeline[i][1]:
        return timeline[i][2]
    return None


def reduce_trace(path, host_spans):
    """The trace's numbers, in seconds.

    Spans: the benchmark's annotations the trace holds (those of the
    thread that started the profiler), and the host spans
    (``Spans.records``: (name, start, end) on the host clock, any thread)
    of every name the trace lacks, put on the trace's clock by the median
    offset of the spans both hold, matched by name and order.

    ``window_s``, the span ``window``; ``busy_s``, the union of device
    intervals inside it; ``span_device_s``, by span name, the device time
    of the kernels launched inside it, each kernel credited to the
    latest-begun span open when its runtime call was made; ``device_ops``
    and ``idle_gaps``, the 10 largest totals, by operation and by the
    latest-begun span open through each stretch of idle device time;
    ``align_us``, the spread of the offsets the host spans were put on
    the trace's clock by."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launches = [], {}
    traced = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(ev["ts"])
        elif cat == "user_annotation" and ev["name"].startswith(PREFIX):
            a = float(ev["ts"])
            traced[ev["name"][len(PREFIX):]].append((a, a + float(ev["dur"])))
    if not traced.get("window"):
        raise RuntimeError("the trace holds no window span")
    host = defaultdict(list)
    for name, t0, t1 in host_spans:
        host[name].append((t0 * 1e6, t1 * 1e6))
    offsets = sorted(tb[0] - hb[0] for name in traced
                     if len(traced[name]) == len(host[name])
                     for tb, hb in zip(sorted(traced[name]),
                                       sorted(host[name])))
    offset = offsets[len(offsets) // 2]
    w0, w1 = traced["window"][0]
    spans = [(a, b, name) for name, v in traced.items() if name != "window"
             for a, b in v]
    spans += [(a + offset, b + offset, name) for name, v in host.items()
              if name not in traced for a, b in v]
    timeline = _timeline(spans)
    starts = [piece[0] for piece in timeline]

    op_time = defaultdict(float)
    span_dev = defaultdict(float)
    intervals = []
    for ev in device:
        a = float(ev["ts"])
        dur = float(ev["dur"])
        lo, hi = max(a, w0), min(a + dur, w1)
        if hi <= lo:
            continue
        intervals.append((lo, hi))
        op_time[ev["name"]] += (hi - lo) * 1e-6
        t = launches.get(ev.get("args", {}).get("correlation"))
        if ev.get("cat") == "kernel" and t is not None:
            name = _label_at(timeline, starts, t)
            if name is not None:
                span_dev[name] += dur * 1e-6
    busy = _union(intervals)

    gaps = []
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = defaultdict(float)
    for a, b in gaps:
        # the timeline's pieces are contiguous from its first cut to its
        # last; outside them no span is open
        i = bisect.bisect_right(starts, a) - 1
        t = a
        while t < b:
            if i < 0:
                end = min(b, starts[0]) if starts else b
                label = None
            elif i < len(timeline):
                end = min(b, timeline[i][1])
                label = timeline[i][2]
            else:
                end, label = b, None
            idle[label or "none"] += (end - t) * 1e-6
            t = end
            i += 1

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]

    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "span_device_s": dict(span_dev), "device_ops": top(op_time),
            "idle_gaps": top(idle), "align_us": offsets[-1] - offsets[0]}
