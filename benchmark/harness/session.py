"""One run of one cell: set-up, the window of jobs, the metrics, and the
judgement of the window's outputs against the plain reference.

``run_cell`` is what ``benchmark/run.py`` calls once it has found the
cards; the tests call it on the CPU (the port's plain PyTorch versions)
with the timed path broken underneath, to see ``correct`` come out false.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import gzip
import os
import shutil
import sys
import tempfile
import time

import torch

from .. import trace
from ..reference.judge import names_bad
from . import datasets, jobs
from .jobs import _sync
from .spec import peaks_for


def count_samples(aln):
    with gzip.open(aln, "rt") as f:
        return sum(1 for line in f if line.startswith(">")) - 1


class Records:
    """What the metric readers read: ``jobs`` (each a dict: ``kind``,
    ``wall_s``, ``samples`` and the job's counters), ``window_s``,
    ``setup_s``, and in a traced run ``trace`` (``trace.reduce_trace``),
    ``work`` (a device step's ``trace.StepWork.resolve()``) and ``peaks``."""

    def __init__(self, jobs, window_s, setup_s, trace=None, work=(),
                 peaks=None):
        self.jobs = jobs
        self.window_s = window_s
        self.setup_s = setup_s
        self.trace = trace
        self.work = list(work)
        self.peaks = peaks


def kind_of(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def roofline_lines(counts, peaks):
    """A line per step kind: its steps, the bound that wins, and the
    features' fill (mean nonzeros a query row and a changed anchor row,
    of D)."""
    from ..metrics.roofline import bound_s
    lines = []
    for kind in sorted({w["kind"] for w in counts}):
        steps = [w for w in counts if w["kind"] == kind]
        by = [bound_s(w, peaks)[1] for w in steps] if peaks else []
        k = sum(w["queries"] for w in steps)
        changed = sum(w["changed"] for w in steps)
        lines.append(
            f"# roofline {kind}: {len(steps)} steps, bound by flops "
            f"{by.count('flops')}, bytes {by.count('bytes')}; fill "
            f"{sum(w['q_nnz'] for w in steps) / max(k, 1):.1f} a query "
            f"row, {sum(w['a_nnz'] for w in steps) / max(changed, 1):.1f} "
            f"a changed anchor row, of D = {steps[0]['D']}")
    return lines


def check(numbers, limits):
    """{name: {"value", "limit"}} and whether every value is within its
    limit; a value that could not be read fails."""
    out = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or value > limit:
            ok = False
    return out, ok


def judge_outputs(outputs, aln, spec, log, readings=None):
    """The worst of each number over the judged outputs, and how many of
    them failed a limit.  ``spec`` is the cell's limits file.  A list
    ``readings`` gets, for each output, the numbers and beside them the
    ``lk_gap`` of the float32 control (the reference in float32 put in the
    port's place) and, where the port wrote site error rates, of the tree
    scored with them dropped (``errors_dropped_lk_gap``) and with each
    multiplied by 10 (``errors_x10_lk_gap``); a tree that is impossible
    under such rates (``likelihood.ZeroMerge``) reads inf."""
    from ..reference.judge import judge, reference_lk
    from ..reference.likelihood import ZeroMerge
    data = datasets.judge_data(aln)
    limits = spec["limits"]
    worst = {}
    failed = 0
    for tree, lk, rates, written in outputs:
        res = judge(data, tree, lk, rates, spec.get("lk_base"))
        if written is not None:
            res["names_bad"] += names_bad(written, data.samples)
        print(f"# judged: LK {lk!r}, reference LK {res['reference_lk']!r}, "
              + ", ".join(f"{k} {res.get(k)!r}" for k in limits),
              file=log, flush=True)
        if readings is not None and res["reference_lk"] is not None:
            f32 = reference_lk(data, tree, rates, "float32")
            res["control_lk_gap"] = abs(f32 - res["reference_lk"])
            eps = rates.site_error_rates
            if eps is not None:
                for name, bent in (("errors_dropped", None),
                                   ("errors_x10", [10 * e for e in eps])):
                    bad = dataclasses.replace(rates, site_error_rates=bent)
                    try:
                        res[name + "_lk_gap"] = abs(
                            lk - reference_lk(data, tree, bad))
                    except ZeroMerge:
                        res[name + "_lk_gap"] = float("inf")
            res["lk"] = lk
            readings.append(res)
            print(f"# readings: {res}", file=log, flush=True)
        failed += not check(res, limits)[1]
        for key in limits:
            v = res.get(key)
            w = worst.get(key, v)
            worst[key] = None if v is None or w is None else max(v, w)
    return worst, failed


def run_cell(cell, seed, seconds, traced, device, t_start, log=sys.stderr,
             readings=None):
    """One run; returns the result's dict (checks last), the lines to
    print last on standard error, and the metric readers' records.
    ``readings``: see ``judge_outputs``."""
    spans = trace.Spans(profiled=traced)
    work = []
    saved = trace.wrap_port(spans, work)
    tmp = tempfile.mkdtemp(prefix="bench_")
    try:
        aln = datasets.make(cell, seed)
        n_samples = count_samples(aln)
        jobs.warm(cell, aln, device, n_samples)
        work.clear()                    # the warm-up's steps are not timed
        run_job, output = jobs.KINDS[cell.traffic["kind"]]
        gc.collect()
        gc.freeze()
        prof = trace.profile(tmp) if traced else contextlib.nullcontext({})
        done = []
        with prof as prof_out:
            with spans.span("window"):
                t0 = time.time()
                setup_s = t0 - t_start
                while True:
                    done.append(run_job(cell, aln, device,
                                        os.path.join(tmp, f"job{len(done)}"),
                                        spans, time.time))
                    gc.freeze()
                    if time.time() - t0 >= seconds:
                        break
                _sync(device)
                window_s = time.time() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        trace.unwrap(saved)
        saved = []
        summary = None
        counts = []
        if traced:
            summary = trace.reduce_trace(prof_out["path"], spans.records)
            print(f"# trace: host spans put on the trace's clock within "
                  f"{summary['align_us']:.1f} us", file=log, flush=True)
            counts = [w.resolve() for w in work]
        work.clear()
        for line in roofline_lines(counts, peaks_for(kind_of(device))):
            print(line, file=log, flush=True)
        kind = kind_of(device)
        records = Records(
            [{"kind": j.kind, "wall_s": j.wall_s, "samples": j.samples,
              **j.counters} for j in done],
            window_s, setup_s, summary, counts, peaks_for(kind))
        metrics = {}
        for m in (cell.per_layer if traced else cell.end_to_end):
            value = cell.reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print("# jobs " + " ".join(f"{j.wall_s:.3f}s" for j in done),
              file=log, flush=True)

        # the judged outputs: every job of the window; the port reports
        # each, then its state is freed
        outputs = []
        for job in done:
            outputs.append(output(job))
            job.run = None
        gc.unfreeze()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_judge = time.time()
        numbers, failed = judge_outputs(outputs, aln, cell.limits, log,
                                        readings)
        checks, correct = check(numbers, cell.limits["limits"])
        print(f"# judged {len(outputs)} of {len(done)} jobs in "
              f"{time.time() - t_judge:.1f}s", file=log, flush=True)
        device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                       "kind": kind, "count": cell.chips,
                       "memory_peak_bytes": peak}
        result = {"correct": correct, "attempted": len(done),
                  "failed": failed,
                  "metrics": metrics, "device": device_info}
        if traced:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        result["checks"] = checks
        lines = [f"check {name}: {c['value']} (limit {c['limit']})"
                 for name, c in checks.items()]
        return result, lines, records
    finally:
        trace.unwrap(saved)
        shutil.rmtree(tmp, ignore_errors=True)
