#!/usr/bin/env python3
"""The port's own spans (``maple_tpu_torch/runtime/phases.py``) held
against a ``torch.profiler`` trace of tree jobs of a cell, with the trace
switch on.  Not part of a benchmark run.

    python3 benchmark/spans_check.py --workload <cell> --seed <n> \\
        [--jobs 4] [--out spans_check.json] [--device cpu]

Prints one JSON line and writes the whole record to ``--out``:

- ``clock``: each profiler range of a main-thread span against the
  span's ``start_ns`` (the nearest of its name): the median and largest
  gap in us; the two clocks are one, so no offset is fitted;
- ``dispatch``: the ``proxy.dispatch`` spans of the screen thread, the
  kernel launches off the main thread inside them, and those outside
  (the pool's allocation in ``place.pool_init`` is counted apart);
- ``jobs``: for each tree, its wall, ``pipeline.rest_s.tree``'s remainder,
  ``Run.timings``, the inclusive seconds of ``run``, ``place``,
  ``post_placement`` and ``spr.round`` and their exclusive share, the
  exclusive seconds of every span name, the counters and the spans kept.

Without a CUDA device it exits 2 unless ``--device cpu`` names the CPU.
"""
import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
          "cuLaunchKernelEx")
COVER = ("run", "place", "post_placement", "spr.round")


def clock_gaps(tracers, ranges, ns):
    """Gaps (ns) between each range of a main-thread span's name and the
    nearest start of such a span."""
    starts = {}
    for tr in tracers:
        for name, thread, s, _ in tr.timeline():
            if thread == "MainThread" and name in ranges:
                starts.setdefault(name, []).append(s)
    gaps = []
    for name, ss in starts.items():
        ss.sort()
        for ev in ranges[name]:
            t = ns(ev)
            i = bisect.bisect_left(ss, t)
            near = [ss[j] for j in (i - 1, i) if 0 <= j < len(ss)]
            gaps.append(min((t - s for s in near), key=abs))
    return gaps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="b1429.tree-devspr")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="spans_check.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ["MAPLE_DEBUG_DEVBATCH"] = "1"      # the trace switch
    import torch
    from benchmark import trace
    from benchmark.harness import datasets, jobs
    from benchmark.harness.session import count_samples
    from benchmark.harness.spec import Cell
    from maple_tpu_torch.runtime import phases
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cpu") if args.device == "cpu" \
        else torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = Cell(args.workload)
    aln = datasets.make(cell, args.seed)
    jobs.warm(cell, aln, device, count_samples(aln))
    spans = trace.Spans(profiled=True)
    tmp = tempfile.mkdtemp(prefix="spans_check_")
    done = []
    gc.collect()
    gc.freeze()
    with trace.profile(tmp) as out:
        for k in range(args.jobs):
            done.append(jobs.run_tree(cell, aln, device,
                                      os.path.join(tmp, f"j{k}"), spans,
                                      time.time))
            gc.freeze()
    with open(out["path"]) as f:
        prof = json.load(f)
    base = int(prof["baseTimeNanoseconds"])
    tracers = phases.recent()[-args.jobs:]
    main_tid = threading.main_thread().native_id

    def ns(ev):
        return float(ev["ts"]) * 1000 + base

    ranges, launches = {}, []
    for ev in prof["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") in ("user_annotation", "cpu_op"):
            ranges.setdefault(ev["name"], []).append(ev)
        elif ev.get("cat") in ("cuda_runtime", "cuda_driver") \
                and ev["name"] in LAUNCH:
            launches.append((ns(ev), ev.get("tid")))
    gaps = clock_gaps(tracers, ranges, ns) or [float("nan")]
    clock = {"spans": len(gaps),
             "median_abs_us": statistics.median(map(abs, gaps)) / 1e3,
             "max_abs_us": max(map(abs, gaps)) / 1e3,
             "median_us": statistics.median(gaps) / 1e3}

    def kept(name):
        return [(s, e) for tr in tracers for n, _, s, e in tr.timeline()
                if n == name]

    disp, init = kept("proxy.dispatch"), kept("place.pool_init")
    side = [t for t, tid in launches if tid != main_tid]
    inside = [sum(1 for t in side if s <= t <= e) for s, e in disp]
    outside = [t for t in side if not any(s <= t <= e for s, e in disp)]
    dispatch = {"spans": len(disp),
                "spans_with_launches": sum(1 for n in inside if n),
                "launches_a_span": [min(inside, default=0),
                                    max(inside, default=0)],
                "off_main_launches": len(side),
                "outside": len(outside),
                "outside_in_pool_init": sum(
                    1 for t in outside if any(s <= t <= e for s, e in init))}

    rows = []
    for job, tr in zip(done, tracers):
        timings = job.counters["timings"]
        rows.append({
            "wall_s": job.wall_s,
            "rest_s": job.wall_s - sum(timings.values()),
            "timings": timings,
            "inclusive": {n: tr.inclusive(n) for n in COVER},
            "cover": {n: tr.exclusive(n) / tr.inclusive(n) for n in COVER
                      if tr.inclusive(n)},
            "exclusive": {n: tr.exclusive(n) for n in tr.names()},
            "counters": tr.counters(),
            "spans_kept": len(tr.timeline()), "dropped": tr.dropped})
    result = {"device": torch.cuda.get_device_name(device)
              if device.type == "cuda" else "cpu",
              "seed": args.seed, "clock": clock, "dispatch": dispatch,
              "jobs": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"device": result["device"], "clock": clock,
                      "dispatch": dispatch,
                      "cover": [r["cover"] for r in rows],
                      "spans_kept": [r["spans_kept"] for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
