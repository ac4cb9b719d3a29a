#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``maple_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; what it names is
found by name under ``benchmark/`` (``harness/spec.py``).  The run makes
the cell's dataset from ``--seed``, warms the cell's shapes (set-up,
``setup_s``), runs the cell's jobs back to back for ``--seconds`` (the job
running when they have passed finishes and counts), and judges the outputs
of every job of the window against the plain reference in
``benchmark/reference/``.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window, the benchmark's spans and the
port's counters.

The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines on standard error repeat the checks.  Everything the port
prints goes to standard error.  Without a CUDA device, or with fewer than
the cell asks for, the run prints no result and exits 2; if JAX or the JAX
package is loaded once the window has closed, it exits 3.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
BANNED = ("jax", "jaxlib", "flax", "maple_tpu")


def banned_modules():
    """Top-level names of loaded modules that the run may not load."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's build and kernel caches live in the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if args.trace:
        os.environ["MAPLE_DEBUG_DEVBATCH"] = "1"
    sys.stdout.flush()
    result_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)          # the port's and its native library's prints

    from benchmark.harness.spec import Cell
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"no CUDA device, or fewer than the {cell.chips} that "
              f"{cell.name} asks for: no result", file=sys.stderr)
        return 2
    from benchmark.harness.session import run_cell
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"# {cell.name} seed {args.seed} trace {args.trace}: "
          f"{power_limit()}", file=result_out, flush=True)

    result, lines, _ = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), device, T_START)
    found = banned_modules()
    if found:
        print(f"loaded once the window closed: {', '.join(found)}: "
              "no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), file=result_out, flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT          # the checkout, not benchmark/
    sys.exit(main())
