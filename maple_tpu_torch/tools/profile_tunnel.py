"""Profile the device's dispatch path: the floor every device step pays
per call, and one batched placement-scoring call at its production shape.
The torch twin of the repository's ``scripts/profile_tunnel.py``, with its
measurements, argument names, defaults and output keys.

It measures, on the card (``--device cuda``, the default; it exits 2
without one) or on the CPU when that is named (``--device cpu``):

  1. null dispatch: the round trip of a trivial op (``x + 1`` on a float32
     scalar tensor, then ``torch.cuda.synchronize``), median over
     ``--reps``, after one untimed call;
  2. readback: device-to-host copies (``.cpu().numpy()``, into pageable
     memory as ``np.asarray`` copies) of 4 B and of 4 MB (a [1024, 1024]
     float32 tensor); ``readback_MB_per_s`` is 4.0 over the 4 MB wall;
  3. one call of the interval-algebra scorer
     (``ops.append_batch.grid_append_scores``, the legacy placer's default
     scorer), operands already on the device, the [B1, B2] score grid read
     back to the host inside the timed window: wall a call and scores/s,
     median over ``max(5, reps // 3)`` after one untimed call.

Shape names.  ``--K`` is the entry budget of every packed genome list,
``--B2`` the candidate rows and ``--B1`` the queries of the call, as in the
JAX script.  (In PERF.md's tables K / N / B1 / B2 mean queries /
candidates / the candidates' and queries' entry budgets, so the default
--K 128 --B2 2048 --B1 32 is K 32, N 2048, B1 = B2 = 128 there.)  The
operands are the first 64 (candidate upper vectors) and the next 32
(query tips) samples of ``--input`` (default the repository's 3,000-sample
B.1.429 subset), tiled as the JAX script tiles them: whole copies
concatenated, then cut to B2 candidate rows and B1 query rows.

One JSON line on standard output with the JAX script's keys, and appended
to ``--out`` when given.  ``backend`` is ``cuda`` or ``cpu``, ``device``
the card's name (or ``cpu``).  Times are in ms and not rounded.

    python3 -m maple_tpu_torch.tools.profile_tunnel [--device cpu]
        [--reps 30] [--K 128] [--B2 2048] [--B1 32] [--out result.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from .common import ROOT, device_error, device_kind

DEFAULT_INPUT = os.path.join(ROOT, "tests", "data_b1429_3000.maple.gz")
N_CANDIDATES, N_QUERIES = 64, 32      # distinct rows before tiling


def median_wall(fn, reps):
    """Median host wall of ``fn()`` over ``reps`` calls, in seconds."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def null_dispatch(device: torch.device, reps: int) -> float:
    """ms of one ``x + 1`` on a float32 scalar on ``device``, waited for."""
    x = torch.zeros((), dtype=torch.float32, device=device)

    def one():
        y = x + 1
        _sync(device)
        return y

    one()
    return median_wall(one, reps) * 1e3


def readback(device: torch.device, reps: int) -> dict:
    """ms of reading a float32 scalar and a [1024, 1024] float32 tensor
    back to the host, and the second's rate."""
    small = torch.zeros((), dtype=torch.float32, device=device)
    big = torch.zeros((1024, 1024), dtype=torch.float32, device=device)
    _sync(device)
    small_ms = median_wall(lambda: small.cpu().numpy(), reps) * 1e3
    wall_big = median_wall(lambda: big.cpu().numpy(), max(5, reps // 3))
    return {"readback_4B_ms": small_ms, "readback_4MB_ms": wall_big * 1e3,
            "readback_MB_per_s": 4.0 / wall_big}


def tile(arrays: dict, n: int) -> dict:
    """Each field's rows repeated whole and cut to ``n``, in row order."""
    return {k: torch.cat([v] * (n // v.shape[0] + 1))[:n]
            for k, v in arrays.items()}


def score_call_state(device: torch.device, K: int, B1: int, B2: int,
                     input: str = DEFAULT_INPUT,
                     dtype: torch.dtype = torch.float32,
                     n_candidates: int = N_CANDIDATES,
                     n_queries: int = N_QUERIES):
    """The scoring call's operands on ``device``: (``n_candidates`` upper
    vectors tiled to ``B2`` rows, ``n_queries`` tips tiled to ``B1`` rows,
    branch length, model), every genome list packed at entry budget
    ``K``."""
    from ..dryrun import _example_state
    from ..ops.append_batch import device_model_from, to_device
    _, model, dc, P, C = _example_state(n_candidates=n_candidates,
                                        n_queries=n_queries, budget=K,
                                        input=input)
    dm = device_model_from(model, dc, device=device, dtype=dtype)
    P_dev = tile(to_device(P, device=device, dtype=dtype), B2)
    C_dev = tile(to_device(C, device=device, dtype=dtype), B1)
    _sync(device)
    return P_dev, C_dev, dc.oneMutBLen, dm


def score_call(state):
    """One scoring call on ``state`` and its readback: the [B1, B2] grid
    as a numpy array."""
    from ..ops.append_batch import grid_append_scores
    P, C, blen, dm = state
    return grid_append_scores(P, C, blen, True, dm).cpu().numpy()


def profile(device: torch.device, reps: int = 30, K: int = 128,
            B1: int = 32, B2: int = 2048, input: str = DEFAULT_INPUT) -> dict:
    """The three measurements on ``device``, under the JAX script's keys."""
    res = {"backend": device.type, "device": device_kind(device),
           "reps": reps, "null_dispatch_ms": null_dispatch(device, reps)}
    res.update(readback(device, reps))
    state = score_call_state(device, K, B1, B2, input)
    score_call(state)
    wall = median_wall(lambda: score_call(state), max(5, reps // 3))
    res["score_call_shape"] = {"B1": B1, "B2": B2, "K": K}
    res["score_call_ms"] = wall * 1e3
    res["score_call_scores_per_s"] = B1 * B2 / wall
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m maple_tpu_torch.tools.profile_tunnel",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--K", type=int, default=128, help="entry budget")
    ap.add_argument("--B2", type=int, default=2048,
                    help="candidate-pool rows per call")
    ap.add_argument("--B1", type=int, default=32, help="queries per call")
    ap.add_argument("--input", default=DEFAULT_INPUT,
                    help="alignment in MAPLE format (.gz read too)")
    ap.add_argument("--out", default=None, help="append the JSON line here")
    args = ap.parse_args(argv)
    err = device_error(args.device)
    if err:
        print(f"profile_tunnel: {err}", file=sys.stderr)
        return 2
    res = profile(torch.device(args.device), args.reps, args.K, args.B1,
                  args.B2, args.input)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
