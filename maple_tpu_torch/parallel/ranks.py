"""Run one function on N ``torch.distributed`` ranks of this host.

``run_ranks`` starts N fresh processes (``spawn``), gives each its rank and
its device, joins them into one process group over a ``tcp://localhost``
rendezvous, calls ``fn(rank, device, *args)`` in each and returns the N
results in rank order.  Every rank has the same time limit: a rank that
fails, or that is still running when the limit passes (a collective that
some rank never joined), ends the whole run with an error, and no process
is left behind.  ``gloo`` ranks use the CPU; ``nccl`` rank r uses
``cuda:r``.
"""
from __future__ import annotations

import datetime
import multiprocessing
import socket
import time
import traceback

import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(backend: str, rank: int) -> torch.device:
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    raise ValueError(f"backend {backend!r} (gloo or nccl)")


def init_group(backend: str, rank: int, world: int, port: int,
               timeout: float) -> torch.device:
    """Join the process group of ``world`` ranks at localhost:``port``;
    returns this rank's device."""
    device = rank_device(backend, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)   # NCCL binds a rank to one card
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return device


def _rank_main(fn, rank, world, backend, port, timeout, conn, args):
    try:
        torch.set_num_threads(1)
        device = init_group(backend, rank, world, port, timeout)
        try:
            out = fn(rank, device, *args)
        finally:
            dist.destroy_process_group()
        conn.send(("ok", out))
    except BaseException:  # reported to the parent, which raises
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_ranks(fn, n_ranks: int, *, backend: str, timeout: float, args=()):
    """``[fn(rank, device, *args) for rank in range(n_ranks)]``, each call
    in its own process of one ``backend`` group.  ``fn`` and ``args`` go
    through pickle: ``fn`` is a module-level function.  Raises
    ``RuntimeError`` with a rank's traceback when it failed, and
    ``TimeoutError`` when a rank gave no result within ``timeout``
    seconds."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs, conns = [], []
    try:
        for rank in range(n_ranks):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(fn, rank, n_ranks, backend, port, timeout,
                                  send, args))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        deadline = time.monotonic() + timeout
        results = []
        for rank, conn in enumerate(conns):
            try:
                ready = conn.poll(max(0.0, deadline - time.monotonic()))
                status, value = conn.recv() if ready else ("timeout", None)
            except EOFError:
                status, value = "error", "the process ended with no result"
            if status == "timeout":
                raise TimeoutError(f"rank {rank} of {n_ranks} gave no "
                                   f"result within {timeout} s")
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n"
                                   f"{value}")
            results.append(value)
        return results
    finally:
        for p in procs:
            p.join(timeout=0 if p.exitcode is not None else 5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for conn in conns:
            conn.close()
