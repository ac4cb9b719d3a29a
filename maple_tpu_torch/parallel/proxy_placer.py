"""Device proxy screen + engine seeded placement (the default
``--devicePlacement`` path).

The torch twin of the single-device half of the JAX package's
``parallel/proxy_placer.py``.  Screening every query against every anchor
with the exact pair kernel costs far more than the placement decisions
need; this path replaces both ends of that design:

* **Screen with one matrix product.**  Each anchor's mid-branch vector and
  each query are embedded as sparse features over a fixed D-dimensional
  space (hashed (position, nucleotide) buckets of non-reference entries +
  genome-interval buckets for missing-data coverage + a bias term,
  extracted engine-side in C++: native/maple_native.cpp feat_extract).
  The screen is then ONE [K, D] x [D, cap] product: qf . af = 2 * |shared
  muts| - |anchor muts| + N-coverage correction, a monotone proxy (up to
  hash collisions) for the exact relative appendProbNode score.
* **Decide on the engine, not in Python.**  The device returns only the
  top-M anchor rows per query; the C++ engine then runs a *seeded*
  best-first crawl from those anchors against the live tree (exact
  appendProbNode scores, minor-sequence absorption, reference stop rules:
  native E_find_best_parent_budget in seeded mode) and applies through the
  same serially re-validated batch apply as engine_place_batch.  Proxy
  error and pipeline staleness therefore cost recall only, never
  exactness: every decision is made on live vectors by the exact kernels.
* **One-batch-deep pipelining.**  Batch i+1's screen is queued before batch
  i is applied; the engine's changed-node log (engine_screen_drain) tells
  the host which pool rows to re-export between screens.

Who touches what.  The host export threads produce numpy arrays only.
Every tensor operation on the pool (``AF``, ``valid``) is queued by the
single screen thread, on the pool's own CUDA stream; a step's results go to
pinned host buffers behind an event recorded on that stream, and ``_fetch``
waits on that event, never on the device as a whole.

Over a (dp x cand) mesh of ``torch.distributed`` ranks
(:mod:`maple_tpu_torch.parallel.mesh`) the pool's rows shard over ``cand``:
each rank holds ``cap / cand`` of them, and :func:`proxy_step_sharded`
scatters the rows it owns, scores every query against its slice and merges
the ranks' top-M winners.  The engine, the tree and the apply stay
replicated: every rank runs the same host pipeline on the same merged
result.  The screen thread is the only one that queues a collective, inside
``on_stream()``: a collective is ordered after the current stream, which is
what orders the gather after the local top-k.

The placer records into its run's tracer (``runtime/phases.py``), on the
thread that does the work:

* ``place.pool_init`` (the pool's allocation, on the thread that builds
  the placer);
* ``proxy.sync`` (``_sync_pool``, the sync thread): the anchor feature
  export, with the counters ``proxy.rows_changed`` and
  ``proxy.rows_skipped``, the changed nodes it exported and those the
  fingerprint dedup dropped;
* ``prep.batch`` (the prep thread): the next batch's terminal vectors;
* ``proxy.query_export``, ``proxy.upload``, ``proxy.dispatch`` and
  ``proxy.fetch`` (``_submit`` and ``_fetch``, the screen thread): the
  batch's query features; on CUDA the pinned staging of the step's arrays
  and the queueing of their copies, not the copies themselves; queueing
  the step and its result copies on the pool's stream, not the device's
  work (``time_device`` has that); the wait on the step's done event,
  device work included;
* on the main thread the three joins of ``place_all``,
  ``place.wait.screen``, ``place.wait.prep`` and ``place.wait.sync``, and
  ``place.seeded`` (``_place``: the engine's seeded placement) with the
  model refreshes inside it as ``place.serial``.

The ``time_*`` counters are read from those spans.  With the trace switch
(``MAPLE_DEBUG_DEVBATCH=1``) the placer also prints the first full
batch's feature counts (percentiles), "slow submit" above 1.0 s and
"slow fetch" above 0.5 s, and the stage sums in brackets on the progress
line of ``place_all`` (``stage_split``).  The JAX twin's "initial pool
build spilled" line has no counterpart: the port scatters a sync's rows
unpadded in one step and never spills.

Reference contract being replaced: the strictly serial stepwise addition
loop, MAPLEv0.7.5.4.py:11692-11752 with the per-sample DFS at :7912-8293.
"""
from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .proxy_features import (BF16_CAP, BF16_TOPM, FMAX_ANCHOR, FMAX_QUERY,
                             _f_bucket, feature_dims, proxy_scores,
                             scatter_only)
from .stacked_pool import to_host, upload


def proxy_step(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid,
               q_fidx, q_fw, *, topm: int):
    """Scatter stale anchor rows + proxy product + top-M.  Twin of
    ``_proxy_step`` of the JAX package.

    AF [cap, D] float32 or bfloat16 and valid [cap] bool are updated in
    place (the JAX step donated them); upd_idx [R] int (unique rows),
    upd_fidx [R, Fa] int, upd_fw [R, Fa] float32, upd_valid [R] bool,
    q_fidx [K, Fq] int, q_fw [K, Fq] float32.  Returns float32
    (topm_scores [K, M], topm_rows [K, M]) with M = min(topm, cap).

    The product runs over the full pool capacity; unassigned and invalid
    rows are masked to -inf before the top-k.  The top-k is exact."""
    if upd_idx.shape[0]:
        scatter_only(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid)
    scores = proxy_scores(AF, q_fidx, q_fw)
    scores.masked_fill_(~valid[None, :], float("-inf"))
    return torch.topk(scores, min(topm, AF.shape[0]), dim=1)


def local_updates(mesh, cap, upd_idx, upd_fidx, upd_fw, upd_valid):
    """One step's host update arrays (numpy, global rows of a pool of
    ``cap``) cut to the rows this rank holds over ``mesh``'s ``cand`` axis,
    numbered from its first row: the updates :func:`proxy_step_sharded`
    takes.  Only they are uploaded."""
    rows = _local_rows(cap, mesh)
    base = mesh.coords["cand"] * rows
    own = (upd_idx >= base) & (upd_idx < base + rows)
    return upd_idx[own] - base, upd_fidx[own], upd_fw[own], upd_valid[own]


def proxy_step_sharded(mesh, AF, valid, upd_idx, upd_fidx, upd_fw,
                       upd_valid, q_fidx, q_fw, *, topm: int, cap: int):
    """:func:`proxy_step` over a pool whose ``cap`` rows shard over the
    mesh's ``cand`` axis.  Twin of ``_proxy_step`` of the JAX package on a
    pool laid out ``P("cand", None)``, and of the hand-written screen of
    its ``scripts/multihost_screen_worker.py`` (``_shard_screen``).

    ``AF`` [cap / cand, D] and ``valid`` [cap / cand] are this rank's rows
    (global row ``r`` lives on cand coordinate ``r // (cap / cand)``); the
    updates are this rank's, numbered from its first row
    (:func:`local_updates`); the queries are the same on every rank.  A
    rank runs :func:`proxy_step` on its slice (a slice of fewer rows than M
    pads its winners with -inf and row -1), and the ``cand`` group
    all-gathers the ``[K, M]`` winners with their global rows; the top-M of
    the ``[K, M * cand]`` gathered winners is the result.  Gathering the
    winners and not the ``[K, cap]`` scores is the design of the JAX worker
    (1.29x at 2 processes with the full scores gathered, 1.8x and more with
    the merge, on its CPU mesh).  Every rank of a group merges the same
    gathered tensors, so all return the same bits; ranks along ``dp``
    repeat the screen.  Returns float32 (scores [K, M], global rows [K, M],
    int64) with M = min(topm, cap)."""
    rows = _local_rows(cap, mesh)
    if AF.shape[0] != rows:
        raise ValueError(f"{AF.shape[0]} local rows: a pool of {cap} over "
                         f"{mesh.shape['cand']} cand ranks holds {rows}")
    m = min(topm, cap)
    ts, ti = proxy_step(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid,
                        q_fidx, q_fw, topm=m)
    ti = ti + mesh.coords["cand"] * rows
    if ts.shape[1] < m:
        pad = (ts.shape[0], m - ts.shape[1])
        ts = torch.cat([ts, ts.new_full(pad, float("-inf"))], dim=1)
        ti = torch.cat([ti, ti.new_full(pad, -1)], dim=1)
    cand = mesh.shape["cand"]
    group = mesh.axis_groups["cand"]
    all_ts = [torch.empty_like(ts) for _ in range(cand)]
    all_ti = [torch.empty_like(ti) for _ in range(cand)]
    dist.all_gather(all_ts, ts, group=group)
    dist.all_gather(all_ti, ti, group=group)
    if cand == 1:   # one slice: its winners are the top-M, in order
        return all_ts[0], all_ti[0]
    ts, sel = torch.topk(torch.cat(all_ts, dim=1), m, dim=1)
    return ts, torch.cat(all_ti, dim=1).gather(1, sel)


class ProxyPool:
    """Device-resident anchor feature matrix with persistent rows.

    A node keeps its row for the whole run; new nodes append; stale or
    ineligible nodes are re-exported/invalidated via the engine's
    changed-node log.  Capacity is fixed up front from the expected sample
    count (2 nodes per placed sample).  On CUDA the pool owns the stream
    its tensors are made and used on.

    With a ``mesh`` the tensors hold this rank's ``capacity / cand`` rows
    on ``device`` (the mesh's); ``capacity``, ``node_arr`` and ``row_of``
    stay global and equal on every rank."""

    def __init__(self, expected_nodes: int, device: torch.device,
                 force_bf16: bool = False, fast: bool = False, mesh=None):
        cap = 1024
        while cap < expected_nodes:
            cap *= 2
        self.capacity = cap
        self.device = torch.device(device)
        self.mesh = mesh
        rows = _local_rows(cap, mesh)
        self.d_hash, self.g_buckets = feature_dims(cap, fast)
        self.D = self.d_hash + self.g_buckets
        self.node_arr = np.full(cap, -1, dtype=np.int64)
        self.row_of = {}
        # float32 storage by default: bf16 rounding reorders near-tie
        # candidates (a measurable LK loss at 3,000 samples with 64
        # seeds).  Very large pools keep bf16 for the halved footprint;
        # callers then deepen the seed list to recover recall.
        # MAPLE_PROXY_BF16=1 forces bf16; the fast screen contract
        # (cfg.fast) forces it too.
        dtype = torch.bfloat16 if (force_bf16 or cap >= BF16_CAP
                                   or os.environ.get("MAPLE_PROXY_BF16")) \
            else torch.float32
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        with self.on_stream():
            self.AF = torch.zeros((rows, self.D), dtype=dtype,
                                  device=self.device)
            self.valid = torch.zeros(rows, dtype=torch.bool,
                                     device=self.device)

    def on_stream(self):
        """Context in which tensor operations queue on the pool's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def assign_rows(self, nodes: np.ndarray) -> Optional[np.ndarray]:
        """Rows for ``nodes`` (assigning fresh rows to new ones); None
        when capacity is exhausted."""
        rows = np.empty(len(nodes), np.int32)
        nxt = len(self.row_of)
        for i, node in enumerate(nodes):
            r = self.row_of.get(int(node))
            if r is None:
                if nxt >= self.capacity:
                    return None
                r = nxt
                self.row_of[int(node)] = r
                self.node_arr[r] = node
                nxt += 1
            rows[i] = r
        return rows


def _local_rows(cap: int, mesh) -> int:
    """The pool rows one rank holds: all of them without a mesh."""
    if mesh is None:
        return cap
    cand = mesh.shape["cand"]
    if cap % cand:
        raise ValueError(f"a pool of {cap} rows does not divide over the "
                         f"{cand} ranks of mesh axis 'cand'")
    return cap // cand


def pool_from_numpy(AF, valid, row_of, node_arr, *, device: torch.device,
                    dtype: torch.dtype, d_hash: int, g_buckets: int,
                    mesh=None) -> ProxyPool:
    """A ProxyPool holding the given state: ``AF`` [cap, D] float32 values
    (stored as ``dtype``), ``valid`` [cap] bool, the node -> row map and
    the row -> node array; with a ``mesh``, this rank's rows of them.  It
    starts both sides of a comparison from one state."""
    AF = np.asarray(AF, dtype=np.float32)
    pool = ProxyPool.__new__(ProxyPool)
    pool.capacity = AF.shape[0]
    pool.device = torch.device(device)
    pool.mesh = mesh
    pool.d_hash, pool.g_buckets = d_hash, g_buckets
    pool.D = d_hash + g_buckets
    if AF.shape[1] != pool.D:
        raise ValueError(f"AF has {AF.shape[1]} columns, the feature space "
                         f"{pool.D}")
    rows = _local_rows(pool.capacity, mesh)
    base = 0 if mesh is None else mesh.coords["cand"] * rows
    own = slice(base, base + rows)
    pool.node_arr = np.array(node_arr, dtype=np.int64)
    pool.row_of = {int(k): int(v) for k, v in row_of.items()}
    pool.stream = torch.cuda.Stream(pool.device) \
        if pool.device.type == "cuda" else None
    with pool.on_stream():
        # a writable copy of the rows this rank holds
        pool.AF = torch.from_numpy(np.array(AF[own])).to(pool.device,
                                                         dtype=dtype)
        pool.valid = torch.from_numpy(
            np.array(np.asarray(valid)[own], dtype=bool)).to(pool.device)
    return pool


class _Screen(NamedTuple):
    """One queued proxy step: host-side result buffers, the events that
    bracket it on the pool's stream (None off CUDA), and the row -> node
    mapping as of its submission."""
    ts: torch.Tensor
    ti: torch.Tensor
    start: Optional[torch.cuda.Event]
    done: Optional[torch.cuda.Event]
    node_arr: np.ndarray


class EngineProxyPlacer:
    """Drives device-screened, engine-applied stepwise addition.  With a
    ``mesh`` (whose device is ``device``) the pool shards over its ``cand``
    axis and every step is :func:`proxy_step_sharded`."""

    def __init__(self, run, eng, num_cores: int = 1,
                 batch_size: int = 256, topm: int = 64,
                 seed_budget: int = 48, *, device: torch.device,
                 fast_screen: bool = False, mesh=None):
        self.run = run
        self.eng = eng
        self.num_cores = max(1, num_cores)
        self.batch_size = batch_size
        self.topm = topm
        self.seed_budget = seed_budget
        # fast contract (cfg.fast): bf16 pool, narrow features; the
        # quality bar is the production host preset's (budgeted search),
        # so screen recall loss is acceptable and the deepened-topm
        # exactness guard below is skipped
        self.fast_screen = fast_screen
        # feature budgets grow on saturation (feat_extract truncates at
        # fmax; a truncated row mis-ranks silently, so saturation is
        # detected via the returned max feature count and the budget
        # doubles: one extra export, rare)
        self.fmax_anchor = FMAX_ANCHOR
        self.fmax_query = FMAX_QUERY
        self.tracer = run.tracer
        n_expected = len(run.data) * 2 + 64
        with self.tracer.span("place.pool_init"):
            self.pool = ProxyPool(n_expected, device,
                                  force_bf16=fast_screen, fast=fast_screen,
                                  mesh=mesh)
        if self.pool.AF.dtype == torch.bfloat16 and self.topm < BF16_TOPM \
                and not fast_screen:
            # bf16 rounding reorders near-ties; a deeper seed list
            # restores exact parity with the serial engine
            self.topm = BF16_TOPM
        self.steps = 0             # proxy steps queued
        self.time_screen = 0.0     # host: uploads, queueing, result waits
        self.time_place = 0.0         # place.seeded
        self.time_export = 0.0        # proxy.sync: anchor feature exports
        self.time_query_export = 0.0  # proxy.query_export
        self.time_device = 0.0     # device seconds in proxy steps (CUDA)
        self.time_wait = 0.0       # place.wait.screen
        self.time_sync_join = 0.0  # place.wait.sync
        self.time_prep_wait = 0.0  # place.wait.prep
        self._nf_printed = False

    # ------------------------------------------------------------------
    def _sync_pool(self, changed: np.ndarray):
        """Export features for ``changed`` nodes; returns the host scatter
        arrays (rows, idx, w, valid) of the next step.  Rows whose features
        equal their last export are dropped (fingerprint dedup)."""
        with self.tracer.span("proxy.sync") as sp:
            pool = self.pool
            changed = np.unique(changed)
            rows = pool.assign_rows(changed)
            if rows is None:
                raise RuntimeError("proxy pool capacity exhausted")
            idx, w, valid, max_nf, skip = self.eng.export_feats(
                changed, pool.d_hash, pool.g_buckets,
                self.fmax_anchor, use_fp=True)
            self.tracer.count("proxy.rows_changed", len(changed))
            self.tracer.count("proxy.rows_skipped", int(skip.sum()))
            while max_nf >= self.fmax_anchor:
                self.fmax_anchor *= 2
                print(f"[proxy] anchor feature budget -> "
                      f"{self.fmax_anchor}", flush=True)
                idx, w, valid, max_nf, skip = self.eng.export_feats(
                    changed, pool.d_hash, pool.g_buckets,
                    self.fmax_anchor)
            if skip.any():
                keep = ~skip
                rows = rows[keep]
                idx = idx[keep]
                w = w[keep]
                valid = valid[keep]
            fb = _f_bucket(max_nf, self.fmax_anchor)
            if fb < idx.shape[1]:
                idx = np.ascontiguousarray(idx[:, :fb])
                w = np.ascontiguousarray(w[:, :fb])
        self.time_export += sp.seconds
        return rows, idx, w, valid

    def _export_queries(self, vids: np.ndarray):
        """Query-feature export for one batch (engine-side, read-only
        over the immutable terminal vectors)."""
        with self.tracer.span("proxy.query_export") as sp:
            pool = self.pool
            qidx, qw, max_nf = self.eng.export_query_feats(
                vids, pool.d_hash, pool.g_buckets, self.fmax_query)
            while max_nf >= self.fmax_query:
                self.fmax_query *= 2
                print(f"[proxy] query feature budget -> "
                      f"{self.fmax_query}", flush=True)
                qidx, qw, max_nf = self.eng.export_query_feats(
                    vids, pool.d_hash, pool.g_buckets, self.fmax_query)
            fbq = _f_bucket(max_nf, self.fmax_query)
            if fbq < qidx.shape[1]:
                qidx = np.ascontiguousarray(qidx[:, :fbq])
                qw = np.ascontiguousarray(qw[:, :fbq])
        self.time_query_export += sp.seconds
        return qidx, qw

    def _submit(self, vids: np.ndarray, sync) -> _Screen:
        """Export one batch's queries, upload them with the pool updates
        ``sync`` (a _sync_pool result) and queue the proxy step on the
        pool's stream; does not wait for it.  Runs on the screen thread
        only."""
        pool = self.pool
        device = pool.device
        tracer = self.tracer
        qidx, qw = self._export_queries(vids)
        if tracer.traced:
            self._feature_counts(vids, qw, sync[2])
        start = done = None
        with tracer.span("proxy.upload") as up:
            rows, aidx, aw, avalid = sync if pool.mesh is None \
                else local_updates(pool.mesh, pool.capacity, *sync)
            with pool.on_stream():
                if pool.stream is not None:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                args = (pool.AF, pool.valid, upload(rows, device),
                        upload(aidx, device), upload(aw, device),
                        upload(avalid, device), upload(qidx, device),
                        upload(qw, device))
        with tracer.span("proxy.dispatch") as disp, pool.on_stream():
            if pool.mesh is None:
                ts, ti = proxy_step(*args, topm=self.topm)
            else:
                ts, ti = proxy_step_sharded(pool.mesh, *args, topm=self.topm,
                                            cap=pool.capacity)
            ts, ti = to_host(ts, ti)
            if pool.stream is not None:
                done = torch.cuda.Event(enable_timing=True)
                done.record()
        self.steps += 1
        dt = up.seconds + disp.seconds
        self.time_screen += dt
        if tracer.traced and dt > 1.0:
            print(f"[proxy] slow submit {dt:.1f}s (R={len(rows)}, "
                  f"cap={pool.capacity})", flush=True)
        # rows are assigned while this step is in flight: snapshot the
        # row -> node mapping as of its submission
        return _Screen(ts, ti, start, done, pool.node_arr.copy())

    def _fetch(self, screen: _Screen):
        """Block on one step's results; returns (scores, rows, node_arr)
        as numpy arrays."""
        with self.tracer.span("proxy.fetch") as sp:
            if screen.done is not None:
                screen.done.synchronize()
                self.time_device += \
                    screen.start.elapsed_time(screen.done) / 1e3
            res = screen.ts.numpy(), screen.ti.numpy(), screen.node_arr
        self.time_screen += sp.seconds
        if self.tracer.traced and sp.seconds > 0.5:
            print(f"[proxy] slow fetch {sp.seconds:.2f}s", flush=True)
        return res

    def _feature_counts(self, vids, qw, aw):
        """Once, on the first full batch: the percentiles of its queries'
        and its anchor update rows' feature counts."""
        if self._nf_printed or len(vids) != self.batch_size:
            return
        self._nf_printed = True
        qn = np.count_nonzero(qw, axis=1)
        an = np.count_nonzero(aw, axis=1)
        if not len(an):   # no anchor row changed
            an = np.zeros(1, np.int64)
        print(f"[proxy] nf query p50={np.percentile(qn, 50):.0f} "
              f"p99={np.percentile(qn, 99):.0f} max={qn.max()}  "
              f"anchor p50={np.percentile(an, 50):.0f} "
              f"p99={np.percentile(an, 99):.0f} max={an.max()}",
              flush=True)

    def _place(self, vids, first_sample: int, res, refresh_every: int,
               checkpoint=None):
        """Map screen rows to seeds and place through the engine in
        model-refresh-aligned chunks (span ``place.seeded``, the refreshes
        inside it ``place.serial``)."""
        tracer = self.tracer
        with tracer.span("place.seeded") as sp:
            ts, ti, node_arr = res
            seeds = node_arr[ti].astype(np.int32)
            seeds[~np.isfinite(ts)] = -1
            run = self.run
            cfg = run.cfg
            eng = self.eng
            s = 0
            num = first_sample
            n = len(vids)
            while s < n:
                k = n - s
                if refresh_every:
                    if num % refresh_every == 0:
                        with tracer.span("place.serial"):
                            eng.flush_pseudo_counts(run.model.pseudo_counts)
                            run.model.update_from_pseudo_counts()
                            eng.sync_model()
                    k = min(k, refresh_every - num % refresh_every)
                k = min(k, cfg.saveInitialTreeEvery
                        - num % cfg.saveInitialTreeEvery)
                eng.place_batch_seeded(vids[s:s + k], num, seeds[s:s + k],
                                       self.num_cores, self.seed_budget)
                num += k
                s += k
                if checkpoint and num % cfg.saveInitialTreeEvery == 0:
                    checkpoint(num)
        self.time_place += sp.seconds
        return num

    def stage_split(self) -> str:
        """The bracketed stage sums of the JAX twin's progress line, read
        from the tracer."""
        tr = self.tracer
        return (f"[upload {tr.inclusive('proxy.upload'):.1f} dispatch "
                f"{tr.inclusive('proxy.dispatch'):.1f} block "
                f"{tr.inclusive('proxy.fetch'):.1f} sync "
                f"{tr.inclusive('proxy.sync'):.1f} rows "
                f"{tr.counter('proxy.rows_changed')} skip "
                f"{tr.counter('proxy.rows_skipped')}]")

    # ------------------------------------------------------------------
    def place_all(self, distances, num_samples: int, checkpoint=None,
                  progress_every: int = 4096) -> int:
        """Place every remaining sample from ``distances`` (a list used
        as a pop()-stack of (key, name), mirroring the serial loop's
        order).  Returns the final sample count."""
        run = self.run
        eng = self.eng
        cfg = run.cfg
        tracer = self.tracer
        refresh_every = (cfg.updateSubstMatrixEveryThisSamples
                         if cfg.model != "JC" else 0)
        eng.screen_log(True)
        start = time.time()
        n_start = num_samples
        last_print = num_samples
        # initial pool: every current node
        n_nodes = int(eng.lib.engine_node_count(eng.h))
        eng.screen_drain()  # clear the warmup log; we export all nodes
        changed = np.arange(n_nodes, dtype=np.int32)

        def next_batch():
            with tracer.span("prep.batch"):
                names = []
                for _ in range(self.batch_size):
                    if not distances:
                        break
                    _, sample = distances.pop()
                    run.names_in_tree.append(sample)
                    names.append(sample)
                if not names:
                    return np.empty(0, np.int64)
                diffs = [run.data[s] for s in names]
                for s in names:
                    run.data[s] = None
                return eng.terminal_vids_batch(diffs)

        vids = next_batch()
        if not len(vids):
            eng.screen_log(False)
            return num_samples

        def fetch_job(job_vids, sync):
            return self._fetch(self._submit(job_vids, sync))

        # Three single-thread executors beside the main loop (the ctypes
        # calls release the GIL):
        # prep: the NEXT batch's terminal vectors build while the engine
        #   places the current batch (store slot allocation is
        #   mutex-guarded); only this thread touches distances/run.data;
        # sync: the next pool export (changed-node drain + feature
        #   export), read-only over the tree, joined BEFORE the place
        #   phase so it never races the engine's mutation;
        # screen: the whole device round trip (query export over immutable
        #   terminal vectors, uploads, the step, the wait for its results),
        #   the only thread that touches the pool's tensors.
        with ThreadPoolExecutor(1, "proxy.prep") as prep_pool, \
                ThreadPoolExecutor(1, "proxy.sync") as sync_pool, \
                ThreadPoolExecutor(1, "proxy.screen") as screen_pool:
            # the first batch's pool export runs here: its tree reads
            # finish before any place can mutate
            sync0 = self._sync_pool(changed)
            pend = (vids, screen_pool.submit(fetch_job, vids, sync0))
            prep_fut = prep_pool.submit(next_batch) if distances else None
            while pend is not None:
                cur_vids, fetch_fut = pend
                sync_fut = sync_pool.submit(
                    lambda: self._sync_pool(eng.screen_drain()))
                with tracer.span("place.wait.screen") as sp:
                    res = fetch_fut.result()
                self.time_wait += sp.seconds
                with tracer.span("place.wait.prep") as sp:
                    nxt = prep_fut.result() if prep_fut is not None \
                        else np.empty(0, np.int64)
                self.time_prep_wait += sp.seconds
                with tracer.span("place.wait.sync") as sp:
                    sync_res = sync_fut.result()  # join: tree reads done
                self.time_sync_join += sp.seconds
                fetch_next = None
                if len(nxt):
                    fetch_next = screen_pool.submit(fetch_job, nxt,
                                                    sync_res)
                prep_fut = prep_pool.submit(next_batch) \
                    if distances else None
                num_samples = self._place(cur_vids, num_samples, res,
                                          refresh_every, checkpoint)
                pend = (nxt, fetch_next) if len(nxt) else None
                if progress_every and num_samples - last_print \
                        >= progress_every:
                    last_print = num_samples
                    el = time.time() - start
                    rate = (num_samples - n_start) / max(el, 1e-9)
                    msg = (f"placed {num_samples} samples, {rate:.1f} seq/s "
                           f"(screen {self.time_screen:.1f}s place "
                           f"{self.time_place:.1f}s export "
                           f"{self.time_export + self.time_query_export:.1f}"
                           f"s)")
                    if tracer.traced:
                        msg += f" {self.stage_split()}"
                    print(msg, flush=True)
        eng.screen_log(False)
        return num_samples
