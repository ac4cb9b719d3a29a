"""Pipelined device placement: one fused step per batch.

The torch twin of :mod:`maple_tpu.parallel.pipelined_placer`.  Each batch
of queries is one device step

  fused_step(pool, valid, updates, queries) =
      scatter the changed anchor rows into the device-resident pool
      -> pair kernel of the batch's queries against the active pool prefix
      -> mask invalid rows -> top-k per query

and only the [K, topk] scores and row indices come back to the host.

Pipelining: batch i+1's step is queued BEFORE the host processes batch
i, so the device screens ahead while the host runs the exact fine phase
and applies.  The screen of batch i+1 therefore sees the pool as of batch
i-1; everything batch i changed is handled by the staleness machinery in
``_process`` (stale rows dropped from the candidate list, changed nodes
re-scored fresh on host for every query).  The screen uses the model as of
submit time; the host fine phase, which makes every decision, runs the
exact serial model-refresh cadence (reference MAPLEv0.7.5.4.py:11708-
11711).

On a CUDA device nothing in the loop synchronises the whole stream: the
top-k pair is copied into pinned host buffers behind an event, and
``_process`` waits on that event only.  Host-to-device copies go through a
fresh pinned staging tensor per submit, so later host edits of the pool's
mirror never reach a copy still in flight.

``BatchedPlacer._tick`` records the host time by the JAX twin's stages as
spans ``pipelined.<stage>`` of the tracer; with ``MAPLE_DEBUG_DEVBATCH=1``
their seconds (``_prof``) are appended to the progress line:
``export_queries`` (the batch's genome lists), ``pool_sync`` (the row update
or rebuild of the pool's host mirror), ``pack_queries`` (packing and
stacking the queries, the model arrays), ``dispatch`` (the uploads through
pinned staging, queueing the fused step and its result copies), ``block``
(the wait on the step's done event) and ``host`` (the exact host decisions
and applies).

Reference contract being replaced: the strictly serial stepwise addition
loop, MAPLEv0.7.5.4.py:11692-11752 with the per-sample DFS at :7912-8293.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.append_pairs import append_scores_prestacked
from .batch_placement import BatchedPlacer
from .stacked_pool import StackedDevicePool, to_host, upload

TOPK = 192            # device top-k per query (the host takes at most 64
                      # candidates; the margin absorbs stale-row drops)


def fused_step(pool, valid, upd_idx, upd_rows, upd_valid, Cflat, prm,
               mm_flat, rf, *, n_prefix: int, uer: bool, topk: int):
    """Scatter + screen + top-k.

    pool [cap, F, B1], valid [cap] bool, upd_idx [R] int64,
    upd_rows [R, F, B1], upd_valid [R] bool, Cflat [K, 1, B2*F],
    prm [K, 1, 4], mm_flat [1, 1, 16], rf [1, 1, 4].  ``pool`` and
    ``valid`` are updated in place (the JAX step donated them).  Returns
    (topk_scores [K, topk], topk_rows [K, topk])."""
    if upd_idx.numel():
        pool.index_copy_(0, upd_idx, upd_rows)
        valid.index_copy_(0, upd_idx, upd_valid)
    scores = append_scores_prestacked(pool[:n_prefix], Cflat, prm,
                                      mm_flat, rf, uer=uer)
    scores.masked_fill_(~valid[:n_prefix], float("-inf"))
    return torch.topk(scores, min(topk, n_prefix), dim=1)


class _Screen(NamedTuple):
    """One queued fused step: host-side result buffers, the events that
    bracket it on the device (None off CUDA), and the row->node mapping
    as of this screen."""
    ts: torch.Tensor
    ti: torch.Tensor
    start: Optional[torch.cuda.Event]
    done: Optional[torch.cuda.Event]
    node_arr: np.ndarray
    row_of: dict


class PipelinedPlacer(BatchedPlacer):
    """Single-device batched placer with fused steps and one-batch-deep
    pipelining (module docstring).  Reuses BatchedPlacer's exact host
    decision phase (_place_one: staleness re-scoring, minor absorption,
    float64 fine phase, serial apply)."""

    SPAN_PREFIX = "pipelined."

    def __init__(self, rt, stats, device: torch.device,
                 batch_size: int = 64, expected_samples: int = 0,
                 topk: int = TOPK):
        super().__init__(rt, stats, device, batch_size=batch_size)
        self.topk = topk
        self.pool = StackedDevicePool(rt, device,
                                      n_pad_hint=2 * expected_samples)
        self.q_budget = 128
        self.time_device = 0.0    # device seconds in fused steps (CUDA)
        self.n_total = 0

    # ------------------------------------------------------------------
    def _submit(self, batch, unscattered) -> _Screen:
        """Upload queries + pool updates and queue the fused step; does
        not wait for it."""
        rt = self.rt
        pool = self.pool
        device = self.device
        t0 = time.time()
        # queries padded to the batch size by repeating the last one
        queries = [rt.kern.export(d) for _, d in batch]
        K = self.batch_size
        while len(queries) < K:
            queries.append(queries[-1])
        t0 = self._tick("export_queries", t0)

        upd = pool.make_update(unscattered) \
            if pool.rows_host is not None else None
        if upd is None:
            pool.full_rebuild()
            upd = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
        idx, flags = upd
        rows = pool.rows_host[idx]
        t0 = self._tick("pool_sync", t0)

        Cflat, prm = self._query_arrays(queries)
        mm, rf = self._model_arrays()
        t0 = self._tick("pack_queries", t0)

        on_cuda = device.type == "cuda"
        start = done = None
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        ts, ti = fused_step(
            pool.dev_pool, pool.dev_valid, upload(idx, device),
            upload(rows, device), upload(flags, device),
            upload(Cflat, device), upload(prm, device), mm, rf,
            n_prefix=pool.n_prefix, uer=rt.model.using_error_rate,
            topk=self.topk)
        ts, ti = to_host(ts, ti)
        if on_cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
        self._tick("dispatch", t0)
        # snapshot the row->node mapping AS OF THIS SCREEN: a later
        # full_rebuild (while this screen is still in flight) reassigns
        # rows wholesale, and translating this screen's top-k indices
        # through the rebuilt mapping would name the wrong nodes.
        # full_rebuild creates fresh objects and scatters only append,
        # so holding the references is snapshot enough.
        return _Screen(ts, ti, start, done, pool.node_arr, pool.row_of)

    # ------------------------------------------------------------------
    def _process(self, root, batch, screen: _Screen, stale,
                 refresh_every):
        """Wait for the batch's screen and run the exact host decision +
        apply for each sample.  Returns (root, delta) where delta = nodes
        whose pool rows must be re-scattered."""
        rt = self.rt
        tree = rt.tree
        t0 = time.time()
        if screen.done is not None:
            screen.done.synchronize()
            self.time_device += screen.start.elapsed_time(screen.done) / 1e3
        ts = screen.ts.numpy()
        ti = screen.ti.numpy()
        node_arr, row_of = screen.node_arr, screen.row_of
        self.time_scoring += time.time() - t0
        t0 = self._tick("block", t0)

        stale_rows = np.zeros(len(node_arr), dtype=bool)
        recent: List[int] = []
        recent_set = set()
        delta: List[int] = []
        delta_set = set()

        def note(n, is_delta=True):
            if is_delta and n not in delta_set:
                delta_set.add(n)
                delta.append(n)
            if n not in recent_set:
                recent_set.add(n)
                recent.append(n)
                row = row_of.get(n)
                if row is not None:
                    stale_rows[row] = True

        for n in stale:
            note(n, is_delta=False)

        touched = set()
        prev_log = rt.touch_log
        rt.touch_log = touched
        try:
            for k, (sample_id, diffs) in enumerate(batch):
                if refresh_every and self.n_total % refresh_every == 0:
                    rt.model.update_from_pseudo_counts()
                n_before = len(tree.up)
                touched.clear()
                cols = ti[k]
                nodes_row = node_arr[cols]
                row = ts[k].copy()
                row[stale_rows[cols] | (nodes_row < 0)] = -np.inf
                root = self._place_one(root, sample_id, diffs, row,
                                       nodes_row.tolist(), recent)
                self.n_total += 1
                for n in range(n_before, len(tree.up)):
                    note(n)
                for n in touched:
                    if n < n_before:
                        note(n)
        finally:
            rt.touch_log = prev_log
        self._tick("host", t0)
        return root, delta

    # ------------------------------------------------------------------
    def place_all(self, root, sample_iter, refresh_every: int = 0,
                  n_placed: int = 0, progress_every: int = 1024):
        """Drive the pipelined loop over an iterator of
        (sample_id, diffs_genome_list), in order.  ``n_placed`` seeds the
        model-refresh counter with the warmup count so the cadence
        matches the serial loop exactly."""
        self.n_total = n_placed
        it = iter(sample_iter)
        start = time.time()
        last_print = n_placed

        def next_batch():
            out = []
            for _ in range(self.batch_size):
                nxt = next(it, None)
                if nxt is None:
                    break
                out.append(nxt)
            return out

        batch = next_batch()
        if not batch:
            return root
        pend = (batch, self._submit(batch, []), [])
        unscattered: List[int] = []
        while pend is not None:
            nxt = next_batch()
            screen_next = None
            if nxt:
                screen_next = self._submit(nxt, unscattered)
                unscattered = []
            cur_batch, screen_cur, stale_cur = pend
            root, delta = self._process(root, cur_batch, screen_cur,
                                        stale_cur, refresh_every)
            unscattered.extend(delta)
            pend = (nxt, screen_next, list(delta)) if nxt else None
            if progress_every and \
                    self.n_total - last_print >= progress_every:
                last_print = self.n_total
                el = time.time() - start
                rate = (self.n_total - n_placed) / max(el, 1e-9)
                msg = (f"placed {self.n_total} samples, {rate:.1f} seq/s "
                       f"(block {self.time_scoring:.1f}s fine "
                       f"{self.time_fine:.1f}s apply "
                       f"{self.time_apply:.1f}s)")
                if self._prof is not None:
                    msg += " " + str({k: round(v, 1)
                                      for k, v in sorted(self._prof.items())})
                print(msg, flush=True)
        return root
