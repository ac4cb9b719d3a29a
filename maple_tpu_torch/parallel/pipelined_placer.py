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

Reference contract being replaced: the strictly serial stepwise addition
loop, MAPLEv0.7.5.4.py:11692-11752 with the per-sample DFS at :7912-8293.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from maple_tpu.ops import pack as OP

from ..ops.append_pairs import append_scores_prestacked
from ..ops.layout import NFIELDS, stack_fields_host
from .batch_placement import BatchedPlacer

TOPK = 192            # device top-k per query (the host takes at most 64
                      # candidates; the margin absorbs stale-row drops)
REBUILD_ROWS = 1024   # a batch that changes more pool rows than this
                      # rebuilds the whole pool instead of scattering


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


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of ``arr`` that later host edits of ``arr`` cannot
    reach: staged through fresh pinned memory on CUDA (the caching host
    allocator keeps the block until the copy has completed)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def _to_host(ts: torch.Tensor, ti: torch.Tensor):
    """Queue pinned host copies of a screen's (score, row) results on
    CUDA (read them after an event recorded behind this call); CPU
    tensors are returned as they are."""
    if ts.device.type != "cuda":
        return ts, ti
    ts_h = torch.empty(ts.shape, dtype=ts.dtype, pin_memory=True)
    ti_h = torch.empty(ti.shape, dtype=ti.dtype, pin_memory=True)
    ts_h.copy_(ts, non_blocking=True)
    ti_h.copy_(ti, non_blocking=True)
    return ts_h, ti_h


class StackedDevicePool:
    """Device-resident anchor pool in the pair kernel's stacked field
    layout, with a host mirror for incremental row scatters.

    Rows are persistent (an anchor keeps its row for the run; new anchors
    append; ineligible anchors are invalidated, not compacted).  The entry
    budget (B1) is snug: a multiple of 8 with headroom.  Budget or capacity
    growth triggers a full rebuild."""

    def __init__(self, rt, device: torch.device, n_pad_hint: int = 0,
                 dtype=np.float32):
        self.rt = rt
        self.device = device
        self.dtype = dtype
        self.n_pad_hint = n_pad_hint
        self.budget = 0            # B1 (entry slots)
        self.capacity = 0          # row count (pow2, multiple of 128)
        self.rows_host: Optional[np.ndarray] = None   # [cap, F, B1]
        self.valid_host: Optional[np.ndarray] = None  # [cap] bool
        self.node_arr: Optional[np.ndarray] = None    # [cap] int64, -1=free
        self.row_of = {}
        self.dev_pool: Optional[torch.Tensor] = None
        self.dev_valid: Optional[torch.Tensor] = None
        model = rt.model
        self.site_rates = None if model.site_rates is None \
            else np.asarray(model.site_rates)
        self.error_rates = None
        if model.using_error_rate:
            if model.error_rates is not None:
                self.error_rates = np.asarray(model.error_rates)
            else:
                self.error_rates = np.full(rt.refd.lRef, model.error_rate)

    # -- anchor eligibility & export --
    def _chain_up(self, node):
        tree = self.rt.tree
        chain = []
        n = node
        while n is not None:
            if tree.mutations[n]:
                chain.append(n)
            n = tree.up[n]
        return chain

    def eligible_vec(self, node):
        rt = self.rt
        tree = rt.tree
        if node >= len(tree.up) or tree.up[node] is None \
                or tree.children[node] is None:
            return None
        if tree.dist[node] <= rt.dc.effectivelyNon0BLen \
                or tree.probVectTotUp[node] is None:
            return None
        v = tree.probVectTotUp[node]
        for n in self._chain_up(node):
            v = rt.pass_up(v, n)
        return rt.kern.export(v)

    def _pack_rows(self, vecs) -> np.ndarray:
        """[len(vecs), F, B1] stacked rows."""
        rt = self.rt
        packed = OP.pack_genome_lists(vecs, rt.refd.lRef, self.budget,
                                      rt.model.using_error_rate,
                                      dtype=self.dtype)
        return stack_fields_host(packed, self.site_rates,
                                 self.error_rates, axis=-2,
                                 dtype=self.dtype)

    @property
    def n_prefix(self) -> int:
        n = 128
        while n < len(self.row_of):
            n *= 2
        return min(n, self.capacity) or 128

    def full_rebuild(self):
        """Rebuild the whole pool from the current tree and upload it."""
        rt = self.rt
        tree = rt.tree
        eff0 = rt.dc.effectivelyNon0BLen
        # per-node MAT frame chains via one pre-order walk
        chains = {}
        stack = []
        for node in range(len(tree.up)):
            if tree.up[node] is None and tree.children[node] is not None:
                chains[node] = (node, None) if tree.mutations[node] else None
                stack.append(node)
        anchors, vecs = [], []
        while stack:
            n = stack.pop()
            for c in tree.children[n] or ():
                chains[c] = (c, chains[n]) if tree.mutations[c] \
                    else chains[n]
                stack.append(c)
            if tree.up[n] is None or tree.children[n] is None:
                continue
            if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
                v = tree.probVectTotUp[n]
                link = chains.get(n)
                while link is not None:
                    v = rt.pass_up(v, link[0])
                    link = link[1]
                anchors.append(n)
                vecs.append(rt.kern.export(v))
        n = len(anchors)
        self.budget = OP.snug_budget(max((len(v) for v in vecs),
                                         default=1))
        cap = 128
        while cap < max(2 * n, self.n_pad_hint):
            cap *= 2
        self.capacity = cap
        self.rows_host = np.zeros((cap, NFIELDS, self.budget),
                                  dtype=self.dtype)
        if n:
            self.rows_host[:n] = self._pack_rows(vecs)
        self.valid_host = np.zeros(cap, dtype=bool)
        self.valid_host[:n] = True
        self.node_arr = np.full(cap, -1, dtype=np.int64)
        self.node_arr[:n] = anchors
        self.row_of = {node: i for i, node in enumerate(anchors)}
        self.dev_pool = _upload(self.rows_host, self.device)
        self.dev_valid = _upload(self.valid_host, self.device)
        return n

    def make_update(self, changed):
        """(idx, valid) arrays of a row scatter covering ``changed`` nodes
        (their rows are refreshed in ``rows_host``), or None when a full
        rebuild is required (budget growth, capacity exhaustion, more than
        REBUILD_ROWS rows)."""
        if self.rows_host is None:
            return None
        idx: List[int] = []
        vecs = []
        flags: List[bool] = []
        for node in dict.fromkeys(changed):
            vec = self.eligible_vec(node)
            row = self.row_of.get(node)
            if vec is None:
                if row is None:
                    continue
                self.valid_host[row] = False
                idx.append(row)
                vecs.append(None)
                flags.append(False)
                continue
            if len(vec) > self.budget:
                return None
            if row is None:
                row = len(self.row_of)
                if row >= self.capacity:
                    return None
                self.row_of[node] = row
                self.node_arr[row] = node
            self.valid_host[row] = True
            idx.append(row)
            vecs.append(vec)
            flags.append(True)
        if len(idx) > REBUILD_ROWS:
            return None
        live = [v for v in vecs if v is not None]
        if live:
            packed = self._pack_rows(live)
            j = 0
            for i, v in enumerate(vecs):
                if v is not None:
                    self.rows_host[idx[i]] = packed[j]
                    j += 1
        return (np.asarray(idx, dtype=np.int64),
                np.asarray(flags, dtype=bool))


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

    def __init__(self, rt, stats, device: torch.device,
                 batch_size: int = 64, expected_samples: int = 0,
                 topk: int = TOPK):
        self.rt = rt
        self.stats = stats
        self.device = device
        self.batch_size = batch_size
        self.topk = topk
        self.pool = StackedDevicePool(rt, device,
                                      n_pad_hint=2 * expected_samples)
        self.q_budget = 128
        self.mm_dev = None
        self.rf_dev = None
        self.mm_version = -1
        self.time_scoring = 0.0   # host seconds blocked on screens
        self.time_fine = 0.0
        self.time_apply = 0.0
        self.time_device = 0.0    # device seconds in fused steps (CUDA)
        self.n_total = 0

    def _model_arrays(self):
        model = self.rt.model
        if self.mm_dev is None or self.mm_version != model.version:
            mm = np.asarray(model.mut_matrix,
                            dtype=np.float32).reshape(1, 1, 16)
            rf = np.asarray(model.refd.root_freqs,
                            dtype=np.float32).reshape(1, 1, 4)
            self.mm_dev = _upload(mm, self.device)
            self.rf_dev = _upload(rf, self.device)
            self.mm_version = model.version
        return self.mm_dev, self.rf_dev

    # ------------------------------------------------------------------
    def _submit(self, batch, unscattered) -> _Screen:
        """Upload queries + pool updates and queue the fused step; does
        not wait for it."""
        rt = self.rt
        pool = self.pool
        device = self.device
        # queries padded to the batch size by repeating the last one
        queries = [rt.kern.export(d) for _, d in batch]
        K = self.batch_size
        while len(queries) < K:
            queries.append(queries[-1])
        while any(len(q) > self.q_budget for q in queries):
            self.q_budget *= 2

        upd = pool.make_update(unscattered) \
            if pool.rows_host is not None else None
        if upd is None:
            pool.full_rebuild()
            upd = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
        idx, flags = upd
        rows = pool.rows_host[idx]

        packed = OP.pack_genome_lists(queries, rt.refd.lRef,
                                      self.q_budget,
                                      rt.model.using_error_rate,
                                      dtype=np.float32)
        Cstk = stack_fields_host(packed, pool.site_rates,
                                 pool.error_rates, axis=-1)
        Cflat = Cstk.reshape(K, 1, -1)
        dc = rt.dc
        prm = np.broadcast_to(
            np.asarray([dc.oneMutBLen, 1.0, dc.globalTotRate,
                        rt.model.tot_error or 0.0], dtype=np.float32),
            (K, 4)).reshape(K, 1, 4).copy()
        mm, rf = self._model_arrays()

        on_cuda = device.type == "cuda"
        start = done = None
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        ts, ti = fused_step(
            pool.dev_pool, pool.dev_valid, _upload(idx, device),
            _upload(rows, device), _upload(flags, device),
            _upload(Cflat, device), _upload(prm, device), mm, rf,
            n_prefix=pool.n_prefix, uer=rt.model.using_error_rate,
            topk=self.topk)
        ts, ti = _to_host(ts, ti)
        if on_cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
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
                print(f"placed {self.n_total} samples, {rate:.1f} seq/s "
                      f"(block {self.time_scoring:.1f}s fine "
                      f"{self.time_fine:.1f}s apply "
                      f"{self.time_apply:.1f}s)", flush=True)
        return root
