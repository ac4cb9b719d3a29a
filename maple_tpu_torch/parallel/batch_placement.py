"""Device-batched sample placement: the legacy batch placer and the exact
host decision phase that every device placer shares.

The torch twin of the single-device half of the JAX package's
``parallel/batch_placement.py``.  Instead of the reference's strictly
serial one-sample-at-a-time DFS (MAPLEv0.7.5.4.py:11692-11752), samples are
processed in batches:

1. the mid-branch (probVectTotUp) vectors of every eligible anchor node are
   kept on the device, in the pair kernel's stacked layout
   (:class:`DeviceTreePool`),
2. a whole batch of queries is scored against the active prefix of the pool
   in one call: by the interval-algebra scorer
   (:mod:`maple_tpu_torch.ops.append_batch`, the default) or, with
   ``--devicePallas``, by one launch of the appendProbNode pair kernel
   (``csrc/append_pairs.cu``); an exact argmax over a superset of the nodes
   the reference's stop-rule DFS would visit,
3. the top candidates per query get the reference's exact host fine phase
   (3-way branch-length optimization in float64) and the placement is
   applied serially with the ordinary runtime (dirty propagation, minor
   absorption, pseudo-counts; reference semantics :8105-8293).

Within-batch sequential coupling (a sample placed first can attract the
next one) is preserved: nodes created or touched by earlier placements in
the batch are re-scored fresh on host for the remaining queries, and their
stale batch-start pool scores are masked out of the screen so an inflated
stale score can never crowd genuine candidates out of the fine phase.  The
caller keeps the serial model-refresh cadence (batches never cross an
updateSubstMatrixEveryThisSamples boundary).

With a ``mesh`` (:mod:`maple_tpu_torch.parallel.mesh`) the pool is sharded
over the ``cand`` axis and each query chunk over ``dp``; every rank runs
this same placer on the same tree, scores its tile and gathers the whole
score matrix, so the host phase decides the same on every rank.

``_tick`` records the host time of ``place_batch`` by the JAX twin's
stages as spans ``legacy.<stage>`` of the tree runtime's tracer
(``runtime/phases.py``): ``sync_pool`` (the pool's refresh or row update),
``model_warm`` (the device model or the pair kernel's model arrays),
``score_readback`` (the queries' export and packing, their upload, the
scorer and the copy of its scores to the host; on a mesh the gather of
every rank's tiles too), ``mask`` and ``host_apply`` (the exact host
decisions and applies).  With the trace switch (``MAPLE_DEBUG_DEVBATCH=1``)
``_prof`` is a view of those spans' seconds by stage, printed every 40
batches (``[devbatch]``); without it ``_prof`` is None.  The pipelined
placer shares ``_prof`` and ``_tick`` (spans ``pipelined.<stage>``).
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..ops import pack as OP
from ..ops.append_batch import device_model_from, grid_append_scores
from ..ops.append_pairs import append_scores_prestacked
from ..ops.layout import NFIELDS, fields_view, stack_fields_host
from ..search.placement import (find_best_parent_for_new_sample,
                                place_sample_on_tree)
from .stacked_pool import StackedRows, upload


class DeviceTreePool(StackedRows):
    """The legacy placer's anchor pool: stacked rows on the device, the
    row bookkeeping and the validity mask on the host.

    Rows are persistent between refreshes: an anchor keeps its row, new
    anchors append, and ineligible anchors are masked host-side rather than
    compacted, so an ``update`` scatters only the changed rows
    (``index_copy_``) where a ``refresh`` repacks and re-uploads all.

    With a ``mesh`` the stacked rows are sharded over its ``cand`` axis at
    every refresh (``dev_pool`` is then a ``GlobalArray``: this rank's
    slice of the tree's anchors), and ``update`` always asks for a full
    refresh."""

    def __init__(self, rt, device: torch.device, n_pad_hint: int = 0,
                 dtype=np.float32, mesh=None):
        super().__init__(rt, device, dtype)
        self.mesh = mesh
        self.budget = 64
        # a caller that knows how many samples the run will place sizes
        # the pool for all of them up front
        self.n_pad_hint = n_pad_hint
        self.anchor_ids: List[int] = []
        self.dev_pool = None            # [capacity, F, B1] on the device
        self.row_of = {}                # node -> row
        self.node_at: List[int] = []    # row -> node (-1 = unassigned)
        self.valid = None               # host bool mask over rows
        self.capacity = 0

    def refresh(self) -> int:
        """Repack every eligible anchor (node-index order) and upload."""
        anchors, vecs = self.all_anchors(by_node_index=True)
        self.anchor_ids = anchors
        if not anchors:
            self.dev_pool = None
            return 0
        self.budget = OP.budget_for(vecs, self.budget)
        n = len(vecs)
        n_pad = 64
        while n_pad < max(n, self.n_pad_hint):
            n_pad *= 2
        rows = np.zeros((n_pad, NFIELDS, self.budget), dtype=self.dtype)
        rows[:n] = self._pack_rows(vecs)
        if self.mesh is not None:
            from .mesh import put_global
            self.dev_pool = put_global(self.mesh, rows, ("cand",))
        else:
            self.dev_pool = upload(rows, self.device)
        self.capacity = n_pad
        self.row_of = {node: i for i, node in enumerate(anchors)}
        self.node_at = anchors + [-1] * (n_pad - n)
        self.valid = np.zeros(n_pad, dtype=bool)
        self.valid[:n] = True
        return n

    def update(self, changed) -> bool:
        """Incremental refresh: re-export only ``changed`` nodes and
        scatter their rows into the device-resident pool.  Returns False
        when a full refresh is required instead (first build, mesh
        sharding, entry-budget growth, or capacity exhausted)."""
        if self.dev_pool is None or self.mesh is not None \
                or not self.capacity:
            return False
        idx = []
        vecs = []
        for node in changed:
            vec = self.eligible_vec(node)
            row = self.row_of.get(node)
            if vec is None:
                if row is not None:
                    self.valid[row] = False
                continue
            if len(vec) > self.budget:
                return False        # entry budget must grow: full repack
            if row is None:
                row = len(self.row_of)
                if row >= self.capacity:
                    return False    # out of rows: full repack
                self.row_of[node] = row
                self.node_at[row] = node
            self.valid[row] = True
            idx.append(row)
            vecs.append(vec)
        if idx:
            self.dev_pool.index_copy_(
                0, upload(np.asarray(idx, dtype=np.int64), self.device),
                upload(self._pack_rows(vecs), self.device))
        return True

    @property
    def n_prefix(self) -> int:
        """Rows to score: the power-of-two prefix that holds every
        assigned row (rows are assigned compactly)."""
        n = 64
        while n < len(self.row_of):
            n *= 2
        return min(n, self.capacity)


class BatchedPlacer:
    """Places samples in device-scored batches (``place_batch``), and holds
    the host decision phase (``_place_one``) that the pipelined placer
    reuses."""

    SPAN_PREFIX = "legacy."     # its stages' spans (module docstring)

    def __init__(self, rt, stats, device: torch.device,
                 batch_size: int = 64, query_chunk: int = 16, mesh=None,
                 use_pallas: bool = False, expected_samples: int = 0):
        self.rt = rt
        self.stats = stats
        self.device = device
        self.batch_size = batch_size
        self.mesh = mesh
        self.use_pallas = use_pallas
        if mesh is not None:
            # query chunks shard over dp: keep them divisible by the axis
            dp = mesh.shape["dp"]
            query_chunk = max(query_chunk, dp)
            query_chunk += (-query_chunk) % dp
        self.query_chunk = query_chunk    # a mesh scores in such chunks
        # a de-novo run on K samples ends with < 2K anchors (leaves +
        # internals, minus collapsed minors and 0-length nodes)
        self.pool = DeviceTreePool(rt, device, mesh=mesh,
                                   n_pad_hint=2 * expected_samples)
        # Cross-batch pool retention: nodes created/touched since the last
        # pool sync (their stale pool scores are masked out of every
        # screen and re-scored fresh on host, the same exactness machinery
        # as within-batch staleness).  They are host-rescored for EVERY
        # query until the next sync, and the incremental row scatter is
        # cheap, so the single-device pool syncs early and often; a mesh
        # repacks and re-uploads the whole pool per sync and keeps the
        # high threshold.
        self.recent: List[int] = []
        self.recent_set = set()
        self.refresh_threshold = 768 if mesh is not None else 48
        self.q_budget = 256
        self.mm_dev = None
        self.rf_dev = None
        self.mm_version = -1
        self.dm = None
        self.dm_version = -1
        self.time_scoring = 0.0   # host seconds in (or blocked on) screens
        self.time_fine = 0.0
        self.time_apply = 0.0
        # the stage split (module docstring)
        self.tracer = rt.tracer
        self._prof = self.tracer.totals(prefix=self.SPAN_PREFIX) \
            if self.tracer.traced else None
        self._prof_batches = 0

    def _tick(self, key, t0):
        """Record the time since ``t0`` as the span of stage ``key``;
        returns now."""
        now = time.time()
        self.tracer.add(self.SPAN_PREFIX + key, now - t0)
        return now

    def _model_arrays(self):
        """(mm [1, 1, 16], rf [1, 1, 4]) float32 on the device, uploaded
        again when the model's version moves."""
        model = self.rt.model
        if self.mm_dev is None or self.mm_version != model.version:
            mm = np.asarray(model.mut_matrix,
                            dtype=np.float32).reshape(1, 1, 16)
            rf = np.asarray(model.refd.root_freqs,
                            dtype=np.float32).reshape(1, 1, 4)
            self.mm_dev = upload(mm, self.device)
            self.rf_dev = upload(rf, self.device)
            self.mm_version = model.version
        return self.mm_dev, self.rf_dev

    def _device_model(self):
        """The float32 DeviceModel of the interval-algebra and mesh
        scorers, made again when the model's version moves."""
        if self.dm is None or self.dm_version != self.rt.model.version:
            self.dm = device_model_from(self.rt.model, self.rt.dc,
                                        device=self.device,
                                        dtype=torch.float32)
            self.dm_version = self.rt.model.version
        return self.dm

    def _mesh_scores(self, Cflat: np.ndarray) -> np.ndarray:
        """[K, capacity] scores over the mesh: fixed-size query chunks
        (the tail padded by repeating row 0), each sharded over ``dp``
        against the ``cand``-sharded pool, the tiles gathered to every
        rank.  The whole pool is scored: a prefix would break the cand
        sharding."""
        from .mesh import (host_fetch, placement_scores,
                           placement_scores_pallas, put_global)
        K = Cflat.shape[0]
        qc = self.query_chunk
        pad_to = -(-K // qc) * qc
        if pad_to > K:
            Cflat = np.concatenate(
                [Cflat, np.repeat(Cflat[:1], pad_to - K, axis=0)], axis=0)
        scorer = placement_scores_pallas if self.use_pallas \
            else placement_scores
        dm = self._device_model()
        return np.concatenate([host_fetch(scorer(
            self.mesh, self.pool.dev_pool,
            put_global(self.mesh, Cflat[s:s + qc], ("dp",)),
            self.rt.dc.oneMutBLen, dm)) for s in range(0, pad_to, qc)],
            axis=0)[:K]

    def _query_arrays(self, queries):
        """Host (Cflat [K, 1, B2 * F], prm [K, 1, 4]) of K exported queries
        scored as tips at branch length oneMutBLen; the query entry budget
        doubles until every query fits."""
        rt = self.rt
        pool = self.pool
        while any(len(q) > self.q_budget for q in queries):
            self.q_budget *= 2
        K = len(queries)
        packed = OP.pack_genome_lists(queries, rt.refd.lRef, self.q_budget,
                                      rt.model.using_error_rate,
                                      dtype=np.float32)
        Cflat = stack_fields_host(packed, pool.site_rates, pool.error_rates,
                                  axis=-1).reshape(K, 1, -1)
        dc = rt.dc
        prm = np.broadcast_to(
            np.asarray([dc.oneMutBLen, 1.0, dc.globalTotRate,
                        rt.model.tot_error or 0.0], dtype=np.float32),
            (K, 4)).reshape(K, 1, 4).copy()
        return Cflat, prm

    # ------------------------------------------------------------------
    def place_batch(self, root: int, samples: List[tuple]) -> int:
        """samples: list of (sample_id, diffs_genome_list).  Returns the
        (possibly new) root."""
        rt = self.rt
        tree = rt.tree
        pool = self.pool
        t0 = time.time()
        need_refresh = pool.dev_pool is None or not pool.anchor_ids
        if not need_refresh and len(self.recent) > self.refresh_threshold:
            # incremental path: scatter only the changed rows into the
            # device-resident pool; a full repack when the entry budget or
            # the row capacity must grow
            if pool.update(self.recent):
                self.recent = []
                self.recent_set = set()
            else:
                need_refresh = True
        if need_refresh:
            n_anchors = pool.refresh()
            self.recent = []
            self.recent_set = set()
        else:
            n_anchors = len(pool.anchor_ids)
        if n_anchors == 0:
            # degenerate tree (e.g. everything absorbed as minors so far):
            # fall back to the host search for this batch
            for sample_id, diffs in samples:
                bn, bs, bb, bv = find_best_parent_for_new_sample(
                    rt, root, diffs, sample_id, self.stats)
                if bb is not None:
                    nr = place_sample_on_tree(
                        rt, bn, bv, sample_id, bs, bb[0], bb[1], bb[2],
                        rt.model.pseudo_counts, self.stats)
                    if nr is not None:
                        root = nr
            return root
        t1 = self._tick("sync_pool", t0)
        if self.use_pallas and self.mesh is None:
            mm, rf = self._model_arrays()
        else:
            self._device_model()
        t1 = self._tick("model_warm", t1)
        # one scorer call per batch, over the active power-of-two prefix
        # of the pool: the full-capacity pool is sized for the whole run
        # and would spend most of the work on unassigned rows
        Cflat, prm = self._query_arrays(
            [rt.kern.export(q) for _, q in samples])
        if self.mesh is not None:
            n_used = pool.capacity
            scores = self._mesh_scores(Cflat)
        elif self.use_pallas:
            n_used = pool.n_prefix
            scores = append_scores_prestacked(
                pool.dev_pool[:n_used], upload(Cflat, self.device),
                upload(prm, self.device), mm, rf,
                uer=rt.model.using_error_rate).cpu().numpy()
        else:
            n_used = pool.n_prefix
            C = upload(Cflat, self.device).reshape(len(samples), -1, NFIELDS)
            scores = grid_append_scores(
                fields_view(pool.dev_pool[:n_used], -2), fields_view(C, -1),
                rt.dc.oneMutBLen, True, self._device_model()).cpu().numpy()
        t1 = self._tick("score_readback", t1)
        # columns map to persistent pool rows; rows whose node became
        # ineligible (or were never assigned) are masked out
        scores[:, ~pool.valid[:n_used]] = -np.inf
        t1 = self._tick("mask", t1)
        self.time_scoring += time.time() - t0

        anchor_ids = pool.node_at
        # Staleness repair: nodes created by earlier placements (this
        # batch or any batch since the last pool sync) AND existing
        # anchors whose cached vectors were touched by dirty propagation
        # are re-scored on host for every query, so chained placements
        # stay exactly as sharp as the serial path's (whose tree the
        # device pool cannot see).  The touch set comes from the
        # runtime's update_partials recorder.
        recent = self.recent
        recent_set = self.recent_set
        touched = set()
        anchor_index = pool.row_of
        prev_log = rt.touch_log
        rt.touch_log = touched
        try:
            for k, (sample_id, diffs) in enumerate(samples):
                n_before = len(tree.up)
                touched.clear()
                row = scores[k]
                if recent:
                    # stale-anchor mask: pool scores of nodes modified
                    # earlier in this batch are batch-start values — an
                    # inflated stale score would raise the screening
                    # threshold and shut genuine candidates out of the
                    # fine phase, so they are dropped here and re-scored
                    # fresh on host below
                    row = row.copy()
                    for n in recent:
                        j = anchor_index.get(n)
                        if j is not None:
                            row[j] = -np.inf
                root = self._place_one(root, sample_id, diffs, row,
                                       anchor_ids, recent)
                for n in range(n_before, len(tree.up)):
                    if n not in recent_set:
                        recent_set.add(n)
                        recent.append(n)
                for n in touched:
                    if n < n_before and n not in recent_set:
                        recent_set.add(n)
                        recent.append(n)
        finally:
            rt.touch_log = prev_log
        self._tick("host_apply", t1)
        if self._prof is not None:
            self._prof_batches += 1
            if self._prof_batches % 40 == 0:
                print("[devbatch]", {k: round(v, 1)
                                     for k, v in sorted(self._prof.items())},
                      flush=True)
        return root

    # ------------------------------------------------------------------
    def _diffs_in_frame(self, diffs, node, memo):
        """Sample diffs translated from the global frame into ``node``'s
        MAT frame (composition of passGenomeListThroughBranch down the
        root->node mutation chain, reference :3749; memoized per distinct
        chain so polytomy-mates share the translation)."""
        tree = self.rt.tree
        chain = []
        n = node
        while n is not None:
            if tree.mutations[n]:
                chain.append(n)
            n = tree.up[n]
        if not chain:
            return diffs
        key = tuple(chain)
        v = memo.get(key)
        if v is None:
            v = diffs
            for n in reversed(chain):
                v = self.rt.pass_down(v, n)
            memo[key] = v
        return v

    def _place_one(self, root: int, sample_id, diffs, anchor_scores,
                   anchor_ids, recent_nodes=()) -> int:
        """Exact host decision for one query given device anchor scores."""
        rt = self.rt
        tree = rt.tree
        dc = rt.dc
        kern = rt.kern
        one_mut = dc.oneMutBLen
        t0 = time.time()
        memo = {}
        # base: appending at the root
        root_vect = rt.root_vector(tree.probVect[root], False, False, root)
        root_score = kern.append_prob_node(
            root_vect, self._diffs_in_frame(diffs, root, memo), True,
            one_mut)
        best_lk = root_score
        # host-score the nodes changed since the screen (absent from or
        # stale in the device pool) so chained placements stay sharp
        eff0 = dc.effectivelyNon0BLen
        recent_scored = []
        for n in recent_nodes:
            if tree.up[n] is None or tree.children[n] is None:
                continue
            if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
                sc = kern.append_prob_node(
                    tree.probVectTotUp[n],
                    self._diffs_in_frame(diffs, n, memo), True, one_mut)
                recent_scored.append((sc, n))
                best_lk = max(best_lk, sc)
        order = np.argsort(anchor_scores)[::-1]
        top = []
        if len(order):
            best_dev = float(anchor_scores[order[0]])
            best_lk = max(best_lk, best_dev)
        thresh = best_lk - dc.thresholdLogLKoptimization - 1.0
        for sc, n in sorted(recent_scored, reverse=True):
            if sc >= thresh:
                top.append(n)
        for j in order[:64]:
            if anchor_scores[j] < thresh:
                break
            top.append(anchor_ids[j])

        # minor-sequence absorption around the best candidates
        leaf_checks = []
        for node in top[:4]:
            if not tree.children[node]:
                leaf_checks.append(node)
            else:
                for c in tree.children[node]:
                    if not tree.children[c]:
                        leaf_checks.append(c)
            if tree.up[node] is not None:
                sib = tree.children[tree.up[node]][
                    1 - tree.child_index(node)]
                if not tree.children[sib]:
                    leaf_checks.append(sib)
        for leaf in leaf_checks:
            v = tree.probVect[leaf]
            if v is None:
                continue
            q_at = self._diffs_in_frame(diffs, leaf, memo)
            comparison = kern.is_minor_sequence(v, q_at)
            if comparison == 1:
                tree.minorSequences[leaf].append(sample_id)
                self.stats.num_minors_found += 1
                self.time_fine += time.time() - t0
                return root

        # exact fine phase on the top candidates (host float64; reference
        # :8105-8293 semantics)
        best_node = root
        best_score = root_score
        best_blens = (False, False, one_mut)
        best_diffs = self._diffs_in_frame(diffs, root, memo)
        for node in top:
            if tree.probVectTotUp[node] is None or tree.up[node] is None \
                    or tree.children[node] is None:
                continue  # restructured by an earlier placement in the batch
            diffs_at = self._diffs_in_frame(diffs, node, memo)
            up_vect = tree.vect_up_for(node)
            if tree.mutations[node]:
                up_vect = rt.pass_down(up_vect, node)
            is_tip = tree.is_tip(node)
            best_appending = kern.estimate_branch_length(
                tree.probVectTotUp[node], diffs_at, from_tip_c=True)
            mid_lower = kern.merge_vectors(
                tree.probVect[node], tree.dist[node] / 2, is_tip,
                diffs_at, best_appending, True)
            best_top = kern.estimate_branch_length(up_vect, mid_lower)
            mid_top = kern.merge_vectors(
                up_vect, best_top, False, diffs_at, best_appending, True,
                is_up_down=True)
            best_bottom = kern.estimate_branch_length(
                mid_top, tree.probVect[node], from_tip_c=is_tip)
            new_mid = kern.merge_vectors(
                up_vect, best_top, False, tree.probVect[node],
                best_bottom, is_tip, is_up_down=True)
            appending_cost = kern.append_prob_node(new_mid, diffs_at, True,
                                                   best_appending)
            initial_cost = kern.append_prob_node(
                up_vect, tree.probVect[node], is_tip, tree.dist[node])
            new_partial_cost = kern.append_prob_node(
                up_vect, tree.probVect[node], is_tip,
                best_bottom + best_top)
            optimized = appending_cost + new_partial_cost - initial_cost
            if optimized >= best_score:
                best_score = optimized
                best_node = node
                best_blens = (best_top, best_bottom, best_appending)
                best_diffs = diffs_at
        self.time_fine += time.time() - t0

        t0 = time.time()
        new_root = place_sample_on_tree(
            rt, best_node, best_diffs, sample_id, best_score, best_blens[0],
            best_blens[1], best_blens[2], rt.model.pseudo_counts, self.stats)
        self.time_apply += time.time() - t0
        return new_root if new_root is not None else root
