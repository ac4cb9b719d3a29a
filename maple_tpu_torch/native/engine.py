"""Python driver for the native C++ placement engine.

The engine (native/maple_native.cpp, `Engine`) runs the stepwise-addition
DFS, placement and dirty propagation entirely in C++ over store-owned
vectors — a port of maple_tpu_torch/search/placement.py and
maple_tpu_torch/runtime/partials.py:update_partials (reference
findBestParentForNewSample :7912-8293, placeSampleOnTree :8370-8710,
updatePartials :5479-5817).  The driver feeds it global-frame terminal
vectors, refreshes the substitution model from pseudo-counts on the same
cadence as the Python loop, and finally exports the C++ tree into the
session's PhyloTree with zero-copy vector handles.

Placement covers the de-novo path including rate variation, HnZ, and
active error models; time trees and deeper-long-branch search fall
back to the Python loop (callers gate on `native_engine_supported`).
The module also hosts whole-phase helpers — run_native_spr_pass,
run_native_recalculate, run_native_tree_lk, run_native_blen_sweep, ... —
that run the phase through a `NativeSession` method: the live session's,
or, where none is live, a one-shot engine's that imports the tree and
hands it back.
"""
from __future__ import annotations

import contextlib
import ctypes as C

import numpy as np

from ..core import genomelist as gl
from ..core.backend import NV, NativeBackend


def _ptr(a):
    """A ctypes pointer to the data of numpy array ``a``."""
    return a.ctypes.data_as(C.POINTER(np.ctypeslib.as_ctypes_type(a.dtype)))


def _export_nodes(lib, h, n):
    """The engine's per-node arrays (engine_export_nodes): up, child 0,
    child 1, dist, name, nDesc, dirty, the four vector handles (probVect,
    up-right, up-left, total-up), minor-sequence and mutation counts."""
    i32, i64 = np.int32, np.int64
    out = [np.empty(n, t) for t in (i32, i32, i32, np.float64, i32, i32,
                                    np.uint8, i64, i64, i64, i64, i32, i32)]
    lib.engine_export_nodes(h, *map(_ptr, out))
    return out


def native_engine_supported(run) -> bool:
    """The engine covers the reference's de-novo placement configurations
    incl. rate variation, HnZ, and active error models; time trees and
    deeper-long-branch search fall back to the Python loop."""
    cfg = run.cfg
    # rate variation is supported natively: the store's per-site matrix
    # is mut[i][j] * site_rates[pos], exactly the python per-site tables
    # (byte parity pinned by the example_ratevar golden); HnZ placement
    # corrections + nDesc0 bookkeeping run natively too; error-model
    # placement works through the store's error rates + alias-tagged
    # shared ambiguity lists (sweep_errfixed / sweep_errfile goldens)
    return (run.time_ctx is None
            and not cfg.deeperSearchForLongBranches
            and not cfg.doNotPlaceNewSamples)


class NativePlacementEngine:
    """Owns a C++ Engine for one stepwise-addition run."""

    def __init__(self, rt, root_diffs):
        assert isinstance(rt.kern, NativeBackend)
        self.rt = rt
        self.store = rt.kern.store
        self.lib = self.store.lib
        cfg = rt.cfg
        dc = rt.dc
        only_identical = (bool(cfg.errorRateSiteSpecificFile)
                          or bool(cfg.errorRateFixed)
                          or cfg.estimateErrorRate
                          or cfg.estimateSiteSpecificErrorRate
                          or cfg.supportFor0Branches or bool(cfg.HnZ))
        self.store.sync_model(rt.model)
        root_vec = self.store.from_tuples(self._terminal_tuples(root_diffs))
        self.h = C.c_void_p(self.lib.engine_create(
            self.store.h, root_vec, 0,
            0 if cfg.nonStrictStopRules else 1, cfg.allowedFails,
            dc.thresholdLogLK, dc.thresholdLogLKoptimization,
            dc.thresholdLogLKconsecutivePlacement, dc.oneMutBLen,
            dc.effectivelyNon0BLen,
            1 if only_identical else 0,
            1 if rt.use_local_reference else 0,
            cfg.maxNumDescendantsForMATClade, cfg.minNumNon4))
        if cfg.HnZ:
            self.lib.engine_set_hnz(self.h, cfg.HnZ)
        if cfg.placementBudget:
            self.lib.engine_set_search_budget(self.h, cfg.placementBudget)
        if cfg.numCores > 1:
            # threads the read-only engine exports (device-screen
            # feature rows) across the configured width
            self.lib.engine_set_threads(self.h, cfg.numCores)

    def _terminal_tuples(self, diffs):
        model = self.rt.model
        return gl.terminal_node_genome_list(
            self.rt.refd, diffs,
            only_n_ambiguities=self.rt.cfg.onlyNambiguities,
            using_error_rate=model.using_error_rate,
            error_rate=model.error_rate,
            error_rates=model.error_rates)

    def _terminal_vid(self, diffs) -> int:
        """Build the sample's terminal genome list store-side
        (vec_from_diffs) when the error model is inactive — the shared
        ambiguity lists are pristine then, so the C table is exact; error
        runs keep the python builder (mutable-aliasing semantics)."""
        if diffs is not None and not self.rt.model.using_error_rate:
            n = len(diffs)
            chars = np.frombuffer(
                "".join([m[0] for m in diffs]).encode("latin-1"), np.int8) \
                if n else np.empty(0, np.int8)
            if len(chars) == n:  # all single-character diff codes
                pos = np.fromiter((m[1] for m in diffs), np.int32, n)
                lens = np.fromiter(
                    (m[2] if len(m) > 2 else 1 for m in diffs), np.int32, n)
                vid = self.lib.vec_from_diffs(
                    self.store.h, n, chars.ctypes.data_as(C.POINTER(C.c_int8)),
                    pos.ctypes.data_as(C.POINTER(C.c_int32)),
                    lens.ctypes.data_as(C.POINTER(C.c_int32)),
                    1 if self.rt.cfg.onlyNambiguities else 0)
                if vid >= 0:
                    return vid
        return self.store.from_tuples(self._terminal_tuples(diffs))

    def terminal_vids_batch(self, diffs_list) -> np.ndarray:
        """Terminal vector handles for a whole batch in one native call
        (vec_from_diffs_batch).  Samples the fast path cannot express
        (error model active, multi-character ambiguity codes, missing
        diff lists) fall back to the per-sample python builder, exactly
        as :meth:`_terminal_vid` does."""
        n = len(diffs_list)
        fast = not self.rt.model.using_error_rate
        all_m: list = []
        counts = np.empty(n, np.int64)
        if fast:
            for i, dl in enumerate(diffs_list):
                if dl is None:
                    fast = False
                    break
                counts[i] = len(dl)
                all_m.extend(dl)
        if fast:
            s = "".join([m[0] for m in all_m])
            if len(s) == len(all_m):  # all single-character diff codes
                chars = np.frombuffer(s.encode("latin-1"), np.int8) \
                    if all_m else np.empty(0, np.int8)
                pos = np.array([m[1] for m in all_m], np.int32) \
                    if all_m else np.empty(0, np.int32)
                lens = np.array(
                    [m[2] if len(m) > 2 else 1 for m in all_m],
                    np.int32) if all_m else np.empty(0, np.int32)
                out = np.empty(n, np.int64)
                self.lib.vec_from_diffs_batch(
                    self.store.h, n,
                    counts.ctypes.data_as(C.POINTER(C.c_int64)),
                    chars.ctypes.data_as(C.POINTER(C.c_int8)),
                    pos.ctypes.data_as(C.POINTER(C.c_int32)),
                    lens.ctypes.data_as(C.POINTER(C.c_int32)),
                    1 if self.rt.cfg.onlyNambiguities else 0,
                    out.ctypes.data_as(C.POINTER(C.c_int64)))
                for i in np.nonzero(out < 0)[0]:
                    out[i] = self.store.from_tuples(
                        self._terminal_tuples(diffs_list[i]))
                return out
        return np.fromiter((self._terminal_vid(d) for d in diffs_list),
                           np.int64, n)

    def place(self, diffs, sample: int) -> bool:
        """Place one sample; returns True when absorbed as a minor
        sequence."""
        vid = self._terminal_vid(diffs)
        status = self.lib.engine_place(self.h, vid, sample)
        if status < 0:
            msg = self.lib.engine_error(self.h).decode()
            raise RuntimeError(f"native placement engine: {msg}")
        return status == 1

    def place_batch(self, diffs_list, first_sample: int, num_cores: int):
        """Search-parallel / apply-serial placement of a contiguous run
        of samples numbered first_sample..first_sample+len-1 (see
        native engine_place_batch).  Requires an active --placementBudget
        (the exact DFS is order-dependent by design).  If the engine
        reports the configuration unsupported (alias tags active), the
        already-uploaded terminals are placed serially instead."""
        self.place_batch_vids(self.terminal_vids_batch(diffs_list),
                              first_sample, num_cores)

    def place_batch_vids(self, vids: np.ndarray, first_sample: int,
                         num_cores: int):
        """place_batch over prebuilt terminal handles (the pipelined
        driver builds the next batch's vectors while the engine places
        the current one — store slot allocation is mutex-guarded, so
        the overlap is safe)."""
        n = len(vids)
        vids = np.ascontiguousarray(vids, np.int64)
        samples = np.arange(first_sample, first_sample + n, dtype=np.int32)
        rc = self.lib.engine_place_batch(
            self.h, num_cores, n,
            vids.ctypes.data_as(C.POINTER(C.c_int64)),
            samples.ctypes.data_as(C.POINTER(C.c_int32)))
        if rc == 2:  # engine_place owns and reclaims each vid
            for vid, sample in zip(vids.tolist(), samples.tolist()):
                if self.lib.engine_place(self.h, int(vid), int(sample)) < 0:
                    rc = -1
                    break
        if rc < 0:
            msg = self.lib.engine_error(self.h).decode()
            raise RuntimeError(f"native placement engine: {msg}")

    # -- device proxy-screen support (maple_tpu_torch/parallel/proxy_placer) --
    def terminal_vid(self, diffs) -> int:
        """Public terminal-vector handle for the device screen driver
        (feature export + later seeded placement).  The seeded batch
        call reclaims the handle."""
        return self._terminal_vid(diffs)

    def profile(self) -> dict:
        """Engine phase counters (non-zero only in MAPLE_NATIVE_PROFILE
        builds): rdtsc cycles per placement phase plus entry-scan
        statistics — the diagnosis channel behind BASELINE.md's
        placement-droop attribution.  After export_to_tree the engine
        handle is freed; the snapshot taken there is returned instead."""
        if self.h is None:
            return getattr(self, "last_profile", {})
        out = np.zeros(26, np.float64)
        self.lib.engine_profile(self.h, out.ctypes.data_as(
            C.POINTER(C.c_double)))
        return {"find_cy": out[0], "append_cy": out[1],
                "pass_cy": out[2], "fine_cy": out[3],
                "place_cy": out[4], "scored": out[5], "free": out[6],
                "entries": out[7], "tot_entries": out[8],
                "o_entries": out[9], "gap_hist": out[10:26].tolist()}

    def screen_log(self, on: bool):
        self.lib.engine_screen_log(self.h, 1 if on else 0)

    def screen_drain(self) -> np.ndarray:
        """Nodes whose screen row went stale since the last drain
        (sorted, unique)."""
        cap = int(self.lib.engine_node_count(self.h)) + 16
        out = np.empty(cap, np.int32)
        m = self.lib.engine_screen_drain(
            self.h, out.ctypes.data_as(C.POINTER(C.c_int32)), cap)
        return out[:m]

    def export_feats(self, nodes: np.ndarray, d_hash: int, g_buckets: int,
                     fmax: int, use_fp: bool = False):
        """(idx [n, fmax] i32, w [n, fmax] f32, valid [n] bool, max_nf,
        skip [n] bool) anchor-side proxy features of the nodes'
        mid-branch vectors.  With ``use_fp`` the engine fingerprints
        each row and marks rows identical to their last export as
        skip=True (their idx/w rows are UNINITIALIZED — drop them
        before use)."""
        n = len(nodes)
        nodes = np.ascontiguousarray(nodes, np.int32)
        idx = np.empty((n, fmax), np.int32)
        w = np.empty((n, fmax), np.float32)
        counts = np.empty(n, np.int32)
        valid = np.empty(n, np.uint8)
        max_nf = self.lib.engine_export_feats(
            self.h, nodes.ctypes.data_as(C.POINTER(C.c_int32)), n,
            d_hash, g_buckets, fmax,
            idx.ctypes.data_as(C.POINTER(C.c_int32)),
            w.ctypes.data_as(C.POINTER(C.c_float)),
            counts.ctypes.data_as(C.POINTER(C.c_int32)),
            valid.ctypes.data_as(C.POINTER(C.c_uint8)),
            1 if use_fp else 0)
        return idx, w, valid.astype(bool), int(max_nf), counts < 0

    def export_query_feats(self, vids: np.ndarray, d_hash: int,
                           g_buckets: int, fmax: int):
        n = len(vids)
        vids = np.ascontiguousarray(vids, np.int64)
        idx = np.empty((n, fmax), np.int32)
        w = np.empty((n, fmax), np.float32)
        counts = np.empty(n, np.int32)
        max_nf = self.lib.engine_export_query_feats(
            self.h, vids.ctypes.data_as(C.POINTER(C.c_int64)), n,
            d_hash, g_buckets, fmax,
            idx.ctypes.data_as(C.POINTER(C.c_int32)),
            w.ctypes.data_as(C.POINTER(C.c_float)),
            counts.ctypes.data_as(C.POINTER(C.c_int32)))
        return idx, w, int(max_nf)

    def place_batch_seeded(self, vids: np.ndarray, first_sample: int,
                           seeds: np.ndarray, num_cores: int,
                           seed_budget: int):
        """Seeded batched placement (native engine_place_batch_seeded):
        vids are terminal handles from :meth:`terminal_vid` (reclaimed
        by the call), seeds is [n, seeds_per] i32 (pad with -1).  Falls
        back to serial placement when unsupported (alias tags)."""
        n = len(vids)
        vids = np.ascontiguousarray(vids, np.int64)
        seeds = np.ascontiguousarray(seeds, np.int32)
        samples = np.arange(first_sample, first_sample + n,
                            dtype=np.int32)
        rc = self.lib.engine_place_batch_seeded(
            self.h, num_cores, n,
            vids.ctypes.data_as(C.POINTER(C.c_int64)),
            samples.ctypes.data_as(C.POINTER(C.c_int32)),
            seeds.ctypes.data_as(C.POINTER(C.c_int32)),
            seeds.shape[1], seed_budget)
        if rc == 2:  # engine_place owns and reclaims each vid
            for vid, sample in zip(vids.tolist(), samples.tolist()):
                if self.lib.engine_place(self.h, int(vid),
                                         int(sample)) < 0:
                    rc = -1
                    break
        if rc < 0:
            msg = self.lib.engine_error(self.h).decode()
            raise RuntimeError(f"native placement engine: {msg}")

    def flush_pseudo_counts(self, pseudo_counts):
        """Move the engine's accumulated substitution counts into the
        model's pseudo-count matrix (same totals as the Python loop's
        incremental update_pseudo_counts calls)."""
        buf = np.zeros(16, np.float64)
        self.lib.engine_counts(self.h, buf.ctypes.data_as(
            C.POINTER(C.c_double)), 1)
        out = buf.reshape(4, 4).tolist()
        for i in range(4):
            for j in range(4):
                pseudo_counts[i][j] += out[i][j]

    def sync_model(self):
        self.store.sync_model(self.rt.model)

    def snapshot_tree(self):
        """Non-destructive topology export for mid-run checkpoints (the
        reference's ``_initialTree_<N>samples.tree`` writes,
        :11754-11760): returns a (PhyloTree, root) pair carrying only the
        arrays the newick writer needs — no vector handles change hands
        and the engine keeps running."""
        from ..runtime.tree import PhyloTree
        lib, h = self.lib, self.h
        n = lib.engine_node_count(h)
        up, c0, c1, dist, name, _, _, _, _, _, _, n_minor, _ = \
            _export_nodes(lib, h, n)
        tree = PhyloTree()
        tree.up = [u if u >= 0 else None for u in up.tolist()]
        tree.children = [[] if a < 0 else [a, b]
                         for a, b in zip(c0.tolist(), c1.tolist())]
        tree.dist = dist.tolist()
        tree.name = [m if m >= 0 else "" for m in name.tolist()]
        tree.minorSequences = [[] for _ in range(n)]
        for node in np.nonzero(n_minor)[0].tolist():
            buf = np.empty(int(n_minor[node]), np.int32)
            lib.engine_export_minor(h, node, _ptr(buf))
            tree.minorSequences[node] = buf.tolist()
        return tree, int(lib.engine_root(h))

    def export_to_tree(self, stats) -> int:
        """Materialize the engine's tree into self.rt.tree (in place) and
        return the root id.  Vector handles transfer zero-copy."""
        # snapshot phase counters before engine_free invalidates the handle
        self.last_profile = self.profile()
        self.rt.mark_mutated()
        lib, h, store = self.lib, self.h, self.store
        n = lib.engine_node_count(h)
        (up, c0, c1, dist, name, ndesc, dirty, pv, upr, upl, totup, n_minor,
         n_muts) = _export_nodes(lib, h, n)

        tree = self.rt.tree
        up_l = up.tolist()
        c0_l = c0.tolist()
        c1_l = c1.tolist()
        name_l = name.tolist()
        tree.up = [u if u >= 0 else None for u in up_l]
        tree.children = [[] if a < 0 else [a, b]
                         for a, b in zip(c0_l, c1_l)]
        tree.dist = dist.tolist()
        tree.name = [m if m >= 0 else "" for m in name_l]
        tree.nDesc = ndesc.tolist()
        tree.dirty = [bool(x) for x in dirty.tolist()]
        tree.replacements = [0] * n
        if tree.use_hnz:
            nd0 = np.empty(n, np.int32)
            lib.engine_export_ndesc0(h, _ptr(nd0))
            tree.nDesc0 = nd0.tolist()
        tree.minorSequences = [[] for _ in range(n)]
        tree.mutations = [[] for _ in range(n)]
        for node in np.nonzero(n_minor)[0].tolist():
            buf = np.empty(int(n_minor[node]), np.int32)
            lib.engine_export_minor(h, node, _ptr(buf))
            tree.minorSequences[node] = buf.tolist()
        for node in np.nonzero(n_muts)[0].tolist():
            buf = np.empty(int(n_muts[node]) * 3, np.int32)
            lib.engine_export_muts(h, node, _ptr(buf))
            flat = buf.tolist()
            tree.mutations[node] = [tuple(flat[k:k + 3])
                                    for k in range(0, len(flat), 3)]

        def wrap(arr):
            return [NV(store, int(v)) if v >= 0 else None for v in arr]

        tree.probVect = wrap(pv)
        tree.probVectUpRight = wrap(upr)
        tree.probVectUpLeft = wrap(upl)
        tree.probVectTotUp = wrap(totup)

        sbuf = np.zeros(9, np.float64)
        lib.engine_stats(h, _ptr(sbuf))
        stats.dfs_visits = int(sbuf[7])
        stats.fine_evals = int(sbuf[8])
        stats.num_minors_found += int(sbuf[0])
        stats.total_missed_minors += int(sbuf[1])
        stats.sum_child_lks += float(sbuf[2])
        stats.num_child_lks += int(sbuf[3])
        if sbuf[4] and not stats.warned_blen:
            stats.warned_blen = True
            print("\n WARNING: found branch of length " + str(sbuf[5])
                  + " ; at high divergence MAPLE-style inference struggles "
                  "in accuracy and speed; a traditional phylogenetic "
                  "approach may fit better.\n")
        self.rt.num_refs += int(sbuf[6])
        root = int(lib.engine_root(h))
        lib.engine_free(h)
        self.h = None
        return root


def native_spr_supported(rt, abayes_on, network_output, check_each_spr):
    cfg = rt.cfg
    return (isinstance(rt.kern, NativeBackend)
            and not abayes_on and not network_output
            and not check_each_spr
            and not rt.do_time_tree
            and not cfg.deeperSearchForLongBranches
            and not cfg.doNotImproveTopology
            and getattr(rt, "trace", None) is None)


def run_native_spr_pass(rt, root, strict_stop, allowed_fails,
                        threshold_log_lk, threshold_topology_placement):
    """Run one full startTopologyUpdates sweep inside the C++ engine
    (native/maple_native.cpp engine_spr_pass): the live session's, or a
    one-shot engine that takes the tree's vector handles and hands them
    back re-wrapped with the MAT.  Returns (new_root_or_None, improvement,
    topo_updates, blen_updates) or None if the tree state is unsuitable
    (caller falls back)."""
    ses = rt.native_session
    if ses is not None:
        return ses.spr_pass(strict_stop, allowed_fails, threshold_log_lk,
                            threshold_topology_placement)
    with NativeSession._one_shot(rt, root, spr_budget=True) as one:
        if one is None:
            return None
        res = one.spr_pass(strict_stop, allowed_fails, threshold_log_lk,
                           threshold_topology_placement)
        one.close()  # the pass marked the tree mutated where it moved it
        return res


def run_native_spr_parallel(rt, root, num_cores, strict_stop, allowed_fails,
                            threshold_log_lk, threshold_topology_placement):
    """One search-parallel / apply-serial SPR pass with engine worker
    THREADS instead of the reference's forked processes
    (engine_spr_pass_parallel; host twin search/parallel_spr.py,
    reference startTopologyUpdatesParallel :9580-9716 +
    applySPRMovesParallel :9470-9484).  Proposals, sort order, and the
    re-validated serial applies match the fork path move for move, so
    outputs are byte-identical — without pickling, pool spin-up, or the
    python crawl in the workers.  Returns (new_root_or_None, improvement)
    or None when the tree state is unsuitable (caller forks)."""
    ses = rt.native_session
    if ses is not None:
        return ses.spr_parallel(num_cores, strict_stop, allowed_fails,
                                threshold_log_lk,
                                threshold_topology_placement)
    if rt.model.using_error_rate:
        # tag-registry writes during worker merges would race
        return None
    with NativeSession._one_shot(rt, root, spr_budget=True) as one:
        if one is None:
            return None
        res = one.spr_parallel(num_cores, strict_stop, allowed_fails,
                               threshold_log_lk,
                               threshold_topology_placement)
        # an unsupported state (None) hands the unchanged tree back and
        # the caller runs the fork path
        one.close(mat=res is not None)
        return res


def _import_engine(rt, root, transfer):
    """Build a C++ Engine holding the session tree.  With ``transfer``
    the python NV handles are disarmed (ownership moves to the engine and
    must come back via _export_engine); otherwise the engine borrows the
    vector ids read-only."""
    store = rt.kern.store
    lib = store.lib
    tree = rt.tree
    n = len(tree.up)
    store.sync_model(rt.model)
    i32, i64, f64, u8 = np.int32, np.int64, np.float64, np.uint8
    up = np.asarray([u if u is not None else -1 for u in tree.up], i32)
    c0 = np.empty(n, i32)
    c1 = np.empty(n, i32)
    for i, ch in enumerate(tree.children):
        if ch:
            c0[i], c1[i] = ch[0], ch[1]
        else:
            c0[i] = c1[i] = -1
    dist = np.asarray([float(d) if d else 0.0 for d in tree.dist], f64)
    ndesc = np.asarray(tree.nDesc, i32)
    dirty = np.asarray([1 if d else 0 for d in tree.dirty], u8)
    repl = np.asarray(tree.replacements, i32)
    seen = set()

    def vids(arr):
        out = np.empty(n, i64)
        for i, v in enumerate(arr):
            if v is None:
                out[i] = -1
            else:
                if transfer and v.vid in seen:
                    return None  # aliased handle: unsafe to transfer
                seen.add(v.vid)
                out[i] = v.vid
        return out

    pv = vids(tree.probVect)
    upr = vids(tree.probVectUpRight)
    upl = vids(tree.probVectUpLeft)
    totup = vids(tree.probVectTotUp)
    if pv is None or upr is None or upl is None or totup is None:
        return None
    rt.tracer.count("engine.transfers")
    minor_counts = np.asarray([len(m) for m in tree.minorSequences], i32)
    n_muts = np.asarray([len(m) for m in tree.mutations], i32)
    flat = []
    for m in tree.mutations:
        for t in m:
            flat.extend(t)
    muts_flat = np.asarray(flat if flat else [0], i32)
    if transfer:
        for arr in (tree.probVect, tree.probVectUpRight,
                    tree.probVectUpLeft, tree.probVectTotUp):
            for v in arr:
                if v is not None:
                    v.disarm()

    dc = rt.dc
    # full threshold set (notably thresholdLogLKconsecutivePlacement: the
    # SPR crawl's failed-pass gate reads E->threshold_consec — a 0 here
    # stops crawls early and silently changes search results; observed as
    # proposal divergence on --HnZ 2 --numCores 3)
    h = C.c_void_p(lib.engine_create(
        store.h, -1, 0,
        0 if rt.cfg.nonStrictStopRules else 1, rt.cfg.allowedFails,
        dc.thresholdLogLK, dc.thresholdLogLKoptimization,
        dc.thresholdLogLKconsecutivePlacement, dc.oneMutBLen,
        dc.effectivelyNon0BLen, 0, 1 if rt.use_local_reference else 0,
        rt.cfg.maxNumDescendantsForMATClade, rt.cfg.minNumNon4))
    lib.engine_import(h, n, _ptr(up), _ptr(c0),
                      _ptr(c1), _ptr(dist),
                      _ptr(ndesc), _ptr(dirty),
                      _ptr(repl), _ptr(pv),
                      _ptr(upr), _ptr(upl),
                      _ptr(totup), _ptr(minor_counts),
                      _ptr(n_muts), _ptr(muts_flat), root)
    if tree.use_hnz:
        lib.engine_set_hnz(h, rt.cfg.HnZ)
        nd0 = np.asarray(tree.nDesc0, i32)
        lib.engine_import_ndesc0(h, _ptr(nd0))
    return h


def _export_engine(rt, h, mutated=True, mat=False):
    """Write the engine's tree back into rt.tree, re-wrapping vector ids
    (counterpart of the transfer-mode _import_engine): topology, lengths,
    dirty flags and vectors; with ``mat`` also the replacement counts and
    local-reference mutation lists, which only SPR passes move (MAT
    relocation).  ``mutated`` False where the export itself changes
    nothing: a session handing its state back (its phases marked their
    own changes), or an SPR pass that moved nothing."""
    if mutated:
        rt.mark_mutated()  # every mutating one-shot engine phase exports here
    rt.tracer.count("engine.transfers")
    store = rt.kern.store
    lib = store.lib
    tree = rt.tree
    n = len(tree.up)
    (e_up, e_c0, e_c1, e_dist, _, e_nd, e_dirty, e_pv, e_upr, e_upl, e_tot,
     _, e_nm) = _export_nodes(lib, h, n)
    tree.up = [u if u >= 0 else None for u in e_up.tolist()]
    tree.children = [[] if a < 0 else [a, b]
                     for a, b in zip(e_c0.tolist(), e_c1.tolist())]
    tree.dist = e_dist.tolist()
    tree.nDesc = e_nd.tolist()
    tree.dirty = [bool(x) for x in e_dirty.tolist()]

    def wrap(arr):
        return [NV(store, int(v)) if v >= 0 else None for v in arr]

    tree.probVect = wrap(e_pv)
    tree.probVectUpRight = wrap(e_upr)
    tree.probVectUpLeft = wrap(e_upl)
    tree.probVectTotUp = wrap(e_tot)
    if tree.use_hnz:
        e_nd0 = np.empty(n, np.int32)
        lib.engine_export_ndesc0(h, _ptr(e_nd0))
        tree.nDesc0 = e_nd0.tolist()
    if not mat:
        return
    e_repl = np.empty(n, np.int32)
    lib.engine_export_replacements(h, _ptr(e_repl))
    tree.replacements = e_repl.tolist()
    tree.mutations = [[] for _ in range(n)]
    for node in np.nonzero(e_nm)[0].tolist():
        buf = np.empty(int(e_nm[node]) * 3, np.int32)
        lib.engine_export_muts(h, node, _ptr(buf))
        flat = buf.tolist()
        tree.mutations[node] = [tuple(flat[k:k + 3])
                                for k in range(0, len(flat), 3)]


def native_phase_supported(rt) -> bool:
    from ..core.backend import NativeBackend
    return (isinstance(rt.kern, NativeBackend)
            and rt.time is None)


class NativeSession:
    """A persistent C++ Engine spanning several host-driver phases.

    Every engine phase runs through a method of this class.  Outside a
    session a phase helper below (run_native_recalculate,
    run_native_tree_lk, ...) opens a one-shot engine (:meth:`_one_shot`)
    for its one call — an O(n) import/export round-trip per call that at
    pandemic scale costs more than the phases themselves.  A session
    imports the tree ONCE (transfer mode: vector ownership moves to the
    engine), runs any number of native phases against the resident state,
    and exports once at close.

    While a session is live the python-side tree arrays and vector handles
    are STALE; every consumer inside the session scope must either be
    routed through the session (the phase helpers check
    ``rt.native_session`` first) or read only topology refreshed via
    :meth:`sync_topology` (the newick writers), or suspend the session
    around itself (:meth:`suspend` / :meth:`resume`: a device SPR pass
    that runs on the host tree, ``parallel/batch_spr.py``).  The device
    proxy SPR pass runs against the resident tree instead
    (:meth:`spr_collect`, :meth:`spr_apply`).  Scopes are opened only for
    configurations where that holds — see
    ``pipeline.Run._native_session_eligible``.
    """

    def __init__(self, rt, root):
        self.rt = rt
        self.lib = None
        self.h = None
        self._last_root = root

    def _attach(self, root, transfer=True, spr_budget=True,
                root_budget=True, threads=True) -> bool:
        """Import the tree into a new engine (``transfer`` as in
        ``_import_engine``) and set the run's SPR budget, root budget and
        threads where asked (a session sets all three).  False, with no
        engine, where an aliased vector handle makes the transfer
        unsafe."""
        rt = self.rt
        self.h = _import_engine(rt, root, transfer)
        if self.h is None:
            return False
        self.lib = rt.kern.store.lib
        cfg = rt.cfg
        if spr_budget and cfg.topologyBudget:
            self.lib.engine_set_spr_budget(self.h, cfg.topologyBudget)
        if root_budget and cfg.rootSearchBudget:
            self.lib.engine_set_root_budget(self.h, cfg.rootSearchBudget)
        if threads and cfg.numCores > 1:
            self.lib.engine_set_threads(self.h, cfg.numCores)
        return True

    @classmethod
    @contextlib.contextmanager
    def _one_shot(cls, rt, root, transfer=True, spr_budget=False,
                  root_budget=False, threads=False):
        """An engine for one phase where no session is live: the tree
        imported by :meth:`_attach` with only the settings the caller
        names; neither the run's live session nor counted in
        ``engine.sessions``.  Yields None where the transfer is unsafe.  The phase hands a transferred tree
        back itself (:meth:`close`); an engine still held at the end (a
        borrow, or a phase that raised) is freed with no export."""
        one = cls(rt, root)
        if not one._attach(root, transfer, spr_budget, root_budget,
                           threads):
            yield None
            return
        try:
            yield one
        finally:
            if one.h is not None:
                one.lib.engine_free(one.h)
                one.h = None

    def suspend(self):
        """Hand the resident state back to rt.tree and free the engine,
        as :meth:`close` does, but keep the session for :meth:`resume`:
        a python-side pass (the device SPR screen and its serial apply)
        reads and changes the real host vectors in between."""
        self.close()
        self.rt.tracer.count("engine.suspends")

    def resume(self, root) -> bool:
        """Import the tree again into this session and make it the run's
        live one.  False where the transfer is unsafe: the scope then goes
        on one-shot, as if no session had been opened."""
        if not self._attach(root):
            return False
        self._last_root = root
        self.rt.native_session = self
        return True

    # -- scalar phases -------------------------------------------------
    def _sync(self):
        self.rt.kern.store.sync_model(self.rt.model)

    def _err(self, what):
        msg = self.lib.engine_error(self.h).decode()
        raise RuntimeError(f"native {what}: {msg}")

    def recalculate(self) -> bool:
        """Full recompute of the resident tree.  Under an error-rate model
        (never a session's) it replays the per-tip shared-list refresh
        schedule inside the engine's post-order (engine_recalculate_err);
        False, with nothing recomputed, where that schedule cannot be
        collected: its dry scan precedes any host mutation, so the caller
        recomputes the untouched tree in Python."""
        self._sync()
        rt = self.rt
        if rt.model.using_error_rate and not rt.cfg.onlyNambiguities:
            patches = rt.collect_error_patches(self.root())
            if patches is None:
                return False
            n = len(patches)
            nodes = np.asarray([p[0] for p in patches], np.int32)
            tags = np.asarray([p[1] for p in patches], np.int32)
            vals = np.asarray([p[2] for p in patches],
                              np.float64).reshape(n, 4) if n else \
                np.zeros((0, 4), np.float64)
            rc = self.lib.engine_recalculate_err(
                self.h, nodes.ctypes.data_as(C.POINTER(C.c_int32)),
                tags.ctypes.data_as(C.POINTER(C.c_int32)),
                vals.ctypes.data_as(C.POINTER(C.c_double)), n)
        else:
            rc = self.lib.engine_recalculate(self.h)
        if rc != 0:
            self._err("recalculate")
        return True

    def tree_lk(self) -> float:
        self._sync()
        out = np.zeros(1, np.float64)
        if self.lib.engine_tree_lk(
                self.h, out.ctypes.data_as(C.POINTER(C.c_double))) != 0:
            self._err("tree likelihood")
        return float(out[0])

    def blen_sweep(self, fast_pass=False) -> int:
        self._sync()
        self.rt.mark_mutated()
        updates = np.zeros(1, np.int64)
        if self.lib.engine_blen_sweep(
                self.h, 1 if fast_pass else 0,
                updates.ctypes.data_as(C.POINTER(C.c_int64))) != 0:
            self._err("blen sweep")
        return int(updates[0])

    def blen_loop(self, max_extra=20) -> int:
        self._sync()
        self.rt.mark_mutated()
        sub_rounds = np.zeros(1, np.int64)
        if self.lib.engine_blen_loop(
                self.h, max_extra,
                sub_rounds.ctypes.data_as(C.POINTER(C.c_int64))) != 0:
            self._err("blen loop")
        return int(sub_rounds[0])

    def set_all_dirty(self):
        self.lib.engine_set_all_dirty(self.h, 1)

    def em_crawl(self) -> int:
        """Run the EM branch accumulation over the resident tree
        (engine_em); the caller must em_reset the store first and read
        em_totals afterwards.  Returns num_tips."""
        self._sync()
        num_tips = self.lib.engine_em(self.h)
        if num_tips < 0:
            self._err("EM crawl")
        return int(num_tips)

    def _spr_params(self, threshold_topology_placement):
        """Sync the model and set the SPR crawl's parameters, as every SPR
        phase does first."""
        self._sync()
        rt = self.rt
        self.lib.engine_set_spr_params(
            self.h, rt.dc.thresholdLogLKoptimizationTopology,
            threshold_topology_placement, rt.cfg.defaultBLen,
            rt.cfg.maxReplacements)

    def _spr_moves(self, what, call, *args):
        """``call(h, *args, new_root, improvement, topology updates,
        branch-length updates)``, an SPR phase that applies moves; the tree
        is marked mutated where it moved (a phase that moved nothing left
        every vector as it was).  Returns (new_root_or_None, improvement,
        topology updates, branch-length updates)."""
        new_root = np.zeros(1, np.int32)
        improvement = np.zeros(1, np.float64)
        topo = np.zeros(1, np.int64)
        blen = np.zeros(1, np.int64)
        rc = call(self.h, *args,
                  new_root.ctypes.data_as(C.POINTER(C.c_int32)),
                  improvement.ctypes.data_as(C.POINTER(C.c_double)),
                  topo.ctypes.data_as(C.POINTER(C.c_long)),
                  blen.ctypes.data_as(C.POINTER(C.c_long)))
        if rc != 0:
            self._err(what)
        if topo[0] or blen[0]:
            self.rt.mark_mutated()
        nr = int(new_root[0])
        return (nr if nr >= 0 else None, float(improvement[0]),
                int(topo[0]), int(blen[0]))

    def spr_pass(self, strict_stop, allowed_fails, threshold_log_lk,
                 threshold_topology_placement):
        self._spr_params(threshold_topology_placement)
        return self._spr_moves("SPR pass", self.lib.engine_spr_pass,
                               1 if strict_stop else 0, allowed_fails,
                               threshold_log_lk)

    def spr_parallel(self, num_cores, strict_stop, allowed_fails,
                     threshold_log_lk, threshold_topology_placement):
        """Threaded search-parallel/apply-serial pass on the resident
        engine (engine_spr_pass_parallel).  None, with the tree as it was,
        in a state the threads cannot run (the error model's tag
        registry), which a live session never holds."""
        self._spr_params(threshold_topology_placement)
        self.rt.mark_mutated()
        new_root = np.zeros(1, np.int32)
        improvement = np.zeros(1, np.float64)
        topo = np.zeros(1, np.int64)
        blen = np.zeros(1, np.int64)
        searched = np.zeros(num_cores, np.int64)
        proposed = np.zeros(num_cores, np.int64)
        assigned = np.zeros(1, np.int64)
        rc = self.lib.engine_spr_pass_parallel(
            self.h, num_cores, 1 if strict_stop else 0, allowed_fails,
            threshold_log_lk, _ptr(new_root), _ptr(improvement), _ptr(topo),
            _ptr(blen), _ptr(searched), _ptr(proposed), _ptr(assigned))
        if rc == 2:
            return None
        if rc != 0:
            self._err("parallel SPR pass")
        if int(assigned[0]):
            print(f"Assigned {num_cores} cores for {int(assigned[0])} "
                  f"nodes.")
        for c in range(num_cores):
            print(f"Searched {int(searched[c])} nodes within core {c} "
                  f"and found {int(proposed[c])} proposed SPR moves")
        print("Found proposed SPR moves, merged, and sorted.")
        nr = int(new_root[0])
        return (nr if nr >= 0 else None, float(improvement[0]))

    def spr_collect(self, root, placement_thresh) -> dict:
        """The queries and anchors of a device SPR pass, from the resident
        tree (engine_spr_collect; the gates of ``parallel/batch_spr.py``
        ``_collect_queries`` and ``_collect_anchors``).  A dict of arrays,
        one value a query (``q_*``: node, vid, blen, tip, base, lo, hi,
        excl [K, 2], len) or an anchor (``a_*``: node, vid, tin, len); the
        vids are global-frame store handles, valid until
        :meth:`spr_release`."""
        self._spr_params(placement_thresh)
        n = self.lib.engine_node_count(self.h)
        i32, i64, f64 = np.int32, np.int64, np.float64
        # each dict in the order of engine_spr_collect's arguments
        q = {"node": np.empty(n, i32), "vid": np.empty(n, i64),
             "blen": np.empty(n, f64), "tip": np.empty(n, np.uint8),
             "base": np.empty(n, f64), "lo": np.empty(n, i32),
             "hi": np.empty(n, i32), "excl": np.empty((n, 2), i32),
             "len": np.empty(n, i32)}
        a = {"node": np.empty(n, i32), "vid": np.empty(n, i64),
             "tin": np.empty(n, i32), "len": np.empty(n, i32)}
        counts = np.zeros(2, i64)
        rc = self.lib.engine_spr_collect(
            self.h, root, *map(_ptr, q.values()), *map(_ptr, a.values()),
            _ptr(counts))
        if rc != 0:
            self.spr_release()
            self._err("SPR collect")
        K, N = int(counts[0]), int(counts[1])
        out = {f"q_{k}": v[:K] for k, v in q.items()}
        out.update({f"a_{k}": v[:N] for k, v in a.items()})
        return out

    def spr_release(self):
        """Free the handles :meth:`spr_collect` made."""
        self.lib.engine_spr_release(self.h)

    def spr_apply(self, nodes, strict_stop, allowed_fails, threshold_log_lk,
                  threshold_topology_placement):
        """The serial re-validated apply of a sorted proposal list on the
        resident tree (engine_spr_apply; ``search/parallel_spr.py``
        ``apply_spr_moves``): ``nodes`` in ascending order of improvement,
        applied best first.  Returns (new_root_or_None, improvement,
        topology updates, branch-length updates)."""
        self._spr_params(threshold_topology_placement)
        nodes = np.ascontiguousarray(nodes, np.int32)
        return self._spr_moves("SPR apply", self.lib.engine_spr_apply,
                               nodes.ctypes.data_as(C.POINTER(C.c_int32)),
                               len(nodes), 1 if strict_stop else 0,
                               allowed_fails, threshold_log_lk)

    def count_dirty(self):
        out = np.zeros(2, np.int64)
        self.lib.engine_count_dirty(
            self.h, out.ctypes.data_as(C.POINTER(C.c_int64)))
        return int(out[0]), int(out[1])

    def root_search(self, strict_stop, allowed_fails, threshold_log_lk,
                    threshold_consecutive, threshold_opt):
        # read-only, as the one-shot crawl that only borrows the vectors
        self._sync()
        n = self.lib.engine_node_count(self.h)
        best_node = np.zeros(1, np.int32)
        best_lk = np.zeros(1, np.float64)
        cand_nodes = np.empty(n + 1, np.int32)
        cand_scores = np.empty(n + 1, np.float64)
        cand_count = np.zeros(1, np.int64)
        rc = self.lib.engine_root_search(
            self.h, 1 if strict_stop else 0, allowed_fails,
            threshold_log_lk, threshold_consecutive, threshold_opt,
            best_node.ctypes.data_as(C.POINTER(C.c_int32)),
            best_lk.ctypes.data_as(C.POINTER(C.c_double)),
            cand_nodes.ctypes.data_as(C.POINTER(C.c_int32)),
            cand_scores.ctypes.data_as(C.POINTER(C.c_double)),
            cand_count.ctypes.data_as(C.POINTER(C.c_int64)))
        if rc != 0:
            return None
        k = int(cand_count[0])
        best_nodes = dict(zip(cand_nodes[:k].tolist(),
                              cand_scores[:k].tolist()))
        return int(best_node[0]), float(best_lk[0]), best_nodes

    # -- host-visible state ---------------------------------------------
    def root(self) -> int:
        return int(self.lib.engine_root(self.h))

    def sync_topology(self):
        """Refresh the python tree's TOPOLOGY mirror (up/children/dist)
        from the resident engine so the newick writers can run mid-session.
        Names, minor sequences, and supports are not touched by native SPR
        phases, and vector handles stay engine-owned (still stale)."""
        tree = self.rt.tree
        e_up, e_c0, e_c1, e_dist, *_ = _export_nodes(self.lib, self.h,
                                                       len(tree.up))
        tree.up = [u if u >= 0 else None for u in e_up.tolist()]
        tree.children = [[] if a < 0 else [a, b]
                         for a, b in zip(e_c0.tolist(), e_c1.tolist())]
        tree.dist = e_dist.tolist()

    def close(self, mutated=False, mat=True) -> int:
        """Export the engine's state back into rt.tree and free the
        engine; returns the final root.  A session hands everything back,
        its phases having marked their own changes; a one-shot phase passes
        ``_export_engine``'s flags for what it changed.  Idempotent: a
        scope that closed early (e.g. before a python-side re-root) is safe
        to close again in the opener's finally block."""
        if self.h is None:
            return self._last_root
        rt = self.rt
        lib, h = self.lib, self.h
        _export_engine(rt, h, mutated=mutated, mat=mat)
        sbuf = np.zeros(9, np.float64)
        lib.engine_stats(h, sbuf.ctypes.data_as(C.POINTER(C.c_double)))
        rt.num_refs += int(sbuf[6])
        root = int(lib.engine_root(h))
        lib.engine_free(h)
        self.h = None
        self._last_root = root
        rt.native_session = None
        return root


def native_session_eligible(rt) -> bool:
    """A persistent engine session may span whole phase sequences only
    when every consumer in the scope is native-routed: no python-side
    vector readers (SPRTA / estimateMAT / estimateErrors annotations,
    traces, parallel-SPR forks, error-model tip refreshes, time trees,
    debug checks).  The device SPR pass runs inside the session, or, where
    it reads the host tree, suspends the session around itself."""
    cfg = rt.cfg
    error_model_requested = bool(
        cfg.errorRateSiteSpecificFile or cfg.errorRateFixed
        or cfg.estimateErrorRate or cfg.estimateSiteSpecificErrorRate)
    return (isinstance(rt.kern, NativeBackend)
            and rt.time is None
            and not rt.model.using_error_rate
            and not error_model_requested
            and not cfg.SPRTA
            and not cfg.estimateMAT
            and not cfg.estimateErrors
            and not cfg.networkOutput
            and not cfg.debugging
            and not cfg.deeperSearchForLongBranches
            and not cfg.doNotImproveTopology
            and getattr(rt, "trace", None) is None)


def open_native_session(rt, root):
    """Open a persistent engine session if the tree state allows it
    (aliased vector handles make a transfer unsafe); returns the session
    or None.  The caller owns the eligibility decision (see
    pipeline.Run._native_session_eligible) and MUST close() before any
    python-side phase reads tree vectors again."""
    if not native_phase_supported(rt) or rt.model.using_error_rate:
        return None
    ses = NativeSession(rt, root)
    if not ses._attach(root):
        return None
    rt.tracer.count("engine.sessions")
    rt.native_session = ses
    return ses


def run_native_recalculate(rt, root) -> bool:
    """Steady-state full recompute in the C++ engine; returns False when
    unsupported (the caller recomputes in Python).  A one-shot
    recompute marks the tree mutated; a session's does not."""
    ses = rt.native_session
    if ses is not None:
        return ses.recalculate()
    if not native_phase_supported(rt):
        return False
    with NativeSession._one_shot(rt, root, threads=True) as one:
        if one is None:
            return False
        done = one.recalculate()
        one.close(mutated=True, mat=False)
        return done


def run_native_tree_lk(rt, root):
    """Full-tree log-likelihood in the C++ engine (read-only borrow of
    the session vectors); returns None when unsupported."""
    ses = rt.native_session
    if ses is not None:
        return ses.tree_lk()
    if not native_phase_supported(rt):
        return None
    with NativeSession._one_shot(rt, root, transfer=False) as one:
        if one is None:
            return None
        try:
            return one.tree_lk()
        except RuntimeError:  # the python crawl takes over
            return None


def run_native_blen_sweep(rt, root, fast_pass=False):
    """Dirty-gated branch-length sweep in the C++ engine; returns the
    update count, or None when unsupported (python fallback)."""
    ses = rt.native_session
    if ses is not None:
        return ses.blen_sweep(fast_pass=fast_pass)
    if not native_phase_supported(rt):
        return None
    with NativeSession._one_shot(rt, root) as one:
        if one is None:
            return None
        updates = one.blen_sweep(fast_pass=fast_pass)
        one.close(mat=False)  # the sweep marked the tree mutated
        return updates


def run_native_root_search(rt, root, strict_stop, allowed_fails,
                           threshold_log_lk, threshold_consecutive,
                           threshold_opt):
    """Root-position crawl in the C++ engine (reference findBestRoot
    :7730-7902; read-only borrow of the session vectors).  Returns
    (best_node, best_lk_diff, best_nodes ordered dict) or None when
    unsupported (caller runs the Python crawl).  Re-rooting, candidate
    remapping, and abayes normalization stay on the host driver."""
    ses = rt.native_session
    if ses is not None:
        return ses.root_search(strict_stop, allowed_fails, threshold_log_lk,
                               threshold_consecutive, threshold_opt)
    if not native_phase_supported(rt):
        return None
    with NativeSession._one_shot(rt, root, transfer=False,
                                 root_budget=True) as one:
        if one is None:
            return None
        return one.root_search(strict_stop, allowed_fails, threshold_log_lk,
                               threshold_consecutive, threshold_opt)


def run_native_blen_loop(rt, root, max_extra=20):
    """The SPR-round branch-length finalization loop (sweep, then repeat
    while the previous sweep updated something, up to ``max_extra`` extra
    sweeps) in one engine — one import/export cycle instead of one per
    sweep.  Returns the python loop's sub_round counter, or None when
    unsupported."""
    ses = rt.native_session
    if ses is not None:
        return ses.blen_loop(max_extra)
    if not native_phase_supported(rt):
        return None
    with NativeSession._one_shot(rt, root) as one:
        if one is None:
            return None
        sub_rounds = one.blen_loop(max_extra)
        one.close(mat=False)  # the loop marked the tree mutated
        return sub_rounds
