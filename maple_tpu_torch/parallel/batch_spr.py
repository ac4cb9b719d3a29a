"""Device-screened SPR proposals on a torch device (``--deviceTopology``).

The torch twin of the single-device half of
:mod:`maple_tpu.parallel.batch_spr`.  Every eligible dirty node's pruned
subtree is screened against every anchor on the device; a node whose best
re-attachment beats its current one is proposed, and the proposals go
through the same serial re-validated apply as the host paths
(``apply_spr_moves``), so the screen's precision affects recall only.
Two screens, chosen as in the JAX package:

- the proxy screen (native kernels, the default): hashed mutation
  features, one ``[K, D] x [D, cap]`` float32 product per chunk of 256
  queries, on-device masks of each query's own subtree, parent and
  sibling, top-128 per query; the native engine then re-scores those
  anchors exactly in float64 (``store.append_grid``);
- the exhaustive screen (``MAPLE_SPR_EXACT=1`` or python kernels): the
  appendProbNode pair kernel (``csrc/append_pairs.cu``) of each chunk of 64
  queries against the whole anchor pool, the same masks, top-1 per query.

All chunks are queued before any result is read.  Only the top-M (score,
row) pairs of a chunk come back, into pinned host buffers behind a CUDA
event: nothing synchronises the whole stream.  The host helpers
(``_euler_intervals``, ``_current_attachment_lk``, ``_collect_queries``,
``_collect_anchors``) are copies of the JAX package's.

Each pass appends a :class:`ScreenPass` to the module's ``stats``.

Reference crawl being replaced: findBestParentTopology
MAPLEv0.7.5.4.py:6817-7724 with stop rules :8080-8088.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models.hnz import get_hnz
from ..ops import pack as OP
from ..ops.append_pairs import append_scores_prestacked
from ..ops.layout import stack_fields_host
from ..runtime.tree import set_all_dirty
from ..search.parallel_spr import apply_spr_moves
from ..search.spr import SprCounters
from .proxy_features import (BF16_CAP, BF16_TOPM, D, D_HASH, FMAX_ANCHOR,
                             FMAX_QUERY, G_BUCKETS, proxy_scores,
                             scatter_only)
from .stacked_pool import StackedDevicePool, to_host, upload

EXACT_CHUNK = 64          # queries per pair-kernel launch
PROXY_CHUNK = 256         # queries per proxy product
PROXY_TOPM = 128          # anchors per query re-scored exactly
SCATTER_ROWS = 8192       # anchor rows densified per scatter: the float32
                          # [rows, D] temporary stays at 256 MiB
_NO_TIN = np.iinfo(np.int32).max   # Euler entry of a row with no anchor


def _euler_intervals(tree, root: int):
    """Pre-order entry/exit counters: a is inside subtree(q) iff
    tin[q] <= tin[a] < tout[q]."""
    n = len(tree.up)
    tin = np.zeros(n, dtype=np.int64)
    tout = np.zeros(n, dtype=np.int64)
    t = 0
    stack = [(root, False)]
    while stack:
        node, done = stack.pop()
        if done:
            tout[node] = t
            continue
        tin[node] = t
        t += 1
        stack.append((node, True))
        for c in tree.children[node] or ():
            stack.append((c, False))
    return tin, tout


def _current_attachment_lk(rt, node: int):
    """The node's current re-attachment score (the serial crawl's
    best_current_lk, parallel_spr._propose_moves :99-120, incl. the HnZ
    prior correction)."""
    tree = rt.tree
    cfg = rt.cfg
    dist = tree.dist
    up = tree.up
    eff0 = rt.dc.effectivelyNon0BLen
    parent = up[node]
    child = tree.child_index(node)
    vect_up = tree.probVectUpRight[parent] if child == 0 \
        else tree.probVectUpLeft[parent]
    if tree.mutations[node]:
        vect_up = rt.pass_down(vect_up, node)
    lk = rt.kern.append_prob_node(vect_up, tree.probVect[node],
                                  tree.is_tip(node), dist[node])
    if tree.use_hnz:
        pn0 = up[node]
        while dist[pn0] <= eff0 and up[pn0] is not None:
            pn0 = up[pn0]
        if dist[node] > eff0:
            lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                - get_hnz(cfg.HnZ, tree.nDesc0[pn0] - 1)
        else:
            lk += get_hnz(cfg.HnZ, tree.nDesc0[pn0]) \
                - (get_hnz(cfg.HnZ, tree.nDesc0[pn0] - tree.nDesc0[node])
                   + get_hnz(cfg.HnZ, tree.nDesc0[node]))
    return lk


def _collect_queries(rt, root: int, placement_thresh,
                     keep_handles: bool = False):
    """Eligible pruned-subtree queries with the serial crawl's own gates
    (dirty flag, maxReplacements, the current-attachment threshold), each
    exported as its global-frame lower vector plus (blen, tip, base
    score).  With ``keep_handles`` the raw global-frame vector handles
    are returned instead of exported tuples (the proxy screen's feature
    export and exact re-score both run store-side)."""
    tree = rt.tree
    cfg = rt.cfg
    q_nodes, q_vecs, q_blens, q_tips, q_base = [], [], [], [], []
    stack = [root]
    while stack:
        n = stack.pop()
        for c in tree.children[n] or ():
            stack.append(c)
        if tree.up[n] is None or not tree.dirty[n] \
                or tree.replacements[n] > cfg.maxReplacements:
            continue
        base = _current_attachment_lk(rt, n)
        if not (base < placement_thresh or tree.dist[n] or tree.use_hnz) \
                or cfg.doNotImproveTopology:
            continue
        # pruned-subtree lower vector in the global frame (one pass
        # through the composed frame list)
        v = rt.global_frame_up(tree.probVect[n], n)
        q_nodes.append(n)
        q_vecs.append(v if keep_handles else rt.kern.export(v))
        q_blens.append(tree.dist[n])
        q_tips.append(tree.is_tip(n))
        q_base.append(base)
    return q_nodes, q_vecs, q_blens, q_tips, q_base


def _collect_anchors(rt, root: int):
    """Screen-eligible anchors (same criteria as the placement pool:
    attached, non-zero branch, cached mid-branch vector) with their
    global-frame totUp handles (MAT chains composed out, reference
    :3749).

    NOTE: the eligibility rule + MAT-chain walk has a packed-row twin
    (stacked_pool.StackedRows.all_anchors) — an eligibility change must
    land in both or the screens diverge from their pools."""
    tree = rt.tree
    eff0 = rt.dc.effectivelyNon0BLen
    anchors, handles = [], []
    for n in range(len(tree.up)):
        if tree.up[n] is None or tree.children[n] is None:
            continue
        if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
            anchors.append(n)
            handles.append(rt.global_frame_up(tree.probVectTotUp[n], n))
    return anchors, handles


@dataclass
class ScreenPass:
    """Counts and seconds of one screen pass.

    ``collect_s``: host, eligible queries and anchors (for the exhaustive
    screen, the pool rebuild with its exports and upload).  ``pack_s``:
    host, feature exports, query packing, uploads and queueing the chunks.
    ``device_s``: device, CUDA events around each queued unit of work
    (0.0 off CUDA); a unit's span also holds the device's waits for the
    host's enqueues inside it.  ``decide_s``: host, waiting for the results and
    testing each query (for the proxy screen, with the native re-score).
    ``apply_s``: host, the serial re-validated apply.  Per query:
    ``q_nodes``, the screened best score ``q_best`` (-inf if none) and the
    current attachment score ``q_base``."""
    branch: str
    queries: int = 0
    anchors: int = 0
    chunks: int = 0
    proposals: int = 0
    kernel_launches: int = 0
    collect_s: float = 0.0
    pack_s: float = 0.0
    device_s: float = 0.0
    decide_s: float = 0.0
    apply_s: float = 0.0
    q_nodes: np.ndarray = field(default_factory=lambda: np.zeros(0, int))
    q_best: np.ndarray = field(default_factory=lambda: np.zeros(0))
    q_base: np.ndarray = field(default_factory=lambda: np.zeros(0))


@dataclass
class ScreenStats:
    """The passes screened since the last ``reset``."""
    passes: List[ScreenPass] = field(default_factory=list)

    def reset(self):
        self.passes.clear()


stats = ScreenStats()


class _Events:
    """CUDA events around each queued unit of device work; no-ops off
    CUDA."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.pairs = []

    def begin(self):
        if not self.on:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end(self, start):
        if not self.on:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.append((start, ev))
        return ev

    def seconds(self) -> float:
        for _, done in self.pairs:
            done.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def _mask_trivial_targets(scores, valid, a_tin, q_lo, q_hi, excl):
    """-inf, in place, on rows no SPR move may take: invalid rows, anchors
    inside the query's own subtree (Euler-interval containment), and the
    query's parent and sibling rows."""
    at = a_tin[None, :]
    inval = (at >= q_lo[:, None]) & (at < q_hi[:, None])
    iota = torch.arange(scores.shape[1], device=scores.device)[None, :]
    inval |= (iota == excl[:, 0:1]) | (iota == excl[:, 1:2])
    scores.masked_fill_(inval | ~valid[None, :], float("-inf"))


def spr_screen_step(AF, valid, a_tin, q_fidx, q_fw, q_lo, q_hi, excl, *,
                    topm: int):
    """Proxy screen of one query chunk: densify the query features, one
    product with the anchor features, mask, top-M.  Twin of
    ``_get_spr_screen_step().step`` (maple_tpu/parallel/batch_spr.py:195-212).

    AF [cap, D] float32 or bfloat16, valid [cap] bool, a_tin [cap] int32,
    q_fidx [K, F] int, q_fw [K, F] float32, q_lo/q_hi [K] int32, excl
    [K, 2] int32.  Returns float32 (scores [K, M], rows [K, M]).  The
    products are full float32 (as ``preferred_element_type=f32``): a bf16
    pool is upcast block by block, never multiplied in bf16."""
    scores = proxy_scores(AF, q_fidx, q_fw)
    _mask_trivial_targets(scores, valid, a_tin, q_lo, q_hi, excl)
    return torch.topk(scores, min(topm, AF.shape[0]), dim=1)


def screen_chunk(pool, valid, a_tin, Cflat, prm, q_lo, q_hi, excl, mm, rf,
                 *, n_prefix: int, uer: bool):
    """Exhaustive screen of one query chunk: pair-kernel scores against the
    pool prefix, masks, top-1.  Twin of ``_screen_chunk_impl``
    (maple_tpu/parallel/batch_spr.py:128-146).

    pool [cap, F, B1], valid [cap] bool, a_tin [cap] int32, Cflat
    [K, 1, B2 * F], prm [K, 1, 4], q_lo/q_hi [K] int32, excl [K, 2] int32,
    mm [1, 1, 16], rf [1, 1, 4].  Returns (scores [K, 1], rows [K, 1])."""
    scores = append_scores_prestacked(pool[:n_prefix], Cflat, prm, mm, rf,
                                      uer=uer)
    _mask_trivial_targets(scores, valid[:n_prefix], a_tin[:n_prefix], q_lo,
                          q_hi, excl)
    return torch.topk(scores, 1, dim=1)


def _exclusions(tree, nodes, row_of) -> np.ndarray:
    """[len(nodes), 2] int32: the pool rows of each node's parent and
    sibling (-1 where not in the pool), the trivial SPR targets."""
    excl = np.full((len(nodes), 2), -1, dtype=np.int32)
    for j, node in enumerate(nodes):
        parent = tree.up[node]
        sibling = tree.children[parent][1 - tree.child_index(node)]
        excl[j, 0] = row_of.get(parent, -1)
        excl[j, 1] = row_of.get(sibling, -1)
    return excl


def _accept(proposals, node, anchor, best, base, placement_thresh):
    """The serial acceptance test's form; re-validated exactly by the
    serial apply."""
    improvement = best - base
    if best + placement_thresh > base and improvement > 0.0:
        proposals.append((node, anchor, improvement))


def _apply(rt, root, proposals, params, counters, st: ScreenPass, t0,
           what: str):
    proposals.sort(key=lambda p: p[2])
    st.proposals = len(proposals)
    print(f"Device SPR screen: {st.queries} queries x {st.anchors} anchors "
          f"{what}-> {len(proposals)} proposals in {time.time() - t0:.2f}s",
          flush=True)
    set_all_dirty(rt.tree, root, dirtiness=False)
    t = time.time()
    out = apply_spr_moves(rt, proposals, params, counters)
    st.apply_s = time.time() - t
    return out


def _screen_single_device(rt, root: int, params, counters, t0, *,
                          device: torch.device, chunk: int = PROXY_CHUNK,
                          topm: int = PROXY_TOPM):
    """Proxy single-device SPR screen (module docstring); the exhaustive
    screen with python kernels or ``MAPLE_SPR_EXACT``.  Twin of
    maple_tpu/parallel/batch_spr.py:218-355."""
    if rt.kern.name != "native" or os.environ.get("MAPLE_SPR_EXACT"):
        return _screen_single_device_exact(rt, root, params, counters, t0,
                                           device=device)
    tree = rt.tree
    strict, fails, threshold, placement_thresh = params
    st = ScreenPass("proxy")
    t = time.time()
    q_nodes, q_handles, q_blens, q_tips, q_base = _collect_queries(
        rt, root, placement_thresh, keep_handles=True)
    if not q_nodes:
        return None, 0.0
    anchors, a_handles = _collect_anchors(rt, root)
    if not anchors:
        return None, 0.0
    st.collect_s = time.time() - t
    stats.passes.append(st)
    t = time.time()
    store = rt.kern.store
    a_vids = np.asarray([h.vid for h in a_handles], np.int64)
    fmax_a = FMAX_ANCHOR
    while True:  # budgets grow on saturation (truncation is silent)
        aidx, aw, cnt = store.export_feats(a_vids, False, D_HASH,
                                           G_BUCKETS, fmax_a)
        if cnt.max(initial=0) < fmax_a:
            break
        fmax_a *= 2
    q_vids = np.asarray([h.vid for h in q_handles], np.int64)
    fmax_q = FMAX_QUERY
    while True:
        qidx, qw, cnt = store.export_feats(q_vids, True, D_HASH,
                                           G_BUCKETS, fmax_q)
        if cnt.max(initial=0) < fmax_q:
            break
        fmax_q *= 2

    N = len(anchors)
    K_total = len(q_nodes)
    st.queries, st.anchors = K_total, N
    cap = 1024
    while cap < N:
        cap *= 2
    # bf16 features at 512k+ rows (as the JAX package, for the halved
    # footprint); the exact top-M re-score absorbs the rounding, and topm
    # deepens to keep recall
    dtype = torch.float32
    if cap >= BF16_CAP:
        dtype = torch.bfloat16
        topm = max(topm, BF16_TOPM)
    events = _Events(device)
    start = events.begin()
    AF = torch.zeros((cap, D), dtype=dtype, device=device)
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    for s0 in range(0, N, SCATTER_ROWS):
        rows = np.arange(s0, min(N, s0 + SCATTER_ROWS), dtype=np.int64)
        scatter_only(AF, valid, upload(rows, device),
                     upload(aidx[rows], device), upload(aw[rows], device),
                     upload(np.ones(len(rows), dtype=bool), device))
    tin, tout = _euler_intervals(tree, root)
    a_tin = np.full(cap, _NO_TIN, dtype=np.int32)
    a_tin[:N] = tin[np.asarray(anchors)]
    dev_a_tin = upload(a_tin, device)
    events.end(start)
    row_of = {node: i for i, node in enumerate(anchors)}
    nodes_arr = np.asarray(q_nodes)

    pending = []
    for s in range(0, K_total, chunk):
        e = min(K_total, s + chunk)
        nodes = nodes_arr[s:e]
        excl = _exclusions(tree, nodes, row_of)
        start = events.begin()
        ts, ti = spr_screen_step(
            AF, valid, dev_a_tin, upload(qidx[s:e], device),
            upload(qw[s:e], device),
            upload(tin[nodes].astype(np.int32), device),
            upload(tout[nodes].astype(np.int32), device),
            upload(excl, device), topm=topm)
        ts, ti = to_host(ts, ti)
        pending.append((s, e, ts, ti, events.end(start)))
    st.chunks = len(pending)
    st.pack_s = time.time() - t

    # exact re-score of each query's top-M (native appendProbNode, f64)
    t = time.time()
    proposals = []
    n_threads = max(1, rt.cfg.numCores)
    blens_arr = np.asarray(q_blens, np.float64)
    tips_arr = np.asarray(q_tips, np.uint8)
    st.q_nodes = nodes_arr
    st.q_best = np.full(K_total, -np.inf)
    st.q_base = np.asarray(q_base, np.float64)
    n_exact = 0
    for s, e, ts, ti, done in pending:
        if done is not None:
            done.synchronize()
        ts = ts.numpy()
        ti = ti.numpy()
        vP = np.where((ti < N) & np.isfinite(ts),
                      a_vids[np.minimum(ti, N - 1)], -1)
        exact = store.append_grid(vP, q_vids[s:e], blens_arr[s:e],
                                  tips_arr[s:e], n_threads)
        n_exact += vP.size
        for k in range(e - s):
            j = int(np.argmax(exact[k]))
            best = float(exact[k, j])
            st.q_best[s + k] = best
            if np.isfinite(best):
                _accept(proposals, q_nodes[s + k], int(anchors[int(ti[k, j])]),
                        best, q_base[s + k], placement_thresh)
    st.device_s = events.seconds()
    st.decide_s = time.time() - t
    return _apply(rt, root, proposals, params, counters, st, t0,
                  f"(proxy; {n_exact} exact re-scores) ")


def _screen_single_device_exact(rt, root: int, params, counters, t0, *,
                                device: torch.device,
                                chunk: int = EXACT_CHUNK):
    """Exhaustive single-device SPR screen: the pair kernel over every
    (query, anchor) pair, masks and top-1 per chunk (module docstring).
    Twin of maple_tpu/parallel/batch_spr.py:358-468.

    Exhaustive over anchors, a superset of the reference crawl's stop-rule
    neighbourhood, but about 120x the exact scoring work of the proxy
    screen."""
    tree = rt.tree
    strict, fails, threshold, placement_thresh = params
    st = ScreenPass("exact")
    launches0 = append_scores_prestacked.launches
    t = time.time()
    q_nodes, q_vecs, q_blens, q_tips, q_base = _collect_queries(
        rt, root, placement_thresh)
    if not q_nodes:
        return None, 0.0
    pool = StackedDevicePool(rt, device)
    pool.full_rebuild()
    n_anchors = len(pool.row_of)
    if n_anchors == 0:
        return None, 0.0
    st.collect_s = time.time() - t
    stats.passes.append(st)
    K_total = len(q_nodes)
    st.queries, st.anchors = K_total, n_anchors

    t = time.time()
    n_prefix = pool.n_prefix
    tin, tout = _euler_intervals(tree, root)
    a_tin = np.full(pool.capacity, _NO_TIN, dtype=np.int32)
    a_tin[:n_anchors] = tin[pool.node_arr[:n_anchors]]
    dev_a_tin = upload(a_tin, device)
    mm = upload(np.asarray(rt.model.mut_matrix,
                            dtype=np.float32).reshape(1, 1, 16), device)
    rf = upload(np.asarray(rt.model.refd.root_freqs,
                            dtype=np.float32).reshape(1, 1, 4), device)
    uer = rt.model.using_error_rate
    gtr = float(rt.dc.globalTotRate)
    tot_error = float(rt.model.tot_error or 0.0)
    q_budget = OP.budget_for(q_vecs, 64)
    nodes_arr = np.asarray(q_nodes)
    events = _Events(device)
    pending = []
    for s in range(0, K_total, chunk):
        e = min(K_total, s + chunk)
        n_sub = e - s
        nodes = nodes_arr[s:e]
        packed = OP.pack_genome_lists(q_vecs[s:e], rt.refd.lRef, q_budget,
                                      uer, dtype=np.float32)
        Cflat = stack_fields_host(packed, pool.site_rates, pool.error_rates,
                                  axis=-1).reshape(n_sub, 1, -1)
        prm = np.stack([
            np.asarray(q_blens[s:e], dtype=np.float32),
            np.asarray(q_tips[s:e], dtype=np.float32),
            np.full(n_sub, gtr, dtype=np.float32),
            np.full(n_sub, tot_error, dtype=np.float32),
        ], axis=-1).reshape(n_sub, 1, 4)
        excl = _exclusions(tree, nodes, pool.row_of)
        start = events.begin()
        ts, ti = screen_chunk(
            pool.dev_pool, pool.dev_valid, dev_a_tin, upload(Cflat, device),
            upload(prm, device),
            upload(tin[nodes].astype(np.int32), device),
            upload(tout[nodes].astype(np.int32), device),
            upload(excl, device), mm, rf, n_prefix=n_prefix, uer=uer)
        ts, ti = to_host(ts, ti)
        pending.append((s, e, ts, ti, events.end(start)))
    st.chunks = len(pending)
    st.kernel_launches = append_scores_prestacked.launches - launches0
    st.pack_s = time.time() - t

    t = time.time()
    proposals = []
    node_arr = pool.node_arr
    st.q_nodes = nodes_arr
    st.q_best = np.full(K_total, -np.inf)
    st.q_base = np.asarray(q_base, np.float64)
    for s, e, ts, ti, done in pending:
        if done is not None:
            done.synchronize()
        ts = ts.numpy()
        ti = ti.numpy()
        for k in range(e - s):
            best = float(ts[k, 0])
            st.q_best[s + k] = best
            if np.isfinite(best):
                # screened in float32
                _accept(proposals, q_nodes[s + k], int(node_arr[ti[k, 0]]),
                        best, q_base[s + k], placement_thresh)
    st.device_s = events.seconds()
    st.decide_s = time.time() - t
    return _apply(rt, root, proposals, params, counters, st, t0, "")


def device_topology_update(rt, root: int, params,
                           counters: Optional[SprCounters] = None, *,
                           device: torch.device, mesh=None):
    """One device-screened search / serial-apply SPR pass on ``device``.
    Returns (new_root_or_None, cumulative_improvement) like the host
    parallel paths.  Twin of maple_tpu/parallel/batch_spr.py:471-507 for
    a single device.

    SPRTA and network annotation need the crawl's per-candidate
    posteriors and stay on the host paths (the rounds loop gates
    them)."""
    if mesh is not None:
        raise NotImplementedError(
            "maple_tpu_torch: the mesh SPR screen is not ported yet; "
            "ROADMAP.md Queue 1 item 6 ports it")
    if counters is None:
        counters = SprCounters()
    return _screen_single_device(rt, root, params, counters, time.time(),
                                 device=torch.device(device))
