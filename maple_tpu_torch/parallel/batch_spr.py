"""Device-screened SPR proposals on a torch device (``--deviceTopology``).

The torch twin of :mod:`maple_tpu.parallel.batch_spr`.  Every eligible
dirty node's pruned subtree is screened against every anchor on the
device; a node whose best re-attachment beats its current one is proposed,
and the proposals go
through the same serial re-validated apply as the host paths
(``apply_spr_moves``), so the screen's precision affects recall only.
Two single-device screens, chosen as in the JAX package:

- the proxy screen (native kernels, the default): hashed mutation
  features, one ``[K, D] x [D, cap]`` float32 product per chunk of 256
  queries, on-device masks of each query's own subtree, parent and
  sibling, top-128 per query; those anchors are then re-scored exactly in
  float64;
- the exhaustive screen (``MAPLE_SPR_EXACT=1`` or python kernels): the
  appendProbNode pair kernel (``csrc/append_pairs.cu``) of each chunk of 64
  queries against the whole anchor pool, the same masks, top-1 per query.

Where the proxy screen runs inside a live engine session (``native/engine.py``
``NativeSession``) on a model without error rates or site rates, the pass
stays in the engine (``_screen_session``): one native call collects the
queries and anchors from the resident tree, with their features' handles,
Euler intervals and exclusions; the store packs their lists in the pair
kernel's stacked layout; the device screens them and re-scores each
query's top-128 with the pair kernel's gathered entry in float64
(``spr_rescore``), so that only each query's best score and row come back;
and one native call applies the proposals on the resident tree.  Elsewhere
(no session, error models, site rates) the host collects the pass from
``rt.tree``, the native engine re-scores the top-128 on the host
(``store.append_grid``) and the copied ``apply_spr_moves`` applies it, a
live session suspended around it.

Over a mesh of ranks (``mesh=``, :mod:`maple_tpu_torch.parallel.mesh`) the
screen is exhaustive on the interval-algebra scorer: the pool sharded over
``cand``, query chunks over ``dp``, the score matrix gathered to every rank
and masked on the host (``_screen_mesh``).

All chunks are queued before any result is read.  Only the top-M (score,
row) pairs of a chunk come back, into pinned host buffers behind a CUDA
event: nothing synchronises the whole stream.  The host helpers
(``_euler_intervals``, ``_current_attachment_lk``, ``_collect_queries``,
``_collect_anchors``) are copies of the JAX package's.

Each pass appends a :class:`ScreenPass` to the module's ``stats``, and
records into the tree runtime's tracer (``runtime/phases.py``) the span
``spr.pass`` with its children ``spr.collect``, ``spr.pack``,
``spr.decide`` and ``spr.apply`` (the ``ScreenPass`` seconds of the same
names are theirs), and the counters ``spr.queries``, ``spr.proposals``
and ``spr.applied`` (moves the serial apply made).  The proxy screen counts
the pairs it re-scores exactly, ``spr.rescored_device`` in the session and
``spr.rescored_host`` outside it, and the passes made in the session,
``spr.native_passes``.  A pass that suspends a live session also holds
``engine.suspend`` and ``engine.resume`` (:func:`device_topology_update`).

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
from ..ops import _build
from ..ops import pack as OP
from ..ops.append_pairs import (append_scores_gathered,
                                append_scores_prestacked)
from ..ops.layout import NFIELDS, stack_fields_host
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
    pool is upcast block by block, never multiplied in bf16.

    On CUDA the first call of a process also builds and loads the pair
    kernel's library, whose gathered entry re-scores the screened rows
    (``spr_rescore``): set-up warms the pass with a call of this function,
    so no pass pays the build.  Nothing of it is launched here."""
    if AF.device.type == "cuda":
        _build.library()
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
           what: str, ses=None):
    """The serial re-validated apply of a pass's proposals, best
    improvement first: the copied host ``apply_spr_moves`` on ``rt.tree``,
    or in the live engine session ``ses`` (``NativeSession.spr_apply``,
    the same moves on the resident tree)."""
    proposals.sort(key=lambda p: p[2])
    st.proposals = len(proposals)
    print(f"Device SPR screen: {st.queries} queries x {st.anchors} anchors "
          f"{what}-> {len(proposals)} proposals in {time.time() - t0:.2f}s",
          flush=True)
    if ses is None:
        set_all_dirty(rt.tree, root, dirtiness=False)
    applied = counters.topology_updates
    with rt.tracer.span("spr.apply") as sp:
        if ses is None:
            out = apply_spr_moves(rt, proposals, params, counters)
        else:
            new_root, improvement, topo, blen = ses.spr_apply(
                [p[0] for p in proposals], *params)
            counters.topology_updates += topo
            counters.blen_updates += blen
            out = new_root, improvement
    st.apply_s = sp.seconds
    rt.tracer.count("spr.queries", st.queries)
    rt.tracer.count("spr.proposals", st.proposals)
    rt.tracer.count("spr.applied", counters.topology_updates - applied)
    return out


def _export_feats(store, vids, query_side: bool, fmax: int):
    """Hashed features of store handles (global frame); the budget doubles
    until no row fills it (truncation is silent)."""
    while True:
        idx, w, cnt = store.export_feats(vids, query_side, D_HASH, G_BUCKETS,
                                         fmax)
        if cnt.max(initial=0) < fmax:
            return idx, w
        fmax *= 2


def _queue_screen(st: ScreenPass, store, device, a_vids, q_vids, a_tin, q_lo,
                  q_hi, excl, *, chunk: int, topm: int, rescore=None):
    """Queue the proxy screen of a pass on ``device``: the anchors'
    features into the anchor matrix, then one ``spr_screen_step`` a chunk
    of queries.  Nothing is read: returns the ``_Events`` and, a chunk,
    (s, e, host copy of its top-M scores, of their rows, its end event).
    With ``rescore(ts, ti)``, a function that queues more work on the
    pass's top-M (all chunks') and returns two tensors, one entry (0, K,
    host copies of rescore's tensors, end event) instead.

    ``a_tin`` [N] is each anchor's Euler entry, ``q_lo`` / ``q_hi`` [K] each
    query's Euler interval and ``excl`` [K, 2] its parent's and sibling's
    anchor rows (-1 where none)."""
    aidx, aw = _export_feats(store, a_vids, False, FMAX_ANCHOR)
    qidx, qw = _export_feats(store, q_vids, True, FMAX_QUERY)
    N = len(a_vids)
    K_total = len(q_vids)
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
    a_tin_cap = np.full(cap, _NO_TIN, dtype=np.int32)
    a_tin_cap[:N] = a_tin
    dev_a_tin = upload(a_tin_cap, device)
    events.end(start)

    pending = []
    for s in range(0, K_total, chunk):
        e = min(K_total, s + chunk)
        start = events.begin()
        ts, ti = spr_screen_step(
            AF, valid, dev_a_tin, upload(qidx[s:e], device),
            upload(qw[s:e], device),
            upload(np.asarray(q_lo[s:e], np.int32), device),
            upload(np.asarray(q_hi[s:e], np.int32), device),
            upload(np.asarray(excl[s:e], np.int32), device), topm=topm)
        if rescore is None:
            ts, ti = to_host(ts, ti)
        pending.append((s, e, ts, ti, events.end(start)))
    st.chunks = len(pending)
    if rescore is not None and pending:
        start = events.begin()
        a, b = rescore(torch.cat([p[2] for p in pending]),
                       torch.cat([p[3] for p in pending]))
        a, b = to_host(a, b)
        pending = [(0, K_total, a, b, events.end(start))]
    return events, pending


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
    with rt.tracer.span("spr.collect") as sp:
        q_nodes, q_handles, q_blens, q_tips, q_base = _collect_queries(
            rt, root, placement_thresh, keep_handles=True)
        if not q_nodes:
            return None, 0.0
        anchors, a_handles = _collect_anchors(rt, root)
        if not anchors:
            return None, 0.0
    st.collect_s = sp.seconds
    stats.passes.append(st)
    with rt.tracer.span("spr.pack") as sp:
        store = rt.kern.store
        a_vids = np.asarray([h.vid for h in a_handles], np.int64)
        q_vids = np.asarray([h.vid for h in q_handles], np.int64)
        N = len(anchors)
        K_total = len(q_nodes)
        st.queries, st.anchors = K_total, N
        tin, tout = _euler_intervals(tree, root)
        nodes_arr = np.asarray(q_nodes)
        row_of = {node: i for i, node in enumerate(anchors)}
        events, pending = _queue_screen(
            st, store, device, a_vids, q_vids, tin[np.asarray(anchors)],
            tin[nodes_arr], tout[nodes_arr],
            _exclusions(tree, nodes_arr, row_of), chunk=chunk, topm=topm)
    st.pack_s = sp.seconds

    # exact re-score of each query's top-M (native appendProbNode, f64)
    with rt.tracer.span("spr.decide") as sp:
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
                    _accept(proposals, q_nodes[s + k],
                            int(anchors[int(ti[k, j])]), best, q_base[s + k],
                            placement_thresh)
        st.device_s = events.seconds()
    st.decide_s = sp.seconds
    rt.tracer.count("spr.rescored_host", n_exact)
    return _apply(rt, root, proposals, params, counters, st, t0,
                  f"(proxy; {n_exact} exact re-scores) ")


def _stacked(store, vids, lens, query_side: bool, device: torch.device):
    """The lists of ``vids`` in the pair kernel's stacked layout, float64,
    on ``device`` (a budget of the longest list): packed by the store
    straight into pinned memory on CUDA."""
    B = max(1, int(np.max(lens, initial=1)))
    n = len(vids)
    if device.type == "cuda":
        buf = torch.empty(n * NFIELDS * B, dtype=torch.float64,
                          pin_memory=True)
        store.pack_stacked(vids, B, query_side, out=buf.numpy())
        out = buf.to(device, non_blocking=True)
    else:
        out = torch.from_numpy(store.pack_stacked(vids, B, query_side))
    return out.reshape((n, B, NFIELDS) if query_side else (n, NFIELDS, B))


def spr_rescore(P, Cflat, prm, mm, rf, ts, ti, n_anchors: int):
    """The exact re-score of a pass's screened rows on the device: each
    query against its top-M rows of ``spr_screen_step`` by the pair kernel's
    gathered entry, in float64, and the first best of each query.

    P [N, F, B1] the anchors' stacked lists, Cflat [k, 1, B2 * F] the
    queries, prm [k, 1, 4] (blen, tip, globalTotRate, 0), mm [1, 1, 16],
    rf [1, 1, 4], all float64 on one device; ts / ti [k, M] the screen's
    scores and rows.  A row that is padding (>= ``n_anchors``) or
    masked (score -inf) scores -inf.  Returns (best [k] float64, row [k]
    int64)."""
    rows = torch.where((ti < n_anchors) & torch.isfinite(ts), ti,
                       torch.full_like(ti, -1))
    exact = append_scores_gathered(P, Cflat, prm, mm, rf, rows, uer=False)
    j = exact.argmax(1, keepdim=True)
    return exact.gather(1, j).squeeze(1), ti.gather(1, j).squeeze(1)


def _proposals(q_nodes, a_nodes, best, row, base, placement_thresh):
    """``_accept``'s test over a pass's queries at once: (node, anchor,
    improvement) of each query, in query order, whose best re-attachment
    ``best`` (at anchor row ``row``) beats its current one ``base``."""
    improvement = best - base
    ok = np.isfinite(best) & (best + placement_thresh > base) \
        & (improvement > 0.0)
    return [(int(q_nodes[k]), int(a_nodes[row[k]]), float(improvement[k]))
            for k in np.flatnonzero(ok)]


def _screen_session(rt, ses, root: int, params, counters, t0, *,
                    device: torch.device, chunk: int = PROXY_CHUNK,
                    topm: int = PROXY_TOPM):
    """The proxy screen inside a live engine session ``ses``: the resident
    tree gives the pass's queries and anchors (``NativeSession
    .spr_collect``), the device screens them and re-scores each query's
    top-M exactly in float64 (``spr_rescore``), and the engine applies the
    proposals (``NativeSession.spr_apply``).  Only each query's best score
    and row come back to the host; the decision rule is the host path's."""
    strict, fails, threshold, placement_thresh = params
    st = ScreenPass("proxy")
    store = rt.kern.store
    try:
        with rt.tracer.span("spr.collect") as sp:
            c = ses.spr_collect(root, placement_thresh)
        st.collect_s = sp.seconds
        K_total, N = len(c["q_node"]), len(c["a_node"])
        if not K_total or not N:
            return None, 0.0
        stats.passes.append(st)
        st.queries, st.anchors = K_total, N
        with rt.tracer.span("spr.pack") as sp:
            P = _stacked(store, c["a_vid"], c["a_len"], False, device)
            mm = upload(np.asarray(rt.model.mut_matrix, np.float64)
                        .reshape(1, 1, 16), device)
            rf = upload(np.asarray(rt.refd.root_freqs, np.float64)
                        .reshape(1, 1, 4), device)
            Q = _stacked(store, c["q_vid"], c["q_len"], True, device)
            prm = upload(np.stack(
                [c["q_blen"], c["q_tip"].astype(np.float64),
                 np.full(K_total, float(rt.dc.globalTotRate)),
                 np.zeros(K_total)], axis=-1).reshape(K_total, 1, 4), device)
            rescored = []

            def rescore(ts, ti):
                rescored.append(ti.numel())
                return spr_rescore(P, Q.reshape(K_total, 1, -1), prm, mm, rf,
                                   ts, ti, N)

            events, pending = _queue_screen(
                st, store, device, c["a_vid"], c["q_vid"], c["a_tin"],
                c["q_lo"], c["q_hi"], c["q_excl"], chunk=chunk, topm=topm,
                rescore=rescore)
        st.pack_s = sp.seconds
    finally:
        ses.spr_release()

    with rt.tracer.span("spr.decide") as sp:
        best = np.full(K_total, -np.inf)
        row = np.zeros(K_total, np.int64)
        for s, e, b, r, done in pending:
            if done is not None:
                done.synchronize()
            best[s:e] = b.numpy()
            row[s:e] = r.numpy()
        st.device_s = events.seconds()
        st.q_nodes = c["q_node"].astype(np.int64)
        st.q_best = best
        st.q_base = c["q_base"]
        proposals = _proposals(c["q_node"], c["a_node"], best, row,
                               c["q_base"], placement_thresh)
    st.decide_s = sp.seconds
    rt.tracer.count("spr.rescored_device", sum(rescored))
    rt.tracer.count("spr.native_passes")
    return _apply(rt, root, proposals, params, counters, st, t0,
                  f"(proxy, in the engine session; {sum(rescored)} exact "
                  f"re-scores on {device.type}) ", ses=ses)


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
    with rt.tracer.span("spr.collect") as sp:
        q_nodes, q_vecs, q_blens, q_tips, q_base = _collect_queries(
            rt, root, placement_thresh)
        if not q_nodes:
            return None, 0.0
        pool = StackedDevicePool(rt, device)
        pool.full_rebuild()
        n_anchors = len(pool.row_of)
        if n_anchors == 0:
            return None, 0.0
    st.collect_s = sp.seconds
    stats.passes.append(st)
    K_total = len(q_nodes)
    st.queries, st.anchors = K_total, n_anchors

    with rt.tracer.span("spr.pack") as sp:
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
            Cflat = stack_fields_host(packed, pool.site_rates,
                                      pool.error_rates,
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
                pool.dev_pool, pool.dev_valid, dev_a_tin,
                upload(Cflat, device), upload(prm, device),
                upload(tin[nodes].astype(np.int32), device),
                upload(tout[nodes].astype(np.int32), device),
                upload(excl, device), mm, rf, n_prefix=n_prefix, uer=uer)
            ts, ti = to_host(ts, ti)
            pending.append((s, e, ts, ti, events.end(start)))
        st.chunks = len(pending)
        st.kernel_launches = append_scores_prestacked.launches - launches0
    st.pack_s = sp.seconds

    with rt.tracer.span("spr.decide") as sp:
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
    st.decide_s = sp.seconds
    return _apply(rt, root, proposals, params, counters, st, t0, "")


def _screen_mesh(rt, root: int, params, counters, t0, *, mesh,
                 query_chunk: int):
    """The SPR screen over a (dp x cand) mesh of ranks: the anchor pool
    sharded over ``cand``, fixed-size query chunks over ``dp``, every tile
    by the interval-algebra scorer (``spr_screen_scores``), the score
    matrix gathered to every rank; masking of each query's own subtree,
    parent and sibling on the host.  Twin of
    maple_tpu/parallel/batch_spr.py:509-588.  Every rank runs this on the
    same tree and applies the same proposals."""
    from .batch_placement import DeviceTreePool
    from .mesh import host_fetch, put_global, spr_screen_scores
    from ..ops.append_batch import device_model_from
    tree = rt.tree
    strict, fails, threshold, placement_thresh = params
    st = ScreenPass("mesh")
    with rt.tracer.span("spr.collect") as sp:
        pool = DeviceTreePool(rt, mesh.device, mesh=mesh)
        n_anchors = pool.refresh()
        if n_anchors == 0:
            return None, 0.0
        q_nodes, q_vecs, q_blens, q_tips, q_base = _collect_queries(
            rt, root, placement_thresh)
        if not q_nodes:
            return None, 0.0
    st.collect_s = sp.seconds
    stats.passes.append(st)
    K = len(q_nodes)
    st.queries, st.anchors = K, n_anchors

    with rt.tracer.span("spr.pack") as sp:
        dm = device_model_from(rt.model, rt.dc, device=mesh.device)
        q_budget = 256
        while any(len(q) > q_budget for q in q_vecs):
            q_budget *= 2
        packed_q = OP.pack_genome_lists(q_vecs, rt.refd.lRef, q_budget,
                                        rt.model.using_error_rate,
                                        dtype=np.float32)
        Q = stack_fields_host(packed_q, pool.site_rates, pool.error_rates,
                              axis=-1).reshape(K, 1, -1)
        blens = np.asarray(q_blens, dtype=np.float32)
        tips = np.asarray(q_tips, dtype=bool)
        qc = query_chunk
        score_rows = []
        for s in range(0, K, qc):
            sub, bl, tp = Q[s:s + qc], blens[s:s + qc], tips[s:s + qc]
            n_sub = sub.shape[0]
            if n_sub < qc:  # pad the tail chunk so that it divides over dp
                sub, bl, tp = (np.concatenate(
                    [a, np.repeat(a[:1], qc - n_sub, axis=0)], axis=0)
                    for a in (sub, bl, tp))
            out = host_fetch(spr_screen_scores(
                mesh, pool.dev_pool, put_global(mesh, sub, ("dp",)),
                put_global(mesh, bl, ("dp",)), put_global(mesh, tp, ("dp",)),
                dm))
            score_rows.append(out[:n_sub])
            st.chunks += 1
        scores = np.concatenate(score_rows, axis=0)[:, :n_anchors]  # [K, N]
    st.pack_s = sp.seconds

    # host masking: own subtree, parent, sibling
    with rt.tracer.span("spr.decide") as sp:
        tin, tout = _euler_intervals(tree, root)
        anchor_ids = np.asarray(pool.anchor_ids)
        a_tin = tin[anchor_ids]
        proposals = []
        st.q_nodes = np.asarray(q_nodes)
        st.q_best = np.full(K, -np.inf)
        st.q_base = np.asarray(q_base, np.float64)
        for k, node in enumerate(q_nodes):
            invalid = (a_tin >= tin[node]) & (a_tin < tout[node])
            parent = tree.up[node]
            sibling = tree.children[parent][1 - tree.child_index(node)]
            invalid |= (anchor_ids == parent) | (anchor_ids == sibling)
            row = np.where(invalid, -np.inf, scores[k])
            j = int(np.argmax(row))
            st.q_best[k] = float(row[j])
            if np.isfinite(row[j]):
                # screened in float32
                _accept(proposals, node, int(anchor_ids[j]), float(row[j]),
                        q_base[k], placement_thresh)
    st.decide_s = sp.seconds
    return _apply(rt, root, proposals, params, counters, st, t0,
                  f"(mesh {mesh.shape}) ")


def _session_screen(rt) -> bool:
    """Whether a pass inside a live engine session runs there
    (``_screen_session``): the proxy screen on the native kernels, for a
    model without error rates or site rates, which the engine's packing of
    the re-score's lists does not carry."""
    model = rt.model
    return (rt.kern.name == "native"
            and not os.environ.get("MAPLE_SPR_EXACT")
            and not model.using_error_rate
            and model.site_rates is None)


def device_topology_update(rt, root: int, params,
                           counters: Optional[SprCounters] = None, *,
                           device: torch.device, mesh=None,
                           query_chunk: Optional[int] = None,
                           use_pallas: bool = False):
    """One device-screened search / serial-apply SPR pass on ``device``.
    Returns (new_root_or_None, cumulative_improvement) like the host
    parallel paths.  Twin of maple_tpu/parallel/batch_spr.py:471-588.

    Single-device runs take the pipelined screens above.  With a ``mesh``
    the screen runs over its ranks on the interval-algebra scorer
    (``device`` is then the mesh's own); ``query_chunk`` and
    ``use_pallas`` belong to the mesh screen alone, and ``use_pallas``
    only sets the default chunk (64 instead of 16), as in the JAX package.

    SPRTA and network annotation need the crawl's per-candidate
    posteriors and stay on the host paths (the rounds loop gates
    them).

    Inside a live engine session (``native/engine.py`` ``NativeSession``)
    the proxy screen runs in the session (``_screen_session``) where the
    model has no error rates or site rates.  Every other pass reads and
    changes the host-side tree, so a live session is suspended before it
    (span ``engine.suspend``: the resident tree comes back to ``rt.tree``)
    and resumed after it on the pass's root (span ``engine.resume``); a
    resume that cannot import leaves the scope one-shot."""
    if counters is None:
        counters = SprCounters()
    with rt.tracer.span("spr.pass"):
        ses = rt.native_session
        if ses is not None and mesh is None and _session_screen(rt):
            return _screen_session(rt, ses, root, params, counters,
                                   time.time(), device=torch.device(device))
        if ses is not None:
            with rt.tracer.span("engine.suspend"):
                ses.suspend()
        out = None
        try:
            if mesh is not None:
                if query_chunk is None:
                    query_chunk = 64 if use_pallas else 16
                dp = mesh.shape["dp"]
                out = _screen_mesh(
                    rt, root, params, counters, time.time(), mesh=mesh,
                    query_chunk=query_chunk + (-query_chunk) % dp)
            else:
                out = _screen_single_device(rt, root, params, counters,
                                            time.time(),
                                            device=torch.device(device))
            return out
        finally:
            if ses is not None:
                with rt.tracer.span("engine.resume"):
                    ses.resume(root if out is None or out[0] is None
                               else out[0])
