"""Anchor pools in the pair kernel's stacked field layout, resident on the
device, and the host<->device copies that the placers and the screens share.

``StackedRows`` holds what both pools need: which nodes are anchors, their
mid-branch vectors in the global frame, and packing them as ``[n, F, B1]``
rows.  ``StackedDevicePool`` is the pool of the pipelined placer and of the
exhaustive SPR screen (twin of ``StackedDevicePool`` in the JAX package's
``parallel/pipelined_placer.py``); the legacy placer's ``DeviceTreePool``
is in :mod:`maple_tpu_torch.parallel.batch_placement`.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops import pack as OP
from ..ops.layout import NFIELDS, stack_fields_host

REBUILD_ROWS = 1024   # a batch that changes more pool rows than this
                      # rebuilds the whole pool instead of scattering


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of ``arr`` that later host edits of ``arr`` cannot
    reach: staged through fresh pinned memory on CUDA (the caching host
    allocator keeps the block until the copy has completed)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def to_host(ts: torch.Tensor, ti: torch.Tensor):
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


class StackedRows:
    """Anchor eligibility, export and packing, shared by the pools."""

    def __init__(self, rt, device: torch.device, dtype=np.float32):
        self.rt = rt
        self.device = device
        self.dtype = dtype
        self.budget = 0            # B1 (entry slots)
        model = rt.model
        self.site_rates = None if model.site_rates is None \
            else np.asarray(model.site_rates)
        self.error_rates = None
        if model.using_error_rate:
            if model.error_rates is not None:
                self.error_rates = np.asarray(model.error_rates)
            else:
                self.error_rates = np.full(rt.refd.lRef, model.error_rate)

    def _chain_up(self, node):
        """MAT mutation chain of one node, node first."""
        tree = self.rt.tree
        chain = []
        n = node
        while n is not None:
            if tree.mutations[n]:
                chain.append(n)
            n = tree.up[n]
        return chain

    def eligible_vec(self, node):
        """The node's global-frame mid-branch vector when it is a valid
        anchor, else None (the criteria of ``all_anchors``)."""
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

    def all_anchors(self, by_node_index: bool):
        """(anchors, vecs) of every eligible node of the current tree, in
        node-index order or in the order of a pre-order walk.

        Per-node MAT frame chains are persistent linked lists: chain[node]
        = (node, chain[parent]) when the node carries a mutation list, else
        chain[parent].  Anchors below local references are translated to
        the global frame here (composition of passGenomeListThroughBranch,
        reference :3749), so device scoring stays frame-free while MAT
        stays enabled."""
        rt = self.rt
        tree = rt.tree
        eff0 = rt.dc.effectivelyNon0BLen
        chains = {}
        stack = []
        for node in range(len(tree.up)):
            if tree.up[node] is None and tree.children[node] is not None:
                chains[node] = (node, None) if tree.mutations[node] else None
                stack.append(node)
        walk = []
        while stack:
            n = stack.pop()
            for c in tree.children[n] or ():
                chains[c] = (c, chains[n]) if tree.mutations[c] \
                    else chains[n]
                stack.append(c)
            walk.append(n)
        anchors, vecs = [], []
        for n in (range(len(tree.up)) if by_node_index else walk):
            if tree.up[n] is None or tree.children[n] is None:
                continue   # root / spliced-out minor parents
            if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
                v = tree.probVectTotUp[n]
                link = chains.get(n)
                while link is not None:
                    v = rt.pass_up(v, link[0])
                    link = link[1]
                anchors.append(n)
                vecs.append(rt.kern.export(v))
        return anchors, vecs

    def _pack_rows(self, vecs) -> np.ndarray:
        """[len(vecs), F, B1] stacked rows."""
        rt = self.rt
        packed = OP.pack_genome_lists(vecs, rt.refd.lRef, self.budget,
                                      rt.model.using_error_rate,
                                      dtype=self.dtype)
        return stack_fields_host(packed, self.site_rates,
                                 self.error_rates, axis=-2,
                                 dtype=self.dtype)


class StackedDevicePool(StackedRows):
    """Device-resident anchor pool in the pair kernel's stacked field
    layout, with a host mirror for incremental row scatters.

    Rows are persistent (an anchor keeps its row for the run; new anchors
    append; ineligible anchors are invalidated, not compacted).  The entry
    budget (B1) is snug: a multiple of 8 with headroom.  Budget or capacity
    growth triggers a full rebuild."""

    def __init__(self, rt, device: torch.device, n_pad_hint: int = 0,
                 dtype=np.float32):
        super().__init__(rt, device, dtype)
        self.n_pad_hint = n_pad_hint
        self.capacity = 0          # row count (pow2, multiple of 128)
        self.rows_host: Optional[np.ndarray] = None   # [cap, F, B1]
        self.valid_host: Optional[np.ndarray] = None  # [cap] bool
        self.node_arr: Optional[np.ndarray] = None    # [cap] int64, -1=free
        self.row_of = {}
        self.dev_pool: Optional[torch.Tensor] = None
        self.dev_valid: Optional[torch.Tensor] = None

    @property
    def n_prefix(self) -> int:
        n = 128
        while n < len(self.row_of):
            n *= 2
        return min(n, self.capacity) or 128

    def full_rebuild(self):
        """Rebuild the whole pool from the current tree and upload it."""
        anchors, vecs = self.all_anchors(by_node_index=False)
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
        self.dev_pool = upload(self.rows_host, self.device)
        self.dev_valid = upload(self.valid_host, self.device)
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
