"""Packing sparse genome lists into fixed-budget padded tensors.

The device twin of the host tuple representation: each genome list becomes
fixed-size arrays of B entries (the dense-array dual of the reference's
run-length lists, MAPLEv0.7.5.4.py:378-390).  Entries are encoded by their
*end position* (1-based, inclusive); entry k covers
(end[k-1], end[k]].  PAD entries (type 7) carry end = lRef so that interval
algebra stays well-formed.

Packing is pure numpy (host side); stacks of packed lists feed the batched
JAX kernels in :mod:`maple_tpu_torch.ops.append_batch`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

TYPE_R = 4
TYPE_N = 5
TYPE_O = 6
TYPE_PAD = 7


@dataclass
class PackedBatch:
    """A batch of packed genome lists: leading axes index the batch."""

    types: np.ndarray   # int8  [..., B]
    ends: np.ndarray    # int32 [..., B]   end position of each entry
    vals: np.ndarray    # int8  [..., B]   local-ref nucleotide (nuc/O)
    bl1: np.ndarray     # f32   [..., B]
    bl2: np.ndarray     # f32   [..., B]
    has_bl1: np.ndarray  # bool [..., B]
    has_bl2: np.ndarray  # bool [..., B]
    flags: np.ndarray   # bool  [..., B]   error-prone-tip observation flag
    probs: np.ndarray   # f32   [..., B, 4] O-entry likelihoods

    @property
    def budget(self) -> int:
        return self.types.shape[-1]


def pack_genome_list(vec, lRef: int, budget: int, using_error_rate: bool,
                     dtype=np.float64) -> PackedBatch:
    """Pack one host genome list (tuple form) into padded arrays.

    Raises ValueError when the list exceeds the entry budget — callers grow
    the budget (next power of two) and repack.
    """
    n = len(vec)
    if n > budget:
        raise ValueError(f"genome list has {n} entries > budget {budget}")
    types = np.full(budget, TYPE_PAD, dtype=np.int8)
    ends = np.full(budget, lRef, dtype=np.int32)
    vals = np.zeros(budget, dtype=np.int8)
    bl1 = np.zeros(budget, dtype=dtype)
    bl2 = np.zeros(budget, dtype=dtype)
    has_bl1 = np.zeros(budget, dtype=bool)
    has_bl2 = np.zeros(budget, dtype=bool)
    flags = np.zeros(budget, dtype=bool)
    probs = np.zeros((budget, 4), dtype=dtype)
    pos = 0
    uer = 1 if using_error_rate else 0
    for k, e in enumerate(vec):
        c = e[0]
        types[k] = c
        if c in (TYPE_R, TYPE_N):
            pos = e[1]
            ends[k] = pos
        else:
            pos += 1
            ends[k] = pos
            vals[k] = e[1]
        if c == TYPE_O:
            probs[k] = e[-1]
            if len(e) > 3:
                bl1[k] = e[2]
                has_bl1[k] = True
        elif c != TYPE_N:
            # layouts: (c,v), (c,v,b1[,flag]), (c,v,b1,b2[,flag])
            n_extra = len(e) - 2 - (uer if len(e) > 2 else 0)
            if n_extra >= 1:
                bl1[k] = e[2]
                has_bl1[k] = True
            if n_extra >= 2:
                bl2[k] = e[3]
                has_bl2[k] = True
            if uer and len(e) > 2:
                flags[k] = bool(e[-1])
    if pos != lRef:
        raise ValueError(f"genome list covers {pos} of {lRef} positions")
    return PackedBatch(types, ends, vals, bl1, bl2, has_bl1, has_bl2, flags,
                       probs)


def pack_genome_lists(vecs: Sequence, lRef: int, budget: int,
                      using_error_rate: bool,
                      dtype=np.float64) -> PackedBatch:
    """Pack many genome lists into one stacked batch (axis 0)."""
    packed = [pack_genome_list(v, lRef, budget, using_error_rate, dtype)
              for v in vecs]
    return PackedBatch(
        types=np.stack([p.types for p in packed]),
        ends=np.stack([p.ends for p in packed]),
        vals=np.stack([p.vals for p in packed]),
        bl1=np.stack([p.bl1 for p in packed]),
        bl2=np.stack([p.bl2 for p in packed]),
        has_bl1=np.stack([p.has_bl1 for p in packed]),
        has_bl2=np.stack([p.has_bl2 for p in packed]),
        flags=np.stack([p.flags for p in packed]),
        probs=np.stack([p.probs for p in packed]),
    )


def budget_for(vecs: Sequence, minimum: int = 64) -> int:
    """Smallest power-of-two budget holding every list (static shapes keep
    XLA recompilation bounded to O(log max_len) variants)."""
    need = max((len(v) for v in vecs), default=1)
    b = minimum
    while b < need:
        b *= 2
    return b


def snug_budget(max_entries: int, minimum: int = 24,
                headroom: float = 1.4) -> int:
    """Entry budget from a x1.5 ladder of sublane multiples
    (24, 40, 64, 96, 144, 216, 328, ...) with growth headroom.

    The Pallas candidate-lane kernel only needs the entry axis to be a
    sublane multiple (8), not a power of two — and measured entry counts
    (mean ~25, max ~67 at 3k samples) make the power-of-two rounding the
    single largest waste of pair work in the screen (budget 128 for a
    mean-25 pool).  The coarse ladder + headroom keep the number of
    distinct budgets per run at 1-2: every budget change invalidates
    every compiled (prefix, budget) kernel variant, and compiles
    serialize on the dispatch thread."""
    need = max(minimum, int(max_entries * headroom) + 4)
    b = minimum
    while b < need:
        b = (b + b // 2) + (-(b + b // 2)) % 8
    return b
