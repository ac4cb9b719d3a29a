"""The 16-field stacked entry layout of the pair kernel.

A jax-free copy of the field constants and ``stack_fields_host`` of
:mod:`maple_tpu.ops.pallas_append` (that module imports jax).  Candidate
rows are stacked as ``[N, F, B1]`` and queries as ``[K, B2, F]``; every
field is stored in the working float type, so entry types and positions
are floats too (positions stay exact in float32 up to 2**24, far above
any SARS-CoV-2 reference length).
"""
from __future__ import annotations

import numpy as np

# field order in the stacked entry tensors
F_TYPE, F_VAL, F_BL1, F_BL2, F_HAS1, F_HAS2, F_FLAG = range(7)
F_P0, F_P1, F_P2, F_P3 = 7, 8, 9, 10
F_END, F_PREV, F_RATE, F_EPS = 11, 12, 13, 14
NFIELDS = 16  # padded to a power of two


def stack_fields_host(p, site_rates, error_rates, axis, dtype=None):
    """Stack a PackedBatch's per-entry fields, plus the derived
    end/prev/rate/eps planes, into the kernel's NFIELDS layout.

    Per-entry site rate and error rate are baked in at pack time: the rate
    of a contributing pair is the rate at ``min(ends) - 1``, and both tables
    change only at EM boundaries.  ``axis=-2`` packs candidates
    (``[N, F, B]``); ``axis=-1`` packs queries (``[..., B, F]``)."""
    dtype = dtype or np.float32
    ends = p.ends
    pos = np.maximum(ends - 1, 0)
    prev = np.concatenate(
        [np.zeros_like(ends[..., :1]), ends[..., :-1]], axis=-1)
    rate = (np.ones_like(ends, dtype=dtype) if site_rates is None
            else np.asarray(site_rates)[pos])
    eps = (np.zeros_like(ends, dtype=dtype) if error_rates is None
           else np.asarray(error_rates)[pos])
    fields = [
        p.types, p.vals, p.bl1, p.bl2, p.has_bl1, p.has_bl2, p.flags,
        p.probs[..., 0], p.probs[..., 1], p.probs[..., 2], p.probs[..., 3],
        ends, prev, rate, eps, np.zeros_like(ends),
    ]
    return np.stack([np.asarray(f, dtype=dtype) for f in fields],
                    axis=axis)


def fields_view(stk, axis: int) -> dict:
    """The nine named fields of a packed dict as views of a stacked entry
    tensor (no copy): ``axis=-2`` for candidates stacked ``[..., F, B]``,
    ``axis=-1`` for queries stacked ``[..., B, F]``.  Every field comes in
    the stacked tensor's float type (entry types, positions and flags
    too); the interval-algebra scorer casts them itself."""
    if axis == -2:
        def field(f):
            return stk[..., f, :]
        probs = stk[..., F_P0:F_P3 + 1, :].swapaxes(-1, -2)
    elif axis == -1:
        def field(f):
            return stk[..., f]
        probs = stk[..., F_P0:F_P3 + 1]
    else:
        raise ValueError(f"fields_view: axis {axis} (want -2 or -1)")
    return {"types": field(F_TYPE), "ends": field(F_END),
            "vals": field(F_VAL), "bl1": field(F_BL1), "bl2": field(F_BL2),
            "has_bl1": field(F_HAS1), "has_bl2": field(F_HAS2),
            "flags": field(F_FLAG), "probs": probs}
