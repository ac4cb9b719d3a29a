"""The proxy screen's feature space and its anchor-row scatter.

A jax-free copy of the feature constants and of ``_scatter_only`` of
:mod:`maple_tpu.parallel.proxy_placer` (that module imports jax).  The
C++ engine exports each vector as at most ``fmax`` (bucket, weight)
pairs, zero-filled past its count (``feat_extract``,
``native/maple_native.cpp:7160-7260``); the device densifies them into
rows of ``D`` float32 weights.
"""
from __future__ import annotations

import torch

# Feature layout; each constant must match the C++ feat_extract
# (native/maple_native.cpp:7160-7176, called by store_export_feats :8186):
# bucket 0 = bias, [1, D_HASH) = hashed (position, nucleotide),
# [D_HASH, D) = genome-interval coverage channel.
D_HASH = 7936
G_BUCKETS = 256
D = D_HASH + G_BUCKETS
# the query-side export budget: 2 * mutations + up to G_BUCKETS coverage
# buckets + bias (doubled by the caller when a row saturates it)
FMAX_QUERY = 448


def scatter_only(AF, valid, upd_idx, upd_fidx, upd_fw, upd_valid):
    """Densify R sparse feature rows and write them into rows ``upd_idx``
    of ``AF`` [cap, D] and ``valid`` [cap], in place (the JAX step donated
    both).

    upd_idx [R] int, upd_fidx [R, F] int, upd_fw [R, F] float32,
    upd_valid [R] bool.  Feature indices repeated within a row add up;
    the dense rows are built in float32 and then cast to ``AF``'s dtype."""
    R = upd_idx.shape[0]
    rows = torch.zeros((R, AF.shape[1]), dtype=torch.float32,
                       device=AF.device)
    rows.scatter_add_(1, upd_fidx.long(), upd_fw)
    idx = upd_idx.long()
    AF.index_copy_(0, idx, rows.to(AF.dtype))
    valid.index_copy_(0, idx, upd_valid)
