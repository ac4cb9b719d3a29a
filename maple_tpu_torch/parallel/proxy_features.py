"""The proxy screens' feature space, their anchor-row scatter and their
score product.

Torch twins of the feature constants, ``feature_dims``, ``_f_bucket`` and
``_scatter_only`` of the JAX package's ``parallel/proxy_placer.py``.  The
C++ engine exports each vector as at most ``fmax`` (bucket, weight) pairs,
zero-filled past its count (``feat_extract``,
``native/maple_native.cpp:7160-7260``); the device densifies them into rows
of ``D`` float32 weights.  Both proxy screens (placement and SPR) score
with :func:`proxy_scores`.
"""
from __future__ import annotations

import os

import torch

# Feature layout; each constant must match the C++ feat_extract
# (native/maple_native.cpp:7160-7176, called by store_export_feats :8186):
# bucket 0 = bias, [1, D_HASH) = hashed (position, nucleotide),
# [D_HASH, D) = genome-interval coverage channel.
D_HASH = 7936
G_BUCKETS = 256
D = D_HASH + G_BUCKETS
# export budgets (doubled by the caller when a row saturates them): an
# anchor has 2 features per mutation + bias, a query 2 * mutations + up to
# G_BUCKETS coverage buckets + bias
FMAX_ANCHOR = 192
FMAX_QUERY = 448
# Feature-axis buckets: the budgets are worst cases and real rows hold far
# fewer features, while the upload and the densifying scatter scale with
# rows * F; rows are cut to the smallest bucket covering the batch's
# largest count before upload (lossless: the export zero-fills past each
# row's count).
_F_BUCKETS = (64, 192, 448)
UPCAST_ROWS = 65536       # bf16 pool rows upcast per product block
BF16_CAP = 524288         # pools this large keep bf16 features ...
BF16_TOPM = 192           # ... and re-score deeper to keep recall


def feature_dims(cap: int, fast: bool = False):
    """(d_hash, g_buckets) for a pool of ``cap`` rows.

    The fast contract narrows the feature space 4x (D = 2048): the product
    and both densifying scatters scale with D.  Pools of 2**20 rows or more
    halve it (D = 4096) to halve the pool's footprint.  Either way hash
    collisions rise, a recall-only cost: the engine re-scores every seed
    exactly.  ``MAPLE_PROXY_D`` overrides."""
    override = os.environ.get("MAPLE_PROXY_D")
    if override:
        d = int(override)
        return d - d // 32, d // 32
    if fast:
        return 1984, 64
    if cap >= (1 << 20):
        return 3968, 128
    return D_HASH, G_BUCKETS


def _f_bucket(max_nf: int, fmax: int) -> int:
    for b in _F_BUCKETS:
        if b >= max_nf + 1 and b <= fmax:
            return b
    return fmax


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


def proxy_scores(AF, q_fidx, q_fw):
    """Float32 scores [K, cap] of K sparse queries against every row of
    ``AF`` [cap, D] (float32 or bfloat16): the queries are densified in
    float32 (repeated indices add up) and multiplied with the pool.

    The JAX package rounds the dense queries to the pool's dtype and
    multiplies with float32 accumulation and float32 output.  A bfloat16
    ``torch.matmul`` would round the scores to bfloat16 and reorder
    near-ties, so a bfloat16 pool takes the same query rounding and is then
    upcast block by block for full float32 products.  A float32 matmul
    precision below "highest" (TF32) is refused for the same reason."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("proxy_scores: float32 matmul precision is "
                           f"{torch.get_float32_matmul_precision()!r}; the "
                           "proxy scores need full float32 products")
    K = q_fidx.shape[0]
    cap = AF.shape[0]
    QF = torch.zeros((K, AF.shape[1]), dtype=torch.float32, device=AF.device)
    QF.scatter_add_(1, q_fidx.long(), q_fw)
    if AF.dtype == torch.float32:
        return QF @ AF.T
    QF = QF.to(AF.dtype).float()
    scores = torch.empty((K, cap), dtype=torch.float32, device=AF.device)
    for r in range(0, cap, UPCAST_ROWS):
        scores[:, r:r + UPCAST_ROWS] = QF @ AF[r:r + UPCAST_ROWS].float().T
    return scores
