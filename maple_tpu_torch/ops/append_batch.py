"""Batched placement scores by interval algebra, in torch ops.

The torch twin of :mod:`maple_tpu.ops.append_batch`: the appendProbNode
likelihood cost (reference MAPLEv0.7.5.4.py:6505-6785) of attaching one or
many packed query genome lists below many packed candidate upper vectors.
Both operands' entry end positions are merged into the union breakpoint set
(one sort), every union segment finds the entry of either side that covers
it, and the {R,N,O,nuc} x {R,N,O,nuc} case matrix is applied as vectorised
selects; only segments of one position contribute a factor.  This is the
legacy batch placer's default scorer and the scorer of every mesh function
(:mod:`maple_tpu_torch.parallel.mesh`); the pair kernel
(:mod:`maple_tpu_torch.ops.append_pairs`) computes the same scores another
way.

Where the JAX module gathers the covering entry of a segment with a one-hot
contraction over ``[rows, S, B]`` (S = B1 + B2 segments), this module uses
``torch.searchsorted`` on the entry ends: ends never decrease and padding
entries end at lRef like the last real entry, so the first entry whose end
reaches a breakpoint is the one entry the one-hot selects.  Two stages keep
the memory small: the dense stage (sort, covering entries, entry types, the
mask of contributing segments) works on ``[rows, S]`` planes of at most
``_BLOCK_ELEMS`` elements, about 60 bytes an element at its peak; the case
factors are then computed only for the contributing segments, gathered into
flat vectors (a few percent of the planes on real data), written
back into a zero plane and summed along the segments, so the sum has one
fixed order on every device.

Plain functions on tensors: the device and the working type are those of
the model arrays (float64 for parity, float32 for production).  The sums
are of log factors, in another order than the host kernels' running
product: equal mathematics, other rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .pack import PackedBatch, TYPE_N, TYPE_O, TYPE_PAD, TYPE_R

# Segment elements ([rows, S]) of one dense block.  A grid call is cut into
# blocks of queries (and of candidates, when one query's plane is larger).
_BLOCK_ELEMS = 1 << 23


class DeviceModel(NamedTuple):
    """Model state for the batched kernels."""

    mut_matrix: torch.Tensor       # [4, 4] normalized rates
    root_freqs: torch.Tensor       # [4]
    site_rates: torch.Tensor       # [lRef] (ones when rate variation is off)
    error_rates: torch.Tensor      # [lRef] (zeros when error model is off)
    global_tot_rate: torch.Tensor  # scalar (-lRef)
    tot_error: torch.Tensor        # scalar
    use_rate_variation: bool
    using_error_rate: bool


def model_from_numpy(mut_matrix, root_freqs, site_rates, error_rates,
                     global_tot_rate, tot_error, use_rate_variation,
                     using_error_rate, *, device: torch.device,
                     dtype: torch.dtype) -> DeviceModel:
    """The port's DeviceModel from plain arrays: ``mut_matrix [4, 4]``,
    ``root_freqs [4]``, ``site_rates [lRef]``, ``error_rates [lRef]`` and
    the two scalars, in the layout ``maple_tpu.ops.append_batch`` uses."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=dtype, device=device)
    return DeviceModel(
        mut_matrix=t(mut_matrix), root_freqs=t(root_freqs),
        site_rates=t(site_rates), error_rates=t(error_rates),
        global_tot_rate=t(global_tot_rate), tot_error=t(tot_error),
        use_rate_variation=bool(use_rate_variation),
        using_error_rate=bool(using_error_rate))


def device_model_from(model, dc, *, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> DeviceModel:
    lRef = model.refd.lRef
    site_rates = np.ones(lRef) if model.site_rates is None \
        else np.asarray(model.site_rates)
    error_rates = np.zeros(lRef)
    if model.using_error_rate:
        if model.error_rates is not None:
            error_rates = np.asarray(model.error_rates)
        else:
            error_rates = np.full(lRef, model.error_rate)
    return model_from_numpy(
        model.mut_matrix, model.refd.root_freqs, site_rates, error_rates,
        dc.globalTotRate, model.tot_error or 0.0, model.use_rate_variation,
        model.using_error_rate, device=device, dtype=dtype)


def to_device(p: PackedBatch, *, device: torch.device,
              dtype: torch.dtype = torch.float32) -> dict:
    def t(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    return {
        "types": t(p.types),
        "ends": t(p.ends),
        "vals": t(p.vals),
        "bl1": t(p.bl1, dtype),
        "bl2": t(p.bl2, dtype),
        "has_bl1": t(p.has_bl1),
        "has_bl2": t(p.has_bl2),
        "flags": t(p.flags),
        "probs": t(p.probs, dtype),
    }


def _evolve_o_down(v, t_eff, mm):
    """v + t*(M @ v) with uniform-collapse on negative components
    (reference getPartialVec O branch :4088-4111).  The site rate is folded
    into ``t_eff`` so M stays the constant 4x4 matrix."""
    out = v + t_eff[..., None] * (v[..., None, :] * mm).sum(-1)
    bad = (out < 0).any(-1, keepdim=True)
    return torch.where(bad, 0.25, out)


def _evolve_nuc_down(h, t_eff, mm, eps, flag):
    """One-hot (or error-emission) vector evolved down a branch of length t
    (reference getPartialVec nuc branches :4112-4141); h is the one-hot of
    the nucleotide, site rate folded into t_eff."""
    e3 = 0.33333 * eps[..., None]
    base = torch.where(flag[..., None],
                       h * (1.0 - eps[..., None] - e3) + e3, h)
    return _evolve_o_down(base, t_eff, mm)


def _field_matrix(X: dict, dtype) -> torch.Tensor:
    """The per-entry fields of a packed dict as one [..., B, 11] matrix in
    the working type, so that a segment's covering entry is one gather."""
    probs = X["probs"]
    return torch.stack(
        [X[k].to(dtype) for k in ("types", "vals", "bl1", "bl2", "has_bl1",
                                  "has_bl2", "flags")]
        + [probs[..., q].to(dtype) for q in range(4)], dim=-1)


def _case_log_factors(p, c, blen, tip, rate, eps, mm, rf, uer: bool):
    """log(factor) of M contributing segments: ``p`` and ``c`` are the
    [M, 11] fields of the candidate and query entries covering each,
    ``blen`` [M] and ``tip`` [M] the appending branch length and tip flag
    of its query, ``rate`` and ``eps`` [M] the model state at its position
    (the case factors of maple_tpu/ops/append_batch.py:224-286, in the same
    order)."""
    dtype = p.dtype
    cP, valP, blP1, blP2 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    hasP1, hasP2, flagP = p[:, 4] > 0.5, p[:, 5] > 0.5, p[:, 6] > 0.5
    probsP = p[:, 7:11]
    cC, valC, blC1 = c[:, 0], c[:, 1], c[:, 2]
    hasC1, flagC = c[:, 4] > 0.5, c[:, 6] > 0.5
    probsC = c[:, 7:11]
    is_nucP, is_nucC = cP < 3.5, cC < 3.5
    is_RP = cP == float(TYPE_R)
    is_OP, is_OC = cP == float(TYPE_O), cC == float(TYPE_O)

    # total fixed branch length between the two observations
    contrib = blen \
        + torch.where(is_OP, torch.where(hasP1, blP1, 0.0),
                      torch.where(hasP2, blP2,
                                  torch.where(hasP1, blP1, 0.0))) \
        + torch.where(hasC1, blC1, 0.0)

    refn = torch.where(is_RP, valC, valP)
    i1 = torch.where(is_nucP, cP, refn).long().clamp_(0, 3)   # P-side nuc
    i2 = torch.where(is_nucC, cC, refn).long().clamp_(0, 3)   # C-side nuc
    if uer:
        flagC_eff = tip | flagC
        flagP_eff = flagP
    else:
        flagC_eff = torch.zeros_like(flagC)
        flagP_eff = flagC_eff

    def gather4(v, i):
        return v.gather(-1, i[:, None])[:, 0]

    h1 = torch.nn.functional.one_hot(i1, 4).to(dtype)
    h2 = torch.nn.functional.one_hot(i2, 4).to(dtype)
    m_i1_i2 = rate * mm[i1, i2]
    rf_i1 = rf[i1]

    t_eff = contrib * rate
    evC_O = torch.where((contrib > 0)[:, None],
                        _evolve_o_down(probsC, t_eff, mm), probsC)
    evC_nuc = _evolve_nuc_down(h2, t_eff, mm, eps, flagC_eff)
    evP_root = _evolve_nuc_down(h1, blP1 * rate, mm, eps, flagP_eff)

    # A/F) C is O, P is R or nuc
    pcs_i1 = gather4(probsC, i1)
    simple_CO = torch.where(contrib > 0, gather4(evC_O, i1), pcs_i1)
    root_CO = (evC_O * evP_root * rf).sum(-1) / rf_i1
    f_CO = torch.where(pcs_i1 > 0.02, pcs_i1,
                       torch.where(hasP2, root_CO, simple_CO))
    # B/E) both concrete nucleotides (incl. R on one side)
    base_nn = torch.clamp(m_i1_i2 * contrib, max=0.25)
    fP, fC = flagP_eff.to(dtype), flagC_eff.to(dtype)
    plain_nn = base_nn + (fP * (~is_RP).to(dtype) + fC) * 0.33333 * eps
    # for the R-parent case the reference adds only the child-side flag
    plain_rn = base_nn + fC * 0.33333 * eps
    root_nn = (evC_nuc * evP_root * rf).sum(-1) / rf_i1
    f_nn = torch.where(hasP2, root_nn,
                       torch.where(is_RP, plain_rn, plain_nn))
    # C) both O
    f_OO = (probsP * evC_O).sum(-1)
    # D) P is O, C is nuc/R
    pps_i2 = gather4(probsP, i2)
    f_On = torch.where(pps_i2 > 0.02, pps_i2, (probsP * evC_nuc).sum(-1))

    f = torch.where(is_OP & is_OC, f_OO,
                    torch.where(is_OP, f_On,
                                torch.where(is_OC, f_CO, f_nn)))
    # in float32 the floor 1e-300 is 0: the ``where`` decides, not the clamp
    return torch.where(f > 0, torch.log(torch.clamp(f, min=1e-300)),
                       float("-inf"))


def _covering(ends, E):
    """Index of the entry that covers each breakpoint: the first entry
    whose end reaches it (ends never decrease; padding ends at lRef)."""
    return torch.searchsorted(ends.contiguous(), E) \
        .clamp_(max=ends.shape[-1] - 1)


def _log_factor_sums(endsP, FP, endsC, FC, blen, tip, mm, rf, site_rates,
                     error_rates, uer: bool, gen_offset):
    """Summed log case factors [A, N] of one dense block.

    endsP [1|A, N, B1] int32 and FP [1|A, N, B1, 11] the candidates, endsC
    [A, 1|N, B2] and FC [A, 1|N, B2, 11] the queries (a size-1 axis is
    shared), blen and tip [1|A, 1|N].  With ``gen_offset`` the two tables
    are one slice of the genome starting there, and only segments inside
    it contribute."""
    A = max(endsP.shape[0], endsC.shape[0])
    N = max(endsP.shape[1], endsC.shape[1])
    B1, B2 = endsP.shape[-1], endsC.shape[-1]
    eP, eC = endsP.expand(A, N, B1), endsC.expand(A, N, B2)
    E = torch.sort(torch.cat([eP, eC], dim=-1), dim=-1).values   # [A,N,S]
    seg_valid = torch.empty_like(E, dtype=torch.bool)
    seg_valid[..., 0] = E[..., 0] > 0
    seg_valid[..., 1:] = E[..., 1:] > E[..., :-1]
    iP, iC = _covering(eP, E), _covering(eC, E)
    cP = torch.gather(FP[..., 0].expand(A, N, B1), -1, iP)
    cC = torch.gather(FC[..., 0].expand(A, N, B2), -1, iC)
    # a breakpoint beyond an operand's last end is covered by none of its
    # entries (an all-zero row: an unassigned pool row): no factor, as in
    # the pair kernel, where such a row overlaps nothing
    contributes = seg_valid & (E <= eP[..., -1:]) & (E <= eC[..., -1:]) \
        & (cP != float(TYPE_N)) & (cC != float(TYPE_N)) \
        & (cP != float(TYPE_PAD)) & (cC != float(TYPE_PAD)) \
        & ~((cP == float(TYPE_R)) & (cC == float(TYPE_R))) \
        & ~((cP < 3.5) & (cP == cC))
    # per-position model state (contributing segments span one position);
    # out-of-range positions are clamped, as a JAX gather clamps them
    pos = (E - 1).clamp_(min=0)
    span = site_rates.shape[-1]
    if gen_offset is not None:
        pos = pos - gen_offset
        contributes &= (pos >= 0) & (pos < span)
    pos = pos.clamp_(0, span - 1)

    log_f = torch.zeros(E.shape, dtype=mm.dtype, device=E.device)
    sel = contributes.nonzero(as_tuple=True)
    if sel[0].numel():
        a_i, n_i, _ = sel
        at = pos[sel].long()
        rate = site_rates[at]
        eps = error_rates[at] if uer else torch.zeros_like(rate)
        log_f[sel] = _case_log_factors(
            FP.expand(A, N, B1, -1)[a_i, n_i, iP[sel]],
            FC.expand(A, N, B2, -1)[a_i, n_i, iC[sel]],
            blen.expand(A, N)[a_i, n_i], tip.expand(A, N)[a_i, n_i],
            rate, eps, mm, rf, uer)
    return log_f.sum(-1)


def _cut(t, a0, a1, n0, n1):
    """Rows [a0:a1, n0:n1] of a [1|A, 1|N, ...] tensor; a shared (size-1)
    axis stays whole."""
    if t.shape[0] > 1:
        t = t[a0:a1]
    if t.shape[1] > 1:
        t = t[:, n0:n1]
    return t


def _scores(P: dict, C: dict, blen, tip_c, mm, root_freqs, site_rates,
            error_rates, global_tot_rate, tot_error, uer: bool,
            gen_offset=None, *, grid: bool, block_elems=None):
    """The function behind every entry point.

    ``grid``: P fields [N, B1] x C fields [K, B2] -> [K, N], blen and tip
    scalars or [K].  Otherwise pairwise: P fields [N, B1] against C fields
    [N, B2] (or one query [B2]) -> [N], blen and tip scalars or [N].  The
    dense stage runs in blocks of at most ``block_elems`` segment elements
    (None: one block)."""
    dtype, device = mm.dtype, mm.device
    FP = _field_matrix(P, dtype)[None]                    # [1, N, B1, 11]
    endsP = P["ends"].to(torch.int32)[None]
    FC = _field_matrix(C, dtype)
    endsC = C["ends"].to(torch.int32)
    blen = torch.as_tensor(blen, dtype=dtype, device=device)
    tip = torch.as_tensor(tip_c, dtype=torch.bool, device=device)
    if grid:
        FC, endsC = FC[:, None], endsC[:, None]           # [K, 1, B2, ..]
        blen, tip = (v.reshape(-1, 1) for v in (blen, tip))
    else:
        if endsC.dim() == 1:
            FC, endsC = FC[None], endsC[None]
        FC, endsC = FC[None], endsC[None]                 # [1, 1|N, B2, ..]
        blen, tip = (v.reshape(1, -1) for v in (blen, tip))
    A, N = endsC.shape[0], endsP.shape[1]
    S = endsP.shape[-1] + endsC.shape[-1]
    rows = A * N if block_elems is None else max(1, block_elems // S)
    n_c = min(N, rows)
    a_c = max(1, rows // N)
    out = torch.empty((A, N), dtype=dtype, device=device)
    for a0 in range(0, A, a_c):
        for n0 in range(0, N, n_c):
            cut = (a0, a0 + a_c, n0, n0 + n_c)
            out[a0:a0 + a_c, n0:n0 + n_c] = _log_factor_sums(
                _cut(endsP, *cut), _cut(FP, *cut), _cut(endsC, *cut),
                _cut(FC, *cut), _cut(blen, *cut), _cut(tip, *cut), mm,
                root_freqs, site_rates, error_rates, uer, gen_offset)
    if gen_offset is None:
        out = out + blen * global_tot_rate
        if uer:
            out = out + torch.where(tip, tot_error, 0.0)
    return out if grid else out[0]


def _append_scores_block(P, C, blen, tip_c, mm, root_freqs, site_rates,
                         error_rates, global_tot_rate, tot_error, uer,
                         gen_offset=None):
    """P fields: [N, B1]; C fields: [N, B2] (pairwise) or [B2] (one query)
    -> scores [N], in one dense block.

    With ``gen_offset`` set (genome-axis sharding: the dense per-site
    tables are the only O(lRef) state), ``site_rates`` and ``error_rates``
    are one slice of the genome; only union segments whose position falls
    inside [gen_offset, gen_offset + slice) contribute, and the return
    value is the bare log-factor partial sum: the caller sums it over the
    ``gen`` mesh axis and adds the position-independent terms once."""
    return _scores(P, C, blen, tip_c, mm, root_freqs, site_rates,
                   error_rates, global_tot_rate, tot_error, uer, gen_offset,
                   grid=False)


def _append_scores_impl(P, C, blen, tip_c, mm, root_freqs, site_rates,
                        error_rates, global_tot_rate, tot_error, uer,
                        gen_offset=None):
    """Chunked form: the block function over row blocks of N, so that
    the dense planes stay within ``_BLOCK_ELEMS`` elements."""
    return _scores(P, C, blen, tip_c, mm, root_freqs, site_rates,
                   error_rates, global_tot_rate, tot_error, uer, gen_offset,
                   grid=False, block_elems=_BLOCK_ELEMS)


def _grid_scores_impl(P, C, blens, tips, mm, root_freqs, site_rates,
                      error_rates, global_tot_rate, tot_error, uer,
                      gen_offset=None):
    """All-pairs scores: P fields [N, B1] x C fields [K, B2] -> [K, N];
    ``blens`` and ``tips`` scalars or [K].  Blocks of queries (each cut
    along N when one query's plane is too large) bound the memory."""
    return _scores(P, C, blens, tips, mm, root_freqs, site_rates,
                   error_rates, global_tot_rate, tot_error, uer, gen_offset,
                   grid=True, block_elems=_BLOCK_ELEMS)


def _model_args(dm: DeviceModel):
    return (dm.mut_matrix, dm.root_freqs, dm.site_rates, dm.error_rates,
            dm.global_tot_rate, dm.tot_error, dm.using_error_rate)


def batched_append_scores(P: dict, C: dict, blen, tip_c: bool,
                          dm: DeviceModel):
    """Scores [N] for appending one query C below each of N candidate upper
    vectors P at distance blen."""
    return _append_scores_impl(P, C, blen, bool(tip_c), *_model_args(dm))


def paired_append_scores(P: dict, C: dict, blen, tips, dm: DeviceModel):
    """Scores [N] for N (candidate, query) pairs: P fields [N, B1] against
    C fields [N, B2]; blen and tips may be scalars or [N] vectors."""
    return _append_scores_impl(P, C, blen, tips, *_model_args(dm))


def grid_append_scores(P: dict, C: dict, blen, tip_c: bool,
                       dm: DeviceModel):
    """Scores [K, N]: K packed queries against N candidate vectors."""
    return _grid_scores_impl(P, C, blen, bool(tip_c), *_model_args(dm))


def grid_append_scores_var(P: dict, C: dict, blens, tips,
                           dm: DeviceModel):
    """Scores [K, N]: K packed queries, each carrying its own appending
    branch length and tip flag (the SPR screen's pruned subtrees keep
    their current attachment blen; placement queries are always tips at
    oneMut), against N candidate vectors."""
    return _grid_scores_impl(P, C, blens, tips, *_model_args(dm))
