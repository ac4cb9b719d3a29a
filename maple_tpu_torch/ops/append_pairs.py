"""appendProbNode pair scoring: the CUDA kernel's wrapper and its plain
PyTorch version.

Twin of :func:`maple_tpu.ops.pallas_append.pallas_scores_prestacked` (the
reference semantics are MAPLEv0.7.5.4.py:6505-6785).  Both lists of a
(candidate, query) pair partition [0, lRef] into sorted entries, so every
union segment is the overlap of exactly one entry pair, and the score is
a sum of per-pair log factors over the overlapping pairs: the steps of a
two-pointer merge of the two lists.

On a CUDA tensor :func:`append_scores_prestacked` launches the merge-walk
kernel of ``csrc/append_pairs.cu``; on a CPU tensor it runs
:func:`append_scores_prestacked_plain`; on any other device it raises.
:func:`append_scores_gathered` scores each query against its own list of
candidate rows (the device SPR pass's re-score of each query's screened
rows): on a CUDA tensor the kernel's gathered entry, on a CPU tensor the
host build of the same walk (``csrc/append_walk_host.cpp``), whose
functions are the kernel's.  Its plain PyTorch version,
:func:`append_scores_gathered_plain`, is the tests' float64 yardstick:
it costs some ten seconds a pass at 1,000 genomes, against a tenth for
the walk.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layout import (F_BL1, F_BL2, F_END, F_EPS, F_FLAG, F_HAS1, F_HAS2,
                     F_P0, F_PREV, F_RATE, F_TYPE, F_VAL, NFIELDS)
from .pack import TYPE_N, TYPE_O, TYPE_PAD, TYPE_R

# The plain version finds the contributing pairs on [k, N, B1] planes for
# a chunk of queries; the chunk is cut so that one plane holds at most
# this many elements.
_PLAIN_PLANE_ELEMS = 1 << 23


def append_scores_prestacked(Pstk, Cflat, prm, mm_flat, rf, *, uer: bool):
    """Scores [K, N] of K stacked queries against N stacked candidates.

    Pstk [N, F, B1] stacked candidate fields; Cflat [K, 1, B2 * F] stacked
    query fields; prm [K, 1, 4] per-query (blen, tip, global_tot_rate,
    tot_error); mm_flat [1, 1, 16]; rf [1, 1, 4].  All float32 or all
    float64, on one device (layout: :mod:`maple_tpu_torch.ops.layout`).
    Every row is a sorted entry list: ends never decrease and an entry
    starts where the one before it ends (a row of zeros is one).

    ``append_scores_prestacked.launches`` counts the calls that launched
    the kernel: one a call, which is two CUDA kernels (the rows' compact
    form, then the walk)."""
    device = Pstk.device
    if device.type == "cpu":
        return append_scores_prestacked_plain(Pstk, Cflat, prm, mm_flat, rf,
                                              uer=uer)
    if device.type != "cuda":
        raise ValueError(f"append_scores_prestacked: no kernel for device "
                         f"{device}")
    N, _, B1 = _check_inputs(Pstk, Cflat, prm, mm_flat, rf)
    K = Cflat.shape[0]
    B2 = Cflat.shape[-1] // NFIELDS
    out = torch.empty((K, N), dtype=Pstk.dtype, device=device)
    if out.numel() == 0:
        return out
    built = _build.library()
    n_int, n_rec = ctypes.c_longlong(), ctypes.c_longlong()
    built.lib.append_pairs_scratch(N, K, B1, B2, ctypes.byref(n_int),
                                   ctypes.byref(n_rec))
    scratch_int = torch.empty(n_int.value, dtype=torch.int32, device=device)
    scratch_rec = torch.empty(n_rec.value, dtype=Pstk.dtype, device=device)
    fn = (built.lib.append_pairs_f32 if Pstk.dtype == torch.float32
          else built.lib.append_pairs_f64)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(Pstk.data_ptr(), Cflat.data_ptr(), prm.data_ptr(),
                 mm_flat.data_ptr(), rf.data_ptr(), out.data_ptr(),
                 scratch_int.data_ptr(), scratch_rec.data_ptr(),
                 N, K, B1, B2, int(bool(uer)), stream)
    _build.check(built.lib, err, "append_pairs kernel launch")
    append_scores_prestacked.launches += 1
    return out


append_scores_prestacked.launches = 0


def append_scores_gathered(Pstk, Cflat, prm, mm_flat, rf, rows, *,
                           uer: bool):
    """Scores [K, M]: query k against candidate ``rows[k, m]``.

    The operands of :func:`append_scores_prestacked`, and ``rows`` [K, M]
    int64 on their device: a row outside [0, N) scores -inf.  The walk and
    its sums are the dense kernel's; only the pairs differ.
    ``append_scores_gathered.launches`` counts the calls that launched the
    kernel (two CUDA kernels: the rows' compact form, then the walk)."""
    device = Pstk.device
    N, _, B1 = _check_inputs(Pstk, Cflat, prm, mm_flat, rf)
    K = Cflat.shape[0]
    if rows.dtype != torch.int64 or rows.device != device \
            or tuple(rows.shape[:1]) != (K,) or rows.dim() != 2 \
            or not rows.is_contiguous():
        raise ValueError(f"rows: want a contiguous int64 [{K}, M] tensor "
                         f"on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"append_scores_gathered: no kernel for device "
                         f"{device}")
    M = rows.shape[1]
    B2 = Cflat.shape[-1] // NFIELDS
    out = torch.empty((K, M), dtype=Pstk.dtype, device=device)
    if out.numel() == 0:
        return out
    if device.type == "cpu":
        lib = _build.host_walk()
        fn = (lib.append_walk_host_gathered_f32 if Pstk.dtype == torch.float32
              else lib.append_walk_host_gathered_f64)
        fn(Pstk.data_ptr(), Cflat.data_ptr(), rows.data_ptr(),
           prm.data_ptr(), mm_flat.data_ptr(), rf.data_ptr(),
           out.data_ptr(), N, K, M, B1, B2, int(bool(uer)))
        return out
    built = _build.library()
    n_int, n_rec = ctypes.c_longlong(), ctypes.c_longlong()
    built.lib.append_pairs_scratch(N, K, B1, B2, ctypes.byref(n_int),
                                   ctypes.byref(n_rec))
    scratch_int = torch.empty(n_int.value, dtype=torch.int32, device=device)
    scratch_rec = torch.empty(n_rec.value, dtype=Pstk.dtype, device=device)
    fn = (built.lib.append_pairs_gathered_f32 if Pstk.dtype == torch.float32
          else built.lib.append_pairs_gathered_f64)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(Pstk.data_ptr(), Cflat.data_ptr(), rows.data_ptr(),
                 prm.data_ptr(), mm_flat.data_ptr(), rf.data_ptr(),
                 out.data_ptr(), scratch_int.data_ptr(),
                 scratch_rec.data_ptr(), N, K, M, B1, B2, int(bool(uer)),
                 stream)
    _build.check(built.lib, err, "append_pairs_gathered kernel launch")
    append_scores_gathered.launches += 1
    return out


append_scores_gathered.launches = 0


def _check_inputs(Pstk, Cflat, prm, mm_flat, rf):
    """Validate what the kernel takes; returns (N, F, B1)."""
    tensors = {"Pstk": Pstk, "Cflat": Cflat, "prm": prm,
               "mm_flat": mm_flat, "rf": rf}
    dtype = Pstk.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"append_scores_prestacked: dtype {dtype} "
                        f"(float32 or float64 only)")
    for name, t in tensors.items():
        if t.device != Pstk.device:
            raise ValueError(f"{name} is on {t.device}, Pstk on "
                             f"{Pstk.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, Pstk is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if Pstk.dim() != 3 or Pstk.shape[1] != NFIELDS:
        raise ValueError(f"Pstk shape {tuple(Pstk.shape)}: want [N, "
                         f"{NFIELDS}, B1]")
    K = Cflat.shape[0]
    if Cflat.dim() != 3 or Cflat.shape[1] != 1 \
            or Cflat.shape[2] % NFIELDS:
        raise ValueError(f"Cflat shape {tuple(Cflat.shape)}: want [K, 1, "
                         f"B2 * {NFIELDS}]")
    if tuple(prm.shape) != (K, 1, 4):
        raise ValueError(f"prm shape {tuple(prm.shape)}: want ({K}, 1, 4)")
    if mm_flat.numel() != 16 or rf.numel() != 4:
        raise ValueError("mm_flat must hold 16 values and rf 4")
    if K > 65535:
        raise ValueError(f"{K} queries exceed the kernel grid's y limit")
    if Pstk.numel() >= 2 ** 31 or Cflat.numel() >= 2 ** 31:
        raise ValueError("inputs too large for the kernel's int sizes")
    return Pstk.shape


def append_scores_prestacked_plain(Pstk, Cflat, prm, mm_flat, rf, *,
                                   uer: bool):
    """Plain PyTorch version of the pair kernel, term for term the
    arithmetic of ``_kernel_common`` (maple_tpu/ops/pallas_append.py).

    A loop over query entries j: for a chunk of queries, the pairs of
    entry j with every candidate entry that contribute (overlapping, not
    dead, not R/R, not the same nucleotide) are found on [k, N, B1]
    planes, and their log factors are computed on the gathered pairs and
    added to the [k, N, B1] accumulator.  Pairs that do not contribute add
    log(1) = 0 in the Pallas kernel, so the sums are the same, in the same
    order."""
    N, _, B1 = Pstk.shape
    K = Cflat.shape[0]
    B2 = Cflat.shape[-1] // NFIELDS
    dtype = Pstk.dtype
    C = Cflat.reshape(K, B2, NFIELDS)
    prm = prm.reshape(K, 4)
    mm_v = mm_flat.reshape(16)
    mm = [[mm_v[4 * i + j] for j in range(4)] for i in range(4)]
    rf_v = rf.reshape(4)
    rfl = [rf_v[q] for q in range(4)]
    planes = _CandidatePlanes(Pstk)
    active_all = _live(C[:, :, F_TYPE])                  # [K, B2]
    kc = max(1, _PLAIN_PLANE_ELEMS // max(1, N * B1))
    sums = []
    for k0 in range(0, K, kc):
        Cc = C[k0:k0 + kc]
        kn = Cc.shape[0]
        acc = torch.zeros((kn, N, B1), dtype=dtype, device=Pstk.device)
        js = active_all[k0:k0 + kc].any(0).nonzero().flatten().tolist()
        for j in js:
            ki, ni, ii = planes.contributing(Cc[:, j, :]).nonzero(
                as_tuple=True)
            if not ki.numel():
                continue
            acc[ki, ni, ii] += _pair_log_factors(
                Pstk[ni, :, ii], Cc[ki, j, :], prm[k0 + ki], mm, rfl,
                uer=uer)
        sums.append(acc.sum(-1))
    scores = torch.cat(sums, 0) if sums else \
        torch.zeros((0, N), dtype=dtype, device=Pstk.device)
    scores = scores + (prm[:, 0] * prm[:, 2])[:, None]
    if uer:
        scores = scores + (prm[:, 1] * prm[:, 3])[:, None]
    return scores


def append_scores_gathered_plain(Pstk, Cflat, prm, mm_flat, rf, rows, *,
                                 uer: bool):
    """Plain PyTorch version of the gathered entry, as the walk does it:
    for each (query, candidate) the distinct ends of the two entry lists
    cut [0, lRef] into the union segments, the merge's steps; the pair of
    entries under a segment (the first entry of each list that ends at or
    after it) is found by a sorted search, and the contributing pairs' log
    factors (:func:`_pair_log_factors`) are added up.  The sum runs in
    another order than the walk's, so scores agree to rounding."""
    N = Pstk.shape[0]
    K, M = rows.shape
    dtype = Pstk.dtype
    C = Cflat.reshape(K, -1, NFIELDS)
    prm = prm.reshape(K, 4)
    mm_v = mm_flat.reshape(16)
    mm = [[mm_v[4 * i + j] for j in range(4)] for i in range(4)]
    rf_v = rf.reshape(4)
    rfl = [rf_v[q] for q in range(4)]
    out = torch.full((K, M), float("-inf"), dtype=dtype, device=Pstk.device)
    live = (rows >= 0) & (rows < N)
    for k0, Pg, Cc, ki, mi, i, j in _gathered_pairs(Pstk, C, rows):
        kn = Cc.shape[0]
        acc = torch.zeros(kn * M, dtype=dtype, device=Pstk.device)
        if ki.numel():
            f = _pair_log_factors(Pg[ki, mi, :, i], Cc[ki, j, :],
                                  prm[k0 + ki], mm, rfl, uer=uer)
            acc.index_add_(0, ki * M + mi, f)
        pk = prm[k0:k0 + kn]
        s = acc.reshape(kn, M) + (pk[:, 0] * pk[:, 2])[:, None]
        if uer:
            s = s + (pk[:, 1] * pk[:, 3])[:, None]
        out[k0:k0 + kn] = torch.where(live[k0:k0 + kn], s, out[k0:k0 + kn])
    return out


def _gathered_pairs(Pstk, C, rows):
    """The contributing entry pairs of each (query k, candidate rows[k, m]),
    a chunk of queries at a time: yields (k0, the chunk's candidates [k, M,
    F, B1], its queries [k, B2, F], and for each pair its query, candidate,
    candidate entry and query entry).  Rows outside [0, N) give pairs that
    the caller masks."""
    N, _, B1 = Pstk.shape
    K, M = rows.shape
    B2 = C.shape[1]
    kc = max(1, (_PLAIN_PLANE_ELEMS // 2) // max(1, M * (B1 + B2)))
    for k0 in range(0, K if N else 0, kc):
        Pg = Pstk[rows[k0:k0 + kc].clamp(0, N - 1)]      # [k, M, F, B1]
        Cc = C[k0:k0 + kc]                                # [k, B2, F]
        kn = Cc.shape[0]
        p_end = Pg[:, :, F_END, :].contiguous()
        c_end = Cc[:, None, :, F_END].expand(kn, M, B2).contiguous()
        ends = torch.cat([p_end, c_end], -1).sort(-1).values
        prev = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]],
                         -1)
        i = torch.searchsorted(p_end, ends).clamp_(max=B1 - 1)
        j = torch.searchsorted(c_end, ends).clamp_(max=B2 - 1)
        tP = Pg[:, :, F_TYPE, :].gather(-1, i)
        tC = Cc[:, None, :, F_TYPE].expand(kn, M, B2).gather(-1, j)
        seg = (ends > prev) & _live(tP) & _live(tC) \
            & ~((tP == float(TYPE_R)) & (tC == float(TYPE_R))) \
            & ~((tP < 3.5) & (tP == tC))
        ki, mi, si = seg.nonzero(as_tuple=True)
        yield k0, Pg, Cc, ki, mi, i[ki, mi, si], j[ki, mi, si]


def count_gathered_contributing_pairs(Pstk, Cflat, rows) -> int:
    """How many entry pairs of the gathered (query, candidate) pairs add a
    log factor (rows outside [0, N) add none): the data-dependent work of
    one gathered call."""
    N = Pstk.shape[0]
    live = (rows >= 0) & (rows < N)
    C = Cflat.reshape(Cflat.shape[0], -1, NFIELDS)
    return sum(int(live[k0 + ki, mi].sum())
               for k0, _, _, ki, mi, _, _ in _gathered_pairs(Pstk, C, rows))


def _live(types):
    return (types != float(TYPE_N)) & (types != float(TYPE_PAD))


class _CandidatePlanes:
    """The [1, N, B1] planes of a stacked candidate tensor that decide
    which entry pairs contribute."""

    def __init__(self, Pstk):
        P = Pstk.unsqueeze(0)                       # [1, N, F, B1]
        self.types = P[:, :, F_TYPE, :]
        self.ends, self.prevs = P[:, :, F_END, :], P[:, :, F_PREV, :]
        self.is_nuc = self.types < 3.5
        self.is_R = self.types == float(TYPE_R)
        self.live = _live(self.types)

    def contributing(self, cj):
        """[k, N, B1] bool: the candidate entries whose pair with query
        entry ``cj`` [k, F] contributes (overlapping, not dead, not R/R,
        not the same nucleotide)."""
        return self._contributing(cj.reshape(cj.shape[0], 1, NFIELDS, 1))

    def contributing_paired(self, cj):
        """[1, N, B1] bool: the same for candidate i and entry ``cj[i]``
        of its own query, ``cj`` [N, F]."""
        return self._contributing(cj.reshape(1, cj.shape[0], NFIELDS, 1))

    def _contributing(self, cj):
        cC = cj[:, :, F_TYPE]
        overlap = (torch.minimum(self.ends, cj[:, :, F_END])
                   - torch.maximum(self.prevs, cj[:, :, F_PREV])) > 0.5
        return _live(cC) & overlap & self.live \
            & ~(self.is_R & (cC == float(TYPE_R))) \
            & ~(self.is_nuc & (self.types == cC))


def count_contributing_pairs(Pstk, Cflat) -> int:
    """How many (query, candidate, entry, entry) pairs of these inputs add
    a log factor: the data-dependent work of one call."""
    K = Cflat.shape[0]
    C = Cflat.reshape(K, -1, NFIELDS)
    planes = _CandidatePlanes(Pstk)
    kc = max(1, _PLAIN_PLANE_ELEMS // max(1, Pstk.shape[0] * Pstk.shape[2]))
    total = 0
    for k0 in range(0, K, kc):
        Cc = C[k0:k0 + kc]
        for j in _live(Cc[:, :, F_TYPE]).any(0).nonzero().flatten().tolist():
            total += int(planes.contributing(Cc[:, j, :]).sum())
    return total


def count_paired_contributing_pairs(Pstk, Cstk) -> int:
    """How many entry pairs of N (candidate i, query i) pairs add a log
    factor: the diagonal of :func:`count_contributing_pairs`.  Pstk [N, F,
    B1] and Cstk [N, F, B2], both stacked along ``axis=-2``."""
    planes = _CandidatePlanes(Pstk)
    live = _live(Cstk[:, F_TYPE, :]).any(0).nonzero().flatten().tolist()
    return sum(int(planes.contributing_paired(Cstk[:, :, j]).sum())
               for j in live)


def _pair_log_factors(p, c, prm, mm, rfl, *, uer: bool):
    """log(factor) of contributing entry pairs: ``p`` and ``c`` are the
    [M, F] fields of each pair's candidate and query entry, ``prm`` the
    [M, 4] parameters of its query (``_kernel_common``'s case factors, in
    the same order)."""
    dtype = p.dtype
    cP, valP = p[:, F_TYPE], p[:, F_VAL]
    blP1, blP2 = p[:, F_BL1], p[:, F_BL2]
    hasP1, hasP2 = p[:, F_HAS1] > 0.5, p[:, F_HAS2] > 0.5
    flagP = p[:, F_FLAG] > 0.5
    pP = [p[:, F_P0 + q] for q in range(4)]
    cC, valC, blC1 = c[:, F_TYPE], c[:, F_VAL], c[:, F_BL1]
    hasC1, flagC = c[:, F_HAS1] > 0.5, c[:, F_FLAG] > 0.5
    pC = [c[:, F_P0 + q] for q in range(4)]
    blen, tip = prm[:, 0], prm[:, 1]
    is_nucP = cP < 3.5
    is_R_P = cP == float(TYPE_R)
    is_O_P = cP == float(TYPE_O)
    is_nucC = cC < 3.5
    is_O_C = cC == float(TYPE_O)

    def onehot4(idx):
        return [(idx == float(q)).to(dtype) for q in range(4)]

    def mv(v):
        return [mm[q][0] * v[0] + mm[q][1] * v[1]
                + mm[q][2] * v[2] + mm[q][3] * v[3] for q in range(4)]

    def evolve_down(base, t_eff):
        m = mv(base)
        out = [base[q] + t_eff * m[q] for q in range(4)]
        bad = (out[0] < 0) | (out[1] < 0) | (out[2] < 0) | (out[3] < 0)
        return [torch.where(bad, 0.25, out[q]) for q in range(4)]

    def dot4(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]

    def root4(a, b):
        return (a[0] * b[0] * rfl[0] + a[1] * b[1] * rfl[1]
                + a[2] * b[2] * rfl[2] + a[3] * b[3] * rfl[3])

    # per-position model state: position = min(ends) - 1
    p_side = p[:, F_END] <= c[:, F_END]
    rate = torch.where(p_side, p[:, F_RATE], c[:, F_RATE])
    eps = torch.where(p_side, p[:, F_EPS], c[:, F_EPS]) if uer \
        else torch.zeros_like(rate)
    contrib = blen \
        + torch.where(is_O_P, torch.where(hasP1, blP1, 0.0),
                      torch.where(hasP2, blP2,
                                  torch.where(hasP1, blP1, 0.0))) \
        + torch.where(hasC1, blC1, 0.0)

    refn = torch.where(is_R_P, valC, valP)
    h1 = onehot4(torch.where(is_nucP, cP, refn))
    h2 = onehot4(torch.where(is_nucC, cC, refn))
    if uer:
        fCh = ((tip > 0.5) | flagC).to(dtype)
        fPh = flagP.to(dtype)
    else:
        fCh = torch.zeros_like(rate)
        fPh = torch.zeros_like(rate)

    t_eff = contrib * rate
    pos_t = contrib > 0
    # C is O: evolve its explicit 4-vector down contrib
    evC_O_raw = evolve_down(pC, t_eff)
    evC_O = [torch.where(pos_t, evC_O_raw[q], pC[q]) for q in range(4)]
    # C is concrete: evolve its (error-adjusted) one-hot
    e3 = 0.33333 * eps
    baseC = [fCh * (h2[q] * (1.0 - eps - e3) + e3) + (1.0 - fCh) * h2[q]
             for q in range(4)]
    evC_nuc = evolve_down(baseC, t_eff)
    # P root-side half branch (two-length entries)
    baseP = [fPh * (h1[q] * (1.0 - eps - e3) + e3) + (1.0 - fPh) * h1[q]
             for q in range(4)]
    evP_root = evolve_down(baseP, blP1 * rate)

    rf_i1 = dot4(h1, rfl)
    m_i1_i2 = rate * dot4(h1, mv(h2))

    # --- case factors (same ordering as the Pallas kernel) ---
    pcs_i1 = dot4(h1, pC)
    simple_CO = torch.where(pos_t, dot4(h1, evC_O), pcs_i1)
    root_CO = root4(evC_O, evP_root) / rf_i1
    f_CO = torch.where(pcs_i1 > 0.02, pcs_i1,
                       torch.where(hasP2, root_CO, simple_CO))

    base_nn = torch.clamp(m_i1_i2 * contrib, max=0.25)
    not_R = torch.where(is_R_P, 0.0, 1.0).to(dtype)
    plain_nn = base_nn + (fPh * not_R + fCh) * 0.33333 * eps
    plain_rn = base_nn + fCh * 0.33333 * eps
    root_nn = root4(evC_nuc, evP_root) / rf_i1
    f_nn = torch.where(hasP2, root_nn,
                       torch.where(is_R_P, plain_rn, plain_nn))

    f_OO = dot4(pP, evC_O)
    pps_i2 = dot4(h2, pP)
    f_On = torch.where(pps_i2 > 0.02, pps_i2, dot4(pP, evC_nuc))

    fac = torch.where(is_O_P & is_O_C, f_OO,
                      torch.where(is_O_P, f_On,
                                  torch.where(is_O_C, f_CO, f_nn)))
    return torch.where(fac > 0, torch.log(torch.clamp(fac, min=1e-300)),
                       float("-inf"))


# ----------------------------------------------------------------------
# packed-dict entry points (twins of pallas_grid_append_scores{,_var} and
# pallas_batched_append_scores).  They stack both dicts for every call:
# for tests and one-off scoring; a placer keeps its pool stacked on the
# device and calls append_scores_prestacked.

def stack_fields(X: dict, site_rates, error_rates, axis: int):
    """A packed field dict of tensors in the kernel's NFIELDS layout, on
    the tables' device and in their float type: the torch form of
    ``stack_fields_host`` (``axis=-2`` candidates ``[N, F, B]``,
    ``axis=-1`` queries ``[..., B, F]``)."""
    dtype, device = site_rates.dtype, site_rates.device
    ends = X["ends"].to(device=device, dtype=torch.long)
    pos = (ends - 1).clamp_(min=0)
    prev = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]],
                     dim=-1)
    probs = X["probs"]
    fields = [X["types"], X["vals"], X["bl1"], X["bl2"], X["has_bl1"],
              X["has_bl2"], X["flags"], probs[..., 0], probs[..., 1],
              probs[..., 2], probs[..., 3], ends, prev, site_rates[pos],
              error_rates[pos], torch.zeros_like(ends)]
    return torch.stack([f.to(device=device, dtype=dtype) for f in fields],
                       dim=axis)


def _grid_scores(P: dict, C: dict, blen, tip, dm):
    dtype = dm.mut_matrix.dtype
    device = dm.mut_matrix.device
    Pstk = stack_fields(P, dm.site_rates, dm.error_rates, -2)
    Cstk = stack_fields(C, dm.site_rates, dm.error_rates, -1)
    if Cstk.dim() == 2:
        Cstk = Cstk[None]
    K, B2, _ = Cstk.shape
    Cflat = Cstk.reshape(K, 1, B2 * NFIELDS)
    blen_k = torch.as_tensor(blen, dtype=dtype, device=device) \
        .reshape(-1).expand(K)
    tip_k = torch.as_tensor(tip, dtype=dtype, device=device) \
        .reshape(-1).expand(K)
    prm = torch.stack([blen_k, tip_k,
                       dm.global_tot_rate.expand(K),
                       dm.tot_error.expand(K)], dim=-1) \
        .reshape(K, 1, 4).contiguous()
    return append_scores_prestacked(
        Pstk, Cflat, prm, dm.mut_matrix.reshape(1, 1, 16).contiguous(),
        dm.root_freqs.reshape(1, 1, 4).contiguous(),
        uer=dm.using_error_rate)


def grid_append_scores(P: dict, C: dict, blen: float, tip_c: bool, dm):
    """Scores [K, N] for K packed queries against N packed candidate
    uppers, every query at branch length ``blen`` and tip flag ``tip_c``:
    the twin of ``pallas_grid_append_scores``."""
    return _grid_scores(P, C, float(blen), float(tip_c), dm)


def batched_append_scores(P: dict, C: dict, blen: float, tip_c: bool, dm):
    """Scores [N] for one packed query (a dict of ``[B2]`` or ``[1, B2]``
    fields) against N packed candidate uppers: the twin of
    ``pallas_batched_append_scores``."""
    return grid_append_scores(P, C, blen, tip_c, dm)[0]


def grid_append_scores_var(P: dict, C: dict, blens, tips, dm):
    """Scores [K, N] with a branch length and tip flag per query: the twin
    of ``pallas_grid_append_scores_var``."""
    return _grid_scores(P, C, torch.as_tensor(blens),
                        torch.as_tensor(tips).to(torch.float64), dm)
