"""Exact host-side genome-list kernels.

These are the scalar (per-merge) semantics of the framework's numeric layer:
``merge_vectors`` (reference mergeVectors :4446-4859), ``append_prob_node``
(:6505-6785), ``estimate_branch_length`` (:5040-5358), ``root_vector_frame`` /
``find_prob_root_frame`` (:4865-4996), ``are_vectors_different`` (:5419-5472),
``is_minor_sequence`` (:5919-6004) and ``update_pseudo_counts`` (:5002-5035).

They define the numerics that the batched TPU kernels in
:mod:`maple_tpu_torch.ops` must reproduce, and serve as the host fallback for
operations too small to ship to the device.  Tuple layouts and threshold
behavior match the reference exactly so that golden outputs are reproducible
(see tests/test_kernels_vs_reference.py for the differential fuzz harness).

Likelihood model notes: propagation along a branch of length t uses the
first-order expansion v + t*Qv (not expm — reference getPartialVec
:4073-4141); the total log-likelihood carries a running product
``totalFactor`` that is absorbed into the log when it underflows below
``minimum_carry_over`` (reference :4830-4839).
"""
from __future__ import annotations

import sys
from math import log
from typing import List, Optional, Sequence, Tuple

from ..config import DerivedConfig
from ..refdata import Model, RefData
from .genomelist import GenomeList, TYPE_N, TYPE_O, TYPE_R, simplify

RANGE4 = (0, 1, 2, 3)
FLOAT_MIN = sys.float_info.min


class MergeUnderflow(Exception):
    """A merge/score product underflowed to an impossible likelihood."""


class KernelCtx:
    """Flat bundle of everything the kernels read, bound once per model
    version for cheap attribute access in the hot host loops."""

    __slots__ = (
        "lRef", "threshold_prob", "threshold_prob4", "minimum_carry_over",
        "global_tot_rate", "root_freqs", "root_freqs_log", "cumulative_bases",
        "mut_matrix", "mut_matrices", "use_rate_variation", "cumulative_rate",
        "using_error_rate", "error_rate_site_specific", "error_rate",
        "error_rates", "cumulative_error_rate", "tot_error",
        "root_freqs_log_error_cumulative", "min_blen_sensitivity",
        "threshold_diff_update", "threshold_fold_change_update",
        "model_version",
    )

    def __init__(self, refd: RefData, model: Model, dc: DerivedConfig):
        self.lRef = refd.lRef
        self.threshold_prob = dc.thresholdProb
        self.threshold_prob4 = dc.thresholdProb4
        self.minimum_carry_over = dc.minimumCarryOver
        self.global_tot_rate = dc.globalTotRate
        self.min_blen_sensitivity = dc.minBLenSensitivity
        self.threshold_diff_update = dc.thresholdDiffForUpdate
        self.threshold_fold_change_update = dc.thresholdFoldChangeUpdate
        self.root_freqs = refd.root_freqs
        self.root_freqs_log = refd.root_freqs_log
        self.cumulative_bases = refd.cumulative_bases
        self.mut_matrix = model.mut_matrix
        self.mut_matrices = model.mut_matrices
        self.use_rate_variation = model.use_rate_variation
        self.cumulative_rate = model.cumulative_rate
        self.using_error_rate = model.using_error_rate
        self.error_rate_site_specific = model.error_rate_site_specific
        self.error_rate = model.error_rate
        self.error_rates = model.error_rates
        self.cumulative_error_rate = model.cumulative_error_rate
        self.tot_error = model.tot_error
        self.root_freqs_log_error_cumulative = (
            model.root_freqs_log_error_cumulative)
        self.model_version = model.version


def get_partial_vec(i12: int, tot_len: float, mm, eps: float,
                    vect=None, up_node: bool = False, flag: bool = False):
    """Evolve one site's likelihood 4-vector along a branch: v + t*Qv
    (column form when the observation is below, row form when above), with
    optional error-prone-tip emission [1-eps, eps/3, eps/3, eps/3]
    (reference getPartialVec :4073-4141).  Negative components (possible with
    the first-order expansion at long t) collapse to the uniform vector."""
    if i12 == 6:
        if not tot_len:
            return list(vect)
        out = []
        if up_node:
            for i in RANGE4:
                tot = (mm[0][i] * vect[0] + mm[1][i] * vect[1]
                       + mm[2][i] * vect[2] + mm[3][i] * vect[3]) * tot_len \
                    + vect[i]
                if tot < 0:
                    return [0.25, 0.25, 0.25, 0.25]
                out.append(tot)
        else:
            for i in RANGE4:
                row = mm[i]
                tot = (row[0] * vect[0] + row[1] * vect[1] + row[2] * vect[2]
                       + row[3] * vect[3]) * tot_len + vect[i]
                if tot < 0:
                    return [0.25, 0.25, 0.25, 0.25]
                out.append(tot)
        return out
    if flag:
        base = [eps * 0.33333] * 4
        base[i12] = 1.0 - eps
        if not tot_len:
            return base
        out = []
        for j in RANGE4:
            row = mm[j]
            tot = (row[0] * base[0] + row[1] * base[1] + row[2] * base[2]
                   + row[3] * base[3]) * tot_len + base[j]
            if tot < 0:
                return [0.25, 0.25, 0.25, 0.25]
            out.append(tot)
        return out
    if not tot_len:
        out = [0.0, 0.0, 0.0, 0.0]
        out[i12] = 1.0
        return out
    if up_node:
        out = [mm[i12][i] * tot_len for i in RANGE4]
    else:
        out = [mm[i][i12] * tot_len for i in RANGE4]
    out[i12] += 1.0
    if out[i12] < 0:
        return [0.25, 0.25, 0.25, 0.25]
    return out


def merge_vectors(ctx: KernelCtx, v1: GenomeList, bl1: float, tip1: bool,
                  v2: GenomeList, bl2: float, tip2: bool,
                  return_lk: bool = False, is_up_down: bool = False,
                  n_minor1: int = 0, n_minor2: int = 0):
    """Fuse two genome lists separated by branch lengths bl1/bl2.

    - ``is_up_down=False``: child lower x child lower -> parent lower.
    - ``is_up_down=True``: upper (v1) x lower (v2) -> upper/total vector.

    With ``return_lk`` also returns the log-likelihood contribution of the
    merge (used for full-tree likelihoods).  Returns None when two
    incompatible entries meet at total distance 0 (caller repairs the branch
    length — reference :4753-4758).
    """
    uer = ctx.using_error_rate
    site_err = ctx.error_rate_site_specific
    err_rates = ctx.error_rates
    err = ctx.error_rate
    rate_var = ctx.use_rate_variation
    mms = ctx.mut_matrices
    mm = ctx.mut_matrix
    lRef = ctx.lRef
    root_freqs = ctx.root_freqs
    tp, tp4 = ctx.threshold_prob, ctx.threshold_prob4
    if return_lk:
        cum_rate = ctx.cumulative_rate
        cum_err = ctx.cumulative_error_rate
        lk = (bl1 + bl2) * ctx.global_tot_rate
        if uer:
            if tip1 or n_minor1:
                lk += ctx.tot_error * (1 + n_minor1)
            if tip2 or n_minor2:
                lk += ctx.tot_error * (1 + n_minor2)
    else:
        lk = 0.0
    i1idx = i2idx = 0
    pos = 0
    tot_factor = 1.0
    out: GenomeList = []
    e1 = v1[0]
    e2 = v2[0]
    while True:
        c1 = e1[0]
        c2 = e2[0]
        if c1 == TYPE_N:
            if c2 == TYPE_N:
                new_pos = min(e1[1], e2[1])
                out.append((TYPE_N, new_pos))
            elif c2 < TYPE_R:
                new_pos = pos + 1
                _emit_survivor_lower(out, e2, e2[1], bl2, tip2, is_up_down, uer)
            elif c2 == TYPE_R:
                new_pos = min(e1[1], e2[1])
                _emit_survivor_lower(out, e2, new_pos, bl2, tip2, is_up_down,
                                     uer)
            else:  # O survives against N
                new_pos = pos + 1
                if is_up_down:
                    mmx = mms[pos] if rate_var else mm
                    tot_b = bl2 + (e2[2] if len(e2) > 3 else 0.0)
                    if tot_b:
                        nv = get_partial_vec(6, tot_b, mmx, 0, vect=e2[-1])
                    else:
                        nv = list(e2[-1])
                    nv = [nv[0] * root_freqs[0], nv[1] * root_freqs[1],
                          nv[2] * root_freqs[2], nv[3] * root_freqs[3]]
                    s = sum(nv)
                    out.append((TYPE_O, e2[1],
                                [nv[0] / s, nv[1] / s, nv[2] / s, nv[3] / s]))
                else:
                    if len(e2) > 3:
                        out.append((TYPE_O, e2[1], e2[2] + bl2, e2[3]))
                    elif bl2:
                        out.append((TYPE_O, e2[1], bl2, e2[2]))
                    else:
                        out.append((TYPE_O, e2[1], e2[2]))
            if return_lk:
                lk += (bl1 + bl2) * (cum_rate[pos] - cum_rate[new_pos])
                if uer and (tip1 or tip2):
                    ce = ((cum_err[new_pos] - cum_err[pos]) if site_err
                          else err * (new_pos - pos))
                    if tip1:
                        lk += ce
                    if tip2:
                        lk += ce
            pos = new_pos
        elif c2 == TYPE_N:
            if c1 < TYPE_N:
                if c1 < TYPE_R:
                    new_pos = pos + 1
                    new_el = e1[1]
                else:
                    new_pos = min(e1[1], e2[1])
                    new_el = new_pos
                _emit_survivor_upper(out, e1, new_el, bl1, tip1, is_up_down,
                                     uer)
            else:  # O survives against N
                new_pos = pos + 1
                if is_up_down and ((len(e1) == 4 and e1[2] > 0) or bl1):
                    mmx = mms[pos] if rate_var else mm
                    tot_b = bl1 + (e1[2] if len(e1) > 3 else 0.0)
                    if tot_b:
                        nv = get_partial_vec(6, tot_b, mmx, 0, vect=e1[-1],
                                             up_node=True)
                    else:
                        nv = list(e1[-1])
                    s = sum(nv)
                    out.append((TYPE_O, e1[1],
                                [nv[0] / s, nv[1] / s, nv[2] / s, nv[3] / s]))
                else:
                    if len(e1) > 3:
                        out.append((TYPE_O, e1[1], e1[2] + bl1, e1[3]))
                    elif bl1:
                        out.append((TYPE_O, e1[1], bl1, e1[2]))
                    else:
                        out.append((TYPE_O, e1[1], e1[2]))
            if return_lk:
                lk += (bl1 + bl2) * (cum_rate[pos] - cum_rate[new_pos])
                if uer and (tip1 or tip2):
                    ce = ((cum_err[new_pos] - cum_err[pos]) if site_err
                          else err * (new_pos - pos))
                    if tip1:
                        lk += ce
                    if tip2:
                        lk += ce
            pos = new_pos
        else:
            # both carry information at this segment
            tot_len1 = bl1
            if c1 == TYPE_O:
                if len(e1) > 3:
                    tot_len1 += e1[2]
            else:
                if len(e1) > 2 + uer:
                    tot_len1 += e1[2]
                    if len(e1) > 3 + uer:
                        tot_len1 += e1[3]
            tot_len2 = bl2
            if len(e2) > (2 + (uer or c2 == TYPE_O)):
                tot_len2 += e2[2]
            flag1 = (uer and c1 != TYPE_O
                     and ((len(e1) > 2 and e1[-1]) or tip1))
            flag2 = (uer and c2 != TYPE_O
                     and ((len(e2) > 2 and e2[-1]) or tip2))
            if c1 == TYPE_R and c2 == TYPE_R:
                new_pos = min(e1[1], e2[1])
            else:
                new_pos = pos + 1

            if return_lk:
                if c1 == TYPE_R and c2 == TYPE_R:
                    # within-entry branch lengths contribute extra
                    # non-mutation probability over the run
                    if tot_len2 > bl2 or tot_len1 > bl1:
                        lk += ((tot_len2 - bl2 + tot_len1 - bl1)
                               * (cum_rate[new_pos] - cum_rate[pos]))
                        if uer and (((not tip1) and flag1)
                                    or ((not tip2) and flag2)):
                            ce = ((cum_err[pos] - cum_err[new_pos])
                                  if site_err else err * (pos - new_pos))
                            if (not tip1) and flag1:
                                lk += ce
                            if (not tip2) and flag2:
                                lk += ce
                else:
                    # remove the pre-counted whole-genome non-mutation
                    # contribution for this (mutated) position
                    ref_nuc = e1[1] if c1 != TYPE_R else e2[1]
                    mmx = mms[pos] if rate_var else mm
                    lk -= mmx[ref_nuc][ref_nuc] * (bl2 + bl1)
                    if uer and ((c1 != c2) or c1 == TYPE_O) and (tip1 or tip2):
                        ce = err_rates[pos] if site_err else err
                        if tip1:
                            lk += ce
                        if tip2:
                            lk += ce

            if c2 == c1 and c2 < TYPE_N:
                # identical concrete states: merged evidence is exact
                if c1 == TYPE_R:
                    out.append((TYPE_R, new_pos))
                else:
                    out.append((c1, e1[1]))
                    if return_lk:
                        mmx = mms[pos] if rate_var else mm
                        lk += mmx[c1][c1] * (tot_len1 + tot_len2)
                        if uer and (((not tip1) and flag1)
                                    or ((not tip2) and flag2)):
                            ce = err_rates[pos] if site_err else err
                            if (not tip1) and flag1:
                                lk -= ce
                            if (not tip2) and flag2:
                                lk -= ce
            elif (not tot_len1) and (not tot_len2) and c1 < TYPE_N \
                    and c2 < TYPE_N and (not flag1) and (not flag2):
                # different concrete states at total distance 0: impossible
                if return_lk:
                    raise MergeUnderflow("impossible 0-length merge with LK")
                return None
            else:
                eps = (err_rates[pos] if (uer and site_err) else err)
                mmx = mms[pos] if rate_var else mm
                if c1 == TYPE_R:
                    ref_nuc = e2[1]
                    i1n = ref_nuc
                else:
                    ref_nuc = e1[1]
                    i1n = c1
                if i1n <= 4:
                    if tot_len1 or flag1:
                        if is_up_down and len(e1) > 3 + uer:
                            # root-crossing upper entry: evolve down to the
                            # root, weight by root freqs, then evolve up
                            nv = get_partial_vec(i1n, e1[2], mmx, eps,
                                                 flag=flag1)
                            nv = [nv[0] * root_freqs[0],
                                  nv[1] * root_freqs[1],
                                  nv[2] * root_freqs[2],
                                  nv[3] * root_freqs[3]]
                            if e1[3] + bl1:
                                nv = get_partial_vec(6, e1[3] + bl1, mmx, 0,
                                                     vect=nv, up_node=True)
                        else:
                            nv = get_partial_vec(i1n, tot_len1, mmx, eps,
                                                 flag=flag1,
                                                 up_node=is_up_down)
                    else:
                        nv = [0.0, 0.0, 0.0, 0.0]
                        nv[i1n] = 1.0
                else:  # c1 is O
                    if tot_len1:
                        nv = get_partial_vec(6, tot_len1, mmx, 0, vect=e1[-1],
                                             up_node=is_up_down)
                    else:
                        nv = list(e1[-1])
                i2n = ref_nuc if c2 == TYPE_R else c2
                if i2n == TYPE_O:
                    if tot_len2:
                        nv2 = get_partial_vec(6, tot_len2, mmx, 0,
                                              vect=e2[-1])
                    else:
                        nv2 = e2[-1]
                else:
                    if tot_len2 or flag2:
                        nv2 = get_partial_vec(i2n, tot_len2, mmx, eps,
                                              flag=flag2)
                    else:
                        nv2 = [0.0, 0.0, 0.0, 0.0]
                        nv2[i2n] = 1.0
                nv = [nv[0] * nv2[0], nv[1] * nv2[1], nv[2] * nv2[2],
                      nv[3] * nv2[3]]
                s = sum(nv)
                if not s:
                    if return_lk:
                        raise MergeUnderflow("zero-probability merge with LK")
                    return None
                nv = [nv[0] / s, nv[1] / s, nv[2] / s, nv[3] / s]
                state = simplify(nv, ref_nuc, tp, tp4)
                if state == TYPE_O:
                    out.append((TYPE_O, ref_nuc, nv))
                elif state == TYPE_R:
                    out.append((TYPE_R, new_pos))
                else:
                    out.append((state, ref_nuc))
                if return_lk:
                    tot_factor *= s
            pos = new_pos

        if return_lk and tot_factor <= ctx.minimum_carry_over:
            if tot_factor < FLOAT_MIN:
                raise MergeUnderflow("totalFactor underflow in merge")
            lk += log(tot_factor)
            tot_factor = 1.0
        if pos == lRef:
            break
        if c1 < TYPE_R or c1 == TYPE_O:
            i1idx += 1
            e1 = v1[i1idx]
        elif pos == e1[1]:
            i1idx += 1
            e1 = v1[i1idx]
        if c2 < TYPE_R or c2 == TYPE_O:
            i2idx += 1
            e2 = v2[i2idx]
        elif pos == e2[1]:
            i2idx += 1
            e2 = v2[i2idx]

    if return_lk:
        return out, lk + log(tot_factor)
    return out


def _emit_survivor_lower(out, e, new_el, blen, from_tip, is_up_down, uer):
    """Append a lower-side nuc/R entry that met an N region (reference
    :4501-4548).  In an upper/total merge the surviving lower observation
    crosses the root at distance 0, hence the explicit 0.0 second length."""
    c = e[0]
    n = len(e)
    if is_up_down:
        if uer:
            if n == 2:
                if blen or from_tip:
                    out.append((c, new_el, blen, 0.0, from_tip))
                else:
                    out.append((c, new_el))
            elif n == 3:
                out.append((c, new_el, blen, 0.0, e[2]))
            else:
                out.append((c, new_el, e[2] + blen, 0.0, e[-1]))
        else:
            if n > 2:
                out.append((c, new_el, e[2] + blen, 0.0))
            elif blen:
                out.append((c, new_el, blen, 0.0))
            else:
                out.append((c, new_el))
    else:
        if uer:
            if n == 2:
                if blen or from_tip:
                    out.append((c, new_el, blen, from_tip))
                else:
                    out.append((c, new_el))
            elif n == 3:
                if blen:
                    out.append((c, new_el, blen, e[2]))
                else:
                    out.append((c, new_el, e[2]))
            else:
                out.append((c, new_el, e[2] + blen, e[-1]))
        else:
            if n > 2:
                out.append((c, new_el, e[2] + blen))
            elif blen:
                out.append((c, new_el, blen))
            else:
                out.append((c, new_el))


def _emit_survivor_upper(out, e, new_el, blen, from_tip, is_up_down, uer):
    """Append an upper-side nuc/R entry that met an N region (reference
    :4592-4643).  Root-crossing entries extend their root-side length."""
    c = e[0]
    n = len(e)
    if is_up_down:
        if uer:
            if n == 2:
                if blen:
                    out.append((c, new_el, blen, False))
                else:
                    out.append((c, new_el))
            elif n == 3:
                out.append((c, new_el, blen, e[2]))
            elif n == 4:
                out.append((c, new_el, e[2] + blen, e[3]))
            else:
                out.append((c, new_el, e[2], e[3] + blen, e[4]))
        else:
            if n == 2:
                if blen:
                    out.append((c, new_el, blen))
                else:
                    out.append((c, new_el))
            elif n == 3:
                out.append((c, new_el, e[2] + blen))
            else:
                out.append((c, new_el, e[2], e[3] + blen))
    else:
        if uer:
            if n == 2:
                if blen or from_tip:
                    out.append((c, new_el, blen, from_tip))
                else:
                    out.append((c, new_el))
            elif n == 3:
                if blen:
                    out.append((c, new_el, blen, e[2]))
                else:
                    out.append((c, new_el, e[2]))
            else:
                out.append((c, new_el, e[2] + blen, e[3]))
        else:
            if n > 2:
                out.append((c, new_el, e[2] + blen))
            elif blen:
                out.append((c, new_el, blen))
            else:
                out.append((c, new_el))


def append_prob_node(ctx: KernelCtx, vP: GenomeList, vC: GenomeList,
                     is_tip_c: bool, blen: float) -> float:
    """Relative log-likelihood cost of attaching child list vC below upper
    list vP at distance blen, skipping contributions shared by all candidate
    placements (reference appendProbNode :6505-6785).  Returns -inf for
    impossible 0-length attachments."""
    uer = ctx.using_error_rate
    site_err = ctx.error_rate_site_specific
    err_rates = ctx.error_rates
    err = ctx.error_rate
    rate_var = ctx.use_rate_variation
    mms = ctx.mut_matrices
    mm = ctx.mut_matrix
    lRef = ctx.lRef
    root_freqs = ctx.root_freqs
    min_carry = ctx.minimum_carry_over
    i1idx = i2idx = 0
    tot_factor = 1.0
    pos = 0
    e1 = vP[0]
    e2 = vC[0]
    lk = blen * ctx.global_tot_rate
    if uer and is_tip_c:
        lk += ctx.tot_error
    while True:
        c1 = e1[0]
        c2 = e2[0]
        if c2 == TYPE_N:
            if c1 == TYPE_R or c1 == TYPE_N:
                pos = min(e1[1], e2[1])
                if pos == lRef:
                    break
                if e1[1] == pos:
                    i1idx += 1
                    e1 = vP[i1idx]
            else:
                pos += 1
                if pos == lRef:
                    break
                i1idx += 1
                e1 = vP[i1idx]
            if e2[1] == pos:
                i2idx += 1
                e2 = vC[i2idx]
        elif c1 == TYPE_N:
            # contributions under a parent-side N cancel between placements
            if c2 == TYPE_R:
                pos = min(e1[1], e2[1])
                if pos == lRef:
                    break
                if e2[1] == pos:
                    i2idx += 1
                    e2 = vC[i2idx]
            else:
                pos += 1
                if pos == lRef:
                    break
                i2idx += 1
                e2 = vC[i2idx]
            if e1[1] == pos:
                i1idx += 1
                e1 = vP[i1idx]
        else:
            if c1 != c2 or c1 == TYPE_O:
                contrib = blen
                if c1 < TYPE_N:
                    if len(e1) == 3 + uer:
                        contrib += e1[2]
                    elif len(e1) == 4 + uer:
                        contrib += e1[3]
                elif len(e1) == 4:
                    contrib += e1[2]
                if c2 < TYPE_N:
                    if len(e2) == 3 + uer:
                        contrib += e2[2]
                elif len(e2) == 4:
                    contrib += e2[2]

            if c1 == TYPE_R:
                if c2 == TYPE_R:
                    pos = min(e1[1], e2[1])
                    if pos == lRef:
                        break
                    if e2[1] == pos:
                        i2idx += 1
                        e2 = vC[i2idx]
                elif c2 == TYPE_O:
                    mmx = mms[pos] if rate_var else mm
                    i1n = e2[1]
                    if e2[-1][i1n] > 0.02:
                        tot_factor *= e2[-1][i1n]
                    else:
                        if len(e1) == 4 + uer:
                            flag1 = uer and len(e1) > 2 and e1[-1]
                            eps = err_rates[pos] if (uer and site_err) else err
                            t3 = get_partial_vec(6, contrib, mmx, None,
                                                 vect=e2[-1])
                            t2 = get_partial_vec(i1n, e1[2], mmx, eps,
                                                 flag=flag1)
                            tot = (t3[0] * t2[0] * root_freqs[0]
                                   + t3[1] * t2[1] * root_freqs[1]
                                   + t3[2] * t2[2] * root_freqs[2]
                                   + t3[3] * t2[3] * root_freqs[3])
                            tot /= root_freqs[i1n]
                        else:
                            if contrib:
                                t3 = get_partial_vec(6, contrib, mmx, None,
                                                     vect=e2[-1])
                                tot = t3[i1n]
                            else:
                                tot = e2[-1][i1n]
                        tot_factor *= tot
                    pos += 1
                    if pos == lRef:
                        break
                    i2idx += 1
                    e2 = vC[i2idx]
                else:
                    # R parent vs concrete different child nucleotide
                    flag2 = uer and (is_tip_c or (len(e2) > 2) and e2[-1])
                    mmx = mms[pos] if rate_var else mm
                    if len(e1) == 4 + uer:
                        flag1 = uer and len(e1) > 2 and e1[-1]
                        i1n = e2[1]
                        i2n = e2[0]
                        eps = err_rates[pos] if (uer and site_err) else err
                        t3 = get_partial_vec(i2n, contrib, mmx, eps,
                                             flag=flag2)
                        t2 = get_partial_vec(i1n, e1[2], mmx, eps, flag=flag1)
                        tot = (t3[0] * t2[0] * root_freqs[0]
                               + t3[1] * t2[1] * root_freqs[1]
                               + t3[2] * t2[2] * root_freqs[2]
                               + t3[3] * t2[3] * root_freqs[3])
                        tot_factor *= tot / root_freqs[i1n]
                    else:
                        if flag2:
                            eps = err_rates[pos] if (uer and site_err) else err
                            tot_factor *= (min(0.25, mmx[e2[1]][e2[0]]
                                               * contrib) + eps * 0.33333)
                        else:
                            if contrib:
                                tot_factor *= min(0.25, mmx[e2[1]][e2[0]]
                                                  * contrib)
                            else:
                                return float("-inf")
                    pos += 1
                    if pos == lRef:
                        break
                    i2idx += 1
                    e2 = vC[i2idx]
                if e1[1] == pos:
                    i1idx += 1
                    e1 = vP[i1idx]
            elif c1 == TYPE_O:
                mmx = mms[pos] if rate_var else mm
                if c2 == TYPE_O:
                    if contrib:
                        t3 = get_partial_vec(6, contrib, mmx, None,
                                             vect=e2[-1])
                        tot = (e1[-1][0] * t3[0] + e1[-1][1] * t3[1]
                               + e1[-1][2] * t3[2] + e1[-1][3] * t3[3])
                    else:
                        tot = (e1[-1][0] * e2[-1][0] + e1[-1][1] * e2[-1][1]
                               + e1[-1][2] * e2[-1][2] + e1[-1][3] * e2[-1][3])
                    tot_factor *= tot
                else:
                    i2n = e1[1] if c2 == TYPE_R else c2
                    if e1[-1][i2n] > 0.02:
                        tot_factor *= e1[-1][i2n]
                    else:
                        if uer and (is_tip_c or (len(e2) > 2) and e2[-1]):
                            eps = err_rates[pos] if site_err else err
                            t3 = get_partial_vec(i2n, contrib, mmx, eps,
                                                 flag=True)
                        else:
                            t3 = get_partial_vec(i2n, contrib, mmx, None,
                                                 flag=False)
                        tot = (e1[-1][0] * t3[0] + e1[-1][1] * t3[1]
                               + e1[-1][2] * t3[2] + e1[-1][3] * t3[3])
                        tot_factor *= tot
                pos += 1
                if pos == lRef:
                    break
                i1idx += 1
                e1 = vP[i1idx]
                if c2 != TYPE_R or e2[1] == pos:
                    i2idx += 1
                    e2 = vC[i2idx]
            else:
                # parent is a concrete non-reference nucleotide
                if c2 != c1:
                    flag1 = uer and (len(e1) > 2) and e1[-1]
                    mmx = mms[pos] if rate_var else mm
                    i1n = c1
                    if c2 < TYPE_N:
                        i2n = e1[1] if c2 == TYPE_R else c2
                        flag2 = uer and (is_tip_c or (len(e2) > 2) and e2[-1])
                        if len(e1) == 4 + uer:
                            eps = err_rates[pos] if (uer and site_err) else err
                            t3 = get_partial_vec(i2n, contrib, mmx, eps,
                                                 flag=flag2)
                            t2 = get_partial_vec(i1n, e1[2], mmx, eps,
                                                 flag=flag1)
                            tot = (root_freqs[0] * t3[0] * t2[0]
                                   + root_freqs[1] * t3[1] * t2[1]
                                   + root_freqs[2] * t3[2] * t2[2]
                                   + root_freqs[3] * t3[3] * t2[3])
                            tot_factor *= tot / root_freqs[i1n]
                        else:
                            if flag1 or flag2:
                                eps = (err_rates[pos]
                                       if (uer and site_err) else err)
                                tot_factor *= (min(0.25, mmx[i1n][i2n]
                                                   * contrib)
                                               + (flag1 + flag2)
                                               * 0.33333 * eps)
                            else:
                                if contrib:
                                    tot_factor *= min(0.25, mmx[i1n][i2n]
                                                      * contrib)
                                else:
                                    return float("-inf")
                    else:
                        # child is O
                        eps = err_rates[pos] if (uer and site_err) else err
                        if e2[-1][i1n] > 0.02:
                            tot_factor *= e2[-1][i1n]
                        else:
                            if len(e1) == 4 + uer:
                                t2 = get_partial_vec(i1n, e1[2], mmx, eps,
                                                     flag=flag1)
                                t3 = get_partial_vec(6, contrib, mmx, eps,
                                                     vect=e2[-1])
                                tot = (t2[0] * t3[0] * root_freqs[0]
                                       + t2[1] * t3[1] * root_freqs[1]
                                       + t2[2] * t3[2] * root_freqs[2]
                                       + t2[3] * t3[3] * root_freqs[3])
                                tot_factor *= tot / root_freqs[i1n]
                            else:
                                if contrib:
                                    t3 = get_partial_vec(6, contrib, mmx,
                                                         None, vect=e2[-1])
                                    tot_factor *= t3[i1n]
                                else:
                                    tot_factor *= e2[-1][i1n]
                pos += 1
                if pos == lRef:
                    break
                i1idx += 1
                e1 = vP[i1idx]
                if c2 != TYPE_R or e2[1] == pos:
                    i2idx += 1
                    e2 = vC[i2idx]

        if tot_factor <= min_carry:
            if tot_factor < FLOAT_MIN:
                return float("-inf")
            lk += log(tot_factor)
            tot_factor = 1.0

    return lk + log(tot_factor)


def estimate_branch_length(ctx: KernelCtx, vP: GenomeList, vC: GenomeList,
                           from_tip_c: bool = False):
    """One-branch ML length between upper list vP and lower list vC.

    Extracts per-site coefficients so the derivative of the log-likelihood in
    t is -c1 + sum_i 1/(a_i + t), then bisects to min_blen_sensitivity
    precision, capped at 0.1 (reference estimateBranchLengthWithDerivative
    :5040-5358).  Returns False when the optimum is length 0.
    """
    uer = ctx.using_error_rate
    site_err = ctx.error_rate_site_specific
    err_rates = ctx.error_rates
    err = ctx.error_rate
    rate_var = ctx.use_rate_variation
    mms = ctx.mut_matrices
    mm = ctx.mut_matrix
    lRef = ctx.lRef
    root_freqs = ctx.root_freqs
    cum_rate = ctx.cumulative_rate
    c1 = ctx.global_tot_rate
    ais: List[float] = []
    n_zeros = 0
    i1idx = i2idx = 0
    pos = 0
    e1 = vP[0]
    e2 = vC[0]
    while True:
        t1 = e1[0]
        t2 = e2[0]
        if t2 == TYPE_N:
            end = min(e1[1], e2[1]) if (t1 == TYPE_R or t1 == TYPE_N) \
                else pos + 1
            c1 += cum_rate[pos] - cum_rate[end]
            pos = end
        elif t1 == TYPE_N:
            end = min(e1[1], e2[1]) if t2 == TYPE_R else pos + 1
            c1 += cum_rate[pos] - cum_rate[end]
            pos = end
        else:
            if t1 == TYPE_R and t2 == TYPE_R:
                pos = min(e1[1], e2[1])
            else:
                mmx = mms[pos] if rate_var else mm
                if t1 == TYPE_R:
                    c1 -= mmx[e2[1]][e2[1]]
                else:
                    c1 -= mmx[e1[1]][e1[1]]
                flag1 = uer and t1 != TYPE_O and len(e1) > 2 and e1[-1]
                flag2 = uer and t2 != TYPE_O and (
                    from_tip_c or (len(e2) > 2 and e2[-1]))
                eps = err_rates[pos] if (uer and site_err) else err

                # total fixed length (from root/upper node down to the child)
                contrib = False
                if t1 < TYPE_N:
                    if len(e1) == 3 + uer:
                        contrib = e1[2]
                    elif len(e1) == 4 + uer:
                        contrib = e1[3]
                else:
                    if len(e1) > 3:
                        contrib = e1[2]
                if t2 < TYPE_N:
                    if len(e2) > 2 + uer:
                        contrib += e2[2]
                else:
                    if len(e2) > 3:
                        contrib += e2[2]

                if t1 == TYPE_R:
                    if t2 == TYPE_O:
                        i1n = e2[1]
                        if len(e1) == 4 + uer:
                            coeff0 = root_freqs[i1n] * e2[-1][i1n]
                            coeff1 = 0.0
                            for i in RANGE4:
                                coeff0 += (root_freqs[i] * mmx[i][i1n]
                                           * e1[2] * e2[-1][i])
                                coeff1 += mmx[i1n][i] * e2[-1][i]
                            coeff1 *= root_freqs[i1n]
                            if contrib:
                                coeff0 += coeff1 * contrib
                            if flag1:
                                coeff0 -= (1.33333 * eps * root_freqs[i1n]
                                           * e2[-1][i1n])
                                for i in RANGE4:
                                    coeff0 += (root_freqs[i] * e2[-1][i]
                                               * 0.33333 * eps)
                        else:
                            coeff0 = e2[-1][i1n]
                            coeff1 = 0.0
                            for j in RANGE4:
                                coeff1 += mmx[i1n][j] * e2[-1][j]
                            if contrib:
                                coeff0 += coeff1 * contrib
                        if coeff1 < 0.0:
                            c1 += coeff1 / coeff0
                        elif coeff1:
                            ais.append(coeff0 / coeff1)
                        pos += 1
                    else:
                        # R parent vs different concrete child nucleotide
                        if len(e1) == 4 + uer:
                            i1n = e2[1]
                            i2n = e2[0]
                            coeff0 = root_freqs[i2n] * mmx[i2n][i1n] * e1[2]
                            if contrib:
                                coeff0 += (root_freqs[i1n] * mmx[i1n][i2n]
                                           * contrib)
                            if flag2:
                                coeff0 += root_freqs[i1n] * 0.33333 * eps
                            if flag1:
                                coeff0 += root_freqs[i2n] * 0.33333 * eps
                            coeff1 = root_freqs[i1n] * mmx[i1n][i2n]
                            if coeff1:
                                coeff0 = coeff0 / coeff1
                            else:
                                coeff0 = None
                        else:
                            coeff0 = contrib
                            if flag2:
                                if mmx[e2[1]][e2[0]]:
                                    coeff0 += (eps * 0.33333
                                               / mmx[e2[1]][e2[0]])
                                else:
                                    coeff0 = None
                        if coeff0 is not None:
                            if coeff0:
                                ais.append(coeff0)
                            else:
                                n_zeros += 1
                        pos += 1
                elif t1 == TYPE_O:
                    if t2 == TYPE_O:
                        coeff0 = (e1[-1][0] * e2[-1][0] + e1[-1][1] * e2[-1][1]
                                  + e1[-1][2] * e2[-1][2]
                                  + e1[-1][3] * e2[-1][3])
                        coeff1 = 0.0
                        for i in RANGE4:
                            for j in RANGE4:
                                coeff1 += e1[-1][i] * e2[-1][j] * mmx[i][j]
                        if contrib:
                            coeff0 += coeff1 * contrib
                    else:
                        i2n = e1[1] if t2 == TYPE_R else t2
                        coeff0 = e1[-1][i2n]
                        coeff1 = 0.0
                        for i in RANGE4:
                            coeff1 += e1[-1][i] * mmx[i][i2n]
                        if contrib:
                            coeff0 += coeff1 * contrib
                        if flag2:
                            coeff0 += eps * 0.33333
                    if coeff1 < 0.0:
                        c1 += coeff1 / coeff0
                    elif coeff1:
                        ais.append(coeff0 / coeff1)
                    pos += 1
                else:
                    if t2 == t1:
                        c1 += mmx[t1][t1]
                    else:
                        i1n = t1
                        if t2 < TYPE_N:
                            i2n = e1[1] if t2 == TYPE_R else t2
                            if len(e1) == 4 + uer:
                                coeff0 = (root_freqs[i2n] * mmx[i2n][i1n]
                                          * e1[2])
                                if contrib:
                                    coeff0 += (root_freqs[i1n] * mmx[i1n][i2n]
                                               * contrib)
                                if flag2:
                                    coeff0 += root_freqs[i1n] * 0.33333 * eps
                                if flag1:
                                    coeff0 += root_freqs[i2n] * 0.33333 * eps
                                coeff1 = root_freqs[i1n] * mmx[i1n][i2n]
                                if coeff1:
                                    coeff0 = coeff0 / coeff1
                                else:
                                    coeff0 = None
                            else:
                                coeff0 = contrib
                                if flag2:
                                    coeff0 += eps * 0.33333 / mmx[i1n][i2n]
                            if coeff0 is not None:
                                if coeff0:
                                    ais.append(coeff0)
                                else:
                                    n_zeros += 1
                        else:
                            # child is O
                            if len(e1) == 4 + uer:
                                coeff0 = root_freqs[i1n] * e2[-1][i1n]
                                coeff1 = 0.0
                                for i in RANGE4:
                                    coeff0 += (root_freqs[i] * mmx[i][i1n]
                                               * e1[2] * e2[-1][i])
                                    coeff1 += mmx[i1n][i] * e2[-1][i]
                                coeff1 *= root_freqs[i1n]
                                if contrib:
                                    coeff0 += coeff1 * contrib
                                if flag1:
                                    coeff0 -= (1.33333 * eps * root_freqs[i1n]
                                               * e2[-1][i1n])
                                    for i in RANGE4:
                                        coeff0 += (root_freqs[i] * e2[-1][i]
                                                   * 0.33333 * eps)
                            else:
                                coeff0 = e2[-1][i1n]
                                coeff1 = 0.0
                                for j in RANGE4:
                                    coeff1 += mmx[i1n][j] * e2[-1][j]
                                if contrib:
                                    coeff0 += coeff1 * contrib
                            if coeff1 < 0.0:
                                c1 += coeff1 / coeff0
                            elif coeff1:
                                ais.append(coeff0 / coeff1)
                    pos += 1

        if pos == lRef:
            break
        if t1 < TYPE_R or t1 == TYPE_O:
            i1idx += 1
            e1 = vP[i1idx]
        elif pos == e1[1]:
            i1idx += 1
            e1 = vP[i1idx]
        if t2 < TYPE_R or t2 == TYPE_O:
            i2idx += 1
            e2 = vC[i2idx]
        elif pos == e2[1]:
            i2idx += 1
            e2 = vC[i2idx]

    # ---- optimize t from (c1, ais, n_zeros) by bisection ----
    c1 = -c1
    n = len(ais) + n_zeros
    if n == 0:
        return False
    min_ais = min(ais) if ais else 0.0
    if n_zeros:
        min_ais = min(0.0, min_ais)
    if min_ais < 0.0:
        return 0.1
    t_down = min(0.1, n / c1 - min_ais)
    if t_down <= 0.0:
        return False
    v_down = (n_zeros / t_down) if n_zeros else 0.0
    for ai in ais:
        v_down += 1.0 / (ai + t_down)
    max_ais = max(ais) if ais else 0.0
    t_up = min(0.1, n / c1 - max_ais)
    if t_up >= 0.1:
        return 0.1
    sens = ctx.min_blen_sensitivity
    if t_up <= sens:
        t_up = 0.0 if min_ais else sens
    v_up = (n_zeros / t_up) if n_zeros else 0.0
    for ai in ais:
        v_up += 1.0 / (ai + t_up)
    if v_down > c1 + sens or v_up < c1 - sens:
        if v_up < c1 - sens and (not t_up):
            return False
        if (v_down > c1 + sens) and t_down >= 0.1:
            return 0.1
    while t_down - t_up > sens:
        t_mid = (t_up + t_down) / 2
        v_mid = (n_zeros / t_mid) if n_zeros else 0.0
        for ai in ais:
            v_mid += 1.0 / (ai + t_mid)
        if v_mid > c1:
            t_up = t_mid
        else:
            t_down = t_mid
    return t_up


def root_vector_frame(ctx: KernelCtx, prob_vect: GenomeList, blen,
                      is_from_tip: bool) -> GenomeList:
    """Multiply a lower genome list (already expressed in the root's frame)
    by root frequencies to produce an upper list at the root (reference
    rootVector :4916-4996 minus the MAT translation, which the runtime applies
    around this call)."""
    uer = ctx.using_error_rate
    rate_var = ctx.use_rate_variation
    mms = ctx.mut_matrices
    mm = ctx.mut_matrix
    root_freqs = ctx.root_freqs
    out: GenomeList = []
    new_pos = 0
    for e in prob_vect:
        c = e[0]
        if c == TYPE_N:
            out.append(e)
            new_pos = e[1]
        elif c == TYPE_O:
            tot_b = blen + (e[2] if len(e) > 3 else 0.0)
            if tot_b:
                mmx = mms[new_pos] if rate_var else mm
                nv = get_partial_vec(6, tot_b, mmx, 0, vect=e[-1])
                nv = [nv[i] * root_freqs[i] for i in RANGE4]
            else:
                nv = [e[-1][i] * root_freqs[i] for i in RANGE4]
            s = sum(nv)
            out.append((TYPE_O, e[1],
                        [nv[0] / s, nv[1] / s, nv[2] / s, nv[3] / s]))
            new_pos += 1
        else:
            if uer:
                fl = ((len(e) > 2) and e[-1]) or is_from_tip
                if len(e) > 3:
                    out.append((c, e[1], e[2] + blen, 0.0, fl))
                elif blen or fl:
                    out.append((c, e[1], blen, 0.0, fl))
                else:
                    out.append((c, e[1]))
            else:
                if len(e) == 3:
                    out.append((c, e[1], e[2] + blen, 0.0))
                elif blen:
                    out.append((c, e[1], blen, 0.0))
                else:
                    out.append((c, e[1]))
            new_pos = e[1] if c == TYPE_R else new_pos + 1
    return out


def find_prob_root_frame(ctx: KernelCtx, prob_vect: GenomeList) -> float:
    """Log-probability of the root state given a lower list expressed in the
    global reference frame (reference findProbRoot :4865-4912 minus the MAT
    walk)."""
    uer = ctx.using_error_rate
    site_err = ctx.error_rate_site_specific
    err_rates = ctx.error_rates
    err = ctx.error_rate
    root_freqs = ctx.root_freqs
    root_freqs_log = ctx.root_freqs_log
    cum_bases = ctx.cumulative_bases
    rfle = ctx.root_freqs_log_error_cumulative
    log_lk = 0.0
    log_factor = 1.0
    pos = 0
    for e in prob_vect:
        c = e[0]
        if uer and c < TYPE_N and len(e) > 2 and e[-1]:
            if c == TYPE_R:
                log_lk += rfle[e[1]] - rfle[pos]
                pos = e[1]
            else:
                eps = err_rates[pos] if site_err else err
                log_factor *= (root_freqs[c] * (1.0 - 1.33333 * eps)
                               + 0.33333 * eps)
                pos += 1
        else:
            if c == TYPE_R:
                for i in RANGE4:
                    log_lk += root_freqs_log[i] * (cum_bases[e[1]][i]
                                                   - cum_bases[pos][i])
                pos = e[1]
            elif c < TYPE_R:
                log_lk += root_freqs_log[c]
                pos += 1
            elif c == TYPE_O:
                tot = (root_freqs[0] * e[-1][0] + root_freqs[1] * e[-1][1]
                       + root_freqs[2] * e[-1][2] + root_freqs[3] * e[-1][3])
                log_factor *= tot
                pos += 1
            else:
                pos = e[1]
        if log_factor <= ctx.minimum_carry_over:
            if log_factor < FLOAT_MIN:
                return float("-inf")
            log_lk += log(log_factor)
            log_factor = 1.0
    return log_lk + log(log_factor)


def are_vectors_different(ctx: KernelCtx, v1: Optional[GenomeList],
                          v2: Optional[GenomeList]) -> bool:
    """Threshold-based inequality test gating dirty propagation (reference
    :5419-5472)."""
    if v2 is None:
        return True
    tp = ctx.threshold_prob
    tdiff = ctx.threshold_diff_update
    tfold = ctx.threshold_fold_change_update
    lRef = ctx.lRef
    i1idx = i2idx = 0
    pos = 0
    e1 = v1[0]
    e2 = v2[0]
    while True:
        if e1[0] != e2[0] or len(e1) != len(e2):
            return True
        c = e1[0]
        if c < TYPE_N:
            if len(e1) > 2:
                if abs(e1[2] - e2[2]) > tp:
                    return True
                if len(e1) > 3:
                    if abs(e1[3] - e2[3]) > tp:
                        return True
                    if len(e1) > 4 and abs(e1[4] - e2[4]) > tp:
                        return True
            pos = pos + 1 if c < TYPE_R else min(e1[1], e2[1])
        elif c == TYPE_O:
            if len(e1) == 4 and abs(e1[2] - e2[2]) > tp:
                return True
            for i in RANGE4:
                d = abs(e1[-1][i] - e2[-1][i])
                if d:
                    if (not e1[-1][i]) or (not e2[-1][i]):
                        return True
                    if d > tdiff or (d > tp and (
                            d / e1[-1][i] > tfold or d / e2[-1][i] > tfold)):
                        return True
            pos += 1
        else:
            pos = min(e1[1], e2[1])
        if pos == lRef:
            break
        if e1[0] < TYPE_R or e1[0] == TYPE_O:
            i1idx += 1
            e1 = v1[i1idx]
        elif pos == e1[1]:
            i1idx += 1
            e1 = v1[i1idx]
        if e2[0] < TYPE_R or e2[0] == TYPE_O:
            i2idx += 1
            e2 = v2[i2idx]
        elif pos == e2[1]:
            i2idx += 1
            e2 = v2[i2idx]
    return False


def is_minor_sequence(lRef: int, v1: GenomeList, v2: GenomeList,
                      only_find_identical: bool = False) -> int:
    """Partial-order informativeness comparison of two tip lists: 1 if v2 is
    (weakly) less informative than v1 (collapse v2 under v1), 2 for the
    converse, 0 if incomparable (reference isMinorSequence :5919-6004)."""
    i1idx = i2idx = 0
    pos = 0
    e1 = v1[0]
    e2 = v2[0]
    found1 = found2 = False
    while True:
        c1, c2 = e1[0], e2[0]
        if c1 != c2:
            if only_find_identical:
                return 0
            if c1 == TYPE_N:
                pos = min(e1[1], e2[1]) if c2 == TYPE_R else pos + 1
                found2 = True
            elif c2 == TYPE_N:
                pos = min(e1[1], e2[1]) if c1 == TYPE_R else pos + 1
                found1 = True
            elif c1 == TYPE_O:
                i2n = e1[1] if c2 == TYPE_R else c2
                if e1[-1][i2n] > 0.1:
                    found2 = True
                else:
                    return 0
                pos += 1
            elif c2 == TYPE_O:
                i1n = e2[1] if c1 == TYPE_R else c1
                if e2[-1][i1n] > 0.1:
                    found1 = True
                else:
                    return 0
                pos += 1
            else:
                return 0
        elif c1 == TYPE_O:
            for j in RANGE4:
                if only_find_identical:
                    if e2[-1][j] != e1[-1][j]:
                        return 0
                elif e2[-1][j] > 0.1 and e1[-1][j] < 0.1:
                    found1 = True
                elif e1[-1][j] > 0.1 and e2[-1][j] < 0.1:
                    found2 = True
            pos += 1
        else:
            pos = pos + 1 if c1 < TYPE_R else min(e1[1], e2[1])
        if found1 and found2:
            return 0
        if pos == lRef:
            break
        if e1[0] < TYPE_R or e1[0] == TYPE_O:
            i1idx += 1
            e1 = v1[i1idx]
        elif pos == e1[1]:
            i1idx += 1
            e1 = v1[i1idx]
        if e2[0] < TYPE_R or e2[0] == TYPE_O:
            i2idx += 1
            e2 = v2[i2idx]
        elif pos == e2[1]:
            i2idx += 1
            e2 = v2[i2idx]
    if found1:
        return 0 if found2 else 1
    return 2 if found2 else 1


def update_pseudo_counts(lRef: int, v1: GenomeList, v2: GenomeList,
                         counts) -> None:
    """Accumulate observed substitutions between the placement vector v1 and
    the new sample v2 into 4x4 pseudo-counts (reference :5002-5035)."""
    i1idx = i2idx = 0
    pos = 0
    e1 = v1[0]
    e2 = v2[0]
    while True:
        c1, c2 = e1[0], e2[0]
        if c1 != c2 and c1 < TYPE_N and c2 < TYPE_N:
            if c1 == TYPE_R:
                counts[e2[1]][e2[0]] += 1
            elif c2 == TYPE_R:
                counts[e1[0]][e1[1]] += 1
            else:
                counts[e1[0]][e2[0]] += 1
            pos += 1
        else:
            if c1 in (TYPE_R, TYPE_N) and c2 in (TYPE_R, TYPE_N):
                pos = min(e1[1], e2[1])
            else:
                pos += 1
        if pos == lRef:
            break
        if e1[0] < TYPE_R or e1[0] == TYPE_O:
            i1idx += 1
            e1 = v1[i1idx]
        elif pos == e1[1]:
            i1idx += 1
            e1 = v1[i1idx]
        if e2[0] < TYPE_R or e2[0] == TYPE_O:
            i2idx += 1
            e2 = v2[i2idx]
        elif pos == e2[1]:
            i2idx += 1
            e2 = v2[i2idx]
