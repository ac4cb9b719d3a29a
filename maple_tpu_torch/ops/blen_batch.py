"""Batched branch-length optimisation, in torch ops.

The torch twin of :mod:`maple_tpu.ops.blen_batch` (K10): for N (upper,
child) pairs at once, the appending branch length t in [0, T_MAX] that
maximises the appendProbNode score, the batched counterpart of the
reference's one-branch-at-a-time ``estimateBranchLengthWithDerivative``
(MAPLEv0.7.5.4.py:5040-5358).  The log-likelihood is concave in t and the
append score differs from it only by terms free of t, so a golden-section
search on the batched scorer finds the reference optimum without the
per-site coefficient lists of the host kernel.

Each iteration keeps the retained interior point's score and scores the
one new point; ``_iters_for(sens)`` iterations shrink the bracket below
``sens`` (31 at lRef 29,903), then the boundary rules (below ``sens``: 0;
above ``T_MAX - sens``: T_MAX), the score at t, and the concavity guard
against both end points: 36 scorer calls a call.  The scorer is the
port's interval-algebra scorer (K8, :mod:`.append_batch`, chunked form)
with a vector of lengths; the pair kernel cannot serve, since it scores a
[K, N] grid and these pairs are its diagonal.

The working type is that of the model arrays, the device that of the
tensors.  The loop adds no host sync of its own (the bracket updates are
``torch.where``); each scorer call syncs once, where K8 selects its
contributing segments.  Nothing in the pipeline calls this function, in
either package.
"""
from __future__ import annotations

import math

import torch

from .append_batch import DeviceModel, _append_scores_impl

_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0
T_MAX = 0.1


def _iters_for(sens: float, t_max: float = T_MAX) -> int:
    """Golden-section iterations to shrink [0, t_max] below sens."""
    return max(1, int(math.ceil(math.log(sens / t_max) / math.log(_INVPHI))))


def batched_optimize_blen(P: dict, C: dict, tips, dm: DeviceModel,
                          sens: float):
    """ML appending branch length for N (upper, child) pairs at once.

    P fields [N, B1] (upper vectors), C fields [N, B2] (child lower
    vectors), ``tips`` a bool or [N] child-is-tip flags, ``sens`` =
    DerivedConfig.minBLenSensitivity (the host bisection's bracket
    precision).  Returns ``(t, score)``, both [N]: the optimal length (0.0
    where the host kernel returns False, T_MAX at the cap) and the append
    score at it."""
    mm = dm.mut_matrix
    dtype, device = mm.dtype, mm.device
    N = P["types"].shape[0]
    tips = torch.as_tensor(tips, dtype=torch.bool, device=device)
    iters = _iters_for(sens)
    sens = torch.tensor(sens, dtype=dtype, device=device)

    def f(t):
        return _append_scores_impl(
            P, C, t, tips, mm, dm.root_freqs, dm.site_rates, dm.error_rates,
            dm.global_tot_rate, dm.tot_error, dm.using_error_rate)

    a0 = torch.zeros((N,), dtype=dtype, device=device)
    b0 = torch.full((N,), T_MAX, dtype=dtype, device=device)
    a, b = a0, b0
    c = b - _INVPHI * (b - a)
    d = a + _INVPHI * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        # shrinking left, the new d is the old c (score kept) and c is new;
        # mirrored on the right.  NaN and -inf compare False, as in JAX.
        left = fc > fd
        a = torch.where(left, a, c)
        b = torch.where(left, d, b)
        fkeep = torch.where(left, fc, fd)
        c = b - _INVPHI * (b - a)
        d = a + _INVPHI * (b - a)
        fx = f(torch.where(left, c, d))
        fc = torch.where(left, fx, fkeep)
        fd = torch.where(left, fkeep, fx)
    t = 0.5 * (a + b)
    # the host kernel's boundaries, then the score at the returned length
    t = torch.where(t < sens, a0, torch.where(t > T_MAX - sens, b0, t))
    ft = f(t)
    # concavity guard: the uniform-collapse clamp of the evolve ops can
    # leave the search on a bracket that is not the global one; the end
    # points restore the argmax over {t*, 0, T_MAX}
    f_lo, f_hi = f(a0), f(b0)
    better_lo = f_lo > ft
    t = torch.where(better_lo, a0, t)
    ft = torch.where(better_lo, f_lo, ft)
    better_hi = f_hi > ft
    t = torch.where(better_hi, b0, t)
    ft = torch.where(better_hi, f_hi, ft)
    return t, ft
