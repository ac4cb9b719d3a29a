"""Device-resident model state and packed genome lists as torch tensors.

Torch twins of ``DeviceModel``, ``device_model_from`` and ``to_device`` in
:mod:`maple_tpu.ops.append_batch`, on an explicit device and dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from maple_tpu.ops.pack import PackedBatch


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
