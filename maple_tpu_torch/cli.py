"""Command-line interface of the port: ``python -m maple_tpu_torch``.

Takes the flags of ``python -m maple_tpu`` (the parser is
:func:`maple_tpu.cli.build_parser`) and runs the pipeline with its device
stages on the CUDA card.  Flags whose device code is not ported yet raise.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from maple_tpu.cli import build_parser
from maple_tpu.config import MapleConfig

# parser destinations -> MapleConfig field names (maple_tpu.cli.main)
_FLAG_FIELDS = {
    "devicePlacement": "device_placement",
    "devicePallas": "device_pallas",
    "deviceTopology": "device_topology",
    "deviceWarmup": "device_warmup",
    "deviceBatchSize": "device_batch_size",
    "useDeviceKernels": "use_device_kernels",
    "deviceBatchMin": "device_batch_min",
    "deviceProxyBatch": "device_proxy_batch",
    "deviceSeedTopm": "device_seed_topm",
    "deviceSeedBudget": "device_seed_budget",
    "entryBudget": "entry_budget",
    "kernelBackend": "kernel_backend",
}

# flags whose device code is not ported yet, with the ROADMAP item that
# ports it; it would reach maple_tpu.parallel code that imports jax
_NOT_PORTED = {
    "devicePallas": "ROADMAP.md Queue 1 items 5-6 (legacy and mesh "
                    "scorers)",
}


def main(argv=None):
    parser = build_parser()
    parser.prog = "maple-tpu-torch"
    args = parser.parse_args(argv)
    if args.version:
        from . import __version__
        print(f"maple-tpu-torch {__version__}")
        return 0
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"maple_tpu_torch: --{flag} is not ported yet; {item} "
                f"ports it")
    if not torch.cuda.is_available():
        raise RuntimeError("maple_tpu_torch needs a CUDA device and none "
                           "is available")
    field_names = {f.name for f in dataclasses.fields(MapleConfig)}
    kwargs = {}
    for key, value in vars(args).items():
        name = _FLAG_FIELDS.get(key, key)
        if name in field_names:
            kwargs[name] = value
    cfg = MapleConfig(**kwargs)
    from .pipeline import run_inference
    run_inference(cfg, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
