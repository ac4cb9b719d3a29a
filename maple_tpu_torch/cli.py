"""Command-line interface: ``python -m maple_tpu_torch``.

Flag-compatible with the reference CLI (MAPLEv0.7.5.4.py:26-128): a user of
``pypy3 MAPLEv0.7.5.4.py --input X --output Y ...`` can invoke
``python -m maple_tpu_torch --input X --output Y ...`` with the same flags,
plus the device additions (--devicePlacement, --deviceTopology etc.).  The
device stages run on the CUDA card; without one the command raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from .config import MapleConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="maple-tpu",
        description="TPU-native maximum-likelihood phylogenetics for "
                    "pandemic-scale low-divergence datasets (MAPLE-style "
                    "inference on JAX/XLA).")
    defaults = MapleConfig()
    snake_extras = {
        "device_placement": "devicePlacement",
        "device_pallas": "devicePallas",
        "device_topology": "deviceTopology",
        "device_warmup": "deviceWarmup",
        "device_batch_size": "deviceBatchSize",
        "use_device_kernels": "useDeviceKernels",
        "device_batch_min": "deviceBatchMin",
        "device_proxy_batch": "deviceProxyBatch",
        "device_seed_topm": "deviceSeedTopm",
        "device_seed_budget": "deviceSeedBudget",
        "entry_budget": "entryBudget",
        "kernel_backend": "kernelBackend",
    }
    for f in dataclasses.fields(MapleConfig):
        flag = "--" + snake_extras.get(f.name, f.name)
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            parser.add_argument(flag, action="store_true",
                                default=default)
        elif isinstance(default, int):
            parser.add_argument(flag, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=str, default=default)
    parser.add_argument("--aBayesPlus", dest="SPRTA", action="store_true",
                        help="synonym for --SPRTA")
    parser.add_argument("--version", action="store_true")
    return parser


# parser destinations -> MapleConfig field names (build_parser's map,
# reversed)
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


def main(argv=None):
    parser = build_parser()
    parser.prog = "maple-tpu-torch"
    parser.description = ("Maximum-likelihood phylogenetics for pandemic-"
                          "scale low-divergence datasets (MAPLE-style "
                          "inference; device stages in PyTorch and CUDA).")
    args = parser.parse_args(argv)
    if args.version:
        from . import __version__
        print(f"maple-tpu-torch {__version__}")
        return 0
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
