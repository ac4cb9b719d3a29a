"""What the benchmark tools share: synthetic alignments, the device or
backend a tool runs on, and the RF distance between two trees.

``ensure_dataset`` is a copy of the function of the same name in the
repository's ``scripts/benchmark_scale.py``: it runs
``scripts/make_synthetic_alignment.py`` as a subprocess (that script
imports neither jax nor maple_tpu) and keeps the alignment and its truth
tree in ``workdir`` for the next call.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GENERATOR = os.path.join(ROOT, "scripts", "make_synthetic_alignment.py")
DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(), "maple_bench")
RANK_TIMEOUT = 3600.0    # seconds every rank of a tool's group may take


def ensure_dataset(workdir, n, seed, mut_rate, n_rate, amb_rate):
    """(alignment, truth tree) of ``n`` synthetic samples, made once."""
    tag = f"n{n}_s{seed}_m{mut_rate}"
    aln = os.path.join(workdir, f"scale_{tag}.maple.gz")
    truth = os.path.join(workdir, f"scale_{tag}_truth.nwk")
    if not (os.path.isfile(aln) and os.path.isfile(truth)):
        os.makedirs(workdir, exist_ok=True)
        subprocess.run([sys.executable, GENERATOR, "--samples", str(n),
                        "--seed", str(seed), "--mutRate", str(mut_rate),
                        "--nRate", str(n_rate), "--ambRate", str(amb_rate),
                        "--output", aln, "--treeOut", truth], check=True)
    return aln, truth


def device_error(device: str) -> Optional[str]:
    """Why a tool cannot run on ``device`` ("cuda" or "cpu"), or None.
    The card is the default; the CPU must be named."""
    if device == "cuda" and not torch.cuda.is_available():
        return "no CUDA device (the CPU takes --device cpu)"
    return None


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def rf_between(index_tree: str, query_tree: str, out: str) -> dict:
    """The RF mode of the port's CLI: ``query_tree`` against
    ``index_tree``; the header and first row of its table."""
    from ..analysis.rf import run_rf_mode
    from ..config import MapleConfig
    cfg = MapleConfig(inputTree=index_tree, inputRFtrees=query_tree,
                      output=out, overwrite=True)
    with open(run_rf_mode(cfg)) as f:
        header = f.readline().strip().split("\t")
        values = f.readline().strip().split("\t")
    return dict(zip(header, values))
