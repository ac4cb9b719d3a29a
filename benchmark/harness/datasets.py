"""A configuration's dataset for one seed: the alignment file that both the
port and the reference read.

The configuration's ``dataset`` names an alignment kept under
``benchmark/`` (``kind: "file"``); the seed permutes the order of its
samples (``order: "permuted"``), which changes how the placement order
breaks ties and so the tree, and keeps every genome.  It is made once per
seed into ``benchmark/.cache/datasets/`` (a name made from the
configuration and the seed, written under a temporary name and renamed,
so a cut run leaves no half file).
"""
from __future__ import annotations

import os

import numpy as np

from ..reference.alignment import read_alignment, write_alignment
from ..reference.judge import Dataset

CACHE = ("benchmark", ".cache", "datasets")


def make(cell, seed):
    """The alignment path of ``cell`` for ``seed``."""
    spec = cell.config["dataset"]
    if spec["kind"] != "file":
        raise ValueError(f"unknown dataset kind {spec['kind']!r}")
    folder = os.path.join(cell.root, *CACHE)
    os.makedirs(folder, exist_ok=True)
    aln = os.path.join(folder, f"{cell.config['name']}_s{seed}.maple.gz")
    if not os.path.isfile(aln):
        ref, samples = read_alignment(cell.path(spec["file"]))
        order = list(samples)
        if spec.get("order") == "permuted":
            rng = np.random.default_rng(seed)
            order = [order[i] for i in rng.permutation(len(order))]
        tmp = f"{aln}.{os.getpid()}.gz"
        write_alignment(tmp, ref, samples, order)
        os.replace(tmp, aln)
    return aln


def judge_data(aln):
    """The judge's view of the dataset, read from the same file."""
    return Dataset(*read_alignment(aln))
