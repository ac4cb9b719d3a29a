"""Read a MAPLE alignment: the reference genome and each sample's
differences from it.

The format: ``>reference`` and its sequence lines, then one block per
sample, ``>name`` followed by lines ``char<TAB>pos[<TAB>len]`` (1-based
positions in increasing order; ``n`` or ``-`` is a run of missing data of
length ``len``, default 1; an IUPAC ambiguity code is one position).
"""
from __future__ import annotations

import gzip


def read_alignment(path):
    """(reference genome in lower case, {name: [(char, pos, length)]})."""
    opener = gzip.open if path.endswith(".gz") else open
    samples = {}
    chunks = []
    with opener(path, "rt") as f:
        line = f.readline()
        if not line.startswith(">"):
            raise ValueError(f"{path}: no reference header")
        cur = None
        for line in f:
            if not line.strip():
                break
            if line[0] == ">":
                cur = []
                samples[line[1:].strip()] = cur
                continue
            if cur is None:
                chunks.append(line.strip())
                continue
            parts = line.split()
            length = int(parts[2]) if len(parts) > 2 else 1
            cur.append((parts[0].lower(), int(parts[1]), length))
    return "".join(chunks).lower(), samples


def write_alignment(path, ref, samples, order):
    """Write ``samples`` in the order of the names in ``order``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(">reference\n")
        for i in range(0, len(ref), 80):
            f.write(ref[i:i + 80] + "\n")
        for name in order:
            f.write(f">{name}\n")
            for ch, pos, length in samples[name]:
                if ch in "n-" and length != 1:
                    f.write(f"{ch}\t{pos}\t{length}\n")
                else:
                    f.write(f"{ch}\t{pos}\n")
