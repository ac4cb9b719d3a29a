"""MAPLE alignment-format I-O.

Format (reference readConciseAlignment, MAPLEv0.7.5.4.py:3485-3553):
``>reference`` + sequence lines, then per-sample blocks ``>name`` followed by
diff lines ``char\tpos[\tlen]`` (1-based positions; char 'n'/'-' denotes a
missing-data run of optional length; IUPAC ambiguity codes allowed).
"""
from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple

from ..refdata import ALLELES

# A sample's data is a list of diff tuples (char, pos[, length]).
Diff = Tuple
SampleData = List[Diff]


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def read_reference_fasta(path: str) -> str:
    """Read a single-sequence fasta reference (reference collectReference :3485)."""
    with _open(path) as f:
        f.readline()
        return "".join(line.strip() for line in f).lower()


def read_maple_alignment(
    path: str,
    extract_reference: bool = True,
    ref: str = "",
    only_ref: bool = False,
):
    """Read a MAPLE diff alignment.

    Returns (ref, data) when extract_reference, else data; data maps sample
    name -> list of (char, pos[, len]) with validation identical to the
    reference reader (sorted positions, diffs must differ from ref).
    """
    with _open(path) as f:
        line = f.readline()
        if extract_reference:
            line = f.readline()
            chunks = []
            while line != "" and line[0] != ">":
                chunks.append(line.strip())
                line = f.readline()
            ref = "".join(chunks).lower()
        if only_ref:
            return ref
        # Single pass with C-level file iteration (the nested readline()
        # loops cost ~1 s per million diff lines in Python-call overhead
        # alone); semantics identical to the reference reader: EOF or a
        # blank line terminates parsing, '>' starts a sample, validation
        # unchanged.
        data: Dict[str, SampleData] = {}
        name: Optional[str] = None
        seq: SampleData = []
        pos = 0
        if line != "" and line != "\n":
            # the reference reader takes the first post-reference line as a
            # sample name unconditionally (:3509)
            name = line.replace(">", "").strip()
            seq = []
            data[name] = seq
        else:
            f = iter(())
        for line in f:
            if line == "" or line == "\n":
                break
            if line[0] == ">":
                name = line.replace(">", "").strip()
                seq = []
                data[name] = seq
                pos = 0
                continue
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(
                    f"Malformed MAPLE line (needs >=2 columns): {line!r}")
            ch = parts[0].lower()
            p = int(parts[1])
            if ref[p - 1] == ch and ch != "n" and ch != "-":
                raise ValueError(
                    f"Diff equals reference at position {p} ({ch}); "
                    "wrong reference or diff file?")
            if p <= pos:
                raise ValueError(
                    f"Unsorted/overlapping entry at position {p} in "
                    f"sample {name!r}")
            if len(parts) > 2:
                length = int(parts[2])
                seq.append((ch, p, length))
                pos = p + length - 1
            else:
                seq.append((ch, p))
                pos = p
    if extract_reference:
        return ref, data
    return data


def write_maple_alignment(path: str, ref: str, data: Dict[str, SampleData]):
    """Write a MAPLE diff alignment (inverse of read_maple_alignment)."""
    with open(path, "w") as f:
        f.write(">reference\n")
        for i in range(0, len(ref), 80):
            f.write(ref[i:i + 80] + "\n")
        for name, seq in data.items():
            f.write(f">{name}\n")
            for entry in seq:
                f.write("\t".join(str(x) for x in entry) + "\n")


def sample_distance_from_ref(diffs: SampleData, lRef: int) -> Tuple[int, int, int]:
    """(sort key, n_diffs, n_comparisons) for placement ordering.

    Key = n_diffs*1000 + (lRef - comparable positions): samples with fewer
    diffs and less missing data place first (reference
    distancesFromRefPunishNs :6451-6499).
    """
    pos = 1
    comparisons = 0
    diff_num = 0
    for m in diffs:
        cur = m[1]
        if cur > pos:
            comparisons += cur - pos
            pos = cur
        if m[0] == "n" or m[0] == "-":
            pos = cur + (m[2] if len(m) > 2 else 1)
            diff_num += 1
        elif m[0] in ALLELES:
            comparisons += 1
            diff_num += 1
            pos = cur + 1
        else:
            pos = cur + 1
            diff_num += 1
    if pos <= lRef:
        comparisons += lRef + 1 - pos
    return diff_num * 1000 + lRef - comparisons, diff_num, comparisons
