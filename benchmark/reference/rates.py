"""The rates a program reports: its ``<out>_subs.txt`` read whole.

MAPLE writes the file so (and the port's ``Run.write_subs`` the same): the
4x4 rate matrix, four rows of tab-separated numbers; then, each after two
blank lines and only where the run estimated it, a ``Site rates:`` block
(``--rateVariation``) and a ``Site error rates:`` block (``--estimateErrors``),
each a line ``<position>\\t<value>`` a site; or, in place of the second, one
line ``Error rate: <value>`` (``--estimateErrorRate``: one rate for every
site).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

BLOCKS = {"Site rates:": "site_rates",
          "Site error rates:": "site_error_rates"}
GLOBAL_ERROR = "Error rate:"


@dataclasses.dataclass(frozen=True)
class Rates:
    """The rate matrix, and each optional part or None."""

    matrix: List[List[float]]
    site_rates: Optional[List[float]] = None
    site_error_rates: Optional[List[float]] = None
    error_rate: Optional[float] = None


def read_subs(path):
    """The ``Rates`` that the file at ``path`` holds."""
    with open(path) as f:
        lines = f.read().splitlines()
    matrix = [[float(x) for x in line.split()] for line in lines[:4]]
    if len(matrix) != 4 or any(len(row) != 4 for row in matrix):
        raise ValueError(f"{path}: no 4x4 rate matrix in its first lines")
    parts = {}
    block = None
    for i, line in enumerate(lines[4:], 5):
        text = line.strip()
        if not text:
            block = None
        elif text in BLOCKS:
            block = parts.setdefault(BLOCKS[text], [])
        elif text.startswith(GLOBAL_ERROR):
            parts["error_rate"] = float(text[len(GLOBAL_ERROR):])
        elif block is not None:
            site, value = text.split()
            if int(site) != len(block) + 1:
                raise ValueError(f"{path}:{i}: site {site} out of order")
            block.append(float(value))
        else:
            raise ValueError(f"{path}:{i}: unexpected line {text!r}")
    return Rates(matrix, **parts)
