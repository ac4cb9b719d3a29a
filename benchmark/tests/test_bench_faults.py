"""A whole run of the tree cell on the CPU, at its own size (3,000
genomes, the port's plain PyTorch in place of the card), sound and with
the timed path broken underneath (``faults.py``): ``correct`` must come
out true, then false once for each fault (one chip: no exchange between
chips to leave out)."""
import time

import pytest
import torch

from benchmark.harness.session import run_cell
from benchmark.harness.spec import Cell

from .faults import FAULTS, QUALITY, plant

CELL = "b1429.tree-devspr"


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_faults_make_the_run_incorrect(monkeypatch, fault):
    calls = plant(monkeypatch, fault)
    cell = Cell(CELL)
    limits = cell.limits["limits"]
    readings = []
    result, lines, _ = run_cell(cell, 2 ** 31 + 101, 0.1, False,
                                torch.device("cpu"), time.time(),
                                readings=readings)
    assert result["attempted"] == 1
    assert list(result)[-1] == "checks"
    assert result["correct"] is (fault is None), lines
    checks = result["checks"]
    if fault is None:
        # the float32 control, on the same tree, fails
        assert len(readings) == 1
        assert readings[0]["control_lk_gap"] > limits["lk_gap"]
    if fault in ("state_unchanged", "half_batch"):
        assert len(calls) >= 2
        assert checks["names_bad"]["value"] > 0
    if fault == "answer_altered":
        assert checks["lk_gap"]["value"] > limits["lk_gap"]
    if fault in QUALITY:
        assert checks["lk_short"]["value"] > limits["lk_short"]
