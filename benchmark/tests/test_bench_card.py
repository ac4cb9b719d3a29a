"""On the card, at each cell's own size: a short window of the cell judges
correct and the float32 control (the reference in float32 put in the
port's place) fails its limit, and each fault of the tree's quality
(``faults.QUALITY``) judges not correct, on three seeds each.  Every
reading is printed (``# card reading``).  Run with
``python3 -m pytest benchmark/tests -m card -s``."""
import json
import os
import time

import pytest

from benchmark.harness.session import run_cell
from benchmark.harness.spec import Cell

from .conftest import ROOT
from .faults import QUALITY, plant

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
SEEDS = (2 ** 31 + 201, 2 ** 31 + 203, 2 ** 31 + 207)


@pytest.mark.card
@pytest.mark.parametrize("fault", (None,) + QUALITY)
@pytest.mark.parametrize("name", CELLS)
def test_sound_control_and_faults_on_the_card(card, monkeypatch, name,
                                              fault):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    plant(monkeypatch, fault)
    cell = Cell(name)
    limits = cell.limits["limits"]
    for seed in SEEDS:
        readings = []
        result, lines, _ = run_cell(cell, seed, 1.0, False, card,
                                    time.time(), readings=readings)
        for r in readings:
            print("# card reading " + json.dumps(
                {"cell": name, "fault": fault, "seed": seed,
                 "correct": result["correct"], **r}), flush=True)
        assert result["correct"] is (fault is None), lines
        if fault is None:
            assert all(r["control_lk_gap"] > limits["lk_gap"]
                       for r in readings), readings
        else:
            assert result["checks"]["lk_short"]["value"] \
                > limits["lk_short"], lines
