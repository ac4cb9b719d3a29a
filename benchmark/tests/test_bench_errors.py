"""The error model judged whole on the CPU: the port's ``--estimateErrors``
run of ``tests/goldens/example_sub80.maple`` (80 genomes, UNREST,
``options {"estimateErrors": true}``, the ``tree-devspr`` mix), through the
harness and the reference, with the planted faults of its rates.

The port shares one probability list an ambiguity code across every tip
and refreshes it in place, as MAPLE does; the reference gives each
ambiguity entry its own site's error rate.  So on the 80 genomes as they
are the two disagree by the gap recorded here, and where each code occurs
once (no list shared) they agree."""
import shutil
import time

import pytest
import torch

from benchmark.harness.session import run_cell
from benchmark.harness.spec import Cell

from .conftest import ROOT, make_root

SUB80 = f"{ROOT}/tests/goldens/example_sub80.maple"
SEED = 2 ** 31 + 301
# the port's LK less the reference's on SEED's tree of the 80 genomes as
# they are: the shared ambiguity lists (PERF.md, section 7; ROADMAP.md,
# queue E)
SHARED_LISTS_GAP = 0.025910622396622784
LIMITS = {"limits": {"names_bad": 0, "lk_gap": 1e-06}}


def _first_codes_only(src, dst):
    """``src`` with every ambiguity code after a code's first occurrence
    made an N."""
    seen = set()
    with open(src) as f, open(dst, "w") as out:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and not line.startswith(">") \
                    and parts[0].lower() not in "acgtn-":
                if parts[0].lower() in seen:
                    line = f"n\t{parts[1]}\n"
                seen.add(parts[0].lower())
            out.write(line)


def _errest_run(tmp_path, shared):
    config = {"name": "errest", "dataset": {
        "kind": "file", "file": "data/sub80.maple", "order": "permuted"},
        "model": "UNREST", "options": {"estimateErrors": True}}
    cell = {"name": "errest.tree-devspr", "config": "errest",
            "traffic": "tree-devspr", "chips": 1, "why": "test"}
    root = make_root(tmp_path, configs=[("errest", config)], cells=[cell],
                     limits=[(cell["name"], LIMITS)])
    dst = tmp_path / "benchmark" / "data" / "sub80.maple"
    if shared:
        shutil.copy(SUB80, dst)
    else:
        _first_codes_only(SUB80, dst)
    readings = []
    result, lines, _ = run_cell(Cell(cell["name"], root=root), SEED, 0.1,
                                False, torch.device("cpu"), time.time(),
                                readings=readings)
    assert result["attempted"] == 1 and len(readings) == 1
    return result, lines, readings[0]


def test_error_model_judged_where_no_list_is_shared(tmp_path):
    result, lines, r = _errest_run(tmp_path, shared=False)
    limit = LIMITS["limits"]["lk_gap"]
    assert result["correct"] is True, lines
    assert r["names_bad"] == 0 and r["lk_gap"] <= limit
    # the float32 control and both faults of the rates fail
    assert r["control_lk_gap"] > 100 * limit
    assert r["errors_dropped_lk_gap"] > 1e6 * limit
    assert r["errors_x10_lk_gap"] > 1e6 * limit


def test_error_model_judged_with_shared_lists(tmp_path):
    result, lines, r = _errest_run(tmp_path, shared=True)
    assert result["correct"] is False, lines
    assert r["names_bad"] == 0
    assert r["lk_gap"] == pytest.approx(SHARED_LISTS_GAP, rel=1e-6)
    assert r["errors_dropped_lk_gap"] > 1e3 * r["lk_gap"]
    assert r["errors_x10_lk_gap"] > 1e3 * r["lk_gap"]
