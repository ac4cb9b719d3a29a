"""The port's headline benchmark (``maple_tpu_torch/tools/bench.py``)
against the repository's ``bench.py`` on the same input, at a small size on
the CPU.

``bench.py`` reads an alignment that is not in the repository; its module
attribute ``B1429`` is pointed at 600 synthetic samples (the module object
only; the file is not edited).  Its functions and the twin's then place the
same samples: the device placement (maple_tpu's on JAX on the CPU, the
port's on the plain PyTorch versions) within ``LK_TOL``, the exact engine
within ``ENGINE_TOL``.  Then the twin's line and its gate.
"""
import json

import pytest
import torch

import bench
import maple_tpu.pipeline as JPIPE

from maple_tpu_torch.tools import bench as TB
from maple_tpu_torch.tools.common import ensure_dataset

from test_torch_proxy_placer import SUB80

CPU = torch.device("cpu")
LK_TOL = 1e-6            # the device path's exact-parity contract
ENGINE_TOL = 1e-9        # one engine, the same tree
SAMPLES = 600
BRANCH_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
              "MAPLE_PROXY_D", "MAPLE_SPR_EXACT", "MAPLE_DEBUG_DEVBATCH")
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "protocol", "runs",
             "device", "samples", "input", "first_use_s", "baseline",
             "baseline_seq_per_s", "lk", "lk_baseline", "minors",
             "minors_baseline", "gate", "stage"}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in BRANCH_ENV:
        monkeypatch.delenv(name, raising=False)
    # the JAX proxy placer's stall fallback would place a slow screen's
    # batch unseeded: wait for every screen
    monkeypatch.setenv("MAPLE_SCREEN_TIMEOUT_S", "0")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def aln(workdir):
    return ensure_dataset(workdir, SAMPLES, 1, 1.5, 0.2, 0.05)[0]


def test_device_placement_matches_bench_py(monkeypatch, workdir, aln):
    monkeypatch.setattr(bench, "B1429", aln)
    runs = []

    class KeptRun(JPIPE.Run):   # bench.py prints its LK to 2 decimals
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    monkeypatch.setattr(JPIPE, "Run", KeptRun)
    rate = bench.run_device_placement()
    (jrun,) = runs
    jax_lk = jrun.rt.calculate_tree_likelihood(jrun.root)
    res = TB.run_device_placement(aln, device=CPU, workdir=workdir)
    assert rate > 0 and res["seq_per_s"] > 0
    assert len(jrun.names_in_tree) == SAMPLES
    assert abs(res["lk"] - jax_lk) <= LK_TOL, (res["lk"], jax_lk)
    assert res["minors"] == jrun.stats.num_minors_found
    assert res["steps"] == -(-(SAMPLES - 256) // 256)
    assert set(res) == {"seq_per_s", "wall_s", "lk", "minors",
                        *TB.STAGE_FIELDS}


def test_engine_placement_matches_bench_py(monkeypatch, workdir, aln):
    monkeypatch.setattr(bench, "B1429", aln)
    rate, lk = bench.run_engine_placement_full(budget=0)
    t_rate, t_lk, minors = TB.run_engine_placement_full(
        aln, budget=0, device=CPU, workdir=workdir)
    assert rate > 0 and t_rate > 0 and minors >= 0
    assert abs(t_lk - lk) <= ENGINE_TOL, (t_lk, lk)


def json_lines(out):
    lines = []
    for ln in out.splitlines():
        try:
            obj = json.loads(ln)
        except ValueError:
            continue
        if isinstance(obj, dict):
            lines.append(obj)
    return lines


def test_main_prints_the_line(workdir, capsys, tmp_path):
    out_file = tmp_path / "bench.jsonl"
    assert TB.main(["--device", "cpu", "--samples", str(SAMPLES),
                    "--workdir", workdir, "--out", str(out_file)]) == 0
    out = capsys.readouterr().out
    (res,) = json_lines(out)
    assert json.loads(out.splitlines()[-1]) == res
    assert json.loads(out_file.read_text().splitlines()[-1]) == res
    assert set(res) == LINE_KEYS
    assert res["metric"] == f"placement_throughput_synth{SAMPLES}s1_device"
    assert res["gate"] == "passed" and res["protocol"] == "median-of-3"
    assert len(res["runs"]) == TB.RUNS == 3
    assert res["value"] == sorted(res["runs"])[1]
    assert res["vs_baseline"] == pytest.approx(
        res["value"] / res["baseline_seq_per_s"])
    assert abs(res["lk"] - res["lk_baseline"]) <= LK_TOL
    assert res["minors"] == res["minors_baseline"]
    assert res["samples"] == SAMPLES and res["device"] == "cpu"
    assert res["first_use_s"] > 0
    assert set(res["stage"]) == {"wall_s", *TB.STAGE_FIELDS}
    assert res["stage"]["steps"] == -(-(SAMPLES - 256) // 256)


@pytest.mark.parametrize("field,delta", [("lk", 1e-5), ("minors", 1)])
def test_gate_fails_a_run_with_another_result(monkeypatch, workdir, capsys,
                                              field, delta):
    """A device run whose LK moves by 1e-5, or whose minor count moves, is
    another result: no value, gate failed, exit 1."""
    placed = TB.run_device_placement

    def moved(*args, **kwargs):
        res = placed(*args, **kwargs)
        res[field] += delta
        return res

    monkeypatch.setattr(TB, "run_device_placement", moved)
    assert TB.main(["--device", "cpu", "--samples", str(SAMPLES),
                    "--workdir", workdir]) == 1
    (res,) = json_lines(capsys.readouterr().out)
    assert res["value"] is None and res["vs_baseline"] is None
    assert res["gate"] == "failed" and len(res["runs"]) == 3


@pytest.mark.parametrize("gate", [TB.ENGINE_LK_GATE, -1.0],
                         ids=["budget", "exact"])
def test_engine_headline(monkeypatch, workdir, capsys, gate):
    """``--engine``: bench.py's budgeted search over 4 cores against the
    exact run; with the gate failed, the exact runs reported."""
    monkeypatch.setattr(TB, "ENGINE_LK_GATE", gate)
    assert TB.main(["--device", "cpu", "--samples", str(SAMPLES),
                    "--workdir", workdir, "--engine"]) == 0
    (res,) = json_lines(capsys.readouterr().out)
    assert set(res) == LINE_KEYS and len(res["runs"]) == 3
    tag = f"placement_throughput_synth{SAMPLES}s1"
    if gate > 0:
        assert res["metric"] == f"{tag}_budget1000_cores4"
        assert res["gate"] == "passed"
        assert abs(res["lk"] - res["lk_baseline"]) <= gate
    else:
        assert res["metric"] == f"{tag}_engine"
        assert res["gate"] == "failed: exact runs reported"
        assert abs(res["lk"] - res["lk_baseline"]) <= ENGINE_TOL
    assert res["value"] == sorted(res["runs"])[1]


def test_input_file_names_the_metric(workdir, capsys):
    assert TB.main(["--device", "cpu", "--input", SUB80,
                    "--workdir", workdir]) == 0
    (res,) = json_lines(capsys.readouterr().out)
    assert res["metric"] == "placement_throughput_example_sub80_device"
    assert res["samples"] == 80 and res["input"] == SUB80
    assert res["gate"] == "passed"
    assert TB.input_tag("/x/sameRef_B.1.429.maple.gz", 0) == \
        "sameRef_B_1_429"
