"""The harness on the CPU: every cell resolves by name, a cell and a
metric added as files are found with no edit, the readers work on
recorded counters and a recorded trace, the roofline arithmetic, and the
command loads neither JAX nor the JAX package."""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.jobs import config_for
from benchmark.harness.session import Records
from benchmark.harness.spec import Cell, peaks_for
from benchmark.metrics.roofline import bound_s, work_counts
from benchmark.trace import reduce_trace

from .conftest import ROOT, make_root

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
CELLS = [w["name"] for w in SPEC["workloads"]]
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("name", CELLS)
def test_every_workload_resolves(name):
    cell = Cell(name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["name"] == cell.entry["traffic"]
    assert set(cell.limits["limits"]) == {"names_bad", "lk_gap", "lk_short"}
    assert isinstance(cell.limits["lk_base"], float)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert os.path.isfile(cell.path(*cell.config_entry["file"].split("/")
                                    [1:]))


def _digest(folder):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(folder)):
        for name in sorted(files):
            if "__pycache__" in dirpath or ".cache" in dirpath:
                continue
            with open(os.path.join(dirpath, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    before = _digest(os.path.join(ROOT, "benchmark"))
    config = {"name": "extra", "dataset": {"kind": "file",
              "file": "data/b1429_3000.maple.gz"}, "model": "GTR"}
    mix = {"name": "mix2", "kind": "tree", "flags": {}, "why": "test"}
    cell = {"name": "extra.mix2", "config": "extra", "traffic": "mix2",
            "chips": 1, "why": "test"}
    metric = ("extra.jobs", "def read(rec):\n    return len(rec.jobs)\n",
              {"name": "extra.jobs", "unit": "jobs", "better": "higher",
               "source": "program_counter", "layer": "pipeline",
               "moves": "tree_s", "workloads": ["extra.mix2"]})
    root = make_root(tmp_path, configs=[("extra", config)],
                     traffic=[("mix2", mix)], cells=[cell],
                     limits=[("extra.mix2", {"limits": {"names_bad": 0}})],
                     metrics=[metric])
    c = Cell("extra.mix2", root=root)
    assert c.config["model"] == "GTR" and c.traffic["kind"] == "tree"
    assert [m["name"] for m in c.per_layer] == ["extra.jobs"]
    rec = Records([{"kind": "tree"}] * 3, 1.0, 1.0)
    assert c.reader("extra.jobs")(rec) == 3
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]
    assert _digest(os.path.join(ROOT, "benchmark")) == before


def test_the_configuration_reaches_the_port_as_it_did():
    """A configuration without ``options`` gives the port the MapleConfig
    that the model and the mix's flags alone gave it."""
    from maple_tpu_torch.config import MapleConfig
    for name in CELLS:
        cell = Cell(name)
        if "options" in cell.config:
            continue
        got = config_for(cell, "in.maple", "out")
        want = MapleConfig(input="in.maple", output="out",
                           model=cell.config["model"], overwrite=True,
                           **cell.traffic["flags"])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    unrest = Cell("b1429.tree-devspr")
    assert "options" not in unrest.config
    assert config_for(unrest, "in.maple", "out").estimateErrors is False


def test_options_reach_the_port_and_may_not_clash(tmp_path):
    config = {"name": "errest", "dataset": {"kind": "file",
              "file": "data/b1429_3000.maple.gz"}, "model": "UNREST",
              "options": {"estimateErrors": True}}
    clash = dict(config, name="clash",
                 options={"device_topology": False})
    cells = [{"name": f"{c}.tree-devspr", "config": c,
              "traffic": "tree-devspr", "chips": 1, "why": "test"}
             for c in ("errest", "clash")]
    limits = {"limits": {"names_bad": 0}}
    root = make_root(tmp_path, configs=[("errest", config),
                                        ("clash", clash)], cells=cells,
                     limits=[(c["name"], limits) for c in cells])
    cfg = config_for(Cell("errest.tree-devspr", root=root), "in", "out")
    assert cfg.estimateErrors and cfg.estimateSiteSpecificErrorRate
    assert cfg.device_placement and cfg.device_topology
    assert cfg.model == "UNREST"
    with pytest.raises(ValueError, match="device_topology"):
        config_for(Cell("clash.tree-devspr", root=root), "in", "out")


def _tree():
    return {"kind": "tree", "wall_s": 8.0, "samples": None,
            "timings": {"finding": 1.0, "placing": 1.0, "topology": 4.0},
            "spr_passes": [{"collect_s": 0.1, "pack_s": 0.2,
                            "decide_s": 0.3, "apply_s": 0.4}] * 2}


def test_readers_on_recorded_counters():
    tree = _tree()
    read = Cell(CELLS[0]).reader
    trees = Records([tree] * 4, 32.0, 5.0)
    assert read("setup_s")(trees) == 5.0
    assert read("tree_s")(trees) == 8.0
    assert read("pipeline.rest_s.tree")(trees) == 2.0
    assert read("spr.topology_s")(trees) == 4.0
    assert read("spr.screen_host_s")(trees) == pytest.approx(2.0)
    host = dict(tree, spr_passes=[])
    assert read("spr.screen_host_s")(Records([host], 8.0, 5.0)) is None
    assert read("kernel.spr_screen_roofline")(trees) is None
    assert read("device.idle_share.tree")(trees) is None


def _event(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": 1, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_readers_on_recorded_trace(tmp_path):
    """A trace of 1,000 us: the window span (the one annotation the trace
    needs), the host spans of a job and of an SPR screen step on another
    thread (the host clock 5 s behind the trace's), the step's two kernels
    of 100 + 50 us, a kernel launched outside it (30 us) and a copy
    (20 us)."""
    events = [
        _event("user_annotation", "bench:window", 0, 1000),
        _event("user_annotation", "bench:job", 2, 996),
        _event("cuda_runtime", "cudaLaunchKernel", 110, 5, tid=2, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 120, 5, tid=2, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 500, 5, tid=1, corr=3),
        _event("kernel", "gemm", 200, 100, corr=1),
        _event("kernel", "topk", 300, 50, corr=2),
        _event("kernel", "other", 600, 30, corr=3),
        _event("gpu_memcpy", "Memcpy HtoD", 700, 20),
        _event("gpu_user_annotation", "bench:window", 200, 150),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    host = [("job", -5.0 + 1e-6, -5.0 + 998e-6),
            ("spr_screen_step", -5.0 + 100e-6, -5.0 + 400e-6),
            ("window", -5.0, -5.0 + 1000e-6)]
    summary = reduce_trace(str(path), host)
    assert summary["align_us"] == pytest.approx(1.0)
    assert summary["window_s"] == pytest.approx(1e-3)
    assert summary["busy_s"] == pytest.approx(200e-6)
    assert summary["span_device_s"]["spr_screen_step"] \
        == pytest.approx(150e-6)
    assert summary["span_device_s"]["job"] == pytest.approx(30e-6)
    assert summary["device_ops"][0] == ["gemm", pytest.approx(100e-6)]
    # idle: 0-200 (none 0-2, job 2-100, step 100-200), 350-400 step,
    # 400-600, 630-700 and 720-998 job, 998-1000 none
    gaps = dict(summary["idle_gaps"])
    assert gaps == {"job": pytest.approx(646e-6, abs=2e-6),
                    "spr_screen_step": pytest.approx(150e-6, abs=2e-6),
                    "none": pytest.approx(4e-6, abs=2e-6)}
    step = {"kind": "spr_screen_step", "rows": 1000, "queries": 256,
            "D": 8192, "elem": 4, "q_feats": 64, "q_index_bytes": 4,
            "changed": 0, "a_feats": 0, "a_index_bytes": 0, "topm": 128,
            "row_mask_bytes": 1}
    peaks = peaks_for(H100)
    rec = Records([_tree()], 1e-3, 1.0, summary, [step], peaks)
    cell = Cell(CELLS[0])
    share = cell.reader("kernel.spr_screen_roofline")(rec)
    assert share == pytest.approx(100 * bound_s(step, peaks)[0] / 150e-6)
    assert 0 < share < 100
    assert cell.reader("device.idle_share.tree")(rec) == pytest.approx(80)


def test_roofline_of_the_full_pool_product():
    """[256, 8192] x [8192, 65536], every row valid: the product's bound
    of PERF.md, 4.1027 ms, set by the FLOPs."""
    step = {"kind": "proxy_step", "rows": 65536, "queries": 256,
            "D": 8192, "elem": 4, "q_feats": 0, "q_index_bytes": 4,
            "changed": 0, "a_feats": 0, "a_index_bytes": 0, "topm": 0,
            "row_mask_bytes": 0}
    flops, nbytes = work_counts(step)
    assert flops == 2 * 256 * 8192 * 65536
    seconds, by = bound_s(step, peaks_for(H100))
    assert by == "flops"
    assert round(seconds * 1e3, 4) == 4.1027
    assert peaks_for("cpu") is None


def test_the_command_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.readings, benchmark.trace\n"
            "import benchmark.harness.session, benchmark.harness.jobs\n"
            "import benchmark.harness.datasets\n"
            "from benchmark.trace import wrap_port, Spans, unwrap\n"
            "unwrap(wrap_port(Spans(), []))\n"
            "import maple_tpu_torch.pipeline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, check=True)
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "maple_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "maple_tpu"}


def test_without_a_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", CELLS[0], "--seed", str(2 ** 31 + 11), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
