"""The port's benchmark tools at a small size on the CPU: the multi-rank
benchmark on gloo ranks, the device benchmark and the SPR-recall benchmark
with the CPU named (the kernels' plain versions), their in-tool assertions
and their output fields; the scale and support benchmarks against the JAX
scripts they twin, on the same alignments; and every tool refusing to run
without a card unless the CPU is named."""
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from maple_tpu_torch.tools import benchmark_device as BD
from maple_tpu_torch.tools import benchmark_multihost as BM
from maple_tpu_torch.tools import benchmark_scale as BSC
from maple_tpu_torch.tools import benchmark_spr_recall as BR
from maple_tpu_torch.tools import benchmark_support as BSU
from maple_tpu_torch.tools.common import GENERATOR, ROOT, ensure_dataset

CPU = torch.device("cpu")
LK_TOL = 1e-6            # the proxy path's exact-parity contract
BRANCH_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
              "MAPLE_PROXY_D", "MAPLE_SPR_EXACT")
PLACEMENT_FIELDS = {"pid", "nproc", "mesh", "wall_s", "lk", "finding_s",
                    "placing_s", "screen_s", "export_s", "place_s",
                    "group_wall_s", "seq_per_s", "efficiency_vs_1proc"}
SCREEN_FIELDS = {"nproc", "rows", "k", "D", "screen_step_s",
                 "group_wall_s", "speedup_vs_1proc"}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in BRANCH_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench"))


def single_device_lks(workdir, samples):
    """The proxy placement of the tools' alignment on one device by each
    package, with default flags: (the port's LK, maple_tpu's LK)."""
    from test_torch_proxy_placer import make_run, placement_lk
    aln, _ = ensure_dataset(workdir, samples, 1, 1.5, 0.2, 0.05)
    lks = []
    for name in ("maple_tpu_torch", "maple_tpu"):
        run = make_run(name, pathlib.Path(workdir), input=aln,
                       model="UNREST", device_placement=True)
        run.build_initial_tree_device(warmup=run.cfg.device_warmup)
        lks.append(placement_lk(run))
    return lks


def test_benchmark_multihost_gloo(workdir):
    """Groups of 1 and 2 gloo ranks: the same LK on every rank and in every
    group, the single-device proxy placement's in both packages (on this
    alignment not serial placement's: the seeded crawl is not the serial
    search), and the JAX script's fields."""
    res = BM.benchmark(1000, [1, 2], [1, 2], backend="gloo",
                       workdir=workdir, screen_rows=8192, screen_iters=1)
    assert res["device"] == "cpu" and res["lk_identical_across_groups"]
    groups = res["groups"]
    assert [g["nproc"] for g in groups] == [1, 2]
    assert [g["mesh"] for g in groups] == [{"dp": 1, "cand": 1},
                                           {"dp": 1, "cand": 2}]
    for g in groups:
        assert PLACEMENT_FIELDS <= set(g)
        assert g["steps"] == -(-(1000 - 256) // 256)
        assert g["seq_per_s"] == pytest.approx(1000 / g["wall_s"])
    assert groups[0]["efficiency_vs_1proc"] == 1.0
    for lk in single_device_lks(workdir, 1000):
        assert abs(groups[0]["lk"] - lk) <= LK_TOL
    screen = res["screen_strong_scaling"]
    assert [s["nproc"] for s in screen] == [1, 2]
    for s in screen:
        assert set(s) >= SCREEN_FIELDS and s["rows"] == 8192
        assert s["screen_step_s"] > 0 and s["finite"]
    assert screen[0]["speedup_vs_1proc"] == 1.0


@pytest.mark.parametrize("mesh,spr", [(0, True), (2, False)],
                         ids=["single-spr", "mesh2"])
def test_benchmark_device_cpu(workdir, mesh, spr):
    """One device, with the SPR pass; two gloo ranks (the mesh SPR screen
    is the dry run's, test_torch_mesh.py)."""
    res = BD.benchmark(400, device=CPU, workdir=workdir, spr=spr, mesh=mesh)
    assert res["device"] == "cpu" and res["placer"] == "proxy"
    assert res["mesh"] == (mesh or None)
    for key in ("serial_placement_s", "serial_seq_per_s",
                "device_placement_s", "device_seq_per_s",
                "rf_device_vs_serial", "nrf_device_vs_serial",
                "nrf_serial_vs_truth", "nrf_device_vs_truth"):
        assert key in res, key
    # on this input the proxy placement lands serial's tree and LK
    assert abs(res["lk_delta_device_minus_serial"]) <= LK_TOL
    assert res["rf_device_vs_serial"] == 0
    assert 0 <= res["nrf_device_vs_truth"] <= 1
    assert ("device_spr_moves" in res) == spr
    if spr:
        assert res["device_lk_after_spr"] >= res["device_lk"] - 1e-6
        assert res["device_spr_s"] > 0 and res["device_spr_moves"] >= 0


def test_benchmark_spr_recall_cpu(workdir):
    """Serial, proxy and exhaustive passes on one starting tree.  At mutation
    rate 0.5 the serial placement of 400 samples leaves one SPR move of
    +9.997 log-LK, which every pass finds."""
    res = BR.benchmark(400, device=CPU, workdir=workdir, cores=2,
                       exact=True, mut_rate=0.5)
    for name in ("serial_pass", "device_screen_pass", "exact_screen_pass"):
        p = res[name]
        assert {"improvement", "wall_s", "lk_after", "applied_gain"} <= set(p)
        assert p["applied_gain"] >= -1e-6
        assert p["lk_after"] == pytest.approx(res["start_lk"]
                                              + p["applied_gain"])
    assert res["serial_pass"]["applied_gain"] > 1
    assert res["device_screen_pass"]["moves"] >= 1
    assert res["exact_screen_pass"]["moves"] >= 1
    assert res["device_recall_of_serial_gain"] == pytest.approx(
        res["device_screen_pass"]["applied_gain"]
        / res["serial_pass"]["applied_gain"]) == pytest.approx(1.0)
    assert res["proxy_recall_of_exact_gain"] == pytest.approx(
        res["device_screen_pass"]["applied_gain"]
        / res["exact_screen_pass"]["applied_gain"]) == pytest.approx(1.0)


def test_benchmark_scale_cpu(tmp_path):
    """The assertions of tests/test_benchmark_scale.py at 300 samples, seed
    3, and the JAX script's ``run_one`` on the same alignment: the same LK
    and RF (both packages run the same host engine on the --fast
    preset)."""
    assert BSC.main(["--sizes", "300", "--workdir", str(tmp_path),
                     "--seed", "3", "--device", "cpu"]) == 0
    rows = (tmp_path / "scale_results.jsonl").read_text().splitlines()
    row = json.loads(rows[-1])
    assert row["samples"] == 300 and row["device"] == "cpu"
    assert row["placement_seq_per_s"] > 0
    assert row["lk"] < 0
    assert row["normalised_rf"] < 0.3
    assert 0 <= row["rfl"] < 0.1
    assert {"wall_s", "max_rss_mb", "placement_s", "topology_s", "phases_s",
            "rf", "mode", "seed", "mut_rate", "flags", "ts"} <= set(row)
    sys.path.insert(0, ROOT)
    from scripts.benchmark_scale import run_one
    aln, truth = ensure_dataset(str(tmp_path), 300, 3, 1.5, 0.2, 0.05)
    ref = run_one(aln, truth, str(tmp_path / "jax_n300"), True, {})
    assert abs(row["lk"] - ref["lk"]) <= LK_TOL
    assert (row["rf"], row["normalised_rf"], row["rfl"]) \
        == (ref["rf"], ref["normalised_rf"], ref["rfl"])
    assert row["samples"] == ref["samples"]


def test_benchmark_support_cpu(tmp_path):
    """The assertions of tests/test_support_calibration.py on its noisy
    1,000-sample alignment, and the same rows as the JAX script's
    ``run_calibration`` on it."""
    aln, truth = str(tmp_path / "sup.maple.gz"), str(tmp_path / "sup.nwk")
    subprocess.run(
        [sys.executable, GENERATOR, "--samples", "1000", "--seed", "1",
         "--mutRate", "0.4", "--nRate", "2", "--output", aln,
         "--treeOut", truth], check=True, timeout=300)
    rows, n_supported = BSU.run_calibration(aln, truth,
                                            str(tmp_path / "port"),
                                            device=CPU)
    assert n_supported > 100
    top = [r for r in rows if r[0] >= 0.95 and r[2] > 0]
    low = [r for r in rows if r[1] <= 0.8 and r[2] > 0]
    assert top and top[-1][2] >= 50
    top_frac = top[-1][3]
    assert top_frac >= 0.85
    low_n = sum(r[2] for r in low)
    if low_n:
        assert sum(r[2] * r[3] for r in low) / low_n < top_frac
    sys.path.insert(0, ROOT)
    from scripts.benchmark_support import run_calibration
    ref, ref_n = run_calibration(aln, truth, str(tmp_path / "jax"))
    assert n_supported == ref_n and len(rows) == len(ref)
    for got, want in zip(rows, ref):
        assert all(a == b or (math.isnan(a) and math.isnan(b))
                   for a, b in zip(got, want)), (got, want)


def test_benchmark_support_main_cpu(tmp_path, capsys):
    """The command line with the CPU named: the table and one JSON line
    with the JAX script's fields and the device."""
    assert BSU.main(["--samples", "200", "--workdir", str(tmp_path),
                     "--device", "cpu"]) == 0
    line = (tmp_path / "support_calibration.jsonl").read_text().splitlines()
    res = json.loads(line[-1])
    assert res["device"] == "cpu" and res["samples"] == 200
    assert res["n_supported"] == sum(b["n"] for b in res["bins"]) > 0
    assert {"seed", "support_for_0branches", "mut_rate", "n_rate",
            "amb_rate", "ts"} <= set(res)
    assert "support bin" in capsys.readouterr().out
    assert os.path.isfile(tmp_path / "sup_run_n200_s1_m1.5_nexusTree.tree")


@pytest.mark.parametrize("tool,argv", [
    ("tools.benchmark_device", []), ("tools.benchmark_spr_recall", []),
    ("tools.benchmark_multihost", []), ("dryrun", []),
    ("tools.benchmark_scale", []), ("tools.benchmark_support", []),
    ("tools.profile_tunnel", []), ("tools.bench", []),
    ("tools.benchmark_device", ["--device", "cpu", "--mesh", "2"])])
def test_tools_need_a_card_unless_the_cpu_is_named(monkeypatch, capsys,
                                                   tool, argv):
    """Without a card the default (the card, NCCL ranks) exits 2 before
    any work; the CPU is taken only when named.  The last case names the
    CPU and is refused nothing: it is stopped where it would start work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"maple_tpu_torch.{tool}")
    if "cpu" in argv:
        monkeypatch.setattr(mod, "benchmark", _stop)
        with pytest.raises(_Started):
            mod.main(argv)
        return
    assert mod.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


class _Started(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Started
