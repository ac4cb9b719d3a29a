"""The port's benchmark tools at a small size on the CPU: the multi-rank
benchmark on gloo ranks, the device benchmark and the SPR-recall benchmark
with the CPU named (the kernels' plain versions), their in-tool assertions
and their output fields; and every tool refusing to run without a card
unless the CPU is named."""
import importlib
import pathlib

import pytest
import torch

from maple_tpu_torch.tools import benchmark_device as BD
from maple_tpu_torch.tools import benchmark_multihost as BM
from maple_tpu_torch.tools import benchmark_spr_recall as BR
from maple_tpu_torch.tools.common import ensure_dataset

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


@pytest.mark.parametrize("tool,argv", [
    ("tools.benchmark_device", []), ("tools.benchmark_spr_recall", []),
    ("tools.benchmark_multihost", []), ("dryrun", []),
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
