"""The port's pipeline and command line on the CPU.

The whole ``--devicePlacement`` run (placement, EM, root search, SPR,
outputs) through each of its branches against maple_tpu's serial pipeline
on the same flags; the port never importing jax or maple_tpu; the command
line refusing to run without CUDA.  The branches over a mesh of ranks are
in ``test_torch_mesh.py`` and ``test_torch_mesh_proxy.py``.
"""
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from maple_tpu.config import MapleConfig as SerialConfig
from maple_tpu.pipeline import run_inference as serial_inference

from maple_tpu_torch import cli
from maple_tpu_torch.config import MapleConfig
from maple_tpu_torch.pipeline import run_inference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
CPU = torch.device("cpu")
LK_TOL = 1e-6
BRANCH_ENV = ("MAPLE_DEVICE_RT", "MAPLE_DEVICE_LEGACY", "MAPLE_PROXY_BF16",
              "MAPLE_PROXY_D")


def read_lk(prefix):
    with open(prefix + "_LK.txt") as f:
        return float(f.read().strip())


@pytest.fixture(scope="module")
def serial_lk(tmp_path_factory):
    ser = str(tmp_path_factory.mktemp("ser") / "ser")
    serial_inference(SerialConfig(input=SUB80, output=ser, model="GTR",
                                  overwrite=True))
    return read_lk(ser)


def test_full_pipeline_matches_serial(tmp_path, monkeypatch, serial_lk):
    monkeypatch.setenv("MAPLE_DEVICE_RT", "1")
    dev = str(tmp_path / "dev")
    run = run_inference(MapleConfig(input=SUB80, output=dev, model="GTR",
                                    overwrite=True, device_placement=True,
                                    device_warmup=16, device_batch_size=16),
                        CPU)
    # 64 samples after the warmup went through device screens
    assert run.pplacer.n_total == 80 and run.pplacer.pool.capacity > 0
    assert os.path.getsize(dev + "_tree.tree") > 0
    assert abs(read_lk(dev) - serial_lk) <= LK_TOL


def test_full_pipeline_default_branch_matches_serial(tmp_path, monkeypatch,
                                                     serial_lk):
    """Default flags take the proxy branch; the whole run's LK is the
    serial pipeline's."""
    for name in BRANCH_ENV:
        monkeypatch.delenv(name, raising=False)
    dev = str(tmp_path / "dev")
    run = run_inference(MapleConfig(input=SUB80, output=dev, model="GTR",
                                    overwrite=True, device_placement=True,
                                    device_warmup=16, device_proxy_batch=32),
                        CPU)
    assert run.rt.kern.name == "native"
    assert run.proxy_placer is not None and run.proxy_placer.steps == 2
    assert run.pplacer is None and run.legacy_placer is None
    assert abs(read_lk(dev) - serial_lk) <= LK_TOL


def test_full_pipeline_legacy_branch_matches_serial(tmp_path, monkeypatch,
                                                    serial_lk):
    """MAPLE_DEVICE_LEGACY with --devicePallas takes the legacy placer on
    the pair kernel."""
    for name in BRANCH_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPLE_DEVICE_LEGACY", "1")
    dev = str(tmp_path / "dev")
    run = run_inference(MapleConfig(input=SUB80, output=dev, model="GTR",
                                    overwrite=True, device_placement=True,
                                    device_pallas=True, device_warmup=16,
                                    device_batch_size=16), CPU)
    assert run.legacy_placer is not None and run.legacy_placer.pool.capacity
    assert run.pplacer is None and run.proxy_placer is None
    assert abs(read_lk(dev) - serial_lk) <= LK_TOL


def test_full_pipeline_legacy_default_scorer_matches_serial(
        tmp_path, monkeypatch, serial_lk):
    """MAPLE_DEVICE_LEGACY without --devicePallas takes the legacy placer
    on the interval-algebra scorer."""
    for name in BRANCH_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPLE_DEVICE_LEGACY", "1")
    dev = str(tmp_path / "dev")
    run = run_inference(MapleConfig(input=SUB80, output=dev, model="GTR",
                                    overwrite=True, device_placement=True,
                                    device_warmup=16, device_batch_size=16),
                        CPU)
    placer = run.legacy_placer
    assert placer is not None and not placer.use_pallas and placer.dm
    assert run.pplacer is None and run.proxy_placer is None
    assert abs(read_lk(dev) - serial_lk) <= LK_TOL


def test_pipeline_never_imports_jax(tmp_path):
    """The default pipeline (proxy placement, the device SPR screen) in a
    fresh process ends with neither jax nor maple_tpu loaded."""
    script = textwrap.dedent(f"""
        import os, sys
        import torch
        from maple_tpu_torch.config import MapleConfig
        from maple_tpu_torch.parallel import batch_spr
        from maple_tpu_torch.pipeline import run_inference
        for name in {BRANCH_ENV!r}:
            os.environ.pop(name, None)
        run = run_inference(MapleConfig(input={SUB80!r},
                                  output={str(tmp_path / "nojax")!r},
                                  overwrite=True, device_placement=True,
                                  device_warmup=16, device_proxy_batch=32,
                                  numTopologyImprovements=1,
                                  device_topology=True),
                      torch.device("cpu"))
        loaded = [m for m in sys.modules
                  if m in ("jax", "maple_tpu")
                  or m.startswith(("jax.", "maple_tpu."))]
        assert not loaded, loaded
        assert run.proxy_placer.steps > 0, "no proxy screen ran"
        assert batch_spr.stats.passes, "no device SPR screen ran"
        print("NO_JAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert os.path.getsize(str(tmp_path / "nojax") + "_tree.tree") > 0


@pytest.mark.parametrize("flag", ["--deviceTopology", "--devicePallas"])
def test_cli_raises_on_unported_flags(tmp_path, monkeypatch, flag):
    """No device flag is refused by the command line any more: both are
    taken, and the run goes on to the CUDA check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--input", SUB80, "--output", str(tmp_path / "x"),
                  "--devicePlacement", flag])
    assert not os.path.exists(str(tmp_path / "x") + "_tree.tree")


def test_cli_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--input", SUB80, "--output", str(tmp_path / "x"),
                  "--devicePlacement"])
    assert not os.path.exists(str(tmp_path / "x") + "_tree.tree")


def test_package_source_has_no_jax_import():
    """No file of the port, nor chip_smoke.py, imports jax or maple_tpu."""
    pkg = os.path.join(ROOT, "maple_tpu_torch")
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|maple_tpu)(\.|\s|$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, name) for name in files
                  if name.endswith((".py", ".cu"))]
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path
    assert len(paths) >= 55
