"""The port's pipeline and command line on the CPU.

The whole ``--devicePlacement`` run (placement, EM, root search, SPR,
outputs) against maple_tpu's serial pipeline on the same flags; the port
never importing jax; and the flags and branches that are not ported yet
raising instead of falling back.
"""
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from maple_tpu.config import MapleConfig
from maple_tpu.pipeline import run_inference as serial_inference

from maple_tpu_torch import cli
from maple_tpu_torch.pipeline import (LEGACY_NOT_PORTED, PROXY_NOT_PORTED,
                                      Run, run_inference)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SUB80 = os.path.join(HERE, "goldens", "example_sub80.maple")
CPU = torch.device("cpu")
LK_TOL = 1e-6


def read_lk(prefix):
    with open(prefix + "_LK.txt") as f:
        return float(f.read().strip())


def test_full_pipeline_matches_serial(tmp_path, monkeypatch):
    monkeypatch.setenv("MAPLE_DEVICE_RT", "1")
    dev = str(tmp_path / "dev")
    run = run_inference(MapleConfig(input=SUB80, output=dev, model="GTR",
                                    overwrite=True, device_placement=True,
                                    device_warmup=16, device_batch_size=16),
                        CPU)
    # 64 samples after the warmup went through device screens
    assert run.pplacer.n_total == 80 and run.pplacer.pool.capacity > 0
    assert os.path.getsize(dev + "_tree.tree") > 0
    ser = str(tmp_path / "ser")
    serial_inference(MapleConfig(input=SUB80, output=ser, model="GTR",
                                 overwrite=True))
    assert abs(read_lk(dev) - read_lk(ser)) <= LK_TOL


def test_pipeline_never_imports_jax(tmp_path):
    script = textwrap.dedent(f"""
        import os, sys
        import torch
        from maple_tpu.config import MapleConfig
        from maple_tpu_torch.parallel import batch_spr
        from maple_tpu_torch.pipeline import run_inference
        os.environ["MAPLE_DEVICE_RT"] = "1"
        run = run_inference(MapleConfig(input={SUB80!r},
                                  output={str(tmp_path / "nojax")!r},
                                  overwrite=True, device_placement=True,
                                  device_warmup=16, device_batch_size=16,
                                  numTopologyImprovements=1,
                                  device_topology=True),
                      torch.device("cpu"))
        assert "jax" not in sys.modules, "jax was imported"
        assert run.pplacer.pool.capacity > 0, "no device screen ran"
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
    """--devicePallas is not ported and raises; --deviceTopology is ported,
    so the CLI takes it and goes on to the CUDA check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if flag == "--deviceTopology":
        expected, match = RuntimeError, "CUDA"
    else:
        expected, match = NotImplementedError, flag
    with pytest.raises(expected, match=match):
        cli.main(["--input", SUB80, "--output", str(tmp_path / "x"),
                  "--devicePlacement", flag])
    assert not os.path.exists(str(tmp_path / "x") + "_tree.tree")


def test_cli_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--input", SUB80, "--output", str(tmp_path / "x"),
                  "--devicePlacement"])
    assert not os.path.exists(str(tmp_path / "x") + "_tree.tree")


@pytest.mark.parametrize("env,message", [
    ({}, PROXY_NOT_PORTED),
    ({"MAPLE_DEVICE_LEGACY": "1"}, LEGACY_NOT_PORTED)],
    ids=["proxy", "legacy"])
def test_unported_branches_raise(tmp_path, monkeypatch, env, message):
    """Without MAPLE_DEVICE_RT the native run takes the proxy branch, and
    MAPLE_DEVICE_LEGACY the legacy one: both raise, no host fallback."""
    monkeypatch.delenv("MAPLE_DEVICE_RT", raising=False)
    monkeypatch.delenv("MAPLE_DEVICE_LEGACY", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    run = Run(MapleConfig(input=SUB80, output=str(tmp_path / "x"),
                          device_placement=True), CPU)
    run.load()
    with pytest.raises(NotImplementedError) as exc:
        run.build_initial_tree_device(warmup=16, batch_size=16)
    assert str(exc.value) == message
    assert "MAPLE_DEVICE_RT=1" in message


def test_package_source_has_no_jax_import():
    pkg = os.path.join(ROOT, "maple_tpu_torch")
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    checked = 0
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert not pattern.search(src), os.path.join(dirpath, name)
                checked += 1
    assert checked >= 10
