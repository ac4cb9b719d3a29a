"""Shared set-up of the benchmark's tests.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which decides inside the test whether there is one; run them on
the card with ``python3 -m pytest benchmark/tests -m card``.  The others
run on the CPU, with the port's plain PyTorch versions.
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def make_root(tmp_path, configs=(), traffic=(), cells=(), limits=(),
              metrics=()):
    """A copy of the benchmark's data beside ``tmp_path``'s own
    BENCHMARK.json, with the files and entries given added: the layout a
    later change that only adds files would leave."""
    bench = os.path.join(ROOT, "benchmark")
    dst = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics", "device", "data"):
        shutil.copytree(os.path.join(bench, sub), dst / sub)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for name, body in configs:
        (dst / "configs" / f"{name}.json").write_text(json.dumps(body))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "test"})
    for name, body in traffic:
        (dst / "traffic" / f"{name}.json").write_text(json.dumps(body))
    for name, body in limits:
        (dst / "limits" / f"{name}.json").write_text(json.dumps(body))
    for name, source, entry in metrics:
        (dst / "metrics" / f"{name}.py").write_text(source)
        spec["per_layer"].append(entry)
    spec["workloads"].extend(cells)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(tmp_path)
