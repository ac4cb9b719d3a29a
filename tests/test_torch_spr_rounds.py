"""The port's ``--deviceTopology`` pipeline against the JAX package.

Whole runs on example_sub80 (placement, root search, SPR rounds with the
device screen, EM, outputs) through each package's ``run_inference`` with
the same flags: once with host placement, once with the pipelined device
placement (``MAPLE_DEVICE_RT=1``), once with the default proxy placement.
The final LKs must agree.

The rounds loop and ``Run.run`` are copies of maple_tpu's; of
``_parallel_update`` only the device branch differs (the port's screen on
``run.device``).  Their syntax trees are held against maple_tpu's (with
the whole modules, in test_torch_copies.py), so that a change to either
side fails here instead of drifting apart.
"""
import ast

import pytest
import torch

from maple_tpu.config import MapleConfig as JaxConfig
from maple_tpu.pipeline import run_inference as jax_inference

from maple_tpu_torch.config import MapleConfig
from maple_tpu_torch.parallel import batch_spr as TB
from maple_tpu_torch.pipeline import run_inference

from test_torch_copies import named, parse
from test_torch_pipeline import LK_TOL, SUB80, read_lk

CPU = torch.device("cpu")


def _device_branch(fn: ast.FunctionDef) -> ast.If:
    (branch,) = [n for n in fn.body if isinstance(n, ast.If)
                 and "device_topology" in ast.unparse(n.test)]
    return branch


@pytest.mark.parametrize("rel,name", [
    ("search/spr.py", "_parallel_update"),
    ("search/spr.py", "run_spr_rounds"),
    ("search/spr.py", "_run_spr_rounds_body"),
    ("pipeline.py", "Run.run"),
], ids=["_parallel_update", "run_spr_rounds", "_run_spr_rounds_body",
        "Run.run"])
def test_copied_host_code_matches_maple_tpu(rel, name):
    ref_t = named(parse("maple_tpu", rel))[name]
    port_t = named(parse("maple_tpu_torch", rel))[name]
    if name == "_parallel_update":
        # the one swapped call: the port's screen on run.device
        ref_b, port_b = _device_branch(ref_t), _device_branch(port_t)
        assert "device_topology_update(" in ast.unparse(ref_b)
        assert ast.unparse(port_b.body[-1]) == (
            "return device_topology_update(rt, run.root, params, "
            "SprCounters(), device=run.device)")
        ref_b.body = port_b.body = [ast.Pass()]
        ref_t.body, port_t.body = ref_t.body[1:], port_t.body[1:]  # docs
    assert ast.dump(port_t) == ast.dump(ref_t), \
        f"{name} has drifted from maple_tpu's copy"


@pytest.mark.parametrize("placement", ["host", "device", "proxy"])
def test_device_topology_pipeline_matches_jax(tmp_path, monkeypatch,
                                              placement):
    for name in ("MAPLE_SPR_EXACT", "MAPLE_DEVICE_RT",
                 "MAPLE_DEVICE_LEGACY"):
        monkeypatch.delenv(name, raising=False)
    flags = dict(input=SUB80, model="GTR", overwrite=True,
                 device_topology=True)
    if placement == "device":
        monkeypatch.setenv("MAPLE_DEVICE_RT", "1")
    if placement != "host":
        flags.update(device_placement=True, device_warmup=16,
                     device_batch_size=16, device_proxy_batch=32)
    TB.stats.reset()
    run = run_inference(MapleConfig(output=str(tmp_path / "port"), **flags),
                        CPU)
    assert TB.stats.passes, "no device SPR screen ran"
    assert all(p.branch == "proxy" for p in TB.stats.passes)
    assert (run.pplacer is not None) == (placement == "device")
    assert (run.proxy_placer is not None) == (placement == "proxy")
    jax_inference(JaxConfig(output=str(tmp_path / "jax"), **flags))
    lk_port = read_lk(str(tmp_path / "port"))
    lk_jax = read_lk(str(tmp_path / "jax"))
    assert abs(lk_port - lk_jax) <= LK_TOL, (lk_port, lk_jax)
