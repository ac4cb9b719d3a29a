"""The port's ``--deviceTopology`` pipeline against the JAX package.

Whole runs on example_sub80 (placement, root search, SPR rounds with the
device screen, EM, outputs) through each package's ``run_inference`` with
the same flags: once with host placement, once with the pipelined device
placement (``MAPLE_DEVICE_RT=1``).  The final LKs must agree.

The rounds loop and ``Run.run`` are copies of maple_tpu's with one call
swapped; their syntax trees are held against maple_tpu's, so that a change
to either side fails here instead of drifting apart.
"""
import ast
import inspect
import textwrap

import pytest
import torch

from maple_tpu import pipeline as jax_pipeline
from maple_tpu.config import MapleConfig
from maple_tpu.pipeline import run_inference as jax_inference
from maple_tpu.search import spr as jax_spr

from maple_tpu_torch import pipeline as port_pipeline
from maple_tpu_torch.parallel import batch_spr as TB
from maple_tpu_torch.pipeline import run_inference
from maple_tpu_torch.search import spr as port_spr

from test_torch_pipeline import LK_TOL, SUB80, read_lk

CPU = torch.device("cpu")


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and imports (the copies import at module level),
    reads ``base.X`` (the port's name for maple_tpu.pipeline) as ``X``, and
    drops the ``_time`` argument that maple_tpu threads through its rounds
    body (the copy imports ``time as _time``)."""

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:]
        node.args.args = [a for a in node.args.args if a.arg != "_time"]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.args = [a for a in node.args
                     if not (isinstance(a, ast.Name) and a.id == "_time")]
        return node

    def visit_Attribute(self, node):
        self.generic_visit(node)
        if isinstance(node.value, ast.Name) and node.value.id == "base":
            return ast.Name(id=node.attr, ctx=node.ctx)
        return node


def _device_branch(fn: ast.FunctionDef) -> ast.If:
    (branch,) = [n for n in fn.body if isinstance(n, ast.If)
                 and "device_topology" in ast.unparse(n.test)]
    return branch


def _tree(fn) -> ast.FunctionDef:
    (node,) = ast.parse(textwrap.dedent(inspect.getsource(fn))).body
    return _Normalise().visit(node)


@pytest.mark.parametrize("ref,port", [
    (jax_spr._parallel_update, port_spr._parallel_update),
    (jax_spr.run_spr_rounds, port_spr.run_spr_rounds),
    (jax_spr._run_spr_rounds_body, port_spr._run_spr_rounds_body),
    (jax_pipeline.Run.run, port_pipeline.Run.run),
], ids=["_parallel_update", "run_spr_rounds", "_run_spr_rounds_body",
        "Run.run"])
def test_copied_host_code_matches_maple_tpu(ref, port):
    ref_t, port_t = _tree(ref), _tree(port)
    if ref is jax_spr._parallel_update:
        # the one swapped call: the port's screen on run.device
        ref_b, port_b = _device_branch(ref_t), _device_branch(port_t)
        assert "device_topology_update(" in ast.unparse(ref_b)
        assert ast.unparse(port_b.body[-1]) == (
            "return device_topology_update(rt, run.root, params, "
            "SprCounters(), device=run.device)")
        ref_b.body = port_b.body = [ast.Pass()]
    assert ast.dump(port_t) == ast.dump(ref_t), \
        f"{port.__qualname__} has drifted from maple_tpu's copy"


@pytest.mark.parametrize("placement", ["host", "device"])
def test_device_topology_pipeline_matches_jax(tmp_path, monkeypatch,
                                              placement):
    monkeypatch.delenv("MAPLE_SPR_EXACT", raising=False)
    flags = dict(input=SUB80, model="GTR", overwrite=True,
                 device_topology=True)
    if placement == "device":
        monkeypatch.setenv("MAPLE_DEVICE_RT", "1")
        flags.update(device_placement=True, device_warmup=16,
                     device_batch_size=16)
    TB.stats.reset()
    run = run_inference(MapleConfig(output=str(tmp_path / "port"), **flags),
                        CPU)
    assert TB.stats.passes, "no device SPR screen ran"
    assert all(p.branch == "proxy" for p in TB.stats.passes)
    assert (run.pplacer is not None) == (placement == "device")
    jax_inference(MapleConfig(output=str(tmp_path / "jax"), **flags))
    lk_port = read_lk(str(tmp_path / "port"))
    lk_jax = read_lk(str(tmp_path / "jax"))
    assert abs(lk_port - lk_jax) <= LK_TOL, (lk_port, lk_jax)
