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
side fails here instead of drifting apart.  The port's spans
(``runtime/phases.py``) are taken out first: its ``with ... .span(...)``
blocks stand for their bodies, and ``Run.run``'s stages are its
``Run._stages`` (the run's tracer around them, the end-of-run breakdown
read from the tracer).
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


def _is_span(item: ast.withitem) -> bool:
    call = item.context_expr
    return isinstance(call, ast.Call) \
        and isinstance(call.func, ast.Attribute) and call.func.attr == "span"


def untraced(node):
    """``node`` with the port's tracer taken out: each ``with`` block of
    spans replaced by its body, ``tracer = ...`` dropped."""
    for field in ("body", "orelse", "finalbody"):
        stmts = getattr(node, field, None)
        if not isinstance(stmts, list):
            continue
        out, todo = [], list(stmts)
        while todo:
            stmt = todo.pop(0)
            if isinstance(stmt, ast.With) and all(map(_is_span,
                                                      stmt.items)):
                todo[:0] = stmt.body
            elif not (isinstance(stmt, ast.Assign)
                      and ast.unparse(stmt.targets[0]) == "tracer"):
                out.append(stmt)
        setattr(node, field, out)
    for child in ast.iter_child_nodes(node):
        untraced(child)
    return node


def stages_of_run(port_t, ref_t):
    """The bodies of maple_tpu's ``Run.run`` and of the port's
    ``Run._stages``, without docstrings: the port returns True or False
    where maple_tpu returns or ends, and maple_tpu's end-of-run phase
    breakdown (the port prints it from the tracer) is left out."""
    port_b, ref_b = port_t.body[1:], ref_t.body[1:]
    assert ast.unparse(port_b[-1]) == "return True"
    port_b = port_b[:-1]
    assert ast.unparse(ref_b[-2]) == "phases = self.rt.phase_times"
    ref_b = ref_b[:-2]
    for node in ast.walk(ast.Module(body=port_b, type_ignores=[])):
        if isinstance(node, ast.Return) and isinstance(node.value,
                                                       ast.Constant):
            assert node.value.value is False
            node.value = None
    return (ast.Module(body=port_b, type_ignores=[]),
            ast.Module(body=ref_b, type_ignores=[]))


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
    port_t = untraced(named(parse("maple_tpu_torch", rel))[
        "Run._stages" if name == "Run.run" else name])
    if name == "Run.run":
        port_t, ref_t = stages_of_run(port_t, ref_t)
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
