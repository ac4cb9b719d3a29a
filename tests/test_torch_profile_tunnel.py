"""The port's dispatch profile (``maple_tpu_torch/tools/profile_tunnel.py``)
on the CPU against the JAX script it twins (``scripts/profile_tunnel.py``):
its score grid against maple_tpu's ``grid_append_scores`` on operands that
each package builds with its own modules from the same in-repo alignment,
in float64 and in float32; its tiling against the JAX script's row order;
its output keys against the keys the JAX script writes (read from its
source, not run); and ``--out`` appending one line a call."""
import ast
import json
import math
import os

import numpy as np
import torch

import jax.numpy as jnp

from maple_tpu.ops import append_batch as AB

from maple_tpu_torch.tools import profile_tunnel as PT
from maple_tpu_torch.tools.common import ROOT

from test_torch_append_batch import F32_ATOL, F32_RTOL
from test_torch_append_pairs import (REL_JAX, assert_same_scores,  # noqa: F401
                                     x64)

CPU = torch.device("cpu")
SCRIPT = os.path.join(ROOT, "scripts", "profile_tunnel.py")
N_CANDS, N_QUERIES = 16, 4
# the first 20 samples of the input hold lists of up to 82 entries
BUDGET = 96
TIMES = ("null_dispatch_ms", "readback_4B_ms", "readback_4MB_ms",
         "readback_MB_per_s", "score_call_ms", "score_call_scores_per_s")


def jax_example_state(n_candidates, n_queries, budget, input):
    """``__graft_entry__._example_state`` on ``input``: the same lines,
    with maple_tpu's own modules."""
    from maple_tpu.config import DerivedConfig, MapleConfig
    from maple_tpu.core import kernels as K
    from maple_tpu.core.genomelist import shorten, terminal_node_genome_list
    from maple_tpu.io.maple_format import read_maple_alignment
    from maple_tpu.ops import pack as OP
    from maple_tpu.refdata import Model, RefData

    ref, data = read_maple_alignment(input)
    refd = RefData.build(ref, model="GTR")
    model = Model.initial(refd, "GTR")
    dc = DerivedConfig.build(MapleConfig(), refd.lRef)
    ctx = K.KernelCtx(refd, model, dc)
    tips = []
    for name in list(data)[:n_candidates + n_queries]:
        v = terminal_node_genome_list(refd, data[name])
        shorten(v, dc.thresholdProb)
        tips.append(v)
    uppers = [K.root_vector_frame(ctx, v, dc.oneMutBLen, True)
              for v in tips[:n_candidates]]
    queries = tips[n_candidates:n_candidates + n_queries]
    P = OP.pack_genome_lists(uppers, refd.lRef, budget, False, np.float32)
    C = OP.pack_genome_lists(queries, refd.lRef, budget, False, np.float32)
    return refd, model, dc, P, C


def jax_tile(arrs, n):
    """``tile`` of scripts/profile_tunnel.py."""
    return {k: jnp.asarray(np.concatenate(
        [np.asarray(v)] * (n // v.shape[0] + 1), axis=0)[:n])
        for k, v in arrs.items()}


def jax_grid(dtype, B1, B2):
    """The JAX script's scoring call at this shape, on maple_tpu."""
    _, model, dc, P, C = jax_example_state(N_CANDS, N_QUERIES, BUDGET,
                                           PT.DEFAULT_INPUT)
    jdt = getattr(jnp, dtype)
    dm = AB.device_model_from(model, dc, dtype=jdt)
    return np.asarray(AB.grid_append_scores(
        jax_tile(AB.to_device(P, jdt), B2),
        jax_tile(AB.to_device(C, jdt), B1), dc.oneMutBLen, True, dm))


def port_grid(dtype, B1, B2):
    return PT.score_call(PT.score_call_state(
        CPU, BUDGET, B1, B2, dtype=getattr(torch, dtype),
        n_candidates=N_CANDS, n_queries=N_QUERIES))


def jax_script_keys():
    """The keys of the JAX script's result: those of the dict it starts
    ``res`` with and every ``res["..."]`` it assigns."""
    keys = set()
    for node in ast.walk(ast.parse(open(SCRIPT).read())):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == "res":
                keys |= {k.value for k in node.value.keys}
            elif isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name) and t.value.id == "res":
                keys.add(t.slice.value)
    return keys


def test_score_grid_matches_jax_float64(x64):
    """16 candidates and 4 queries tiled to B2 64 and B1 8, float64."""
    got, want = port_grid("float64", 8, 64), jax_grid("float64", 8, 64)
    assert got.shape == (8, 64) and got.dtype == np.float64
    assert np.isfinite(got).any()
    assert_same_scores(got, want, REL_JAX, "float64 grid")


def test_score_grid_matches_jax_float32():
    """The same in float32: other summation order, F32 tolerances and the
    same -inf cells."""
    got, want = port_grid("float32", 8, 64), jax_grid("float32", 8, 64)
    assert got.shape == want.shape == (8, 64) and got.dtype == np.float32
    inf = np.isneginf(want)
    assert np.array_equal(np.isneginf(got), inf)
    assert np.isfinite(got[~inf]).all()
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_tiling_follows_the_jax_script(x64):
    """B2 40 and B1 6, no multiples of 16 candidates and 4 queries: the
    grid is maple_tpu's on the JAX script's tiling, and cell (i, j) is the
    untiled grid's (i mod 4, j mod 16)."""
    got = port_grid("float64", 6, 40)
    assert_same_scores(got, jax_grid("float64", 6, 40), REL_JAX, "tiled")
    base = port_grid("float64", N_QUERIES, N_CANDS)
    rows, cols = np.arange(6) % N_QUERIES, np.arange(40) % N_CANDS
    np.testing.assert_array_equal(got, base[rows][:, cols])


def test_profile_has_the_jax_script_keys():
    """``profile`` on the CPU: exactly the JAX script's keys, every time
    and rate finite and positive."""
    keys = jax_script_keys()
    assert keys == {"backend", "device", "reps", "score_call_shape",
                    *TIMES}
    res = PT.profile(CPU, reps=3, K=BUDGET, B1=8, B2=64)
    assert set(res) == keys
    assert res["backend"] == res["device"] == "cpu" and res["reps"] == 3
    assert res["score_call_shape"] == {"B1": 8, "B2": 64, "K": BUDGET}
    for k in TIMES:
        assert math.isfinite(res[k]) and res[k] > 0, (k, res[k])


def test_out_appends_one_line_a_call(tmp_path, capsys):
    out = tmp_path / "tunnel.jsonl"
    argv = ["--device", "cpu", "--reps", "3", "--K", str(BUDGET), "--B1",
            "4", "--B2", "16", "--out", str(out)]
    for n in (1, 2):
        assert PT.main(argv) == 0
        lines = out.read_text().splitlines()
        assert len(lines) == n
        printed = capsys.readouterr().out.splitlines()
        assert json.loads(lines[-1]) == json.loads(printed[-1])
    assert all(json.loads(line)["score_call_shape"]["B2"] == 16
               for line in lines)

