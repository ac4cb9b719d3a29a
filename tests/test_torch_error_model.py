"""MAPLE's error model on the port's CPU pipeline, against maple_tpu.

An error-rate model keeps every engine phase one-shot (no engine session),
and each full recomputation replays the per-tip refresh of the shared
ambiguity lists inside the engine (``native/engine.py``
``NativeSession.recalculate``: ``engine_recalculate_err``).  The port's run
must write the files maple_tpu's serial pipeline writes on the same flags,
byte for byte: the tree, the LK, the substitutions and, with
``--estimateErrors``, the estimated errors.  A counting wrapper around the
C function shows the engine's branch ran, so a fall to the Python
recomputation cannot pass unseen.
"""
import os

import pytest
import torch

from maple_tpu.config import MapleConfig as SerialConfig
from maple_tpu.pipeline import run_inference as serial_inference

from maple_tpu_torch.config import MapleConfig
from maple_tpu_torch.native import bridge
from maple_tpu_torch.pipeline import run_inference

from test_torch_pipeline import SUB80

CPU = torch.device("cpu")


def outputs(prefix):
    """name -> contents of every file a run wrote under ``prefix``."""
    folder, stem = os.path.split(prefix)
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.startswith(stem + "_"):
            with open(os.path.join(folder, name)) as f:
                out[name[len(stem):]] = f.read()
    return out


@pytest.mark.parametrize("flag", ["estimateErrors", "estimateErrorRate"])
def test_error_model_matches_maple_tpu(tmp_path, monkeypatch, flag):
    lib = bridge._load()
    assert lib is not None, bridge._load_error
    real, calls = lib.engine_recalculate_err, []

    def counted(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(lib, "engine_recalculate_err", counted)
    flags = dict(input=SUB80, model="GTR", overwrite=True, **{flag: True})
    port = str(tmp_path / "port" / "run")
    ref = str(tmp_path / "ref" / "run")
    os.makedirs(os.path.dirname(port))
    os.makedirs(os.path.dirname(ref))
    run = run_inference(MapleConfig(output=port, **flags), CPU)
    serial_inference(SerialConfig(output=ref, **flags))
    assert run.rt.model.using_error_rate
    assert run.tracer.counter("engine.sessions") == 0
    assert len(calls) > 0 and sum(calls) > 0
    mine, theirs = outputs(port), outputs(ref)
    assert {"_tree.tree", "_LK.txt", "_subs.txt"} <= set(mine)
    assert ("_estimatedErrors.txt" in mine) == (flag == "estimateErrors")
    assert sorted(mine) == sorted(theirs)
    for name in mine:
        assert mine[name] == theirs[name], name
