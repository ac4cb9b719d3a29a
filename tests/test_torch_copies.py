"""The port's copies of maple_tpu's jax-free modules, held to their twins.

maple_tpu_torch imports nothing of maple_tpu: it keeps its own copy of
every host module it needs, under the same name.  Each copy is listed in
``MANIFEST`` with how much of it is held:

- ``ALL``: the whole module, by syntax tree (comments are free), after the
  package name is normalised;
- ``changed=..., added=...``: a module the port changed on purpose is held
  name by name (top-level functions, methods as ``Class.method``, other
  class-body statements as ``Class.<body>``, module-level assignments by
  their target): every name of the twin exists in the copy; the names in
  ``changed`` may differ, the names in ``added`` exist in the copy only,
  every other name is equal;
- ``only=...``: a port module that carries a few copied functions among
  its own code is held on those names alone.

A change to maple_tpu that should reach the port fails here until the copy
follows; a copy changed on purpose moves into ``changed`` (and CHANGES.md
says so).
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = "all"

MANIFEST = {
    "config.py": ALL,
    "refdata.py": ALL,
    "io/__init__.py": ALL,
    "io/maple_format.py": ALL,
    "io/newick.py": ALL,
    "io/nexus.py": ALL,
    "io/tsv.py": ALL,
    "core/__init__.py": ALL,
    "core/backend.py": ALL,
    "core/genomelist.py": ALL,
    "core/kernels.py": ALL,
    "runtime/__init__.py": ALL,
    "runtime/tree.py": ALL,
    "runtime/partials.py": ALL,
    "search/placement.py": ALL,
    "search/blen.py": ALL,
    "search/rootsearch.py": ALL,
    "search/parallel_spr.py": ALL,
    "models/__init__.py": ALL,
    "models/em.py": ALL,
    "models/timetree.py": ALL,
    "models/hnz.py": ALL,
    "analysis/__init__.py": ALL,
    "analysis/errors.py": ALL,
    "analysis/lineages.py": ALL,
    "analysis/placements.py": ALL,
    "analysis/rf.py": ALL,
    "analysis/support_calibration.py": ALL,
    "native/__init__.py": ALL,
    "native/engine.py": ALL,
    "ops/pack.py": ALL,
    # the run takes a device; --devicePlacement's branches are the port's
    # (build_initial_tree_device: the proxy placer over a mesh on the
    # mesh's device, the other branches take the legacy placer there)
    "pipeline.py": dict(
        changed=["Run.__init__", "Run._build_initial_tree_engine_device",
                 "Run.build_initial_tree_device", "run_inference"],
        added=[]),
    # main: the program's name, the CUDA check, the device
    "cli.py": dict(changed=["main"], added=["_FLAG_FIELDS"]),
    # the device SPR screen runs on run.device
    "search/spr.py": dict(changed=["_parallel_update"], added=[]),
    # the port's own library in _build/, built under a lock and renamed
    "native/bridge.py": dict(changed=["_LIB", "_build", "_load"],
                             added=["_stale"]),
    "parallel/batch_spr.py": dict(only=[
        "_euler_intervals", "_current_attachment_lk", "_collect_queries",
        "_collect_anchors"]),
}
# _collect_anchors' docstring names the port's packed-row twin; the module
# docstring of support_calibration.py cites the reference's script by its
# path in the reference, not by a path on one machine
MODULE = "<module>"
DOCSTRING_FREE = {("parallel/batch_spr.py", "_collect_anchors"),
                  ("analysis/support_calibration.py", MODULE)}


def parse(package, rel):
    with open(os.path.join(ROOT, package, rel)) as f:
        src = f.read()
    return ast.parse(src.replace("maple_tpu_torch", "maple_tpu"))


def _targets(stmt):
    if isinstance(stmt, ast.Assign):
        return [t.id for t in stmt.targets if isinstance(t, ast.Name)]
    if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
        return [stmt.target.id]
    return []


def named(tree):
    """name -> syntax-tree dump, for every name the module defines."""
    out = {}
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[stmt.name] = stmt
        elif isinstance(stmt, ast.ClassDef):
            rest = []
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{stmt.name}.{sub.name}"] = sub
                else:
                    rest.append(sub)
            out[f"{stmt.name}.<body>"] = ast.Module(
                body=[ast.Expr(ast.Tuple(stmt.bases, ast.Load())), *rest],
                type_ignores=[])
        else:
            for name in _targets(stmt):
                out[name] = stmt
    return out


def without_docstring(fn):
    body = fn.body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        fn.body = body[1:]
    return fn


@pytest.mark.parametrize("rel", list(MANIFEST))
def test_copy_matches_maple_tpu(rel):
    held = MANIFEST[rel]
    port, twin = parse("maple_tpu_torch", rel), parse("maple_tpu", rel)
    if held == ALL:
        if (rel, MODULE) in DOCSTRING_FREE:
            port, twin = without_docstring(port), without_docstring(twin)
        assert ast.dump(port) == ast.dump(twin), \
            f"maple_tpu_torch/{rel} has drifted from maple_tpu/{rel}"
        return
    port_n, twin_n = named(port), named(twin)
    if "only" in held:
        names = held["only"]
    else:
        changed, added = set(held["changed"]), set(held["added"])
        missing = set(twin_n) - set(port_n)
        assert not missing, f"{rel}: the copy lacks {sorted(missing)}"
        extra = set(port_n) - set(twin_n)
        assert extra == added, \
            f"{rel}: names only in the copy {sorted(extra)}, listed " \
            f"{sorted(added)}"
        assert changed <= set(twin_n), f"{rel}: stale names in 'changed'"
        names = sorted(set(twin_n) - changed)
        # a name listed as changed that is equal again leaves the list
        same = [n for n in changed
                if ast.dump(port_n[n]) == ast.dump(twin_n[n])]
        assert not same, f"{rel}: {same} equal their twins: unlist them"
    assert names
    for name in names:
        a, b = port_n[name], twin_n[name]
        if (rel, name) in DOCSTRING_FREE:
            a, b = without_docstring(a), without_docstring(b)
        assert ast.dump(a) == ast.dump(b), \
            f"{rel}: {name} has drifted from maple_tpu's"


def test_manifest_covers_every_copied_module():
    """Every module of the port that has a twin of the same path in
    maple_tpu is in the manifest, or is one of the port's re-written device
    modules."""
    rewritten = {"__init__.py", "__main__.py", "ops/__init__.py",
                 "ops/append_batch.py", "parallel/__init__.py",
                 "parallel/batch_placement.py", "parallel/mesh.py",
                 "parallel/pipelined_placer.py", "parallel/proxy_placer.py",
                 "search/__init__.py"}
    found = set()
    pkg = os.path.join(ROOT, "maple_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), pkg)
            if name.endswith(".py") and os.path.isfile(
                    os.path.join(ROOT, "maple_tpu", rel)):
                found.add(rel)
    assert found - rewritten == set(MANIFEST)
