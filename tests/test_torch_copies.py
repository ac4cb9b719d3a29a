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

The port's copy of the C++ engine, ``native/maple_native.cpp`` (built by
``native/bridge.py``), is held the same way to the repository's
``native/maple_native.cpp``, which maple_tpu builds: unit by unit
(``CPP_MANIFEST``), a unit being a top-level definition of the file, inside
its namespaces and ``extern "C"`` blocks, compared without comments and
with runs of white space made one.
"""
import ast
import os
import re

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
    # the runtime records its phases into the run's tracer
    # (runtime/phases.py); phase_times is a view of its spans
    "runtime/partials.py": dict(
        changed=["TreeRuntime.__init__", "TreeRuntime.add_phase_time"],
        added=[]),
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
    # --deviceTopology runs keep one engine session a stage, suspended
    # around each device SPR pass (suspend / resume); every export hands
    # back the MAT (replacements, local-reference mutations); a session
    # marks the tree mutated only where a phase changed it (not at close,
    # not for the read-only root search, not for an SPR pass that moved
    # nothing); the transfers count into the run's tracer; the device
    # proxy SPR pass collects and applies in the session (spr_collect,
    # spr_release, spr_apply); every engine phase runs through a session
    # method, the one-shot helpers (run_native_*) on a scoped session
    # (_one_shot) with the import settings, export flags and fallbacks they
    # had, the error model's recompute in NativeSession.recalculate; the
    # node arrays are exported in one place (_export_nodes)
    "native/engine.py": dict(
        changed=["NativePlacementEngine.export_to_tree",
                 "NativePlacementEngine.snapshot_tree",
                 "NativeSession.<body>", "NativeSession.__init__",
                 "NativeSession._err", "NativeSession.close",
                 "NativeSession.recalculate", "NativeSession.root_search",
                 "NativeSession.spr_parallel", "NativeSession.spr_pass",
                 "NativeSession.sync_topology", "_export_engine",
                 "_import_engine", "native_session_eligible",
                 "open_native_session", "run_native_blen_loop",
                 "run_native_blen_sweep", "run_native_recalculate",
                 "run_native_root_search", "run_native_spr_parallel",
                 "run_native_spr_pass", "run_native_tree_lk"],
        added=["NativeSession._attach", "NativeSession._one_shot",
               "NativeSession._spr_moves", "NativeSession._spr_params",
               "NativeSession.resume", "NativeSession.suspend",
               "NativeSession.spr_collect", "NativeSession.spr_release",
               "NativeSession.spr_apply", "_export_nodes", "_ptr"]),
    "ops/pack.py": ALL,
    # the run takes a device; --devicePlacement's branches are the port's
    # (build_initial_tree_device: the proxy placer over a mesh on the
    # mesh's device, the other branches take the legacy placer there);
    # the run owns a tracer (runtime/phases.py) that its stages record
    # their spans into, closed when run() returns
    "pipeline.py": dict(
        changed=["Run.__init__", "Run._build_initial_tree_engine_device",
                 "Run.build_initial_tree_device", "run_inference",
                 "Run.load", "Run.build_initial_tree", "Run.post_placement",
                 "Run.write_tree", "Run.setup_input_tree", "Run.run",
                 "Run.write_outputs"],
        added=["Run._stages"]),
    # main: the program's name, the CUDA check, the device
    "cli.py": dict(changed=["main"], added=["_FLAG_FIELDS"]),
    # the device SPR screen runs on run.device; the rounds record spans
    "search/spr.py": dict(changed=["_parallel_update",
                                   "_run_spr_rounds_body"], added=[]),
    # the port's own library in _build/, built under a lock and renamed,
    # from the port's own copy of the engine; the store packs lists in the
    # pair kernel's stacked layout
    "native/bridge.py": dict(changed=["_LIB", "_SRC", "_build", "_load"],
                             added=["_stale", "NativeStore.pack_stacked"]),
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


# The port's copy of the C++ engine -> its twin, held as MANIFEST's
# changed/added entries: the device SPR pass of a live session collects
# its queries and anchors (engine_spr_collect, the handles it holds in
# Engine::spr_held until engine_spr_release), the store packs lists in the
# pair kernel's stacked layout (store_pack_stacked), and the engine applies
# a host-sorted proposal list (engine_spr_apply) with the serial phase of
# engine_spr_pass_parallel, which now calls it
CPP_MANIFEST = {
    ("maple_tpu_torch/native/maple_native.cpp", "native/maple_native.cpp"):
        dict(changed=["struct Engine", "engine_spr_pass_parallel"],
             added=["engine_spr_apply", "engine_spr_release",
                    "engine_spr_collect", "store_pack_stacked"]),
}


def _without_comments(src):
    out, i, n = [], 0, len(src)
    while i < n:
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
        elif src.startswith("/*", i):
            i = src.index("*/", i + 2) + 2
            out.append(" ")
        elif src[i] in "\"'":
            j = i + 1
            while src[j] != src[i]:
                j += 2 if src[j] == "\\" else 1
            out.append(src[i:j + 1])
            i = j + 1
        else:
            out.append(src[i])
            i += 1
    return "".join(out)


_TRANSPARENT = re.compile(r'(namespace(\s+\w+)?|extern\s+"C")\s*$')


def _cpp_name(text):
    """A unit's name: a preprocessor line itself, ``struct X`` (class,
    union, enum), a function's name, or the name a declaration defines."""
    if text.startswith("#"):
        return text
    head = re.split(r"[{=;]", text, maxsplit=1)[0]
    m = re.match(r"\s*(struct|class|union|enum)\s+(\w+)", head)
    if m:
        return f"{m.group(1)} {m.group(2)}"
    m = re.search(r"([\w:~]+)\s*\(", head)
    if m:
        return m.group(1)
    return re.findall(r"[\w:]+", head)[-1]


def cpp_units(path):
    """name -> text of every top-level unit of a C++ source: a preprocessor
    line, or a declaration or definition up to its ``;`` or closing brace
    (``namespace`` and ``extern "C"`` blocks are looked into).  A name
    that comes again is numbered (``name#2``)."""
    with open(os.path.join(ROOT, path)) as f:
        code = _without_comments(f.read())
    units, cur, depth, i, n = {}, [], 0, 0, len(code)

    def close():
        text = " ".join("".join(cur).split())
        cur.clear()
        if text:
            name = key = _cpp_name(text)
            k = 2
            while key in units:
                key, k = f"{name}#{k}", k + 1
            units[key] = text

    while i < n:
        c = code[i]
        if depth == 0 and c == "#" and not "".join(cur).strip():
            j = i
            while True:   # a directive ends at a newline not escaped
                j = code.find("\n", j)
                if j < 0 or code[j - 1] != "\\":
                    break
                j += 1
            j = n if j < 0 else j
            cur.append(code[i:j])
            close()
            i = j
            continue
        if c == "{" and depth == 0 \
                and _TRANSPARENT.match("".join(cur).strip()):
            cur.clear()
        elif c == "}" and depth == 0:
            pass                       # the end of a namespace or extern
        elif c == "{":
            depth += 1
            cur.append(c)
        elif c == "}":
            depth -= 1
            cur.append(c)
            if depth == 0:
                j = i + 1
                while j < n and code[j].isspace():
                    j += 1
                if j < n and code[j] == ";":
                    cur.append(";")
                    i = j
                close()
        elif c == ";" and depth == 0:
            cur.append(c)
            close()
        else:
            cur.append(c)
        i += 1
    close()
    return units


@pytest.mark.parametrize("pair", list(CPP_MANIFEST),
                         ids=[p[0] for p in CPP_MANIFEST])
def test_cpp_copy_matches_its_twin(pair):
    port_path, twin_path = pair
    held = CPP_MANIFEST[pair]
    port, twin = cpp_units(port_path), cpp_units(twin_path)
    assert len(twin) > 200, "the splitter found too few units"
    changed, added = set(held["changed"]), set(held["added"])
    missing = set(twin) - set(port)
    assert not missing, f"{port_path}: the copy lacks {sorted(missing)}"
    extra = set(port) - set(twin)
    assert extra == added, \
        f"{port_path}: units only in the copy {sorted(extra)}, listed " \
        f"{sorted(added)}"
    assert changed <= set(twin), f"{port_path}: stale names in 'changed'"
    same = sorted(n for n in changed if port[n] == twin[n])
    assert not same, f"{port_path}: {same} equal their twins: unlist them"
    drifted = sorted(n for n in set(twin) - changed if port[n] != twin[n])
    assert not drifted, f"{port_path}: {drifted} have drifted from " \
        f"{twin_path}"


def test_cpp_units_split_a_file(tmp_path):
    """The splitter on a small file: directives, namespaces and extern
    blocks looked into, structs, functions and declarations by name,
    comments and spacing free, a repeated name numbered."""
    src = tmp_path / "a.cpp"
    src.write_text(
        '#include <vector>\n// a comment with { and "\n'
        'namespace {\nconstexpr int A = 1;\nstruct S {\n  int f() {'
        ' return 1; }\n};\nstatic int g(int x) {\n  /* } */ return x'
        ' + A; }\n}  // namespace\nextern "C" {\nint h(S *s) { return '
        's->f(); }\nint h(int a);\n#define X(v) \\\n  (v)\n}\n')
    units = cpp_units(str(src))
    assert list(units) == ["#include <vector>", "A", "struct S", "g", "h",
                           "h#2", "#define X(v) \\ (v)"]
    assert units["g"] == "static int g(int x) { return x + A; }"
    assert units["struct S"] == "struct S { int f() { return 1; } };"


def test_manifest_covers_every_copied_module():
    """Every module of the port that has a twin of the same path in
    maple_tpu is in the manifest, or is one of the port's re-written device
    modules."""
    rewritten = {"__init__.py", "__main__.py", "ops/__init__.py",
                 "ops/append_batch.py", "ops/blen_batch.py",
                 "parallel/__init__.py",
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
