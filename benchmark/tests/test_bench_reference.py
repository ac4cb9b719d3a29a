"""The plain reference on the CPU: its likelihood against the port's at a
small size, and perturbed trees, rates and precisions that fail it."""
import copy
import json
import os

import pytest

from benchmark.reference import likelihood as L
from benchmark.reference.alignment import read_alignment
from benchmark.reference.judge import (Dataset, judge, names_bad,
                                       reference_lk)
from benchmark.reference.tree import Tree, read_newick

from .conftest import ROOT

B1429 = os.path.join(ROOT, "benchmark", "data", "b1429_3000.maple.gz")


CELL = "b1429.tree-devspr"
with open(os.path.join(ROOT, "benchmark", "limits", f"{CELL}.json")) as _f:
    LIMITS = json.load(_f)


def test_newick_reader():
    t = read_newick("((A:0.1,B:0.2)x:0.3,(C:1,D)y:0.5);")
    assert sorted(t.name[n] for n in t.leaves()) == ["A", "B", "C", "D"]
    by = {t.name[n]: t.dist[n] for n in t.leaves()}
    assert by == {"A": 0.1, "B": 0.2, "C": 1.0, "D": 0.0}
    assert t.postorder()[-1] == t.root and len(t.children[t.root]) == 2


def test_pass_through_down_and_up_is_identity():
    model = L.Model("acgtacgtac", [[-1, 0.5, 0.25, 0.25]] * 4, L.Arith())
    tip = L.tip_list([("t", 2, 1), ("n", 5, 2), ("y", 9, 1)], model)
    muts = [(2, 1, 3), (4, 3, 1), (8, 3, 0)]
    down = L.pass_through(tip, muts, False, model.L)
    assert down != tip
    assert L._shorten(L.pass_through(down, muts, True, model.L), 1e-8) \
        == L._shorten(tip, 1e-8)


@pytest.fixture(scope="module")
def placed():
    """The port's serial placement of the 3,000 B.1.429 genomes on the
    CPU, its LK after ``recalculate_all`` and the judge's dataset."""
    import torch
    from maple_tpu_torch.config import MapleConfig
    from maple_tpu_torch.pipeline import Run
    from benchmark.harness.jobs import _tree_of
    cfg = MapleConfig(input=B1429, output=os.devnull, model="UNREST",
                      overwrite=True)
    run = Run(cfg, torch.device("cpu"))
    run.load()
    run.build_initial_tree()
    run.rt.recalculate_all(run.root)
    lk = run.rt.calculate_tree_likelihood(run.root)
    ref, samples = read_alignment(B1429)
    return (_tree_of(run), lk, [list(r) for r in run.model.mut_matrix],
            Dataset(ref, samples))


def test_reference_equals_the_port(placed):
    tree, lk, rates, data = placed
    res = judge(data, tree, lk, rates)
    assert res["names_bad"] == 0
    assert res["lk_gap"] <= 1e-6


def test_frames_of_the_annotated_tree_matter(placed):
    """MAPLE evaluates each list in its node's local-reference frame; the
    global frame gives another number, far outside the limits."""
    tree, lk, rates, data = placed
    assert any(tree.mutations)
    flat = copy.copy(tree)
    flat.mutations = [[] for _ in tree.children]
    assert abs(reference_lk(data, flat, rates) - lk) > 0.1


def test_float32_control_fails(placed):
    tree, lk, rates, data = placed
    ref = reference_lk(data, tree, rates)
    f32 = reference_lk(data, tree, rates, "float32")
    assert abs(f32 - ref) > LIMITS["limits"]["lk_gap"]


def test_perturbed_branch_fails(placed):
    tree, lk, rates, data = placed
    t = copy.copy(tree)
    t.dist = list(tree.dist)
    leaf = next(n for n in tree.leaves() if tree.dist[n] > 0)
    t.dist[leaf] *= 1.5
    assert judge(data, t, lk, rates)["lk_gap"] > LIMITS["limits"]["lk_gap"]


def test_swapped_leaves_fail(placed):
    tree, lk, rates, data = placed
    t = copy.copy(tree)
    t.name = list(tree.name)
    leaves = tree.leaves()
    a, b = leaves[10], leaves[-10]
    t.name[a], t.name[b] = t.name[b], t.name[a]
    assert judge(data, t, lk, rates)["lk_gap"] > LIMITS["limits"]["lk_gap"]


def test_perturbed_rates_fail(placed):
    tree, lk, rates, data = placed
    bent = [list(r) for r in rates]
    bent[0][1] *= 1.01
    bent[0][0] -= bent[0][1] * 0.01 / 1.01
    assert judge(data, tree, lk, bent)["lk_gap"] \
        > LIMITS["limits"]["lk_gap"]


def test_missing_and_repeated_samples_fail(placed):
    tree, lk, rates, data = placed
    t = copy.copy(tree)
    t.minors = [list(m) for m in tree.minors]
    host = next(n for n in tree.leaves() if tree.minors[n])
    t.minors[host] = t.minors[host][1:]
    assert names_bad(t, data.samples) == 1
    t.minors[host] = tree.minors[host] + [tree.minors[host][0]]
    assert names_bad(t, data.samples) == 1
    assert judge(data, t, lk, rates)["lk_gap"] is None


def test_a_tree_as_placed_falls_short(placed):
    """The serial placement before its EM, branch lengths and SPR rounds:
    its own LK agrees, its quality does not reach the cell's."""
    tree, lk, rates, data = placed
    res = judge(data, tree, lk, rates, LIMITS["lk_base"])
    assert res["lk_gap"] <= LIMITS["limits"]["lk_gap"]
    assert res["lk_short"] > LIMITS["limits"]["lk_short"]
