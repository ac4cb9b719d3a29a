"""The plain reference on the CPU: its likelihood against the port's at a
small size, and perturbed trees, rates and precisions that fail it; the
rates a program writes, read whole; MAPLE's error model."""
import copy
import json
import os

import pytest

from benchmark.reference import likelihood as L
from benchmark.reference.alignment import read_alignment
from benchmark.reference.judge import (Dataset, Unjudgeable, judge,
                                       names_bad, reference_lk)
from benchmark.reference.rates import Rates, read_subs
from benchmark.reference.tree import Tree, read_newick

from .conftest import ROOT

B1429 = os.path.join(ROOT, "benchmark", "data", "b1429_3000.maple.gz")
GOLDENS = os.path.join(ROOT, "tests", "goldens")


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
    return (_tree_of(run), lk, Rates([list(r) for r in run.model.mut_matrix]),
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
    bent = [list(r) for r in rates.matrix]
    bent[0][1] *= 1.01
    bent[0][0] -= bent[0][1] * 0.01 / 1.01
    assert judge(data, tree, lk, Rates(bent))["lk_gap"] \
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


@pytest.fixture(scope="module")
def b1429():
    return Dataset(*read_alignment(B1429))


def _golden(name):
    path = os.path.join(GOLDENS, name)
    with open(path + "_tree.tree") as f:
        tree = read_newick(f.read())
    with open(path + "_LK.txt") as f:
        lk = float(f.read())
    return tree, read_subs(path + "_subs.txt"), lk


def test_without_errors_the_reference_is_unchanged(placed, b1429):
    """Without error rates the reference takes the path it took before the
    error model: the same numbers to the bit.  The constants are the
    earlier reference's readings of MAPLE's own tree of the 3,000 genomes
    (``tests/goldens/b3000_ref``, in the global frame: the Newick carries
    no local references); on the port's placed tree it gives the port's
    LK exactly, as the earlier reference did."""
    tree, rates, _ = _golden("b3000_ref")
    assert rates.site_error_rates is None
    assert reference_lk(b1429, tree, rates) == -101884.50732889023
    assert reference_lk(b1429, tree, rates, "float32") == -101884.546875
    tree, lk, rates, data = placed
    assert reference_lk(data, tree, rates) == lk


def test_the_rates_file_read_whole(tmp_path):
    rates = read_subs(os.path.join(GOLDENS, "b3000_errest_subs.txt"))
    assert len(rates.matrix) == 4 and all(len(r) == 4 for r in rates.matrix)
    assert rates.matrix[0][1] == 0.039247161165125305
    assert len(rates.site_error_rates) == 29903
    assert rates.site_error_rates[0] == 1e-10
    assert max(rates.site_error_rates) == 0.00932206849556937
    assert rates.site_rates is None and rates.error_rate is None
    var = read_subs(os.path.join(GOLDENS, "example_ratevar_subs.txt"))
    assert len(var.site_rates) == 29903
    assert var.site_rates[0] == 0.9940770717005044
    assert var.site_error_rates is None and var.error_rate is None
    plain = read_subs(os.path.join(GOLDENS, "b3000_ref_subs.txt"))
    assert plain == Rates(plain.matrix)
    path = tmp_path / "one_subs.txt"
    path.write_text("".join("\t".join(str(x) for x in row) + "\t\n"
                            for row in plain.matrix)
                    + "\n\nError rate: 0.0005\n")
    assert read_subs(str(path)) == Rates(plain.matrix, error_rate=0.0005)


def test_the_judge_refuses_what_it_cannot_compute(b1429):
    tree, rates, lk = _golden("b3000_ref")
    var = read_subs(os.path.join(GOLDENS, "example_ratevar_subs.txt"))
    with pytest.raises(Unjudgeable, match="site rates"):
        judge(b1429, tree, lk, var)
    with pytest.raises(Unjudgeable, match="global error rate"):
        judge(b1429, tree, lk, Rates(rates.matrix, error_rate=0.0005))


def test_maples_error_model_tree(b1429):
    """MAPLE's own --estimateErrors tree of the 3,000 genomes, scored under
    its written error rates in the global frame, lies as close to MAPLE's
    LK as its tree without the error model does to its own (1.44); without
    the error rates the tree is impossible (samples apart at distance 0)."""
    tree, rates, lk = _golden("b3000_errest")
    assert abs(reference_lk(b1429, tree, rates) - lk) < 1.0
    plain, plain_rates, plain_lk = _golden("b3000_ref")
    assert abs(reference_lk(b1429, plain, plain_rates) - plain_lk) < 1.5
    with pytest.raises(L.ZeroMerge):
        reference_lk(b1429, tree, Rates(rates.matrix))


def test_two_leaves_with_one_error_rate():
    """Two tips under one error rate e on the genome ACGT: B carries T at
    2 (C), A misses 4.  The merge starts from -(t1 + t2) 4 - 2 (4 e); at 2
    it takes the diagonal off and adds e for each tip, and scores the
    emissions [e/3, 1-e, e/3, e/3] and [e/3, e/3, e/3, 1-e] evolved over
    t1 and t2; at 4 it takes B's diagonal term off and adds e for each
    tip.  The root reads 1 and 3 by the frequencies (1/4 each), 2 from the
    merged vector (which sums to 1) and 4, B's observation, as
    f (1 - 4/3 e) + e/3."""
    import numpy as np
    Q = np.array([[-1.0, 0.2, 0.6, 0.2], [0.3, -1.5, 0.2, 1.0],
                  [0.5, 0.2, -0.9, 0.2], [0.1, 0.6, 0.3, -1.0]])
    e, t1, t2 = 0.001, 0.01, 0.02
    model = L.Model("acgt", Q.tolist(), L.Arith(), error_rates=[e] * 4)
    a = L.tip_list([("n", 4, 1)], model)
    b = L.tip_list([("t", 2, 1)], model)
    tree = Tree([[], [], [0, 1]], [t1, t2, 0.0], ["a", "b", None],
                [[], [], []], 2)
    got = L.tree_lk(model, tree, {0: a, 1: b})

    def emitted(state, t):
        v = np.full(4, e * 0.33333)
        v[state] = 1 - e
        return v + t * (Q @ v)
    s = float(emitted(1, t1) @ emitted(3, t2))
    f = 0.25
    want = (-(t1 + t2) * 4 - 8 * e
            - Q[1, 1] * (t1 + t2) + 2 * e + np.log(s)
            - Q[3, 3] * (t1 + t2) + 2 * e
            + 3 * np.log(f) + np.log(f * (1 - 1.33333 * e) + 0.333333 * e))
    assert got == pytest.approx(want, rel=1e-14, abs=1e-12)
    assert got != pytest.approx(L.tree_lk(L.Model("acgt", Q.tolist(),
                                                  L.Arith()),
                                          tree, {0: a, 1: b}), abs=1e-4)


def test_a_tips_ambiguity_under_the_error_model():
    model = L.Model("acgt", [[-1, 0.5, 0.25, 0.25]] * 4, L.Arith(),
                    error_rates=[0.0, 0.003, 0.0, 0.0])
    o, ref_nuc, _, vec = L.tip_list([("y", 2, 1)], model)[1]
    assert o == L.O and ref_nuc == L.C
    assert vec == pytest.approx([0.001, 0.499, 0.001, 0.499], abs=1e-6)
    assert L.tip_list([("y", 2, 1)], model, n_minor=2)[1][3] \
        == (0.0, 0.5, 0.0, 0.5)
