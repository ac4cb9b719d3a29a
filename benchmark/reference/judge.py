"""What decides ``correct``: the numbers a job's tree is held to.

- ``names_bad``: samples of the alignment that the tree leaves out, holds
  more than once (as a leaf or a minor sequence), or names though the
  alignment has no such sample.  Limit 0.
- ``lk_gap``: the distance between the log-likelihood that the program
  reports for its tree and the one that ``likelihood.tree_lk`` works out
  again for the same tree, from the alignment and the rates the program
  reports (``rates.Rates``: the matrix, and the site error rates where the
  run estimated them).  It fails a likelihood computed in a lower
  precision than the configuration's float64, a tree whose leaves or
  branch lengths are not the ones the program scored, and error rates
  that are not the ones it scored with.
- ``lk_short``: how far the reference's log-likelihood of the tree, under
  the program's rates, lies below ``lk_base``, the best that sound runs of
  the cell reach on its dataset.  It fails a tree whose SPR rounds or
  screen left it as placed, and rates that the EM never estimated: the
  tree's quality and the rates' are held, not only their agreement.

Every limit, ``lk_base``, and the readings they were set from are in
``benchmark/limits/<cell>.json`` and in PERF.md.
"""
from __future__ import annotations

from collections import Counter

from .likelihood import Arith, Model, tip_list, tree_lk


class Unjudgeable(ValueError):
    """Rates of a model that the reference does not compute."""


class Dataset:
    """An alignment as the judge reads it."""

    def __init__(self, ref, samples):
        self.ref = ref
        self.samples = samples


def names_bad(tree, samples):
    seen = Counter()
    for leaf in tree.leaves():
        seen[tree.name[leaf]] += 1
        seen.update(tree.minors[leaf])
    missing = sum(1 for name in samples if name not in seen)
    repeated = sum(k - 1 for k in seen.values() if k > 1)
    unknown = sum(1 for name in seen if name not in samples)
    return missing + repeated + unknown


def reference_lk(data, tree, rates, dtype="float64"):
    """``likelihood.tree_lk`` of ``tree`` in ``dtype`` under ``rates``
    (``rates.Rates``); rates that carry site rates or one global error
    rate raise ``Unjudgeable``, rather than be scored without them."""
    if rates.site_rates is not None:
        raise Unjudgeable("the rates carry site rates (--rateVariation); "
                          "the reference has no rate variation")
    if rates.error_rate is not None:
        raise Unjudgeable("the rates carry one global error rate "
                          "(--estimateErrorRate); the reference reads "
                          "site error rates only")
    model = Model(data.ref, rates.matrix, Arith(dtype),
                  error_rates=rates.site_error_rates)
    tips = {leaf: tip_list(data.samples[tree.name[leaf]], model,
                           len(tree.minors[leaf]))
            for leaf in tree.leaves()}
    return tree_lk(model, tree, tips)


def judge(data, tree, program_lk, rates, lk_base=None):
    """The numbers compared for one tree, and the reference's LK; the LK
    is not worked out for a tree that fails ``names_bad``, and
    ``lk_short`` only where the cell gives ``lk_base``."""
    bad = names_bad(tree, data.samples)
    out = {"names_bad": bad, "lk_gap": None, "reference_lk": None}
    if lk_base is not None:
        out["lk_short"] = None
    if not bad:
        out["reference_lk"] = reference_lk(data, tree, rates)
        out["lk_gap"] = abs(program_lk - out["reference_lk"])
        if lk_base is not None:
            out["lk_short"] = lk_base - out["reference_lk"]
    return out
