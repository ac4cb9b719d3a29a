"""The log-likelihood of a tree under MAPLE's model, written plainly.

MAPLE (De Maio et al., Nat Genet 2023) keeps each node's partial
likelihoods as a list of entries over the genome:

- ``R``: a run of positions that carry the reference nucleotide, up to an
  end position;
- ``N``: a run of missing data, up to an end position;
- a nucleotide 0-3 (A, C, G, T) at one position that differs from the
  reference;
- ``O``: one position with a 4-vector of probabilities (an ambiguity code,
  or uncertainty after a merge).

A nucleotide or ``R`` entry may carry an extra length: the branch length
from the position's last observation up to the node, deferred where the
other side of a merge was missing.  Along a branch of length t a state
evolves by the first-order step v + t Q v; a run of reference positions
that stays unchanged contributes t times the sum of its diagonal rates.
Every merge starts from ``t * global_tot_rate`` (minus the genome length
times t: the unchanged-genome term of a normalised matrix) and corrects it
where a position is missing or mutated.  Merged 4-vectors are renormalised
and their normalisers multiplied into a factor that is carried into the
log when it gets small.  An ``O`` vector in which a single state is above
``threshold_prob`` collapses to that state.

The likelihood is the sum over internal nodes of the merge of their two
children, in post-order, plus the log-probability of the root's list under
the root frequencies (the reference genome's composition).  A node of the
mutation-annotated tree carries the mutations of its own local reference
against its parent's frame; a list is expressed in its node's frame, and
an R run there stands for that frame's nucleotides while its rate term
still reads the global reference's diagonal, as MAPLE computes it.  No rate
variation: the judge refuses rates that carry it.

MAPLE's site-specific error model (``errors``, from the site error rates
the program wrote; MAPLE's ``getPartialVec``, ``mergeVectors``,
``findProbRoot``, ``updateErrorRates`` and ``probVectTerminalNode`` as
SURVEY.md cites them).  A leaf observes a state through the emission
``[1-e, e/3, e/3, e/3]`` with its site's own error rate e:

- the model adds each site's rate ``e_i``, their cumulative sums, the
  total ``-sum(e_i)`` and the cumulative log of
  ``f(ref_i) (1 - 4/3 e_i) + e_i/3``;
- a leaf stands for itself and its minor sequences; a tip is a leaf
  without them.  A merge starts from the total once for each sample that a
  leaf side stands for.  Where a side is missing (N), each tip side gets
  the run's rates back, and a tip's entry that survives there carries a
  mark (``from_tip``, a fifth field) up into its parent's list.  Where a
  position is not the reference on both sides, each tip side gets ``e_i``
  back, unless both carry the same nucleotide;
- a tip side, and a marked entry, is observed through the emission: its
  state is evolved from ``[1-e, e/3, e/3, e/3]``, not from a unit vector.
  A marked entry of an inner list takes ``e_i`` off where both sides
  carry the same nucleotide, and its run's rates off where it is an R run
  merged with an extra length; at the root a marked R run reads the
  cumulative log above, a marked nucleotide ``f(c) (1 - 4/3 e_i) + e_i/3``;
- a tip's ambiguity code is the normalised pattern with ``e/3`` on the
  states it excludes (``1/2 - e/3`` or ``1/3 - e/9`` on the others); a
  leaf with minor sequences keeps the plain normalised pattern.

One departure from MAPLE: each ambiguity entry gets its own site's rate
and its own leaf's minor sequences.  MAPLE shares one list a code across
every tip and refreshes it in place, so that every entry of a code ends
with the rate of whichever was refreshed last, and the lists merged
before a refresh keep the older values; the port does as MAPLE.  Where no
list is shared (each code at most once) the two agree to rounding.  The
constants are MAPLE's own (``1.33333``, ``0.333333`` and ``0.33333`` where
4/3 and 1/3 are meant), kept so that the numbers agree.

``Arith(dtype)`` fixes the precision of every arithmetic result: float64
is the reference; float32 is the control, the same arithmetic rounded to
float32 after each operation.
"""
from __future__ import annotations

import math

import numpy as np

A, C, G, T, R, N, O = 0, 1, 2, 3, 4, 5, 6
NUC = {"a": A, "c": C, "g": G, "t": T}
AMBIGUOUS = {
    "y": (0.0, 1.0, 0.0, 1.0), "r": (1.0, 0.0, 1.0, 0.0),
    "w": (1.0, 0.0, 0.0, 1.0), "s": (0.0, 1.0, 1.0, 0.0),
    "k": (0.0, 0.0, 1.0, 1.0), "m": (1.0, 1.0, 0.0, 0.0),
    "d": (1.0, 0.0, 1.0, 1.0), "v": (1.0, 1.0, 1.0, 0.0),
    "h": (1.0, 1.0, 0.0, 1.0), "b": (0.0, 1.0, 1.0, 1.0),
}
UNIFORM = (0.25, 0.25, 0.25, 0.25)
FLOAT_MIN = 2.2250738585072014e-308


class Arith:
    """Rounds every result to ``dtype``: float64 leaves Python floats as
    they are, float32 rounds each result to the nearest float32."""

    def __init__(self, dtype="float64"):
        self.dtype = dtype
        if dtype == "float64":
            self.r = float
            self.carry = FLOAT_MIN * 1e50
            self.tiny = FLOAT_MIN
        elif dtype == "float32":
            f32 = np.float32
            self.r = lambda x: float(f32(x))
            info = np.finfo(np.float32)
            self.carry = float(info.tiny) * 1e20
            self.tiny = float(info.tiny)
        else:
            raise ValueError(f"unknown precision {dtype!r}")


class Model:
    """The tables one likelihood needs: the reference genome's nucleotide
    indices, the rate matrix Q, the cumulative sums of Q's diagonal along
    the reference, the cumulative base counts and the root frequencies;
    with ``error_rates`` (one a site) the error model's tables
    (``Errors``), else ``errors`` is None."""

    def __init__(self, ref, rates, arith, threshold_prob=1e-8,
                 error_rates=None):
        r = arith.r
        self.arith = arith
        self.L = len(ref)
        self.ref_idx = [NUC.get(ch, A) for ch in ref]
        self.Q = [[r(x) for x in row] for row in rates]
        cum = [0.0]
        cum_bases = [(0, 0, 0, 0)]
        counts = [0, 0, 0, 0]
        for i, ch in enumerate(ref):
            k = self.ref_idx[i]
            cum.append(r(cum[-1] + self.Q[k][k]))
            if ch in NUC:
                counts[NUC[ch]] += 1
            cum_bases.append(tuple(counts))
        self.cum = cum
        self.cum_bases = cum_bases
        self.freqs = [r(c / self.L) for c in counts]
        self.log_freqs = [r(math.log(f)) for f in self.freqs]
        self.global_rate = r(-float(self.L))
        self.tp = threshold_prob
        self.tp4 = threshold_prob ** 4
        self.errors = None if error_rates is None \
            else Errors(error_rates, self)


class Errors:
    """The error model's tables: each site's rate ``eps``, their cumulative
    sums ``cum``, the total ``-sum(eps)`` and ``root_log``, the cumulative
    log-probability of the reference's nucleotides at a root whose
    observation may be an error."""

    def __init__(self, rates, model):
        r = model.arith.r
        if len(rates) != model.L:
            raise ValueError(f"{len(rates)} site error rates for a genome "
                             f"of {model.L}")
        self.eps = [r(x) for x in rates]
        cum = [0.0]
        root_log = [0.0]
        for i, e in enumerate(self.eps):
            cum.append(r(cum[-1] + e))
            f = model.freqs[model.ref_idx[i]]
            p = r(r(f * r(1.0 - r(1.33333 * e))) + r(0.333333 * e))
            root_log.append(r(root_log[-1] + r(math.log(p))))
        self.cum = cum
        self.total = r(-cum[-1])
        self.root_log = root_log


def from_tip(e):
    """Whether an entry carries a tip's error-prone observation."""
    return len(e) > 4 and e[4]


def tip_list(diffs, model, n_minor=0):
    """A sample's entry list from its (char, pos, length) differences; a
    leaf that stands for ``n_minor`` minor sequences besides its own."""
    L = model.L
    out = []
    pos = 1
    for ch, p, length in diffs:
        if p > pos:
            out.append((R, p - 1, 0.0, None))
        if ch in "n-":
            out.append((N, p + length - 1, 0.0, None))
            pos = p + length
            continue
        ref_nuc = model.ref_idx[p - 1]
        if ch in NUC:
            if NUC[ch] == ref_nuc:
                out.append((R, p, 0.0, None))
            else:
                out.append((NUC[ch], ref_nuc, 0.0, None))
        elif model.errors is None:
            out.append((O, ref_nuc, 0.0, AMBIGUOUS[ch]))
        else:
            out.append((O, ref_nuc, 0.0,
                        _ambiguity_errors(AMBIGUOUS[ch],
                                          model.errors.eps[p - 1], n_minor,
                                          model.arith.r)))
        pos = p + 1
    if pos <= L:
        out.append((R, L, 0.0, None))
    return out


def _ambiguity_errors(code, eps, n_minor, r):
    """An ambiguity code's normalised pattern under the error model: the
    states it excludes get ``eps/3``, unless the leaf has minor
    sequences."""
    k = sum(1 for x in code if x)
    if n_minor:
        on, off = 1.0 / k, 0.0
    else:
        off = r(eps * 0.33333)
        on = r(0.5 - off) if k == 2 else r(1.0 / 3 - r(eps / 9))
    return tuple(on if x else off for x in code)


class ZeroMerge(ArithmeticError):
    """Two different observed states met at total distance 0."""


def _evolve_state(i, t, Q, r):
    """Unit vector of state ``i`` after length t: e_i + t Q[:, i]."""
    v = [r(Q[k][i] * t) for k in range(4)]
    v[i] = r(v[i] + 1.0)
    return UNIFORM if v[i] < 0 else v


def _evolve_vec(vec, t, Q, r):
    """4-vector after length t: v + t Q v (rows of Q against v)."""
    out = []
    for k in range(4):
        row = Q[k]
        x = r(r(r(r(r(row[0] * vec[0]) + r(row[1] * vec[1]))
                    + r(row[2] * vec[2])) + r(row[3] * vec[3])) * t)
        x = r(x + vec[k])
        if x < 0:
            return UNIFORM
        out.append(x)
    return out


def _collapse(vec, ref_nuc, tp, tp4):
    """MAPLE's simplification: R, a nucleotide, or O."""
    max_p, max_i, above = 0.0, 0, 0
    for i in range(4):
        if vec[i] > max_p:
            max_p, max_i = vec[i], i
        if vec[i] > tp:
            above += 1
    if max_p < tp4:
        raise ZeroMerge(f"degenerate vector {vec}")
    if above == 1:
        return R if max_i == ref_nuc else max_i
    return O


def merge(model, v1, t1, v2, t2, tips=(False, False), minors=(0, 0)):
    """Merge two children's lists across branches t1 and t2: (the parent's
    list, the merge's log-likelihood).  Under the error model ``tips``
    says which side is a tip (a leaf without minor sequences) and
    ``minors`` how many minor sequences a leaf side stands for."""
    ar = model.arith
    r = ar.r
    Q, cum, L = model.Q, model.cum, model.L
    err = model.errors
    t12 = r(t1 + t2)
    lk = r(t12 * model.global_rate)
    if err is not None:
        for k in (0, 1):
            if tips[k] or minors[k]:
                lk = r(lk + r(err.total * (1 + minors[k])))
    fac = 1.0
    out = []
    i1 = i2 = 0
    pos = 0
    e1, e2 = v1[0], v2[0]
    while True:
        c1, c2 = e1[0], e2[0]
        if c1 == N or c2 == N:
            if c1 == N and c2 == N:
                new = min(e1[1], e2[1])
                out.append((N, new, 0.0, None))
            else:
                k = 1 if c1 == N else 0
                e, t = (e2, t2) if k else (e1, t1)
                c = e[0]
                new = min(e1[1], e2[1]) if c == R else pos + 1
                field = new if c == R else e[1]
                if err is not None and c != O:
                    out.append((c, field, r(e[2] + t), None,
                                from_tip(e) or tips[k]))
                else:
                    out.append((c, field, r(e[2] + t), e[3]))
            lk = r(lk + r(t12 * r(cum[pos] - cum[new])))
            if err is not None:
                ce = r(err.cum[new] - err.cum[pos])
                for k in (0, 1):
                    if tips[k]:
                        lk = r(lk + ce)
        else:
            x1 = r(t1 + e1[2])
            x2 = r(t2 + e2[2])
            # a side whose state is observed through the emission
            f1 = err is not None and c1 != O and (from_tip(e1) or tips[0])
            f2 = err is not None and c2 != O and (from_tip(e2) or tips[1])
            inner = (f1 and not tips[0], f2 and not tips[1])
            both_ref = c1 == R and c2 == R
            new = min(e1[1], e2[1]) if both_ref else pos + 1
            if both_ref:
                if x2 > t2 or x1 > t1:
                    extra = r(r(r(x2 - t2) + x1) - t1)
                    lk = r(lk + r(extra * r(cum[new] - cum[pos])))
                    if inner[0] or inner[1]:
                        ce = r(err.cum[pos] - err.cum[new])
                        for k in (0, 1):
                            if inner[k]:
                                lk = r(lk + ce)
                out.append((R, new, 0.0, None))
            else:
                ref_nuc = e1[1] if c1 != R else e2[1]
                lk = r(lk - r(Q[ref_nuc][ref_nuc] * t12))
                eps = None if err is None else err.eps[pos]
                if err is not None and (c1 != c2 or c1 == O):
                    for k in (0, 1):
                        if tips[k]:
                            lk = r(lk + eps)
                if c1 == c2 and c1 < R:
                    out.append((c1, e1[1], 0.0, None))
                    lk = r(lk + r(Q[c1][c1] * r(x1 + x2)))
                    for k in (0, 1):
                        if inner[k]:
                            lk = r(lk - eps)
                elif not x1 and not x2 and c1 != O and c2 != O \
                        and not f1 and not f2:
                    raise ZeroMerge(f"states {c1} and {c2} at distance 0 "
                                    f"at position {pos + 1}")
                else:
                    s1 = ref_nuc if c1 == R else c1
                    s2 = ref_nuc if c2 == R else c2
                    p1 = _side(s1, e1, x1, Q, r, eps if f1 else None)
                    p2 = _side(s2, e2, x2, Q, r, eps if f2 else None)
                    prod = [r(p1[k] * p2[k]) for k in range(4)]
                    s = r(r(r(prod[0] + prod[1]) + prod[2]) + prod[3])
                    if not s:
                        raise ZeroMerge(f"zero probability at {pos + 1}")
                    prod = [r(x / s) for x in prod]
                    state = _collapse(prod, ref_nuc, model.tp, model.tp4)
                    if state == O:
                        out.append((O, ref_nuc, 0.0, prod))
                    elif state == R:
                        out.append((R, new, 0.0, None))
                    else:
                        out.append((state, ref_nuc, 0.0, None))
                    fac = r(fac * s)
        pos = new
        if fac <= ar.carry:
            if fac < ar.tiny:
                raise ZeroMerge("likelihood factor underflow")
            lk = r(lk + r(math.log(fac)))
            fac = 1.0
        if pos == L:
            break
        if c1 < R or c1 == O or pos == e1[1]:
            i1 += 1
            e1 = v1[i1]
        if c2 < R or c2 == O or pos == e2[1]:
            i2 += 1
            e2 = v2[i2]
    return _shorten(out, model.tp), r(lk + r(math.log(fac)))


def _side(state, e, x, Q, r, eps=None):
    """One child's 4-vector at a position, evolved over its length x; with
    ``eps`` a tip's observation, from the emission ``[1-e, e/3, ...]``."""
    if state == O:
        return _evolve_vec(e[3], x, Q, r) if x else list(e[3])
    if eps is not None:
        v = [r(eps * 0.33333)] * 4
        v[state] = r(1.0 - eps)
        return _evolve_vec(v, x, Q, r) if x else v
    if x:
        return _evolve_state(state, x, Q, r)
    v = [0.0, 0.0, 0.0, 0.0]
    v[state] = 1.0
    return v


def _shorten(vec, tp):
    """Join neighbouring R runs that both have no extra length, or whose
    extra lengths agree within ``tp``, and that carry the same tip mark;
    the joined run keeps the later run's extra length."""
    out = [vec[0]]
    for e in vec[1:]:
        prev = out[-1]
        if e[0] == R and prev[0] == R and (e[2] == 0) == (prev[2] == 0) \
                and abs(e[2] - prev[2]) <= tp \
                and from_tip(e) == from_tip(prev):
            out[-1] = e
        else:
            out.append(e)
    return out


def root_lk(model, vec):
    """Log-probability of the root's list under the root frequencies;
    under the error model a tip's entry reads its sites' error terms."""
    ar = model.arith
    r = ar.r
    err = model.errors
    lk = 0.0
    fac = 1.0
    pos = 0
    for e in vec:
        c = e[0]
        if err is not None and c < N and from_tip(e):
            if c == R:
                lk = r(lk + r(err.root_log[e[1]] - err.root_log[pos]))
                pos = e[1]
            else:
                eps = err.eps[pos]
                fac = r(fac * r(r(model.freqs[c] * r(1.0 - r(1.33333 * eps)))
                                + r(0.33333 * eps)))
                pos += 1
        elif c == R:
            a, b = model.cum_bases[pos], model.cum_bases[e[1]]
            for k in range(4):
                lk = r(lk + r(model.log_freqs[k] * (b[k] - a[k])))
            pos = e[1]
        elif c < R:
            lk = r(lk + model.log_freqs[c])
            pos += 1
        elif c == O:
            v = e[3]
            f = model.freqs
            fac = r(fac * r(r(r(r(f[0] * v[0]) + r(f[1] * v[1]))
                              + r(f[2] * v[2])) + r(f[3] * v[3])))
            pos += 1
        else:
            pos = e[1]
        if fac <= ar.carry:
            if fac < ar.tiny:
                return float("-inf")
            lk = r(lk + r(math.log(fac)))
            fac = 1.0
    return r(lk + r(math.log(fac)))


def pass_through(vec, muts, up, L):
    """Re-express a list across a branch of the mutation-annotated tree:
    ``muts`` is the branch's sorted (pos, upper nucleotide, lower
    nucleotide) list; going down the lower node's nucleotides become the
    local reference, going up the upper node's.  An entry keeps its extra
    length, vector and tip mark."""
    out = []
    k = 0
    last = 0
    for e in vec:
        c = e[0]
        if c == N:
            out.append(e)
            last = e[1]
            while k < len(muts) and muts[k][0] <= last:
                k += 1
        elif c == R:
            while k < len(muts) and muts[k][0] <= e[1]:
                mpos, upper, lower = muts[k]
                if mpos > last + 1:
                    out.append((R, mpos - 1) + e[2:])
                last = mpos
                nuc, other = (lower, upper) if up else (upper, lower)
                out.append((nuc, other) + e[2:])
                k += 1
            if last < e[1]:
                last = e[1]
                out.append(e)
        else:
            last += 1
            if k < len(muts) and muts[k][0] <= last:
                other = muts[k][1] if up else muts[k][2]
                k += 1
                if c == other:
                    out.append((R, last) + e[2:])
                else:
                    out.append((c, other) + e[2:])
            else:
                out.append(e)
        if last == L:
            break
    return out


def tree_lk(model, tree, tips):
    """The log-likelihood of ``tree`` (``children``, ``dist``, ``root`` and
    ``mutations``, see ``tree.Tree``) whose leaves hold the lists
    ``tips[node]`` in the global frame.  Each list is evaluated in its
    node's frame of the mutation-annotated tree, as MAPLE evaluates it:
    merges in the parent's frame, the root in the global one.  A leaf
    stands for itself and its ``minors``: a tip is a leaf without them."""
    r = model.arith.r
    L = model.L
    children, dist, muts = tree.children, tree.dist, tree.mutations
    lower = {}
    total = 0.0
    for node in tree.postorder():
        kids = children[node]
        if not kids:
            vec = tips[node]
            chain = tree.frame_chain(node)
            for m in chain:
                vec = pass_through(vec, muts[m], False, L)
            lower[node] = _shorten(vec, model.tp) if chain else vec
            continue
        if len(kids) != 2:
            raise ValueError(f"node {node} has {len(kids)} children")
        a, b = kids
        va, vb = lower.pop(a), lower.pop(b)
        if muts[a]:
            va = pass_through(va, muts[a], True, L)
        if muts[b]:
            vb = pass_through(vb, muts[b], True, L)
        minors = tuple(len(tree.minors[k]) if not children[k] else 0
                       for k in kids)
        is_tip = tuple(not children[k] and not m
                       for k, m in zip(kids, minors))
        lower[node], lk = merge(model, va, r(dist[a]), vb, r(dist[b]),
                                is_tip, minors)
        total = r(total + lk)
    vec = lower.pop(tree.root)
    if muts[tree.root]:
        vec = pass_through(vec, muts[tree.root], True, L)
    return r(total + root_lk(model, vec))
