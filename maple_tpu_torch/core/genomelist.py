"""Sparse genome-list representation and structural operations.

A genome list is the run-length encoding of a partial-likelihood vector over
the genome as a Python list of tuples; the layout is byte-compatible with the
reference's (MAPLEv0.7.5.4.py:378-390) so that golden-file parity and
differential tests are exact:

- ``(5, end)``                       N: missing-data run through position end
- ``(4, end[, b1[, b2]][, flag])``   R: run identical to the local reference
- ``(c, v[, b1[, b2]][, flag])``     c in 0..3: concrete nucleotide, v = local
                                     reference nucleotide at that position
- ``(6, v, probs)`` / ``(6, v, b1, probs)``  O: explicit normalized 4-vector

``b1`` = evolutionary distance since the type was observed; ``b2`` (only with
b1) = root-side distance for observations on the other side of the root;
``flag`` (present only when the error model is active, always last) marks
observations coming from an error-prone tip.  Positions are implicit: entries
are walked left-to-right, types <4 and 6 span one position, types 4/5 run
through their ``end`` field (1-based).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..refdata import ALLELES, AMBIGUITIES, RefData


def reshare_tip_ambiguities(tree, kern_name="python"):
    """Restore the reference's tip-ambiguity aliasing after a backend
    conversion: leaf O entries whose probabilities still equal a pristine
    ambiguity pattern are re-pointed at the shared per-code list."""
    by_value = {tuple(v): v for v in AMBIGUITIES.values()}
    for node in range(len(tree.up)):
        if tree.children[node]:
            continue
        vec = tree.probVect[node]
        if vec is None or not isinstance(vec, list):
            continue
        for i, e in enumerate(vec):
            if e[0] == TYPE_O and isinstance(e[-1], list):
                shared = by_value.get(tuple(e[-1]))
                if shared is not None:
                    vec[i] = e[:-1] + (shared,)

TYPE_R = 4
TYPE_N = 5
TYPE_O = 6

GenomeList = List[tuple]


def simplify(vec: Sequence[float], ref_nuc: int, threshold_prob: float,
             threshold_prob4: float) -> int:
    """Collapse an O 4-vector to a concrete type when only one state carries
    mass above threshold_prob: returns 4 if that state is the local reference,
    the nucleotide index otherwise, or 6 when several states remain
    (reference :3697-3717)."""
    max_p = 0.0
    max_i = 0
    num_above = 0
    for i in range(4):
        p = vec[i]
        if p > max_p:
            max_p = p
            max_i = i
        if p > threshold_prob:
            num_above += 1
    if max_p < threshold_prob4:
        raise ValueError(f"simplify(): degenerate O vector {list(vec)}")
    if num_above == 1:
        return TYPE_R if max_i == ref_nuc else max_i
    return TYPE_O


def shorten(vec: GenomeList, threshold_prob: float) -> None:
    """Merge adjacent R entries whose extra fields agree (branch lengths within
    threshold_prob, same flag) in place (reference :3721-3745)."""
    i = 0
    prev = vec[0]
    while i < len(vec) - 1:
        cur = vec[i + 1]
        if cur[0] == TYPE_R and prev[0] == TYPE_R and len(cur) == len(prev):
            n = len(cur)
            if n == 2:
                vec.pop(i)
                prev = vec[i]
                continue
            if abs(cur[2] - prev[2]) > threshold_prob:
                i += 1
                prev = vec[i]
                continue
            if n == 3:
                vec.pop(i)
                prev = vec[i]
                continue
            if abs(cur[3] - prev[3]) > threshold_prob:
                i += 1
                prev = vec[i]
                continue
            if n == 4 or cur[4] == prev[4]:
                vec.pop(i)
                prev = vec[i]
                continue
        i += 1
        prev = vec[i]


def pass_through_branch(lRef: int, prob_vect: GenomeList,
                        mutations: Sequence[Tuple[int, int, int]],
                        dir_is_up: bool = False) -> GenomeList:
    """Re-express a genome list relative to a different local reference.

    ``mutations`` is a MAT branch's sorted list of (pos, upper_nuc, lower_nuc);
    moving down (dir_is_up=False) re-expresses relative to the lower reference,
    moving up relative to the upper one (reference passGenomeListThroughBranch
    :3749-3877).  Two-pointer merge of the list with the mutation list.
    """
    n_mut = len(mutations)
    i_mut = 0
    i_ent = 0
    last_pos = 0
    out: GenomeList = []
    entry = prob_vect[0]
    while True:
        code = entry[0]
        if code == TYPE_N:
            out.append(entry)
            last_pos = entry[1]
            if last_pos == lRef:
                break
            while i_mut < n_mut and mutations[i_mut][0] <= last_pos:
                i_mut += 1
            i_ent += 1
            entry = prob_vect[i_ent]
        elif code < TYPE_R:
            last_pos += 1
            if i_mut < n_mut and mutations[i_mut][0] <= last_pos:
                other = mutations[i_mut][1] if dir_is_up else mutations[i_mut][2]
                if code == other:
                    # the nucleotide matches the new local reference: becomes R
                    out.append((TYPE_R, last_pos) + entry[2:])
                else:
                    out.append((code, other) + entry[2:])
                i_mut += 1
            else:
                out.append(entry)
            if last_pos == lRef:
                break
            i_ent += 1
            entry = prob_vect[i_ent]
        elif code == TYPE_R:
            while i_mut < n_mut and mutations[i_mut][0] <= entry[1]:
                mpos = mutations[i_mut][0]
                if mpos > last_pos + 1:
                    # R segment before the mutation position
                    out.append((TYPE_R, mpos - 1) + entry[2:])
                last_pos = mpos
                if dir_is_up:
                    nuc, other = mutations[i_mut][2], mutations[i_mut][1]
                else:
                    nuc, other = mutations[i_mut][1], mutations[i_mut][2]
                out.append((nuc, other) + entry[2:])
                i_mut += 1
            if last_pos < entry[1]:
                last_pos = entry[1]
                out.append(entry)
            if last_pos == lRef:
                break
            i_ent += 1
            entry = prob_vect[i_ent]
        else:  # O entry
            last_pos += 1
            if i_mut < n_mut and mutations[i_mut][0] <= last_pos:
                other = mutations[i_mut][1] if dir_is_up else mutations[i_mut][2]
                out.append((TYPE_O, other) + entry[2:])
                i_mut += 1
            else:
                out.append(entry)
            if last_pos == lRef:
                break
            i_ent += 1
            entry = prob_vect[i_ent]
    return out


def terminal_node_genome_list(
    refd: RefData,
    diffs: Optional[Sequence[tuple]],
    only_n_ambiguities: bool = False,
    using_error_rate: bool = False,
    error_rate: float = 0.0,
    error_rates: Optional[Sequence[float]] = None,
    num_minor_seqs: int = 0,
) -> GenomeList:
    """Build a tip's genome list from its MAPLE diff entries, in the global
    reference frame (the runtime translates it into the node's MAT frame);
    ambiguity codes become O entries, adjusted for the error model when the
    tip has no minor sequences (reference probVectTerminalNode :3882-3962).
    """
    lRef = refd.lRef
    if diffs is None:
        return [(TYPE_N, lRef)]
    pos = 1
    out: GenomeList = []
    for m in diffs:
        cur = m[1]
        if cur > pos:
            out.append((TYPE_R, cur - 1))
            pos = cur
        ch = m[0]
        if ch == "n" or ch == "-":
            length = m[2] if len(m) > 2 else 1
            entry = (TYPE_N, cur + length - 1)
            pos = cur + length
        elif ch in ALLELES:
            nuc = ALLELES[ch]
            if nuc == refd.ref_indices[cur - 1]:
                entry = (TYPE_R, cur)
            else:
                entry = (nuc, refd.ref_indices[cur - 1])
            pos = cur + 1
        else:
            if only_n_ambiguities:
                entry = (TYPE_N, cur)
            else:
                if not using_error_rate:
                    # the reference shares ONE probability list per
                    # ambiguity code across every tip (:3959); later
                    # error-model refreshes mutate it in place, so all
                    # aliased entries end with the eps of whichever tip
                    # was refreshed last.  Preserve the aliasing for byte
                    # parity.
                    vec = AMBIGUITIES[ch]
                else:
                    vec = list(AMBIGUITIES[ch])
                if using_error_rate and num_minor_seqs == 0:
                    eps = (error_rates[cur - 1] if error_rates is not None
                           else error_rate)
                    n_set = sum(1 for x in vec if x)
                    if n_set == 2:
                        vec = [x - eps * 0.33333 if x else eps * 0.33333
                               for x in vec]
                    elif n_set == 3:
                        vec = [x - eps / 9 if x else eps * 0.33333 for x in vec]
                entry = (TYPE_O, refd.ref_indices[cur - 1], vec)
            pos = cur + 1
        out.append(entry)
    if pos <= lRef:
        out.append((TYPE_R, lRef))
    return out


def genome_list_length_check(lRef: int, vec: GenomeList) -> bool:
    """Sanity invariant: entries tile [1, lRef] exactly."""
    pos = 0
    for e in vec:
        if e[0] in (TYPE_R, TYPE_N):
            if e[1] <= pos:
                return False
            pos = e[1]
        else:
            pos += 1
    return pos == lRef
