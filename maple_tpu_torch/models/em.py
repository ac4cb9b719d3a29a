"""Expectation-maximization estimation of substitution rates, site rates and
(site-specific) error rates; doubles as the MAT annotator when
``track_mutations`` (reference expectationMaximizationCalculationRates
:10077-10947).

One pass over all branches accumulates per-nucleotide waiting times and 4x4
substitution counts from the posterior of each (upper, lower) entry pair.
Estimators: UNREST rate = counts/waitingTimes per row; GTR symmetrized
(c_ij+c_ji)/w_i; matrix normalized to stationary total rate 1; site rates
(counts_i+1)/(expected_i+1) clamped to [0.001, 0.005*lRef]; site error rates
errors/observed clamped >= 1e-10.
"""
from __future__ import annotations

import time

from typing import Optional

from ..core.genomelist import TYPE_N, TYPE_O, TYPE_R
from ..runtime.partials import TreeRuntime

RANGE4 = (0, 1, 2, 3)
MIN_ERROR_PROB = 0.0000000001


def pass_mutation_list_through_branch(ref_indices, mutations1, mutations2,
                                      dir_is_up=False):
    """Update a (pos, nuc) frame-difference list across a MAT branch
    (reference passMutationListThroughBranch :10027-10076)."""
    out = []
    ind1 = ind2 = 0
    n1, n2 = len(mutations1), len(mutations2)
    while True:
        if ind1 < n1:
            pos1 = mutations1[ind1][0]
            if ind2 < n2:
                pos2 = mutations2[ind2][0]
                if pos1 < pos2:
                    out.append(mutations1[ind1])
                    ind1 += 1
                else:
                    end_nuc = mutations2[ind2][1] if dir_is_up \
                        else mutations2[ind2][2]
                    if end_nuc != ref_indices[pos2 - 1]:
                        out.append((pos2, end_nuc))
                    ind2 += 1
                    if pos1 == pos2:
                        ind1 += 1
            else:
                out.append(mutations1[ind1])
                ind1 += 1
        elif ind2 < n2:
            pos2 = mutations2[ind2][0]
            end_nuc = mutations2[ind2][1] if dir_is_up \
                else mutations2[ind2][2]
            if end_nuc != ref_indices[pos2 - 1]:
                out.append((pos2, end_nuc))
            ind2 += 1
        else:
            break
    return out


def expectation_maximization_rates(rt: TreeRuntime, root: int,
                                   track_mutations: bool = False):
    t0 = time.time()
    try:
        return _expectation_maximization_rates_timed_impl(rt, root, track_mutations)
    finally:
        rt.add_phase_time("em", time.time() - t0)


def _expectation_maximization_rates_timed_impl(rt: TreeRuntime, root: int,
                                   track_mutations: bool = False):
    """Returns (rate_matrix, site_rates|None, error_rate|None,
    site_error_rates|None); with track_mutations also fills
    tree.mutationsInf / tree.Ns / tree.errors."""
    if not track_mutations and getattr(rt.kern, "name", "") == "native":
        return _em_native(rt, root)
    tree = rt.tree
    model = rt.model
    refd = rt.refd
    cfg = rt.cfg
    lRef = refd.lRef
    ref_indices = refd.ref_indices
    cumulative_bases = refd.cumulative_bases
    root_freqs = refd.root_freqs
    uer = model.using_error_rate
    site_err = model.error_rate_site_specific
    rate_var = model.use_rate_variation
    mut_matrices = model.mut_matrices
    mut_matrix = model.mut_matrix
    err_rates_in = model.error_rates
    error_rate = model.error_rate
    min_mut_prob = cfg.minMutProb
    model_name = model.model_name
    up = tree.up
    children = tree.children
    dist = tree.dist
    minor = tree.minorSequences

    if track_mutations:
        tree.Ns = [[] for _ in range(len(up))]
        tree.mutationsInf = [[] for _ in range(len(up))]
        Ns = tree.Ns
        mutations_inf = tree.mutationsInf
        if uer:
            tree.errors = [[] for _ in range(len(up))]
            errors = tree.errors

    counts = [[0.0] * 4 for _ in range(4)]
    waiting_times = [0.0] * 4
    num_tips = 0
    error_count = 0.0
    if uer:
        observed_tot = 0
        if site_err:
            observed_sites = [0.0] * (lRef + 1)
            error_count_sites = [0.0] * lRef
    if rate_var:
        tot_tree_length = 0.0
        waiting_times_sites = [[0.0] * 4 for _ in range(lRef)]
        counts_sites = [0.0] * lRef
        tracking_ns = [0.0] * (lRef + 1)

    node = root
    mutations_list = [(m[0], m[2]) for m in tree.mutations[root]]
    last_node = None
    direction = 0
    while node is not None:
        if direction == 0:
            node_is_leaf = len(children[node]) == 0
            if node_is_leaf:
                num_tips += 1 + len(minor[node])
            if (dist[node] or (uer and node_is_leaf)) and up[node] is not None:
                if rate_var:
                    tot_tree_length += dist[node]
                vP = tree.vect_up_for(node)
                if tree.mutations[node]:
                    vP = rt.pass_down(vP, node)
                vP = rt.kern.export(vP)
                vC = rt.kern.export(tree.probVect[node])
                i1x = i2x = 0
                pos = 0
                iml = 0
                e1 = vP[0]
                e2 = vC[0]
                while True:
                    while iml < len(mutations_list) \
                            and mutations_list[iml][0] < pos:
                        iml += 1
                    c1 = e1[0]
                    c2 = e2[0]
                    if c2 == TYPE_N:
                        end = min(e1[1], e2[1]) \
                            if c1 in (TYPE_R, TYPE_N) else pos + 1
                        if uer and node_is_leaf:
                            if site_err:
                                observed_sites[pos] -= 1 + len(minor[node])
                            else:
                                observed_tot -= (end - pos) \
                                    * (1 + len(minor[node]))
                        if rate_var:
                            tracking_ns[pos] -= dist[node]
                        if track_mutations:
                            if (not Ns[node]) or isinstance(Ns[node][-1], int) \
                                    or Ns[node][-1][1] != e2[1]:
                                Ns[node].append((pos + 1, e2[1]))
                        pos = end
                        if rate_var:
                            tracking_ns[pos] += dist[node]
                        if uer and site_err and node_is_leaf:
                            observed_sites[pos] += 1 + len(minor[node])
                    elif c1 == TYPE_N:
                        end = min(e1[1], e2[1]) if c2 == TYPE_R else pos + 1
                        if rate_var:
                            tracking_ns[pos] -= dist[node]
                        pos = end
                        if rate_var:
                            tracking_ns[pos] += dist[node]
                    else:
                        tot_len1 = dist[node]
                        if c1 < TYPE_N:
                            if len(e1) == 3 + uer:
                                tot_len1 += e1[2]
                            elif len(e1) == 4 + uer:
                                tot_len1 += e1[3]
                        else:
                            if len(e1) > 3:
                                tot_len1 += e1[2]
                        tot_len2 = 0.0
                        if c2 < TYPE_N:
                            if len(e2) > 2 + uer:
                                tot_len2 += e2[2]
                        else:
                            if len(e2) > 3:
                                tot_len2 += e2[2]

                        if c1 == TYPE_R and c2 == TYPE_R:
                            end = min(e1[1], e2[1])
                            if (not tot_len2) and dist[node]:
                                for i in RANGE4:
                                    waiting_times[i] += tot_len1 * (
                                        cumulative_bases[end][i]
                                        - cumulative_bases[pos][i])
                                while iml < len(mutations_list) \
                                        and mutations_list[iml][0] < end:
                                    alt_pos, alt_nuc = mutations_list[iml]
                                    ref_nuc = ref_indices[alt_pos]
                                    waiting_times[ref_nuc] -= tot_len1
                                    waiting_times[alt_nuc] += tot_len1
                                    iml += 1
                                    if rate_var:
                                        waiting_times_sites[alt_pos - 1][
                                            alt_nuc] += tot_len1
                                        waiting_times_sites[alt_pos - 1][
                                            ref_nuc] -= tot_len1
                            pos = end
                        else:
                            if rate_var:
                                mm = mut_matrices[pos]
                            else:
                                mm = mut_matrix
                            if site_err:
                                error_rate = err_rates_in[pos]
                            if c1 == TYPE_O:
                                if not tot_len2:
                                    if rate_var:
                                        waiting_times_sites[pos][
                                            ref_indices[pos]] -= tot_len1
                                    if c2 == TYPE_O:
                                        _em_O_O(
                                            e1, e2, tot_len1, pos, node,
                                            node_is_leaf, uer, site_err,
                                            error_rate, mm, counts,
                                            waiting_times, rate_var,
                                            waiting_times_sites if rate_var
                                            else None,
                                            counts_sites if rate_var
                                            else None,
                                            track_mutations,
                                            mutations_inf if track_mutations
                                            else None,
                                            Ns if track_mutations else None,
                                            error_count_sites if (uer and
                                                                  site_err)
                                            else None,
                                            min_mut_prob)
                                        error_count += _em_last_error_count[0]
                                    else:
                                        _em_O_nuc(
                                            e1, e2, tot_len1, pos, node,
                                            node_is_leaf, bool(minor[node]),
                                            uer, site_err, error_rate, mm,
                                            counts, waiting_times, rate_var,
                                            waiting_times_sites if rate_var
                                            else None,
                                            counts_sites if rate_var
                                            else None,
                                            track_mutations,
                                            mutations_inf if track_mutations
                                            else None,
                                            errors if (track_mutations and
                                                       uer) else None,
                                            error_count_sites if (uer and
                                                                  site_err)
                                            else None,
                                            min_mut_prob)
                                        error_count += _em_last_error_count[0]
                            else:
                                i1 = e2[1] if c1 == TYPE_R else c1
                                if c2 == TYPE_O:
                                    inc = _em_nuc_O(
                                        e1, e2, i1, tot_len1, tot_len2, pos,
                                        node, node_is_leaf, uer, site_err,
                                        error_rate, mm, root_freqs,
                                        ref_indices, counts, waiting_times,
                                        rate_var,
                                        waiting_times_sites if rate_var
                                        else None,
                                        counts_sites if rate_var else None,
                                        track_mutations,
                                        mutations_inf if track_mutations
                                        else None,
                                        Ns if track_mutations else None,
                                        error_count_sites if (uer and
                                                              site_err)
                                        else None, min_mut_prob)
                                    error_count += inc
                                else:
                                    i2 = e2[0] if e2[0] < TYPE_R else e1[1]
                                    inc = _em_nuc_nuc(
                                        e1, i1, i2, tot_len1, tot_len2, pos,
                                        node, node_is_leaf,
                                        bool(minor[node]), uer, site_err,
                                        error_rate, mm, root_freqs,
                                        ref_indices, counts, waiting_times,
                                        rate_var,
                                        waiting_times_sites if rate_var
                                        else None,
                                        counts_sites if rate_var else None,
                                        track_mutations,
                                        mutations_inf if track_mutations
                                        else None,
                                        errors if (track_mutations and uer)
                                        else None,
                                        error_count_sites if (uer and
                                                              site_err)
                                        else None, min_mut_prob)
                                    error_count += inc
                            pos += 1

                    if pos == lRef:
                        break
                    if c1 < TYPE_R or c1 == TYPE_O:
                        i1x += 1
                        e1 = vP[i1x]
                    elif pos == e1[1]:
                        i1x += 1
                        e1 = vP[i1x]
                    if c2 < TYPE_R or c2 == TYPE_O:
                        i2x += 1
                        e2 = vC[i2x]
                    elif pos == e2[1]:
                        i2x += 1
                        e2 = vC[i2x]
            else:
                # zero-length branch: still record Ns for annotation
                if track_mutations:
                    pos = 0
                    for e2 in rt.kern.export(tree.probVect[node]):
                        if e2[0] == TYPE_N:
                            if e2[1] > pos + 1:
                                Ns[node].append((pos + 1, e2[1]))
                            else:
                                Ns[node].append(pos + 1)
                            pos = e2[1]
                        elif e2[0] == TYPE_R:
                            pos = e2[1]
                        else:
                            if e2[0] == TYPE_O and node_is_leaf:
                                Ns[node].append(pos + 1)
                            pos += 1

            if children[node]:
                node = children[node][0]
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node])
            else:
                last_node = node
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node],
                        dir_is_up=True)
                node = up[node]
                direction = 1
        else:
            if last_node == children[node][0]:
                node = children[node][1]
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node])
                direction = 0
            else:
                last_node = node
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node],
                        dir_is_up=True)
                node = up[node]
                direction = 1

    return _finalize_em(
        model_name, mut_matrix, root_freqs, ref_indices, lRef, uer,
        site_err, rate_var, track_mutations, counts, waiting_times,
        error_count, observed_tot if uer else 0.0, num_tips,
        observed_sites if (uer and site_err) else None,
        error_count_sites if (uer and site_err) else None,
        tot_tree_length if rate_var else 0.0,
        tracking_ns if rate_var else None,
        waiting_times_sites if rate_var else None,
        counts_sites if rate_var else None)


def _finalize_em(model_name, mut_matrix, root_freqs, ref_indices, lRef,
                 uer, site_err, rate_var, track_mutations, counts,
                 waiting_times, error_count, observed_tot, num_tips,
                 observed_sites, error_count_sites, tot_tree_length,
                 tracking_ns, waiting_times_sites, counts_sites):
    """Estimator tail shared by the Python and native accumulation paths
    (reference :10855-10938)."""
    if uer:
        observed_tot += lRef * num_tips

    # ---- estimators ----
    if model_name == "UNREST":
        for i in RANGE4:
            if not waiting_times[i]:
                for j in RANGE4:
                    counts[i][j] = 0.0
            else:
                for j in RANGE4:
                    if i != j:
                        counts[i][j] /= waiting_times[i]
                counts[i][i] = -sum(counts[i])
    elif model_name == "GTR":
        new_rates = [[0.0] * 4 for _ in range(4)]
        for i in RANGE4:
            if waiting_times[i]:
                for j in RANGE4:
                    if i != j:
                        new_rates[i][j] = (counts[i][j] + counts[j][i]) \
                            / waiting_times[i]
                new_rates[i][i] = -sum(new_rates[i])
        counts = new_rates
    elif (not track_mutations) and (not uer):
        # JC has nothing to estimate here; return the input matrix unchanged
        counts = [row[:] for row in mut_matrix]
        return counts, None, None, None
    tot_rate = -(root_freqs[0] * counts[0][0] + root_freqs[1] * counts[1][1]
                 + root_freqs[2] * counts[2][2]
                 + root_freqs[3] * counts[3][3])
    if tot_rate:
        for i in RANGE4:
            for j in RANGE4:
                counts[i][j] = counts[i][j] / tot_rate

    if uer:
        error_rate_estimate = error_count / observed_tot
        if site_err:
            site_err_rates = []
            observed_nuc = num_tips
            for i in range(lRef):
                observed_nuc += observed_sites[i]
                if observed_nuc > 0:
                    site_err_rates.append(
                        max(MIN_ERROR_PROB, error_count_sites[i]
                            / observed_nuc))
                else:
                    site_err_rates.append(MIN_ERROR_PROB)
        else:
            site_err_rates = None
    else:
        error_rate_estimate = None
        site_err_rates = None

    if rate_var:
        site_rates = []
        tot_rate = 0.0
        normalization = 0.0
        for i in range(lRef):
            tot_tree_length += tracking_ns[i]
            waiting_times_sites[i][ref_indices[i]] += tot_tree_length
            tot_expected = 0.0
            for j in RANGE4:
                tot_expected -= waiting_times_sites[i][j] * counts[j][j]
            if not tot_expected:
                site_rates.append(1.0)
            else:
                site_rates.append((counts_sites[i] + 1) / (tot_expected + 1))
            for j in RANGE4:
                tot_rate -= waiting_times_sites[i][j] * counts[j][j] \
                    * site_rates[i]
            normalization += sum(waiting_times_sites[i])
        tot_rate = tot_rate / normalization
        max_rate = 0.005 * lRef
        for i in range(lRef):
            site_rates[i] = min(max_rate, max(0.001, site_rates[i]
                                              / tot_rate))
    else:
        site_rates = None
    return counts, site_rates, error_rate_estimate, site_err_rates


def _em_native(rt: TreeRuntime, root: int):
    """Native accumulation path: the same branch traversal as the Python
    body, with the per-branch two-pointer accumulation in C++
    (native em_branch; float-op order mirrored, so totals are
    byte-identical).  track_mutations stays on the Python path."""
    import numpy as np
    tree = rt.tree
    model = rt.model
    refd = rt.refd
    lRef = refd.lRef
    ref_indices = refd.ref_indices
    uer = model.using_error_rate
    site_err = model.error_rate_site_specific
    rate_var = model.use_rate_variation
    up = tree.up
    children = tree.children
    dist = tree.dist
    minor = tree.minorSequences
    store = rt.kern._sync()
    store.em_reset()
    if rt.native_session is not None:
        # live engine session: the branch crawl itself runs engine-side
        # (engine_em) over the resident tree — the python mirrors of
        # up/children/dist/probVect are stale while a session is open
        num_tips = rt.native_session.em_crawl()
        return _em_native_finalize(rt, store, num_tips)

    def conv(ml):
        if not ml:
            return (None, None, 0)
        return (np.array([m[0] for m in ml], dtype=np.int32),
                np.array([m[1] for m in ml], dtype=np.int8), len(ml))

    mutations_list = [(m[0], m[2]) for m in tree.mutations[root]]
    mut_arrays = conv(mutations_list)
    num_tips = 0
    node = root
    last_node = None
    direction = 0
    while node is not None:
        if direction == 0:
            node_is_leaf = len(children[node]) == 0
            if node_is_leaf:
                num_tips += 1 + len(minor[node])
            if (dist[node] or (uer and node_is_leaf)) \
                    and up[node] is not None:
                vP = tree.vect_up_for(node)
                if tree.mutations[node]:
                    vP = rt.pass_down(vP, node)
                store.em_branch(vP.vid, tree.probVect[node].vid,
                                dist[node], node_is_leaf,
                                len(minor[node]), mut_arrays[0],
                                mut_arrays[1], mut_arrays[2])
            if children[node]:
                node = children[node][0]
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node])
                    mut_arrays = conv(mutations_list)
            else:
                last_node = node
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node],
                        dir_is_up=True)
                    mut_arrays = conv(mutations_list)
                node = up[node]
                direction = 1
        else:
            if last_node == children[node][0]:
                node = children[node][1]
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node])
                    mut_arrays = conv(mutations_list)
                direction = 0
            else:
                last_node = node
                if tree.mutations[node]:
                    mutations_list = pass_mutation_list_through_branch(
                        ref_indices, mutations_list, tree.mutations[node],
                        dir_is_up=True)
                    mut_arrays = conv(mutations_list)
                node = up[node]
                direction = 1

    return _em_native_finalize(rt, store, num_tips)


def _em_native_finalize(rt: TreeRuntime, store, num_tips: int):
    """Read the store's EM accumulation tables and produce the new model
    estimates (shared tail of the host-driven and engine-session native
    EM paths)."""
    model = rt.model
    refd = rt.refd
    uer = model.using_error_rate
    site_err = model.error_rate_site_specific
    rate_var = model.use_rate_variation
    counts, waiting_times, error_count, observed_tot, tot_tree_length = \
        store.em_totals()
    if rate_var:
        waiting_times_sites, counts_sites, tracking_ns = \
            store.em_site_arrays()
    else:
        waiting_times_sites = counts_sites = tracking_ns = None
    if uer and site_err:
        observed_sites, error_count_sites = store.em_error_arrays()
    else:
        observed_sites = error_count_sites = None
    return _finalize_em(
        model.model_name, model.mut_matrix, refd.root_freqs,
        refd.ref_indices, refd.lRef, uer, site_err, rate_var, False,
        counts, waiting_times, error_count, observed_tot, num_tips,
        observed_sites, error_count_sites, tot_tree_length, tracking_ns,
        waiting_times_sites, counts_sites)


# scratch cell used to return the per-call error-count increment from the
# O-pair helpers without complicating their signatures
_em_last_error_count = [0.0]


def _em_O_O(e1, e2, tot_len1, pos, node, node_is_leaf, uer, site_err,
            error_rate, mm, counts, waiting_times, rate_var, wts, cs,
            track, mutations_inf, Ns, error_count_sites, min_mut_prob):
    """Posterior accumulation for an O upper against an O lower
    (reference :10247-10336)."""
    _em_last_error_count[0] = 0.0
    if track and node_is_leaf:
        Ns[node].append(pos + 1)
    p1 = e1[-1]
    p2 = e2[-1]
    if node_is_leaf and uer:
        no_mut = 0.0
        mut_prob = 0.0
        err_prob = 0.0
        for j in RANGE4:
            if p2[j] > 0.1:
                no_mut += p1[j]
                err_prob += (1.0 - p1[j]) * error_rate * 0.33333
                for i in RANGE4:
                    if j != i:
                        mut_prob += p1[i] * mm[i][j] * tot_len1
        normalization = err_prob + no_mut + mut_prob
        err_prob /= normalization
        _em_last_error_count[0] = err_prob
        if error_count_sites is not None:
            error_count_sites[pos] += err_prob
        for j in RANGE4:
            if p2[j] > 0.1:
                waiting_times[j] += tot_len1 * p1[j] / normalization
                if rate_var:
                    wts[pos][j] += tot_len1 * p1[j] / normalization
                for i in RANGE4:
                    if j != i:
                        mpij = p1[i] * mm[i][j] * tot_len1 / normalization
                        waiting_times[j] += tot_len1 * mpij / 2
                        waiting_times[i] += tot_len1 * mpij / 2
                        counts[i][j] += mpij
                        if rate_var:
                            wts[pos][j] += tot_len1 * mpij / 2
                            wts[pos][i] += tot_len1 * mpij / 2
                            cs[pos] += mpij
    else:
        normalization = 0.0
        approx_failed = [False] * 4
        for i in RANGE4:
            stay = 1.0 + mm[i][i] * tot_len1
            if stay < 0:
                for j in RANGE4:
                    normalization += p1[i] * 0.25 * p2[j]
                approx_failed[i] = True
            else:
                for j in RANGE4:
                    if i == j:
                        normalization += p1[i] * stay * p2[j]
                    else:
                        normalization += p1[i] * mm[i][j] * tot_len1 * p2[j]
        for i in RANGE4:
            for j in RANGE4:
                if i == j:
                    if approx_failed[i]:
                        prob = p1[i] * 0.25 * p2[j] / normalization
                    else:
                        prob = p1[i] * (1.0 + mm[i][i] * tot_len1) * p2[j] \
                            / normalization
                    waiting_times[i] += tot_len1 * prob
                    if rate_var:
                        wts[pos][i] += tot_len1 * prob
                else:
                    if approx_failed[i]:
                        prob = p1[i] * 0.25 * p2[j] / normalization
                    else:
                        prob = p1[i] * mm[i][j] * tot_len1 * p2[j] \
                            / normalization
                    waiting_times[i] += (tot_len1 / 2) * prob
                    waiting_times[j] += (tot_len1 / 2) * prob
                    counts[i][j] += prob
                    if track and prob > min_mut_prob:
                        mutations_inf[node].append((i, pos + 1, j, prob))
                    if rate_var:
                        wts[pos][i] += (tot_len1 / 2) * prob
                        wts[pos][j] += (tot_len1 / 2) * prob
                        cs[pos] += prob


def _em_O_nuc(e1, e2, tot_len1, pos, node, node_is_leaf, has_minor, uer,
              site_err, error_rate, mm, counts, waiting_times, rate_var,
              wts, cs, track, mutations_inf, errors, error_count_sites,
              min_mut_prob):
    """O upper against concrete lower nucleotide (reference :10337-10432)."""
    _em_last_error_count[0] = 0.0
    p1 = e1[-1]
    i2 = e1[1] if e2[0] == TYPE_R else e2[0]
    if node_is_leaf and uer and not has_minor:
        err_prob = (1.0 - p1[i2]) * error_rate * 0.33333
        no_mut = p1[i2]
        mut_prob = 0.0
        for i in RANGE4:
            if i != i2:
                mut_prob += p1[i] * mm[i][i2] * tot_len1
        normalization = err_prob + no_mut + mut_prob
        err_prob /= normalization
        no_mut /= normalization
        mut_prob /= normalization
        _em_last_error_count[0] = err_prob
        if track and err_prob > min_mut_prob:
            errors[node].append((4, pos + 1, i2, err_prob))
        if error_count_sites is not None:
            error_count_sites[pos] += err_prob
        waiting_times[i2] += tot_len1 * no_mut
        waiting_times[i2] += (tot_len1 / 2) * mut_prob
        if rate_var:
            wts[pos][i2] += tot_len1 * no_mut
            wts[pos][i2] += tot_len1 * mut_prob / 2
            cs[pos] += mut_prob
        for i in RANGE4:
            if i != i2:
                prob = p1[i] * mm[i][i2] * tot_len1 / normalization
                prob_err = p1[i] * error_rate * 0.33333 / normalization
                waiting_times[i] += tot_len1 * (prob_err + prob / 2)
                counts[i][i2] += prob
                if track and prob > min_mut_prob:
                    mutations_inf[node].append((i, pos + 1, i2, prob))
                if rate_var:
                    wts[pos][i] += tot_len1 * (prob_err + prob / 2)
    else:
        stay = 1.0 + mm[i2][i2] * tot_len1
        if stay < 0:
            normalization = 0.25
            approx_failed = True
        else:
            approx_failed = False
            normalization = 0.0
            for i in RANGE4:
                if i == i2:
                    normalization += p1[i] * stay
                else:
                    normalization += p1[i] * mm[i][i2] * tot_len1
        for i in RANGE4:
            if i == i2:
                if approx_failed:
                    prob = p1[i]
                else:
                    prob = p1[i] * (1.0 + mm[i][i] * tot_len1) / normalization
                waiting_times[i] += tot_len1 * prob
                if rate_var:
                    wts[pos][i] += tot_len1 * prob
            else:
                if approx_failed:
                    prob = p1[i]
                else:
                    prob = p1[i] * mm[i][i2] * tot_len1 / normalization
                waiting_times[i] += (tot_len1 / 2) * prob
                waiting_times[i2] += (tot_len1 / 2) * prob
                counts[i][i2] += prob
                if track and prob > min_mut_prob:
                    mutations_inf[node].append((i, pos + 1, i2, prob))
                if rate_var:
                    wts[pos][i] += (tot_len1 / 2) * prob
                    wts[pos][i2] += (tot_len1 / 2) * prob
                    cs[pos] += prob


def _em_nuc_O(e1, e2, i1, tot_len1, tot_len2, pos, node, node_is_leaf, uer,
              site_err, error_rate, mm, root_freqs, ref_indices, counts,
              waiting_times, rate_var, wts, cs, track, mutations_inf, Ns,
              error_count_sites, min_mut_prob):
    """Concrete upper nucleotide against an O lower (reference
    :10434-10660).  Returns the error-count increment."""
    err_inc = 0.0
    p2 = e2[-1]
    if track and node_is_leaf:
        Ns[node].append(pos + 1)
    if p2[i1] > 0.1:
        # reference allele plausible: ignore alternatives
        waiting_times[i1] += tot_len1
        if rate_var:
            wts[pos][ref_indices[pos]] -= tot_len1
            wts[pos][i1] += tot_len1
        return err_inc
    uer_here = node_is_leaf and uer
    if uer_here:
        num_alt = sum(1 for i in RANGE4 if p2[i] > 0.1)
        if len(e1) == 4 + uer:
            stay1 = 1.0 + mm[i1][i1] * tot_len1
            if stay1 < 0:
                stay1 = 0.25
            stay2 = 1.0 + mm[i1][i1] * e1[2]
            approx2 = stay2 < 0
            if approx2:
                stay2 = 0.25
            err_prob = root_freqs[i1] * stay1 * stay2 * error_rate \
                * 0.33333 * num_alt
            mut_prob = 0.0
            i1_root = root_freqs[i1] * stay2
            for i in RANGE4:
                if p2[i] > 0.1:
                    stay1i = 1.0 + mm[i][i] * tot_len1
                    approx1 = stay1i < 0
                    if approx1:
                        stay1i = 0.25
                    if approx1:
                        mut_prob += i1_root * 0.25
                    else:
                        mut_prob += i1_root * mm[i1][i] * tot_len1
                    if approx2:
                        mut_prob += root_freqs[i] * stay1i * 0.25
                    else:
                        mut_prob += root_freqs[i] * stay1i * mm[i][i1] * e1[2]
            normalization = err_prob + mut_prob
            err_prob /= normalization
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
                wts[pos][i1] += tot_len1 * err_prob
            waiting_times[i1] += tot_len1 * err_prob
            err_inc += err_prob
            if error_count_sites is not None:
                error_count_sites[pos] += err_prob
            for i in RANGE4:
                if p2[i] > 0.1:
                    stay1i = 1.0 + mm[i][i] * tot_len1
                    approx1 = stay1i < 0
                    if approx1:
                        stay1i = 0.25
                    if approx1:
                        prob1 = i1_root * 0.25 / normalization
                    else:
                        prob1 = i1_root * mm[i1][i] * tot_len1 \
                            / normalization
                    if approx2:
                        probi = root_freqs[i] * stay1i * 0.25 / normalization
                    else:
                        probi = root_freqs[i] * stay1i * mm[i][i1] * e1[2] \
                            / normalization
                    waiting_times[i] += tot_len1 * (probi + prob1 / 2)
                    waiting_times[i1] += tot_len1 * prob1 / 2
                    counts[i1][i] += prob1
                    if rate_var:
                        wts[pos][i] += tot_len1 * (probi + prob1 / 2)
                        wts[pos][i1] += tot_len1 * prob1 / 2
                        cs[pos] += prob1
        else:
            stay = 1.0 + mm[i1][i1] * tot_len1
            approx = stay < 0
            if approx:
                stay = 0.25
            err_prob = stay * error_rate * 0.33333 * num_alt
            mut_prob = 0.0
            for i in RANGE4:
                if p2[i] > 0.1:
                    if approx:
                        mut_prob += 0.25
                    else:
                        mut_prob += mm[i1][i] * tot_len1
            normalization = err_prob + mut_prob
            err_prob /= normalization
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
                wts[pos][i1] += tot_len1 * err_prob
            waiting_times[i1] += tot_len1 * err_prob
            err_inc += err_prob
            if error_count_sites is not None:
                error_count_sites[pos] += err_prob
            for i in RANGE4:
                if p2[i] > 0.1:
                    prob = mm[i1][i] * tot_len1 / normalization
                    waiting_times[i1] += (tot_len1 / 2) * prob
                    waiting_times[i] += (tot_len1 / 2) * prob
                    counts[i1][i] += prob
                    if rate_var:
                        wts[pos][i1] += (tot_len1 / 2) * prob
                        wts[pos][i] += (tot_len1 / 2) * prob
                        cs[pos] += prob
    elif not tot_len2:
        normalization = 0.0
        if len(e1) == 4 + uer:
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
            stay1 = 1.0 + mm[i1][i1] * e1[2]
            approx1 = stay1 < 0
            if approx1:
                stay1 = 0.25
            for i in RANGE4:
                stay2 = 1.0 + mm[i][i] * tot_len1
                approx2 = stay2 < 0
                if approx2:
                    stay2 = 0.25
                if i1 == i:
                    prob = root_freqs[i] * stay1
                    if approx2:
                        tot3 = 0.25
                    else:
                        tot3 = 0.0
                        for j in RANGE4:
                            tot3 += mm[i][j] * p2[j]
                        tot3 *= tot_len1
                        tot3 += p2[i]
                    normalization += prob * tot3
                else:
                    if approx1:
                        prob = root_freqs[i] * 0.25 * stay2 * p2[i]
                    else:
                        prob = root_freqs[i] * mm[i][i1] * e1[2] * stay2 \
                            * p2[i]
                    normalization += prob
            for i in RANGE4:
                stay2 = 1.0 + mm[i][i] * tot_len1
                approx2 = stay2 < 0
                if approx2:
                    stay2 = 0.25
                if i1 == i:
                    prob = root_freqs[i] * stay1
                    for j in RANGE4:
                        if j == i:
                            tot3 = prob * stay2 * p2[j] / normalization
                            waiting_times[i] += tot_len1 * tot3
                            if rate_var:
                                wts[pos][i] += tot_len1 * tot3
                        else:
                            if approx2:
                                tot3 = prob * 0.25 * p2[j] / normalization
                            else:
                                tot3 = prob * mm[i][j] * tot_len1 * p2[j] \
                                    / normalization
                            waiting_times[i] += (tot_len1 / 2) * tot3
                            waiting_times[j] += (tot_len1 / 2) * tot3
                            counts[i][j] += tot3
                            if track and (not node_is_leaf) \
                                    and tot3 > min_mut_prob:
                                mutations_inf[node].append(
                                    (i1, pos + 1, j, tot3))
                            if rate_var:
                                wts[pos][i] += (tot_len1 / 2) * tot3
                                wts[pos][j] += (tot_len1 / 2) * tot3
                                cs[pos] += tot3
                else:
                    if approx1:
                        prob = root_freqs[i] * 0.25 * stay2 * p2[i] \
                            / normalization
                    else:
                        prob = root_freqs[i] * mm[i][i1] * e1[2] * stay2 \
                            * p2[i] / normalization
                    waiting_times[i] += tot_len1 * prob
                    if rate_var:
                        wts[pos][i] += tot_len1 * prob
        else:
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
            stay = 1.0 + mm[i1][i1] * tot_len1
            if stay < 0:
                normalization = 0.25
                approx = True
            else:
                approx = False
                for i in RANGE4:
                    if i1 == i:
                        normalization += stay * p2[i]
                    else:
                        normalization += mm[i1][i] * tot_len1 * p2[i]
            for i in RANGE4:
                if i1 == i:
                    if approx:
                        prob = p2[i]
                    else:
                        prob = (1.0 + mm[i][i] * tot_len1) * p2[i] \
                            / normalization
                    waiting_times[i] += tot_len1 * prob
                    if rate_var:
                        wts[pos][i] += tot_len1 * prob
                else:
                    if approx:
                        prob = p2[i]
                    else:
                        prob = mm[i1][i] * tot_len1 * p2[i] / normalization
                    waiting_times[i1] += (tot_len1 / 2) * prob
                    waiting_times[i] += (tot_len1 / 2) * prob
                    counts[i1][i] += prob
                    if track and (not node_is_leaf) and prob > min_mut_prob:
                        mutations_inf[node].append((i1, pos + 1, i, prob))
                    if rate_var:
                        wts[pos][i1] += (tot_len1 / 2) * prob
                        wts[pos][i] += (tot_len1 / 2) * prob
                        cs[pos] += prob
    return err_inc


def _em_nuc_nuc(e1, i1, i2, tot_len1, tot_len2, pos, node, node_is_leaf,
                has_minor, uer, site_err, error_rate, mm, root_freqs,
                ref_indices, counts, waiting_times, rate_var, wts, cs,
                track, mutations_inf, errors, error_count_sites,
                min_mut_prob):
    """Concrete upper vs concrete lower nucleotide (reference
    :10680-10806).  Returns the error-count increment."""
    err_inc = 0.0
    if i2 == i1:
        if not tot_len2:
            waiting_times[i1] += tot_len1
            if rate_var:
                wts[pos][i1] += tot_len1
                wts[pos][ref_indices[pos]] -= tot_len1
        return err_inc
    if node_is_leaf and uer and not has_minor:
        if len(e1) < 4 + uer:
            error_prob = error_rate * 0.33333
            mut_prob = mm[i1][i2] * tot_len1
            normalization = error_prob + mut_prob
            error_prob /= normalization
            mut_prob /= normalization
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
                wts[pos][i1] += tot_len1 * (mut_prob / 2)
                wts[pos][i2] += tot_len1 * (error_prob + mut_prob / 2)
                cs[pos] += mut_prob
            waiting_times[i1] += tot_len1 * (error_prob + mut_prob / 2)
            waiting_times[i2] += tot_len1 * mut_prob / 2
            counts[i1][i2] += mut_prob
            if track:
                if mut_prob > min_mut_prob:
                    mutations_inf[node].append((i1, pos + 1, i2, mut_prob))
                if error_prob > min_mut_prob:
                    errors[node].append((i1, pos + 1, i2, error_prob))
            err_inc += error_prob
            if error_count_sites is not None:
                error_count_sites[pos] += error_prob
        else:
            mutprob1 = root_freqs[i1] * mm[i1][i2] * tot_len1
            mutprob2 = root_freqs[i2] * mm[i2][i1] * e1[2]
            error_prob = root_freqs[i1] * error_rate * 0.33333
            normalization = mutprob1 + mutprob2 + error_prob
            mutprob1 /= normalization
            mutprob2 /= normalization
            error_prob /= normalization
            waiting_times[i1] += tot_len1 * (mutprob1 / 2 + error_prob)
            waiting_times[i2] += tot_len1 * (mutprob2 + mutprob1 / 2)
            counts[i1][i2] += mutprob1
            if track:
                if mutprob1 > min_mut_prob:
                    mutations_inf[node].append((i1, pos + 1, i2, mutprob1))
                if error_prob > min_mut_prob:
                    errors[node].append((i1, pos + 1, i2, error_prob))
            err_inc += error_prob
            if error_count_sites is not None:
                error_count_sites[pos] += error_prob
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
                wts[pos][i1] += tot_len1 * (mutprob1 / 2 + error_prob)
                wts[pos][i2] += tot_len1 * (mutprob2 + mutprob1 / 2)
                cs[pos] += mutprob1
    elif not tot_len2:
        if len(e1) < 4 + uer:
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
                wts[pos][i1] += tot_len1 / 2
                wts[pos][i2] += tot_len1 / 2
                cs[pos] += 1
            waiting_times[i1] += tot_len1 / 2
            waiting_times[i2] += tot_len1 / 2
            counts[i1][i2] += 1
            if track:
                mutations_inf[node].append((i1, pos + 1, i2, 1.0))
        else:
            no_mut1 = 1.0 + mm[i1][i1] * e1[2]
            if no_mut1 < 0:
                no_mut1 = 0.25
            no_mut2 = 1.0 + mm[i2][i2] * tot_len1
            if no_mut2 < 0:
                no_mut2 = 0.25
            prob1 = root_freqs[i1] * mm[i1][i2] * tot_len1 * no_mut1
            prob2 = root_freqs[i2] * mm[i2][i1] * e1[2] * no_mut2
            normalization = prob1 + prob2
            prob1 /= normalization
            prob2 /= normalization
            waiting_times[i1] += (tot_len1 / 2) * prob1
            waiting_times[i2] += (tot_len1 / 2) * prob1
            counts[i1][i2] += prob1
            if track and prob1 > min_mut_prob:
                mutations_inf[node].append((i1, pos + 1, i2, prob1))
            waiting_times[i2] += tot_len1 * prob2
            if rate_var:
                wts[pos][ref_indices[pos]] -= tot_len1
                wts[pos][i1] += (tot_len1 / 2) * prob1
                wts[pos][i2] += (tot_len1 / 2) * prob1
                wts[pos][i2] += tot_len1 * prob2
                cs[pos] += prob1
    return err_inc
