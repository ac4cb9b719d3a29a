"""Per-sample posterior sequencing-error probabilities.

For every tip (skipping tips with collapsed minor sequences, which carry
no per-site signal), compare the parent's upper genome list against the
tip's observed list and, at every observed difference, compute the
posterior probability that the difference is a sequencing error rather
than a real mutation; writes ``<out>_estimatedErrors.txt`` (reference
calculateErrorProbabilities :9783-10020, driver :12521-12527).
"""
from __future__ import annotations

from ..core.genomelist import TYPE_N, TYPE_O, TYPE_R

ALLELES = "ACGT"
RANGE4 = (0, 1, 2, 3)


def calculate_error_probabilities(rt, root: int, fh, min_error_prob: float,
                                  names_in_tree):
    tree = rt.tree
    model = rt.model
    lRef = rt.refd.lRef
    root_freqs = rt.refd.root_freqs
    up = tree.up
    children = tree.children
    minor = tree.minorSequences
    dist = tree.dist
    uer = model.using_error_rate
    uer1 = 1 if uer else 0
    site_err = model.error_rate_site_specific
    rate_var = model.use_rate_variation

    node = root
    last_node = None
    direction = 0
    while node is not None:
        if direction == 0:
            if not children[node]:
                fh.write(">" + names_in_tree[tree.name[node]] + "\n")
                if minor[node]:
                    for id_node in minor[node]:
                        fh.write(">" + names_in_tree[id_node] + "\n")
                else:
                    vP = tree.vect_up_for(node)
                    if tree.mutations[node]:
                        vP = rt.pass_down(vP, node)
                    vP = rt.kern.export(vP)
                    vC = rt.kern.export(tree.probVect[node])
                    _error_lines_for_tip(
                        fh, vP, vC, dist[node], lRef, model, root_freqs,
                        uer1, site_err, rate_var, min_error_prob)
            if children[node]:
                node = children[node][0]
            else:
                last_node = node
                node = up[node]
                direction = 1
        else:
            if last_node == children[node][0]:
                node = children[node][1]
                direction = 0
            else:
                last_node = node
                node = up[node]
                direction = 1


def _error_lines_for_tip(fh, vP, vC, node_dist, lRef, model, root_freqs,
                         uer1, site_err, rate_var, min_error_prob):
    mut_matrix = model.mut_matrix
    mut_matrices = model.mut_matrices
    error_rates = model.error_rates
    error_rate_g = model.error_rate
    i1x = i2x = pos = 0
    e1 = vP[0]
    e2 = vC[0]
    while True:
        c1, c2 = e1[0], e2[0]
        if c2 == TYPE_N:
            if c1 in (TYPE_R, TYPE_N):
                pos = min(e1[1], e2[1])
            else:
                pos += 1
        elif c1 == TYPE_N:
            if c2 == TYPE_R:
                pos = min(e1[1], e2[1])
            else:
                pos += 1
        else:
            tot_len1 = node_dist
            if c1 < TYPE_N:
                if len(e1) == 3 + uer1:
                    tot_len1 += e1[2]
                elif len(e1) == 4 + uer1:
                    tot_len1 += e1[3]
            else:
                if len(e1) > 3:
                    tot_len1 += e1[2]

            if c1 == TYPE_R:
                if c2 == TYPE_R:
                    pos = min(e1[1], e2[1])
                elif c2 == TYPE_O:
                    i1 = e2[1]
                    if e2[-1][i1] < 0.1:
                        mm = mut_matrices[pos] if rate_var else mut_matrix
                        eps = error_rates[pos] if site_err else error_rate_g
                        num_alt = sum(1 for i in RANGE4 if e2[-1][i] > 0.1)
                        if len(e1) == 4 + uer1:
                            err = root_freqs[i1] \
                                * (1.0 + mm[i1][i1] * (tot_len1 + e1[2])) \
                                * eps * 0.33333 * num_alt
                            mut_p = 0.0
                            i1_root = root_freqs[i1] \
                                * (1.0 + mm[i1][i1] * e1[2])
                            for i in RANGE4:
                                if e2[-1][i] > 0.1:
                                    mut_p += i1_root * mm[i1][i] * tot_len1
                                    mut_p += root_freqs[i] \
                                        * (1.0 + mm[i][i] * tot_len1) \
                                        * mm[i][i1] * e1[2]
                            err = err / (err + mut_p)
                        else:
                            err = (1.0 + mm[i1][i1] * tot_len1) * eps \
                                * 0.33333 * num_alt
                            mut_p = 0.0
                            for i in RANGE4:
                                if e2[-1][i] > 0.1:
                                    mut_p += mm[i1][i] * tot_len1
                            err = err / (err + mut_p)
                        if err >= min_error_prob:
                            fh.write(f"{pos + 1}\tX\t{err}\n")
                    pos += 1
                else:
                    i1 = e2[1]
                    i2 = e2[0]
                    mm = mut_matrices[pos] if rate_var else mut_matrix
                    eps = error_rates[pos] if site_err else error_rate_g
                    if len(e1) < 4 + uer1:
                        err = eps * 0.33333
                        mut_p = mm[i1][i2] * tot_len1
                        err = err / (err + mut_p)
                    else:
                        mut1 = root_freqs[i1] * mm[i1][i2] * tot_len1
                        mut2 = root_freqs[i2] * mm[i2][i1] * e1[2]
                        err = root_freqs[i1] * eps * 0.33333
                        err = err / (mut1 + mut2 + err)
                    if err >= min_error_prob:
                        fh.write(f"{pos + 1}\t{ALLELES[i2]}\t{err}\n")
                    pos += 1
            elif c1 == TYPE_O:
                mm = mut_matrices[pos] if rate_var else mut_matrix
                if c2 == TYPE_O:
                    eps = error_rates[pos] if site_err else error_rate_g
                    no_mut = 0.0
                    mut_p = 0.0
                    err = 0.0
                    for j in RANGE4:
                        if e2[-1][j] > 0.1:
                            no_mut += e1[-1][j]
                            err += (1.0 - e1[-1][j]) * eps * 0.33333
                            for i in RANGE4:
                                if j != i:
                                    mut_p += e1[-1][i] * mm[i][j] * tot_len1
                    err = err / (err + no_mut + mut_p)
                    if err >= min_error_prob:
                        fh.write(f"{pos + 1}\tX\t{err}\n")
                else:
                    i2 = e1[1] if c2 == TYPE_R else c2
                    eps = error_rates[pos] if site_err else error_rate_g
                    err = (1.0 - e1[-1][i2]) * eps * 0.33333
                    no_mut = e1[-1][i2]
                    mut_p = 0.0
                    for i in RANGE4:
                        if i != i2:
                            mut_p += e1[-1][i] * mm[i][i2] * tot_len1
                    err = err / (err + no_mut + mut_p)
                    if err >= min_error_prob:
                        fh.write(f"{pos + 1}\t{ALLELES[i2]}\t{err}\n")
                pos += 1
            else:
                i1 = c1
                if c2 != i1:
                    mm = mut_matrices[pos] if rate_var else mut_matrix
                    if c2 == TYPE_O:
                        if e2[-1][i1] < 0.1:
                            eps = error_rates[pos] if site_err \
                                else error_rate_g
                            num_alt = sum(1 for i in RANGE4
                                          if e2[-1][i] > 0.1)
                            if len(e1) == 4 + uer1:
                                err = root_freqs[i1] \
                                    * (1.0 + mm[i1][i1]
                                       * (tot_len1 + e1[2])) \
                                    * eps * 0.33333 * num_alt
                                mut_p = 0.0
                                i1_root = root_freqs[i1] \
                                    * (1.0 + mm[i1][i1] * e1[2])
                                for i in RANGE4:
                                    if e2[-1][i] > 0.1:
                                        mut_p += i1_root * mm[i1][i] \
                                            * tot_len1
                                        mut_p += root_freqs[i] \
                                            * (1.0 + mm[i][i] * tot_len1) \
                                            * mm[i][i1] * e1[2]
                                err = err / (err + mut_p)
                            else:
                                err = (1.0 + mm[i1][i1] * tot_len1) * eps \
                                    * 0.33333 * num_alt
                                mut_p = 0.0
                                for i in RANGE4:
                                    if e2[-1][i] > 0.1:
                                        mut_p += mm[i1][i] * tot_len1
                                err = err / (err + mut_p)
                            if err >= min_error_prob:
                                fh.write(f"{pos + 1}\tX\t{err}\n")
                    else:
                        i2 = e1[1] if c2 == TYPE_R else c2
                        eps = error_rates[pos] if site_err else error_rate_g
                        if len(e1) < 4 + uer1:
                            err = eps * 0.33333
                            mut_p = mm[i1][i2] * tot_len1
                            err = err / (err + mut_p)
                        else:
                            mut1 = root_freqs[i1] * mm[i1][i2] * tot_len1
                            mut2 = root_freqs[i2] * mm[i2][i1] * e1[2]
                            err = root_freqs[i1] * eps * 0.33333
                            err = err / (mut1 + mut2 + err)
                        if err >= min_error_prob:
                            fh.write(f"{pos + 1}\t{ALLELES[i2]}\t{err}\n")
                pos += 1

        if pos == lRef:
            break
        if e1[0] < TYPE_R or e1[0] == TYPE_O:
            i1x += 1
            e1 = vP[i1x]
        elif pos == e1[1]:
            i1x += 1
            e1 = vP[i1x]
        if e2[0] < TYPE_R or e2[0] == TYPE_O:
            i2x += 1
            e2 = vC[i2x]
        elif pos == e2[1]:
            i2x += 1
            e2 = vC[i2x]
