"""The exact host decision phase of device-batched placement.

Copied from :class:`maple_tpu.parallel.batch_placement.BatchedPlacer`
(``_diffs_in_frame`` and ``_place_one``), because that module imports jax.
Given a query's device screen scores over the anchor pool, the host scores
the nodes that changed since the screen, checks minor-sequence absorption
around the best candidates, runs the reference's float64 fine phase on the
top candidates and applies the placement serially (reference semantics:
MAPLEv0.7.5.4.py:8105-8293).  The device-scored legacy batch loop
(``place_batch``) and its pool are not ported yet.
"""
from __future__ import annotations

import time

import numpy as np

from maple_tpu.search.placement import place_sample_on_tree


class BatchedPlacer:
    """Host decision phase shared by the device placers.  Subclasses set
    ``rt``, ``stats`` and the ``time_fine``/``time_apply`` counters."""

    def _diffs_in_frame(self, diffs, node, memo):
        """Sample diffs translated from the global frame into ``node``'s
        MAT frame (composition of passGenomeListThroughBranch down the
        root->node mutation chain, reference :3749; memoized per distinct
        chain so polytomy-mates share the translation)."""
        tree = self.rt.tree
        chain = []
        n = node
        while n is not None:
            if tree.mutations[n]:
                chain.append(n)
            n = tree.up[n]
        if not chain:
            return diffs
        key = tuple(chain)
        v = memo.get(key)
        if v is None:
            v = diffs
            for n in reversed(chain):
                v = self.rt.pass_down(v, n)
            memo[key] = v
        return v

    def _place_one(self, root: int, sample_id, diffs, anchor_scores,
                   anchor_ids, recent_nodes=()) -> int:
        """Exact host decision for one query given device anchor scores."""
        rt = self.rt
        tree = rt.tree
        dc = rt.dc
        kern = rt.kern
        one_mut = dc.oneMutBLen
        t0 = time.time()
        memo = {}
        # base: appending at the root
        root_vect = rt.root_vector(tree.probVect[root], False, False, root)
        root_score = kern.append_prob_node(
            root_vect, self._diffs_in_frame(diffs, root, memo), True,
            one_mut)
        best_lk = root_score
        # host-score the nodes changed since the screen (absent from or
        # stale in the device pool) so chained placements stay sharp
        eff0 = dc.effectivelyNon0BLen
        recent_scored = []
        for n in recent_nodes:
            if tree.up[n] is None or tree.children[n] is None:
                continue
            if tree.dist[n] > eff0 and tree.probVectTotUp[n] is not None:
                sc = kern.append_prob_node(
                    tree.probVectTotUp[n],
                    self._diffs_in_frame(diffs, n, memo), True, one_mut)
                recent_scored.append((sc, n))
                best_lk = max(best_lk, sc)
        order = np.argsort(anchor_scores)[::-1]
        top = []
        if len(order):
            best_dev = float(anchor_scores[order[0]])
            best_lk = max(best_lk, best_dev)
        thresh = best_lk - dc.thresholdLogLKoptimization - 1.0
        for sc, n in sorted(recent_scored, reverse=True):
            if sc >= thresh:
                top.append(n)
        for j in order[:64]:
            if anchor_scores[j] < thresh:
                break
            top.append(anchor_ids[j])

        # minor-sequence absorption around the best candidates
        leaf_checks = []
        for node in top[:4]:
            if not tree.children[node]:
                leaf_checks.append(node)
            else:
                for c in tree.children[node]:
                    if not tree.children[c]:
                        leaf_checks.append(c)
            if tree.up[node] is not None:
                sib = tree.children[tree.up[node]][
                    1 - tree.child_index(node)]
                if not tree.children[sib]:
                    leaf_checks.append(sib)
        for leaf in leaf_checks:
            v = tree.probVect[leaf]
            if v is None:
                continue
            q_at = self._diffs_in_frame(diffs, leaf, memo)
            comparison = kern.is_minor_sequence(v, q_at)
            if comparison == 1:
                tree.minorSequences[leaf].append(sample_id)
                self.stats.num_minors_found += 1
                self.time_fine += time.time() - t0
                return root

        # exact fine phase on the top candidates (host float64; reference
        # :8105-8293 semantics)
        best_node = root
        best_score = root_score
        best_blens = (False, False, one_mut)
        best_diffs = self._diffs_in_frame(diffs, root, memo)
        for node in top:
            if tree.probVectTotUp[node] is None or tree.up[node] is None \
                    or tree.children[node] is None:
                continue  # restructured by an earlier placement in the batch
            diffs_at = self._diffs_in_frame(diffs, node, memo)
            up_vect = tree.vect_up_for(node)
            if tree.mutations[node]:
                up_vect = rt.pass_down(up_vect, node)
            is_tip = tree.is_tip(node)
            best_appending = kern.estimate_branch_length(
                tree.probVectTotUp[node], diffs_at, from_tip_c=True)
            mid_lower = kern.merge_vectors(
                tree.probVect[node], tree.dist[node] / 2, is_tip,
                diffs_at, best_appending, True)
            best_top = kern.estimate_branch_length(up_vect, mid_lower)
            mid_top = kern.merge_vectors(
                up_vect, best_top, False, diffs_at, best_appending, True,
                is_up_down=True)
            best_bottom = kern.estimate_branch_length(
                mid_top, tree.probVect[node], from_tip_c=is_tip)
            new_mid = kern.merge_vectors(
                up_vect, best_top, False, tree.probVect[node],
                best_bottom, is_tip, is_up_down=True)
            appending_cost = kern.append_prob_node(new_mid, diffs_at, True,
                                                   best_appending)
            initial_cost = kern.append_prob_node(
                up_vect, tree.probVect[node], is_tip, tree.dist[node])
            new_partial_cost = kern.append_prob_node(
                up_vect, tree.probVect[node], is_tip,
                best_bottom + best_top)
            optimized = appending_cost + new_partial_cost - initial_cost
            if optimized >= best_score:
                best_score = optimized
                best_node = node
                best_blens = (best_top, best_bottom, best_appending)
                best_diffs = diffs_at
        self.time_fine += time.time() - t0

        t0 = time.time()
        new_root = place_sample_on_tree(
            rt, best_node, best_diffs, sample_id, best_score, best_blens[0],
            best_blens[1], best_blens[2], rt.model.pseudo_counts, self.stats)
        self.time_apply += time.time() - t0
        return new_root if new_root is not None else root
