"""Incremental tree-state runtime.

Keeps the four cached genome lists per node consistent under edits via
dirty-flag message passing (reference updatePartials :5479-5817), full
recomputation with first-time setup, minor-sequence collapsing and MAT
initialization (reference reCalculateAllGenomeLists :6013-6347), local
MAT references (setUpMAT :4148-4391, makeNodeReference :8296-8353,
mergeMutationLists :2187-2233), and full-tree likelihood
(calculateTreeLikelihood :9721-9779).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

from ..config import DerivedConfig, MapleConfig
from ..core import genomelist as gl
from ..core import kernels as K
from ..core.genomelist import TYPE_N, TYPE_O, TYPE_R
from ..refdata import Model, RefData
from .phases import PHASES, Tracer
from .tree import PhyloTree


class TreeRuntime:
    """Binds a tree to its model/reference context and provides all
    incremental-update operations.  ``self.kctx`` is refreshed whenever the
    model version changes (rate/error-table updates)."""

    def __init__(self, tree: PhyloTree, refd: RefData, model: Model,
                 dc: DerivedConfig, cfg: MapleConfig,
                 backend: str = None, tracer: Tracer = None):
        self.tree = tree
        self.refd = refd
        self.model = model
        self.dc = dc
        self.cfg = cfg
        self.kctx = K.KernelCtx(refd, model, dc)
        from ..core.backend import make_backend
        self.kern = make_backend(
            self, backend or getattr(cfg, "kernel_backend", "python"))
        self.use_local_reference = not cfg.noLocalRef
        self.time = None           # TimeCtx when --datesFile is active
        self.num_refs = 0          # MAT local references created
        self.num_minors_removed = 0
        # Native error-model support: authoritative tuple-form tip vectors
        # (preserving the reference's shared-ambiguity-list aliasing,
        # :3959) with native mirror handles in tree.probVect; see
        # refresh_terminal_errors.  Populated by
        # convert_backend(keep_tip_tuples=True) / adopt_new_tip.
        # alias_tags maps id(list) -> native alias tag for every tip
        # probability list; tagged entries in the C++ store are patched
        # in place when a refresh mutates the list.
        self.tip_tuples = {}
        self.alias_tags = {}
        # keeps every tagged list alive: alias_tags keys by id(), so a
        # collected list's id must never be reused by a new list
        self._tag_lists = []
        self.num_nodes_stats = [0, 0, 0, 0, 0, 0]  # nodes, nucs, Rs, Ns, Os, MATmuts
        # the run's phase tracer (runtime/phases.py); phase_times is a
        # live view of its inclusive seconds by pipeline phase (tree_lk /
        # recalculate / em / blen / root_search)
        self.tracer = tracer if tracer is not None else Tracer()
        self.phase_times = self.tracer.totals(PHASES)
        # Monotone counter bumped by every vector/topology mutation path
        # (update_partials, update_blen, backend conversion, engine-phase
        # exports/sessions, re-rooting).  recalculate_all records
        # (epoch, model.version, root) on completion and becomes a no-op
        # while that key is unchanged — a full recompute of unchanged
        # inputs reproduces the same vectors bit-for-bit, so skipping is
        # semantics-preserving (disable with MAPLE_NO_RECALC_SKIP=1).
        self.mutation_epoch = 0
        self._recalc_clean_key = None
        # Live persistent engine session (native/engine.py NativeSession);
        # when set, the native phase helpers run against the resident
        # engine state instead of round-tripping the tree per call.
        self.native_session = None
        # When a set is installed here, update_partials records every node
        # it processes; the device-batched placer uses this to detect pool
        # anchors whose cached vectors went stale mid-batch (the
        # search-parallel/apply-serial staleness contract, reference
        # applySPRMovesParallel :9470-9484).
        self.touch_log = None

    # ------------------------------------------------------------------
    def ctx(self) -> K.KernelCtx:
        if self.kctx.model_version != self.model.version:
            self.kctx = K.KernelCtx(self.refd, self.model, self.dc)
        return self.kctx

    def shorten(self, vec):
        self.kern.shorten(vec)

    def convert_backend(self, backend: str, keep_tip_tuples: bool = False):
        """Switch kernel backend, converting every tree vector in place.

        With ``keep_tip_tuples`` (python -> native under the error model),
        tips also keep their tuple-form vectors as the authoritative copy:
        the reference aliases one mutable probability list per ambiguity
        code across tips (:3959), and error-model refreshes must keep
        propagating through that aliasing even though the kernel operands
        are native mirrors (see refresh_terminal_errors)."""
        from ..core.backend import make_backend
        self.mark_mutated()
        old = self.kern
        new = make_backend(self, backend)
        if old.name == new.name:
            return
        tree = self.tree
        old_tip_tuples = self.tip_tuples
        self.tip_tuples = {}
        self.alias_tags = {}
        self._tag_lists = []
        if keep_tip_tuples and new.name == "native":
            for node in range(len(tree.up)):
                if tree.children[node]:
                    continue
                v = tree.probVect[node]
                if isinstance(v, list):
                    self.tip_tuples[node] = v
            # assign an alias tag to every tip probability list BEFORE
            # importing, so internal vectors whose entries reference a tip
            # list (passthrough merge products) get tagged too
            self.kern = new  # import_tuples below reads self.alias_tags
            for vec in self.tip_tuples.values():
                for e in vec:
                    if e[0] == TYPE_O and isinstance(e[-1], list):
                        if id(e[-1]) not in self.alias_tags:
                            self.alias_tags[id(e[-1])] = len(self.alias_tags)
                            self._tag_lists.append(e[-1])
        for arr in (tree.probVect, tree.probVectUpRight,
                    tree.probVectUpLeft, tree.probVectTotUp):
            for i, v in enumerate(arr):
                if v is not None:
                    arr[i] = new.import_tuples(old.export(v))
        if old_tip_tuples and new.name == "python":
            # native -> python with tracked tips: restore the authoritative
            # tuple vectors (mirror exports would break list aliasing)
            for node, tup in old_tip_tuples.items():
                if tree.probVect[node] is not None:
                    tree.probVect[node] = tup
        self.kern = new

    def pass_down(self, vec, node):
        """Translate a genome list down through node's MAT branch."""
        muts = self.tree.mutations[node]
        if muts:
            return self.kern.pass_through_branch(vec, muts)
        return vec

    def pass_up(self, vec, node):
        muts = self.tree.mutations[node]
        if muts:
            return self.kern.pass_through_branch(vec, muts, dir_is_up=True)
        return vec

    def global_frame_up(self, vec, node):
        """Translate ``vec`` from ``node``'s MAT frame to the global
        frame in ONE pass through the composed root->frame mutation
        list (memoized per frame, invalidated by mutation_epoch) —
        chains average 10-13 muts-bearing branches at 10k-50k, so this
        replaces O(depth) list transforms with O(1) (the native twin is
        E_frame_comp in maple_native.cpp)."""
        tree = self.tree
        f = node
        while f is not None and not tree.mutations[f]:
            f = tree.up[f]
        if f is None:
            return vec
        if getattr(self, "_frame_comp_epoch", None) != \
                self.mutation_epoch:
            self._frame_comp_epoch = self.mutation_epoch
            self._frame_comp = {}
        memo = self._frame_comp
        comp = memo.get(f)
        if comp is None:
            stack = []
            g = f
            while g is not None and g not in memo:
                if tree.mutations[g]:
                    stack.append(g)
                g = tree.up[g]
            comp = memo.get(g, [])
            for h in reversed(stack):
                # plain downward path composition (downward=False;
                # parent comp applied first, then h's branch list)
                comp = self.merge_mutation_lists(comp, tree.mutations[h]) \
                    if comp else tree.mutations[h]
                memo[h] = comp
        return self.kern.pass_through_branch(vec, comp, dir_is_up=True)

    @property
    def do_time_tree(self) -> bool:
        return self.time is not None

    def _vect_up_time(self, node):
        tree = self.tree
        parent = tree.up[node]
        return tree.probVectUpRightTime[parent] \
            if node == tree.children[parent][0] \
            else tree.probVectUpLeftTime[parent]

    def _tot_up_time(self, node, vect_up_up_time):
        """Recompute probVectTotUpTime[node] = (vector, LK-correction);
        resolves time inconsistencies by extending ancestors (reference
        updatePartials :5531-5554).  Returns the possibly-refreshed
        parent-side time vector."""
        from ..models import timetree as tt
        tree = self.tree
        T = self.time
        d = tree.dist[node]
        new_vect, prob = tt.merge_vectors_time(
            T, vect_up_up_time, d / 2, tree.probVectTime[node], d / 2,
            is_up_down=True, return_lk=True)
        if isinstance(new_vect, int):
            tt.resolve_time_inconsistency(T, tree, node, new_vect)
            vect_up_up_time = self._vect_up_time(node)
            new_vect, prob = tt.merge_vectors_time(
                T, vect_up_up_time, d / 2, tree.probVectTime[node], d / 2,
                is_up_down=True, return_lk=True)
        prob -= tt.append_prob_node_time(T, vect_up_up_time,
                                         tree.probVectTime[node], d)
        tree.probVectTotUpTime[node] = (new_vect, prob)
        return vect_up_up_time

    def _merge_up_time(self, node, vect_up_up_time, child_vect_time,
                       child_dist):
        """Upper-time merge with inconsistency resolution (reference
        updatePartials :5619-5635)."""
        from ..models import timetree as tt
        tree = self.tree
        T = self.time
        new_vect = tt.merge_vectors_time(
            T, vect_up_up_time, tree.dist[node], child_vect_time,
            child_dist, is_up_down=True)
        if isinstance(new_vect, int):
            tt.resolve_time_inconsistency(T, tree, node, new_vect)
            vect_up_up_time = self._vect_up_time(node)
            new_vect = tt.merge_vectors_time(
                T, vect_up_up_time, tree.dist[node], child_vect_time,
                child_dist, is_up_down=True)
        return new_vect, vect_up_up_time

    # ------------------------------------------------------------------
    def terminal_vector(self, diffs, node: Optional[int] = None):
        """Tip genome list from MAPLE diffs, translated into the node's MAT
        frame and shortened (reference probVectTerminalNode :3882-3962)."""
        n_minor = 0 if node is None else len(self.tree.minorSequences[node])
        vec = self.kern.terminal_vector(diffs, num_minor_seqs=n_minor)
        if node is not None:
            # walk root -> node applying each MAT branch's mutations downward
            chain = []
            n = node
            while n is not None:
                chain.append(n)
                n = self.tree.up[n]
            for n in reversed(chain):
                vec = self.pass_down(vec, n)
            self.shorten(vec)
        return vec

    def refresh_terminal_errors(self, node: int):
        """Refresh O entries of a tip's genome list after error-rate changes
        and store it back (reference updateProbVectTerminalNode
        :3968-4006).

        On the native backend with tracked tip tuples, the refresh mutates
        the tuple form (whose O lists may be shared across tips, reference
        :3959 — last write wins), re-imports this tip's mirror, and patches
        the shared values into every other aliased tip's native mirror so
        mid-recompute reads see exactly what the reference's aliasing
        produces."""
        self.mark_mutated()
        v = self.tree.probVect[node]
        if v is None:
            return
        tup = self.tip_tuples.get(node)
        if tup is not None and self.kern.name == "native":
            touched = []
            seen_ids = set()
            for e in tup:
                if e[0] == TYPE_O and isinstance(e[-1], list) \
                        and id(e[-1]) not in seen_ids:
                    seen_ids.add(id(e[-1]))
                    touched.append((e[-1], tuple(e[-1])))
            self.update_terminal_vector_errors(
                tup, len(self.tree.minorSequences[node]))
            for lst, before in touched:
                if tuple(lst) == before:
                    continue
                tag = self.alias_tags.get(id(lst))
                if tag is not None:
                    # every native entry mirroring this list (this tip's
                    # own vector AND any cached vector that the Python
                    # kernels would have left referencing it) is patched
                    self.kern.store.patch_tag(tag, lst)
                else:  # untagged list (unexpected): rebuild the mirror
                    self.tree.probVect[node] = self.kern.import_tuples(tup)
            return
        tuples = self.kern.export(v)
        self.update_terminal_vector_errors(
            tuples, len(self.tree.minorSequences[node]))
        self.tree.probVect[node] = self.kern.import_tuples(tuples)

    def collect_error_patches(self, root: int):
        """Pre-compute the error-refresh patch schedule for an engine-side
        full recompute (native/maple_native.cpp engine_recalculate_err).

        The per-tip refresh values depend only on the error rates and each
        O entry's position — not on tree state — so the whole pass-1
        refresh sequence (reference :3968-4006, invoked per tip during
        reCalculateAllGenomeLists) can be replayed inside the engine at
        each tip's exact post-order position.  Shared lists may be written
        by several tips with DIFFERENT values (num_minor_seqs changes the
        written probabilities; last write wins mid-pass), so every
        changing write is recorded in order.  Host tuple state is mutated
        exactly as the python driver would.

        Returns a list of (node, tag, [4 probs]) in pass-1 post-order, or
        None when some tip lacks tuple authority or a touched list is
        untagged (caller stays on the python path).  The dry scan runs
        first so a None return leaves host state untouched."""
        tree = self.tree
        children = tree.children
        up = tree.up

        def leaves_postorder():
            node, last, direction = root, None, 0
            while node is not None:
                if direction == 0:
                    if children[node]:
                        node = children[node][0]
                        continue
                    yield node
                    last = node
                    node = up[node]
                    direction = 1
                elif last == children[node][0]:
                    node = children[node][1]
                    direction = 0
                else:
                    last = node
                    node = up[node]
                    direction = 1

        # dry scan: no mutation until every tip is known translatable
        for node in leaves_postorder():
            if tree.probVect[node] is None:
                continue
            tup = self.tip_tuples.get(node)
            if tup is None:
                return None
            for e in tup:
                if e[0] == TYPE_O and isinstance(e[-1], list) \
                        and self.alias_tags.get(id(e[-1])) is None:
                    return None
        patches = []
        for node in leaves_postorder():
            if tree.probVect[node] is None:
                continue
            tup = self.tip_tuples[node]
            touched = []
            seen_ids = set()
            for e in tup:
                if e[0] == TYPE_O and isinstance(e[-1], list) \
                        and id(e[-1]) not in seen_ids:
                    seen_ids.add(id(e[-1]))
                    touched.append((e[-1], tuple(e[-1])))
            self.update_terminal_vector_errors(
                tup, len(tree.minorSequences[node]))
            for lst, before in touched:
                if tuple(lst) == before:
                    continue
                patches.append((node, self.alias_tags[id(lst)], list(lst)))
        return patches

    def adopt_tip_pending(self, handle):
        """Tag a new tip vector before it (and vectors derived from it)
        enter the tree — used when the native backend places samples with
        the error model active.  Returns a tagged re-import of the handle
        plus the tuple form to register with adopt_pending_as once the
        tip's node id exists; (handle, None) when there is nothing to
        track (no ambiguity entries)."""
        if self.kern.name != "native" or not self.model.using_error_rate \
                or self.cfg.onlyNambiguities:
            return handle, None
        tup = self.kern.export(handle)
        has_o = False
        for e in tup:
            if e[0] == TYPE_O and isinstance(e[-1], list):
                has_o = True
                if id(e[-1]) not in self.alias_tags:
                    self.alias_tags[id(e[-1])] = len(self.alias_tags)
                    self._tag_lists.append(e[-1])
        if not has_o:
            return handle, None
        return self.kern.import_tuples(tup), tup

    def adopt_pending_as(self, tup, node: int):
        if tup is not None:
            self.tip_tuples[node] = tup

    def update_terminal_vector_errors(self, prob_vect, num_minor_seqs):
        """Refresh O entries of a tip list (tuple form) in place."""
        model = self.model
        if prob_vect is None:
            return
        pos = 0
        for m in prob_vect:
            if m[0] == TYPE_O:
                probs = m[-1]
                n_set = sum(1 for p in probs if p > 0.2)
                eps = (model.error_rates[pos] if model.error_rate_site_specific
                       else model.error_rate)
                if n_set == 2:
                    for i in range(4):
                        if probs[i] < 0.2:
                            probs[i] = 0.0 if num_minor_seqs else eps * 0.33333
                        else:
                            probs[i] = 0.5 if num_minor_seqs \
                                else 0.5 - eps * 0.33333
                elif n_set == 3:
                    for i in range(4):
                        if probs[i] < 0.2:
                            probs[i] = 0.0 if num_minor_seqs else eps * 0.33333
                        else:
                            probs[i] = (1.0 / 3) if num_minor_seqs \
                                else (1.0 / 3) - eps / 9
                pos += 1
            elif m[0] < 4:
                pos += 1
            else:
                pos = m[1]

    # ------------------------------------------------------------------
    def root_vector(self, prob_vect, blen, is_from_tip, node):
        """Upper list at the root from a lower list at ``node``: translate up
        through the MAT to the root frame, apply root frequencies, translate
        back down (reference rootVector :4916-4996)."""
        tree = self.tree
        chain = []
        n = node
        vec = prob_vect
        while n is not None:
            chain.append(n)
            vec = self.pass_up(vec, n)
            n = tree.up[n]
        vec = self.kern.root_vector_frame(vec, blen, is_from_tip)
        for n in reversed(chain):
            vec = self.pass_down(vec, n)
        self.shorten(vec)
        return vec

    def find_prob_root(self, prob_vect, node: Optional[int] = None):
        """Root-state log-probability; the list is first re-expressed in the
        global reference frame (reference findProbRoot :4865-4912)."""
        vec = prob_vect
        n = node
        while n is not None:
            vec = self.pass_up(vec, n)
            n = self.tree.up[n]
        return self.kern.find_prob_root_frame(vec)

    # ------------------------------------------------------------------
    def mark_mutated(self):
        """Record that tree vectors/topology changed since the last full
        recompute (see mutation_epoch in __init__)."""
        self.mutation_epoch += 1

    def update_blen(self, c_node: int, add_to_list: bool = False,
                    node_list=None):
        """Re-optimize the branch above c_node to repair an impossible merge
        and re-dirty the neighborhood (reference updateBLen :5385-5414)."""
        self.mark_mutated()
        tree = self.tree
        node = tree.up[c_node]
        c_num = tree.child_index(c_node)
        vect_up = tree.probVectUpRight[node] if c_num == 0 \
            else tree.probVectUpLeft[node]
        vect_up = self.pass_down(vect_up, c_node)
        best = self.kern.estimate_branch_length(
            vect_up, tree.probVect[c_node],
            from_tip_c=tree.is_tip(c_node))
        if tree.use_hnz:
            self.update_ndesc0_changing_dist(c_node, best)
        tree.dist[c_node] = best
        tree.dirty[node] = True
        tree.dirty[c_node] = True
        if add_to_list:
            node_list.append((c_node, 2, True, self.do_time_tree))
            node_list.append((node, c_num, True, self.do_time_tree))

    def update_ndesc0_changing_dist(self, node: int, new_dist):
        """HnZ bookkeeping when a branch length crosses the effectively-zero
        threshold (reference updateNDesc0whenChangingDist :5361-5380)."""
        tree = self.tree
        eff0 = self.dc.effectivelyNon0BLen
        if tree.dist[node] > eff0 and new_dist <= eff0:
            addendum = tree.nDesc0[node] - 1
        elif tree.dist[node] <= eff0 and new_dist > eff0:
            addendum = 1 - tree.nDesc0[node]
        else:
            return
        parent = tree.up[node]
        tree.nDesc0[parent] += addendum
        while tree.up[parent] is not None and tree.dist[parent] <= eff0:
            parent = tree.up[parent]
            tree.nDesc0[parent] += addendum

    # ------------------------------------------------------------------
    def update_partials(self, node_list: List[tuple]):
        """Dirty-propagation work-list engine.  Each item is
        (node, direction, lk_dirty, time_dirty) with direction 0/1 = from
        that child, 2 = from parent (reference updatePartials :5479-5817;
        time-vector propagation :5531-5554, :5602-5641, :5745-5800)."""
        self.mark_mutated()
        tree = self.tree
        kern = self.kern
        dist = tree.dist
        children = tree.children
        up = tree.up
        probVect = tree.probVect
        probVectUpRight = tree.probVectUpRight
        probVectUpLeft = tree.probVectUpLeft
        probVectTotUp = tree.probVectTotUp
        dtt = self.do_time_tree
        if dtt:
            from ..models import timetree as tt
            T = self.time
            probVectTime = tree.probVectTime
            probVectUpRightTime = tree.probVectUpRightTime
            probVectUpLeftTime = tree.probVectUpLeftTime
        while node_list:
            updated_blen = False
            made_change = False
            node, direction, lk_dirty, time_dirty = node_list.pop()
            tree.dirty[node] = True
            if self.touch_log is not None:
                self.touch_log.add(node)
            vect_up_up = None
            vect_up_up_time = None
            child_num_up = None
            if up[node] is not None:
                child_num_up = tree.child_index(node)
                vect_up_up = probVectUpRight[up[node]] if child_num_up == 0 \
                    else probVectUpLeft[up[node]]
                if dtt:
                    vect_up_up_time = probVectUpRightTime[up[node]] \
                        if child_num_up == 0 else probVectUpLeftTime[up[node]]
                if tree.mutations[node] and lk_dirty:
                    vect_up_up = self.pass_down(vect_up_up, node)
            is_tip = tree.is_tip(node)
            if direction == 2:
                # change coming from the parent
                if dist[node] or dtt:
                    if lk_dirty:
                        new_tot = kern.merge_vectors( vect_up_up, dist[node] / 2, False,
                            probVect[node], dist[node] / 2, is_tip,
                            is_up_down=True)
                        if new_tot is None:
                            self.update_blen(node)
                            node_list.append((up[node], child_num_up, True,
                                              dtt))
                            new_tot = kern.merge_vectors( vect_up_up, dist[node] / 2, False,
                                probVect[node], dist[node] / 2, is_tip,
                                is_up_down=True)
                            made_change = True
                            if dtt:
                                vect_up_up_time = self._tot_up_time(
                                    node, vect_up_up_time)
                        probVectTotUp[node] = new_tot
                        self.shorten(probVectTotUp[node])
                    if dtt and time_dirty:
                        vect_up_up_time = self._tot_up_time(
                            node, vect_up_up_time)
                else:
                    probVectTotUp[node] = None

                if children[node]:
                    c0, c1 = children[node]
                    dist0, dist1 = dist[c0], dist[c1]
                    new_up_right = new_up_left = None
                    if lk_dirty:
                        child0_vect = self.pass_up(probVect[c0], c0)
                        child1_vect = self.pass_up(probVect[c1], c1)
                        is_tip0 = tree.is_tip(c0)
                        is_tip1 = tree.is_tip(c1)
                        new_up_right = kern.merge_vectors( vect_up_up, dist[node], False, child1_vect,
                            dist1, is_tip1, is_up_down=True)
                        if new_up_right is None:
                            if (not dist[node]) and (not dist1):
                                self.update_blen(node)
                                if not dist[node]:
                                    self.update_blen(c1, add_to_list=True,
                                                     node_list=node_list)
                                    updated_blen = True
                                else:
                                    probVectTotUp[node] = kern.merge_vectors( vect_up_up, dist[node] / 2,
                                        False, probVect[node], dist[node] / 2,
                                        is_tip, is_up_down=True)
                                    new_up_right = kern.merge_vectors( vect_up_up, dist[node], False,
                                        child1_vect, dist1, is_tip1,
                                        is_up_down=True)
                                    node_list.append((up[node], child_num_up,
                                                      True, dtt))
                                    made_change = True
                            else:
                                raise RuntimeError(
                                    "impossible merge with non-zero distances "
                                    "in update_partials (from parent)")
                        if not updated_blen:
                            new_up_left = kern.merge_vectors( vect_up_up, dist[node], False,
                                child0_vect, dist0, is_tip0, is_up_down=True)
                            if new_up_left is None:
                                if (not dist[node]) and (not dist0):
                                    self.update_blen(node)
                                    if not dist[node]:
                                        self.update_blen(c0, add_to_list=True,
                                                         node_list=node_list)
                                        updated_blen = True
                                    else:
                                        probVectTotUp[node] = kern.merge_vectors( vect_up_up, dist[node] / 2,
                                            False, probVect[node],
                                            dist[node] / 2, is_tip,
                                            is_up_down=True)
                                        new_up_right = kern.merge_vectors( vect_up_up, dist[node],
                                            False, child1_vect, dist1,
                                            is_tip1, is_up_down=True)
                                        new_up_left = kern.merge_vectors( vect_up_up, dist[node],
                                            False, child0_vect, dist0,
                                            is_tip0, is_up_down=True)
                                        node_list.append(
                                            (up[node], child_num_up, True,
                                             dtt))
                                        made_change = True
                                else:
                                    raise RuntimeError(
                                        "impossible merge with non-zero "
                                        "distances in update_partials "
                                        "(from parent, child0)")
                    if not updated_blen:
                        up_right_changed_time = up_left_changed_time = False
                        if dtt:
                            if made_change:
                                vect_up_up_time = self._tot_up_time(
                                    node, vect_up_up_time)
                            if time_dirty or made_change:
                                new_ur_time, vect_up_up_time = \
                                    self._merge_up_time(
                                        node, vect_up_up_time,
                                        probVectTime[c1], dist1)
                                new_ul_time, vect_up_up_time = \
                                    self._merge_up_time(
                                        node, vect_up_up_time,
                                        probVectTime[c0], dist0)
                                if tt.are_vectors_different_time(
                                        T, probVectUpRightTime[node],
                                        new_ur_time):
                                    up_right_changed_time = True
                                    probVectUpRightTime[node] = new_ur_time
                                if tt.are_vectors_different_time(
                                        T, probVectUpLeftTime[node],
                                        new_ul_time):
                                    up_left_changed_time = True
                                    probVectUpLeftTime[node] = new_ul_time
                        up_right_changed = up_left_changed = False
                        if lk_dirty:
                            if made_change or kern.are_vectors_different( probVectUpRight[node], new_up_right):
                                probVectUpRight[node] = new_up_right
                                self.shorten(probVectUpRight[node])
                                up_right_changed = True
                            if made_change or kern.are_vectors_different( probVectUpLeft[node], new_up_left):
                                probVectUpLeft[node] = new_up_left
                                self.shorten(probVectUpLeft[node])
                                up_left_changed = True
                        if up_right_changed or up_right_changed_time:
                            node_list.append((c0, 2, up_right_changed,
                                              up_right_changed_time))
                        if up_left_changed or up_left_changed_time:
                            node_list.append((c1, 2, up_left_changed,
                                              up_left_changed_time))
            else:
                # change coming from child number `direction`
                child_num = direction
                other_num = 1 - child_num
                child = children[node][child_num]
                other = children[node][other_num]
                child_dist = dist[child]
                other_dist = dist[other]
                new_up_vect = None
                old_prob_vect = None
                other_vect_up = None
                if lk_dirty:
                    other_child_vect = self.pass_up(probVect[other], other)
                    prob_vect_down = self.pass_up(probVect[child], child)
                    c_is_tip = tree.is_tip(child)
                    other_is_tip = tree.is_tip(other)
                    other_vect_up = probVectUpRight[node] if child_num \
                        else probVectUpLeft[node]
                    new_vect = kern.merge_vectors( other_child_vect, other_dist, other_is_tip,
                        prob_vect_down, child_dist, c_is_tip)
                    if new_vect is None:
                        if (not child_dist) and (not other_dist):
                            self.update_blen(child)
                            if not dist[child]:
                                self.update_blen(other, add_to_list=True,
                                                 node_list=node_list)
                                updated_blen = True
                            else:
                                child_dist = dist[child]
                                probVect[node] = kern.merge_vectors( other_child_vect, other_dist,
                                    other_is_tip, prob_vect_down, child_dist,
                                    c_is_tip)
                                node_list.append((child, 2, True, dtt))
                                made_change = True
                        else:
                            raise RuntimeError(
                                "impossible merge with non-zero distances in "
                                "update_partials (from child)")
                    else:
                        old_prob_vect = probVect[node]
                        probVect[node] = new_vect
                        self.shorten(probVect[node])

                    if (not updated_blen) and (dist[node] or dtt) \
                            and up[node] is not None \
                            and vect_up_up is not None:
                        new_tot = kern.merge_vectors( vect_up_up, dist[node] / 2, False,
                            probVect[node], dist[node] / 2, False,
                            is_up_down=True)
                        if new_tot is None:
                            self.update_blen(node)
                            probVect[node] = kern.merge_vectors( other_child_vect, other_dist,
                                other_is_tip, prob_vect_down, child_dist,
                                c_is_tip)
                            node_list.append((child, 2, True, dtt))
                            probVectTotUp[node] = kern.merge_vectors( vect_up_up, dist[node] / 2, False,
                                probVect[node], dist[node] / 2, False,
                                is_up_down=True)
                            made_change = True
                        else:
                            probVectTotUp[node] = new_tot
                            self.shorten(probVectTotUp[node])
                    elif not dist[node]:
                        probVectTotUp[node] = None

                    if (not updated_blen) and other_vect_up is not None:
                        if up[node] is not None:
                            new_up_vect = kern.merge_vectors( vect_up_up, dist[node], False,
                                prob_vect_down, child_dist, c_is_tip,
                                is_up_down=True)
                        else:
                            # prob_vect_down is already in node's frame
                            new_up_vect = self.root_vector(
                                prob_vect_down, child_dist, c_is_tip, node)
                        if new_up_vect is None:
                            if (not dist[node]) and (not child_dist):
                                self.update_blen(node)
                                if not dist[node]:
                                    self.update_blen(child, add_to_list=True,
                                                     node_list=node_list)
                                    updated_blen = True
                                else:
                                    probVectTotUp[node] = kern.merge_vectors( vect_up_up, dist[node] / 2,
                                        False, probVect[node], dist[node] / 2,
                                        False, is_up_down=True)
                                    node_list.append((child, 2, True, dtt))
                                    made_change = True
                                    new_up_vect = kern.merge_vectors( vect_up_up, dist[node], False,
                                        prob_vect_down, child_dist, c_is_tip,
                                        is_up_down=True)
                            else:
                                raise RuntimeError(
                                    "impossible merge with non-zero distances"
                                    " in update_partials (newUpVect)")
                if not updated_blen:
                    up_changed_time = down_changed_time = False
                    if dtt and (time_dirty or made_change):
                        other_child_vect_time = probVectTime[other]
                        prob_vect_down_time = probVectTime[child]
                        other_vect_up_time = probVectUpRightTime[node] \
                            if child_num else probVectUpLeftTime[node]
                        old_prob_vect_time = probVectTime[node]
                        probVectTime[node] = tt.merge_vectors_time(
                            T, other_child_vect_time, other_dist,
                            prob_vect_down_time, child_dist)
                        if up[node] is not None:
                            vect_up_up_time = self._tot_up_time(
                                node, vect_up_up_time)
                            new_up_vect_time, vect_up_up_time = \
                                self._merge_up_time(node, vect_up_up_time,
                                                    prob_vect_down_time,
                                                    child_dist)
                        else:
                            new_up_vect_time = tt.root_vector_time(
                                T, prob_vect_down_time, child_dist)
                        if tt.are_vectors_different_time(
                                T, other_vect_up_time, new_up_vect_time):
                            up_changed_time = True
                        if tt.are_vectors_different_time(
                                T, probVectTime[node], old_prob_vect_time):
                            down_changed_time = True
                        if child_num:
                            probVectUpRightTime[node] = new_up_vect_time
                        else:
                            probVectUpLeftTime[node] = new_up_vect_time
                    up_changed = down_changed = False
                    if lk_dirty:
                        if other_vect_up is not None:
                            if made_change or kern.are_vectors_different( other_vect_up, new_up_vect):
                                up_changed = True
                                if child_num:
                                    probVectUpRight[node] = new_up_vect
                                    self.shorten(probVectUpRight[node])
                                else:
                                    probVectUpLeft[node] = new_up_vect
                                    self.shorten(probVectUpLeft[node])
                        if made_change or kern.are_vectors_different( probVect[node], old_prob_vect):
                            down_changed = True
                    if up[node] is not None \
                            and (down_changed or down_changed_time):
                        node_list.append((up[node], tree.child_index(node),
                                          down_changed, down_changed_time))
                    if up_changed or up_changed_time:
                        node_list.append((other, 2, up_changed,
                                          up_changed_time))

    # ------------------------------------------------------------------
    # MAT machinery
    def merge_mutation_lists(self, mutations1, mutations2, downward=False):
        """Compose two MAT mutation lists (reference :2187-2233)."""
        ind1 = ind2 = 0
        out = []
        n1, n2 = len(mutations1), len(mutations2)
        while True:
            if ind1 < n1:
                pos1 = mutations1[ind1][0]
                if ind2 < n2:
                    pos2 = mutations2[ind2][0]
                    if pos1 < pos2:
                        if downward:
                            out.append((pos1, mutations1[ind1][2],
                                        mutations1[ind1][1]))
                        else:
                            out.append(mutations1[ind1])
                        ind1 += 1
                    elif pos2 < pos1:
                        out.append(mutations2[ind2])
                        ind2 += 1
                    else:
                        if downward:
                            source = mutations1[ind1][2]
                            end = mutations1[ind1][1]
                        else:
                            source = mutations1[ind1][1]
                            end = mutations1[ind1][2]
                        if end != mutations2[ind2][1]:
                            print("WARNING: inconsistent MAT mutations "
                                  f"{mutations1} {mutations2}")
                        if source != mutations2[ind2][2]:
                            out.append((pos2, source, mutations2[ind2][2]))
                        ind1 += 1
                        ind2 += 1
                else:
                    if downward:
                        out.append((pos1, mutations1[ind1][2],
                                    mutations1[ind1][1]))
                    else:
                        out.append(mutations1[ind1])
                    ind1 += 1
            elif ind2 < n2:
                out.append(mutations2[ind2])
                ind2 += 1
            else:
                break
        return out

    def traverse_tree_to_update_mutation_list(self, appended_node: int,
                                              node: int):
        """Rebuild appended_node's MAT mutation list after an SPR move by
        composing branch lists up to the MRCA of (appended_node, node) and
        back down (reference traverseTreeToUpdateMutationList :4396-4439)."""
        tree = self.tree
        up = tree.up
        mutations = tree.mutations
        depth_app = 0
        p = up[appended_node]
        while p is not None:
            p = up[p]
            depth_app += 1
        depth = 0
        p = up[node]
        while p is not None:
            p = up[p]
            depth += 1
        node_list = [node]
        p_node = node
        p_app = appended_node
        while depth_app > depth:
            p_app = up[p_app]
            depth_app -= 1
        while depth_app < depth:
            p_node = up[p_node]
            node_list.append(p_node)
            depth -= 1
        while p_app != p_node:
            p_node = up[p_node]
            node_list.append(p_node)
            p_app = up[p_app]
        node_list.pop()
        p_app = up[appended_node]
        while p_app != p_node:  # p_node is now the MRCA
            if mutations[p_app]:
                mutations[appended_node] = self.merge_mutation_lists(
                    mutations[p_app], mutations[appended_node])
            p_app = up[p_app]
        while node_list:
            n = node_list.pop()
            if mutations[n]:
                mutations[appended_node] = self.merge_mutation_lists(
                    mutations[n], mutations[appended_node], downward=True)

    def make_node_reference(self, node: int, old_value: int = 0):
        """Promote a node to a MAT local reference: record its non-R sites as
        the branch mutation list and re-express the subtree's cached lists
        relative to it (reference makeNodeReference :8296-8353)."""
        tree = self.tree
        self.num_refs += 1
        if old_value:
            p = tree.up[node]
            while p is not None:
                tree.nDesc[p] -= old_value
                if tree.mutations[p]:
                    break
                p = tree.up[p]
        kern = self.kern
        pos = 0
        muts = tree.mutations[node]
        for entry in kern.export(tree.probVect[node]):
            if entry[0] < 4:
                pos += 1
                muts.append((pos, entry[1], entry[0]))
            elif entry[0] == TYPE_O:
                pos += 1
            else:
                pos = entry[1]

        def repass(arr, n):
            arr[n] = kern.pass_through_branch(arr[n], muts)
            self.shorten(arr[n])

        def repass_lower(n):
            # tracked tips re-frame their tuple form (the tuple-path
            # pass-through keeps O-list identity, preserving the shared
            # ambiguity aliasing) and rebuild the native mirror from it
            tup = self.tip_tuples.get(n)
            if tup is not None:
                new_tup = gl.pass_through_branch(self.refd.lRef, tup, muts)
                gl.shorten(new_tup, self.dc.thresholdProb)
                self.tip_tuples[n] = new_tup
                tree.probVect[n] = kern.import_tuples(new_tup)
            else:
                repass(tree.probVect, n)

        repass_lower(node)
        if tree.dist[node] and tree.up[node] is not None:
            repass(tree.probVectTotUp, node)
        repass(tree.probVectUpRight, node)
        repass(tree.probVectUpLeft, node)
        stack = [tree.children[node][0], tree.children[node][1]]
        while stack:
            n = stack.pop()
            if tree.mutations[n]:
                tree.mutations[n] = self.merge_mutation_lists(
                    muts, tree.mutations[n], downward=True)
            else:
                repass_lower(n)
                if tree.dist[n]:
                    repass(tree.probVectTotUp, n)
                if tree.children[n]:
                    repass(tree.probVectUpRight, n)
                    repass(tree.probVectUpLeft, n)
                    stack.append(tree.children[n][0])
                    stack.append(tree.children[n][1])

    # ------------------------------------------------------------------
    def add_phase_time(self, phase: str, dt: float):
        """Record ``phase`` as a span of the tracer that lasted ``dt``
        seconds and ends now."""
        self.tracer.add(phase, dt)

    def calculate_tree_likelihood(self, root: int, separate: bool = False):
        """Full-tree log-likelihood: post-order merges with LK plus root
        contribution (reference calculateTreeLikelihood :9721-9779)."""
        t0 = time.time()
        try:
            return self._calculate_tree_likelihood(root, separate)
        finally:
            self.add_phase_time("tree_lk", time.time() - t0)

    def _calculate_tree_likelihood(self, root, separate):
        if not separate and self.kern.name == "native":
            from ..native.engine import run_native_tree_lk
            lk = run_native_tree_lk(self, root)
            if lk is not None:
                return lk
        tree = self.tree
        kern = self.kern
        node = root
        last_node = None
        direction = 0
        total = 0.0
        total_hnz = 0.0
        children = tree.children
        while node is not None:
            if direction == 0:
                if children[node]:
                    node = children[node][0]
                else:
                    last_node = node
                    node = tree.up[node]
                    direction = 1
            else:
                if last_node == children[node][0]:
                    node = children[node][1]
                    direction = 0
                else:
                    c0, c1 = children[node]
                    v0 = self.pass_up(tree.probVect[c0], c0)
                    v1 = self.pass_up(tree.probVect[c1], c1)
                    _, lk = kern.merge_vectors( v0, tree.dist[c0], tree.is_tip(c0),
                        v1, tree.dist[c1], tree.is_tip(c1),
                        return_lk=True,
                        n_minor1=len(tree.minorSequences[c0]),
                        n_minor2=len(tree.minorSequences[c1]))
                    total += lk
                    if tree.use_hnz and (tree.dist[node]
                                         > self.dc.effectivelyNon0BLen
                                         or tree.up[node] is None):
                        from ..models.hnz import get_hnz
                        total_hnz += get_hnz(self.cfg.HnZ,
                                             tree.nDesc0[node])
                    last_node = node
                    node = tree.up[node]
                    direction = 1
        total += self.find_prob_root(tree.probVect[root], node=root)
        if separate:
            return total, total_hnz
        return total + total_hnz

    # ------------------------------------------------------------------
    def recalculate_all(self, root: int, count_nodes: bool = False,
                        count_pseudo_counts: bool = False,
                        pseudo_mut_counts=None, data=None, names=None,
                        first_setup: bool = False):
        """Two-pass full recompute of all cached genome lists; with
        ``first_setup`` also builds tips from raw data, collapses minor
        sequences, and initializes the MAT (reference
        reCalculateAllGenomeLists :6013-6347)."""
        # Idempotence gate: nothing mutated since the last completed full
        # recompute of the same root under the same model -> recomputing
        # would reproduce every vector bit-for-bit; skip it.  Counting /
        # setup / time-tree variants always run (their side effects are
        # the point; time vectors mutate outside mark_mutated's paths).
        key = (self.mutation_epoch, self.model.version, root)
        if (not first_setup and not count_nodes and not count_pseudo_counts
                and data is None and self.time is None
                and not self.model.using_error_rate and not self.alias_tags
                and self._recalc_clean_key == key
                and not os.environ.get("MAPLE_NO_RECALC_SKIP")):
            # (error-model runs always recompute: shared-ambiguity tip
            # lists mutate through aliasing outside the epoch's
            # chokepoints)
            return
        t0 = time.time()
        try:
            result = self._recalculate_all(root, count_nodes,
                                           count_pseudo_counts,
                                           pseudo_mut_counts, data, names,
                                           first_setup)
            self._recalc_clean_key = (self.mutation_epoch,
                                      self.model.version, root)
            return result
        finally:
            self.add_phase_time("recalculate", time.time() - t0)
            if os.environ.get("MAPLE_DEBUG_RECALC_LK") and not first_setup:
                self._recalc_calls = getattr(self, "_recalc_calls", 0) + 1
                import sys as _sys
                print(f"RECALC_LK #{self._recalc_calls} "
                      f"{self._calculate_tree_likelihood(root, False)!r}",
                      file=_sys.stderr)
                dump = os.environ.get("MAPLE_DEBUG_RECALC_DUMP")
                if dump:
                    n_call, path = dump.split(":", 1)
                    if int(n_call) == self._recalc_calls:
                        with open(path, "w") as fh:
                            t = self.tree
                            for i in range(len(t.up)):
                                for nm, arr in (
                                        ("pv", t.probVect),
                                        ("upR", t.probVectUpRight),
                                        ("upL", t.probVectUpLeft),
                                        ("tot", t.probVectTotUp)):
                                    v = arr[i]
                                    fh.write(f"{i} {nm} " + (
                                        "None" if v is None else
                                        repr(self.kern.export(v))) + "\n")

    def _recalculate_all(self, root, count_nodes, count_pseudo_counts,
                         pseudo_mut_counts, data, names, first_setup):
        if not (first_setup or count_nodes or count_pseudo_counts
                or data is not None) and self.kern.name == "native":
            from ..native.engine import run_native_recalculate
            if run_native_recalculate(self, root):
                return
        if count_nodes and not (first_setup or count_pseudo_counts
                                or data is not None) \
                and self.kern.name == "native" \
                and self.native_session is None:
            # the statistics pass needs per-entry categories, not vector
            # contents: run the recompute natively, then classify entries
            # in C (vec_type_counts) instead of exporting every vector
            from ..native.engine import run_native_recalculate
            if run_native_recalculate(self, root):
                self._count_nodes_native(root)
                return
        tree = self.tree
        kern = self.kern
        dc = self.dc
        children = tree.children
        up = tree.up
        dist = tree.dist
        probVect = tree.probVect
        if first_setup:
            tree.isRef = [False] * len(up)
        # ---- pass 1: lower vectors (post-order) ----
        node = root
        last_node = None
        direction = 0
        data_names_converted = False
        while node is not None:
            if direction == 0:
                if children[node]:
                    node = children[node][0]
                    continue
                if first_setup:
                    if data is None:
                        raise ValueError("first_setup requires sample data")
                    key = names[tree.name[node]]
                    if key not in data and not data_names_converted:
                        for name_in in list(data.keys()):
                            new_name = name_in.replace("?", "_").replace(
                                "&", "_")
                            if new_name != name_in:
                                data[new_name] = data[name_in]
                        data_names_converted = True
                    if key not in data:
                        raise ValueError(
                            f"sample {key!r} has no sequence data")
                    probVect[node] = self.terminal_vector(data[key],
                                                          node=node)
                    if self.do_time_tree:
                        dates = self.time.dates
                        if key in dates:
                            tree.dateData[node] = dates[key]
                        else:
                            print("No date for sample " + str(key)
                                  + ", treating it as an unknown date.")
                            tree.dateData[node] = None
                    # try collapsing minor sequences from an input tree
                    node = self._collapse_minor_on_setup(node)
                if (not self.cfg.onlyNambiguities) \
                        and self.model.using_error_rate:
                    self.refresh_terminal_errors(node)
                if count_nodes:
                    self._count_node(node)
                last_node = node
                node = up[node]
                direction = 1
            else:
                if last_node == children[node][0]:
                    node = children[node][1]
                    direction = 0
                else:
                    if first_setup:
                        c0, c1 = children[node]
                        if children[c0] and not tree.isRef[c0]:
                            tree.nDesc[node] += tree.nDesc[c0]
                        if children[c1] and not tree.isRef[c1]:
                            tree.nDesc[node] += tree.nDesc[c1]
                        # NOTE: the reference tests dist[children[0]] twice
                        # here (:6160-6163); reproduced for parity.
                        if dist[c0]:
                            tree.nDesc[node] += 1
                        if dist[c0]:
                            tree.nDesc[node] += 1
                        if tree.nDesc[node] >= \
                                self.cfg.maxNumDescendantsForMATClade \
                                and dist[node]:
                            tree.nDesc[node] = 0
                            tree.isRef[node] = True
                    c0, c1 = children[node]
                    is_tip0 = tree.is_tip(c0)
                    is_tip1 = tree.is_tip(c1)
                    v0 = self.pass_up(probVect[c0], c0)
                    v1 = self.pass_up(probVect[c1], c1)
                    new_lower = kern.merge_vectors( v0, dist[c0], is_tip0, v1, dist[c1], is_tip1)
                    if new_lower is None:
                        if (not dist[c0]) and (not dist[c1]):
                            if first_setup:
                                dist[c0] = dc.oneMutBLen / 2
                                dist[c1] = dc.oneMutBLen / 2
                            else:
                                self.update_blen(c0)
                                if not dist[c0]:
                                    self.update_blen(c1)
                            probVect[node] = kern.merge_vectors( v0, dist[c0], is_tip0, v1, dist[c1],
                                is_tip1)
                            if probVect[node] is None:
                                dist[c0] = dc.oneMutBLen / 2
                                dist[c1] = dc.oneMutBLen / 2
                                probVect[node] = kern.merge_vectors( v0, dist[c0], is_tip0, v1,
                                    dist[c1], is_tip1)
                                if probVect[node] is None:
                                    raise RuntimeError(
                                        "unresolvable merge in "
                                        "recalculate_all")
                        else:
                            raise RuntimeError(
                                "inconsistent lower list with non-zero "
                                "distances in recalculate_all")
                    else:
                        probVect[node] = new_lower
                        self.shorten(probVect[node])
                    if count_nodes:
                        self._count_node(node)
                    last_node = node
                    node = up[node]
                    direction = 1

        if first_setup and self.use_local_reference:
            self.setup_mat(root)

        # ---- pass 2: upper/total vectors (pre-order) ----
        if not children[root]:
            return
        rc0, rc1 = children[root]
        tree.probVectUpRight[root] = self.root_vector(
            self.pass_up(probVect[rc1], rc1), dist[rc1],
            tree.is_tip(rc1), root)
        tree.probVectUpLeft[root] = self.root_vector(
            self.pass_up(probVect[rc0], rc0), dist[rc0],
            tree.is_tip(rc0), root)
        tot_node_list = []
        node = children[root][0]
        last_node = None
        direction = 0
        while node is not None:
            if direction == 0:
                node_child_num = tree.child_index(node)
                vect_up = tree.probVectUpRight[up[node]] if \
                    node_child_num == 0 else tree.probVectUpLeft[up[node]]
                vect_up = self.pass_down(vect_up, node)
                if dist[node] or self.do_time_tree:
                    is_tip = tree.is_tip(node)
                    if dist[node] and count_pseudo_counts:
                        kern.update_pseudo_counts( vect_up,
                                               probVect[node],
                                               pseudo_mut_counts)
                    new_vect = kern.merge_vectors( vect_up, dist[node] / 2, False, probVect[node],
                        dist[node] / 2, is_tip, is_up_down=True)
                    self.shorten(new_vect)
                    tree.probVectTotUp[node] = new_vect
                else:
                    tree.probVectTotUp[node] = None
                if children[node]:
                    c0, c1 = children[node]
                    is_tip0 = tree.is_tip(c0)
                    is_tip1 = tree.is_tip(c1)
                    v0 = self.pass_up(probVect[c0], c0)
                    v1 = self.pass_up(probVect[c1], c1)
                    new_up_right = kern.merge_vectors( vect_up, dist[node], False, v1, dist[c1],
                        is_tip1, is_up_down=True)
                    if new_up_right is None:
                        if (not dist[c1]) and (not dist[node]):
                            self.update_blen(node)
                            if not dist[node]:
                                if first_setup:
                                    tree.probVectUpLeft[node] = \
                                        kern.merge_vectors( vect_up, dist[node], False,
                                            v0, dist[c0], is_tip0,
                                            is_up_down=True)
                                self.update_blen(c1)
                                tot_node_list.append((node, 1, True, self.do_time_tree))
                            else:
                                tree.probVectTotUp[node] = kern.merge_vectors( vect_up, dist[node] / 2, False,
                                    probVect[node], dist[node] / 2, False,
                                    is_up_down=True)
                                tot_node_list.append(
                                    (up[node], node_child_num, True,
                                     self.do_time_tree))
                            tree.probVectUpRight[node] = kern.merge_vectors( vect_up, dist[node], False, v1,
                                dist[c1], is_tip1, is_up_down=True)
                        else:
                            raise RuntimeError(
                                "inconsistent upRight list in "
                                "recalculate_all")
                    else:
                        self.shorten(new_up_right)
                        tree.probVectUpRight[node] = new_up_right
                    new_up_left = kern.merge_vectors( vect_up, dist[node], False, v0, dist[c0],
                        is_tip0, is_up_down=True)
                    if new_up_left is None:
                        if (not dist[c0]) and (not dist[node]):
                            self.update_blen(c0)
                            if not dist[c0]:
                                self.update_blen(node)
                                tot_node_list.append(
                                    (up[node], node_child_num, True,
                                     self.do_time_tree))
                                tree.probVectTotUp[node] = kern.merge_vectors( vect_up, dist[node] / 2, False,
                                    probVect[node], dist[node] / 2,
                                    tree.is_tip(node), is_up_down=True)
                                tree.probVectUpRight[node] = kern.merge_vectors( vect_up, dist[node], False, v1,
                                    dist[c1], is_tip1, is_up_down=True)
                            else:
                                tot_node_list.append((node, 0, True, self.do_time_tree))
                            tree.probVectUpLeft[node] = kern.merge_vectors( vect_up, dist[node], False, v0,
                                dist[c0], is_tip0, is_up_down=True)
                        else:
                            raise RuntimeError(
                                "inconsistent upLeft list in recalculate_all")
                    else:
                        self.shorten(new_up_left)
                        tree.probVectUpLeft[node] = new_up_left
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
        self.update_partials(tot_node_list)

    def _count_node(self, node):
        stats = self.num_nodes_stats
        stats[0] += 1
        for entry in self.kern.export(self.tree.probVect[node]):
            if entry[0] < 4:
                stats[1] += 1
            elif entry[0] == TYPE_R:
                stats[2] += 1
            elif entry[0] == TYPE_N:
                stats[3] += 1
            else:
                stats[4] += 1
        stats[5] += len(self.tree.mutations[node])

    def _count_nodes_native(self, root):
        """The count_nodes statistics sweep without tuple exports: same
        traversal membership as the recompute's count (every reachable
        node), categories counted in C."""
        tree = self.tree
        stats = self.num_nodes_stats
        store = self.kern.store
        stack = [root]
        while stack:
            n = stack.pop()
            stack.extend(tree.children[n])
            stats[0] += 1
            nuc, r, nn, o = store.type_counts(tree.probVect[n].vid)
            stats[1] += nuc
            stats[2] += r
            stats[3] += nn
            stats[4] += o
            stats[5] += len(tree.mutations[n])

    def _collapse_minor_on_setup(self, node: int) -> int:
        """On first setup, collapse a tip into its sibling when one is
        (weakly) less informative (reference :6077-6127).  Returns the node
        id to continue traversal from."""
        tree = self.tree
        cfg = self.cfg
        only_identical = (bool(cfg.errorRateSiteSpecificFile)
                          or bool(cfg.errorRateFixed)
                          or cfg.estimateErrorRate
                          or cfg.estimateSiteSpecificErrorRate
                          or cfg.supportFor0Branches or bool(cfg.HnZ))
        while True:
            if tree.up[node] is None:
                return node
            if tree.children[tree.up[node]][1] != node or tree.dist[node]:
                return node
            sibling = tree.children[tree.up[node]][0]
            if tree.dist[sibling] or tree.children[sibling]:
                return node
            comparison = self.kern.is_minor_sequence(
                tree.probVect[node], tree.probVect[sibling],
                only_find_identical=only_identical)
            comparison2 = 0
            if self.do_time_tree:
                from ..models.timetree import is_minor_date
                comparison2 = is_minor_date(
                    tree.dateData[node], tree.dateData[sibling],
                    only_find_identical=only_identical)
            dtt = self.do_time_tree
            if comparison == 1 and ((not dtt) or comparison2 == 1):
                major, minor_n = node, sibling
            elif comparison == 2 and ((not dtt) or comparison2 == 2):
                major, minor_n = sibling, node
            else:
                return node
            self.num_minors_removed += 1
            tree.minorSequences[major].append(tree.name[minor_n])
            tree.minorSequences[major].extend(tree.minorSequences[minor_n])
            tree.probVect[minor_n] = None
            self.tip_tuples.pop(minor_n, None)
            parent = tree.up[major]
            tree.up[major] = tree.up[parent]
            tree.dist[major] = tree.dist[parent]
            if tree.up[major] is not None:
                pc = tree.children[tree.up[major]]
                if pc[0] == parent:
                    pc[0] = major
                else:
                    pc[1] = major
            tree.children[parent] = None
            node = major

    # ------------------------------------------------------------------
    def setup_mat(self, root: int):
        """Initialize MAT local references on an input tree (reference
        setUpMAT :4148-4391).  The rewrite walks raw tuple entries, so on
        the native backend lower vectors round-trip through tuples."""
        if self.kern.name != "python":
            tree = self.tree
            for i, v in enumerate(tree.probVect):
                if v is not None:
                    tree.probVect[i] = self.kern.export(v)
            self._setup_mat_tuples(root)
            for i, v in enumerate(tree.probVect):
                if v is not None:
                    tree.probVect[i] = self.kern.import_tuples(v)
        else:
            self._setup_mat_tuples(root)

    def _setup_mat_tuples(self, root: int):
        tree = self.tree
        lRef = self.refd.lRef
        ref_indices = self.refd.ref_indices
        node = root
        last_node = None
        direction = 0
        mutations_added = []  # (pos, nuc) pairs: current frame vs global ref
        stack_added = []      # saved mutations_added per ref ancestor
        while node is not None:
            if direction == 0:
                new_prob_vect = []
                is_ref = tree.isRef[node]
                if is_ref:
                    new_mutations_added = []
                    self.num_refs += 1
                prob_vect = tree.probVect[node]
                ind_prob = 0
                last_pos = 0
                entry = prob_vect[0]
                pos_entry = entry[1] if entry[0] in (TYPE_R, TYPE_N) else 1
                muts1 = mutations_added
                ind_mut = 0
                if muts1:
                    mut = muts1[0]
                    pos_mut = mut[0]
                else:
                    mut = None
                    pos_mut = lRef + 1
                node_muts = tree.mutations[node]
                while True:
                    if pos_entry < pos_mut:
                        if entry[0] < 4 and is_ref:
                            new_mutations_added.append((pos_entry, entry[0]))
                            node_muts.append((pos_entry, entry[1], entry[0]))
                            new_prob_vect.append((TYPE_R, pos_entry)
                                                 + entry[2:])
                        else:
                            new_prob_vect.append(entry)
                        if pos_entry == lRef:
                            break
                        last_pos = pos_entry
                        ind_prob += 1
                        entry = prob_vect[ind_prob]
                        pos_entry = entry[1] if entry[0] in (TYPE_R, TYPE_N) \
                            else pos_entry + 1
                    elif pos_entry > pos_mut:
                        if entry[0] == TYPE_R and is_ref:
                            node_muts.append((pos_mut, mut[1],
                                              ref_indices[pos_mut - 1]))
                        elif entry[0] == TYPE_R:
                            if (pos_mut - 1) > last_pos:
                                new_prob_vect.append((TYPE_R, pos_mut - 1)
                                                     + entry[2:])
                            new_prob_vect.append(
                                (ref_indices[pos_mut - 1], mut[1])
                                + entry[2:])
                            last_pos = pos_mut
                        elif is_ref:
                            new_mutations_added.append(mut)
                        ind_mut += 1
                        if ind_mut < len(muts1):
                            mut = muts1[ind_mut]
                            pos_mut = mut[0]
                        else:
                            mut = None
                            pos_mut = lRef + 1
                    else:  # pos_entry == pos_mut
                        if entry[0] == TYPE_O:
                            new_prob_vect.append((TYPE_O, mut[1])
                                                 + entry[2:])
                            if is_ref:
                                new_mutations_added.append(mut)
                        elif entry[0] == TYPE_N:
                            new_prob_vect.append(entry)
                            if is_ref:
                                new_mutations_added.append(mut)
                        elif entry[0] == mut[1]:
                            new_prob_vect.append((TYPE_R, pos_entry)
                                                 + entry[2:])
                            if is_ref:
                                new_mutations_added.append(mut)
                        else:
                            if entry[0] == TYPE_R and is_ref:
                                new_prob_vect.append(entry)
                                node_muts.append((pos_mut, mut[1],
                                                  ref_indices[pos_mut - 1]))
                            elif entry[0] == TYPE_R:
                                if (pos_mut - 1) > last_pos:
                                    new_prob_vect.append(
                                        (TYPE_R, pos_mut - 1) + entry[2:])
                                new_prob_vect.append(
                                    (ref_indices[pos_mut - 1], mut[1])
                                    + entry[2:])
                            else:
                                if is_ref:
                                    new_prob_vect.append((TYPE_R, pos_mut)
                                                         + entry[2:])
                                    new_mutations_added.append(
                                        (pos_mut, entry[0]))
                                    node_muts.append((pos_mut, mut[1],
                                                      entry[0]))
                                else:
                                    new_prob_vect.append((entry[0], mut[1])
                                                         + entry[2:])
                        ind_mut += 1
                        last_pos = pos_mut
                        if ind_mut < len(muts1):
                            mut = muts1[ind_mut]
                            pos_mut = mut[0]
                        else:
                            mut = None
                            pos_mut = lRef + 1
                        if pos_entry == lRef:
                            break
                        ind_prob += 1
                        entry = prob_vect[ind_prob]
                        pos_entry = entry[1] if entry[0] in (TYPE_R, TYPE_N) \
                            else pos_entry + 1
                gl.shorten(new_prob_vect, self.dc.thresholdProb)
                tree.probVect[node] = new_prob_vect
                if tree.children[node]:
                    if is_ref:
                        mutations_added = new_mutations_added
                    node = tree.children[node][0]
                else:
                    last_node = node
                    node = tree.up[node]
                    direction = 1
            else:
                if last_node == tree.children[node][0]:
                    node = tree.children[node][1]
                    direction = 0
                else:
                    if tree.isRef[node]:
                        # remove this node's mutations from mutations_added
                        new_added = []
                        im = 0
                        ia = 0
                        node_muts = tree.mutations[node]
                        mut = node_muts[0] if node_muts else None
                        pos_mut = mut[0] if mut else lRef + 1
                        added = mutations_added[0] if mutations_added else None
                        pos_added = added[0] if added else lRef + 1
                        while pos_added <= lRef or pos_mut <= lRef:
                            if pos_mut < pos_added:
                                new_added.append((pos_mut, mut[1]))
                                im += 1
                                if im < len(node_muts):
                                    mut = node_muts[im]
                                    pos_mut = mut[0]
                                else:
                                    mut = None
                                    pos_mut = lRef + 1
                            elif pos_mut > pos_added:
                                new_added.append(added)
                                ia += 1
                                if ia < len(mutations_added):
                                    added = mutations_added[ia]
                                    pos_added = added[0]
                                else:
                                    added = None
                                    pos_added = lRef + 1
                            else:
                                if mut[1] != ref_indices[pos_mut - 1]:
                                    new_added.append((pos_mut, mut[1]))
                                im += 1
                                if im < len(node_muts):
                                    mut = node_muts[im]
                                    pos_mut = mut[0]
                                else:
                                    mut = None
                                    pos_mut = lRef + 1
                                ia += 1
                                if ia < len(mutations_added):
                                    added = mutations_added[ia]
                                    pos_added = added[0]
                                else:
                                    added = None
                                    pos_added = lRef + 1
                        mutations_added = new_added
                    last_node = node
                    node = tree.up[node]
                    direction = 1


def num_non4(prob_vect) -> int:
    """Number of concrete non-reference nucleotides in a genome list
    (reference numNon4 :8357-8363)."""
    return sum(1 for e in prob_vect if e[0] < 4)
