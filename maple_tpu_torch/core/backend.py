"""Kernel backends: pure-Python tuple lists vs native C++ store vectors.

Every runtime/search component calls kernels through ``rt.kern`` so the
whole inference engine can run on either representation; both are
byte-identical (tests/test_native_kernels.py), so golden outputs are the
same on either backend.
"""
from __future__ import annotations

from typing import List, Optional

from . import genomelist as gl
from . import kernels as K


class PyBackend:
    """Genome lists as Python tuple lists; kernels from core.kernels."""

    name = "python"

    def __init__(self, rt):
        self.rt = rt

    def _ctx(self):
        return self.rt.ctx()

    # --- vector constructors / converters ---
    def import_tuples(self, vec):
        return vec

    def export(self, vec):
        return vec

    def terminal_vector(self, diffs, num_minor_seqs=0):
        model = self.rt.model
        return gl.terminal_node_genome_list(
            self.rt.refd, diffs,
            only_n_ambiguities=self.rt.cfg.onlyNambiguities,
            using_error_rate=model.using_error_rate,
            error_rate=model.error_rate,
            error_rates=model.error_rates,
            num_minor_seqs=num_minor_seqs)

    # --- kernels ---
    def merge_vectors(self, v1, bl1, tip1, v2, bl2, tip2, return_lk=False,
                      is_up_down=False, n_minor1=0, n_minor2=0):
        return K.merge_vectors(self._ctx(), v1, bl1, tip1, v2, bl2, tip2,
                               return_lk=return_lk, is_up_down=is_up_down,
                               n_minor1=n_minor1, n_minor2=n_minor2)

    def append_prob_node(self, vP, vC, is_tip_c, blen):
        return K.append_prob_node(self._ctx(), vP, vC, is_tip_c, blen)

    def estimate_branch_length(self, vP, vC, from_tip_c=False):
        return K.estimate_branch_length(self._ctx(), vP, vC,
                                        from_tip_c=from_tip_c)

    def root_vector_frame(self, v, blen, is_from_tip):
        return K.root_vector_frame(self._ctx(), v, blen, is_from_tip)

    def find_prob_root_frame(self, v):
        return K.find_prob_root_frame(self._ctx(), v)

    def are_vectors_different(self, v1, v2):
        return K.are_vectors_different(self._ctx(), v1, v2)

    def is_minor_sequence(self, v1, v2, only_find_identical=False):
        return K.is_minor_sequence(self.rt.refd.lRef, v1, v2,
                                   only_find_identical=only_find_identical)

    def update_pseudo_counts(self, v1, v2, counts):
        K.update_pseudo_counts(self.rt.refd.lRef, v1, v2, counts)

    def pass_through_branch(self, v, mutations, dir_is_up=False):
        return gl.pass_through_branch(self.rt.refd.lRef, v, mutations,
                                      dir_is_up=dir_is_up)

    def shorten(self, v):
        gl.shorten(v, self.rt.dc.thresholdProb)

    def num_non4(self, v):
        return sum(1 for e in v if e[0] < 4)


class NV:
    """A native vector handle with automatic release."""

    __slots__ = ("vid", "store")

    def __init__(self, store, vid):
        self.store = store
        self.vid = vid

    def __del__(self):
        try:
            if self.vid >= 0:
                self.store.release(self.vid)
        except Exception:
            pass

    def disarm(self) -> int:
        """Transfer ownership of the underlying vector (e.g. to the C++
        engine); returns the vid and neutralizes this handle."""
        vid, self.vid = self.vid, -1
        return vid

    def __repr__(self):
        return f"NV({self.vid}, n={self.store.lib.vec_size(self.store.h, self.vid)})"


class NativeBackend:
    """Genome lists as C++-store handles; kernels from native/maple_native.

    Results are byte-identical to PyBackend; ~10x faster per kernel call.
    """

    name = "native"

    def __init__(self, rt):
        from ..native import NativeStore
        self.rt = rt
        self.store = NativeStore(rt.refd, rt.dc)
        self.store.sync_model(rt.model)

    def _sync(self):
        if self.store.model_version != self.rt.model.version:
            self.store.sync_model(self.rt.model)
        return self.store

    # --- converters ---
    def import_tuples(self, vec):
        s = self._sync()
        at = getattr(self.rt, "alias_tags", None)
        tags = None
        if at:
            tags = [at.get(id(e[-1]), -1)
                    if e[0] == gl.TYPE_O and isinstance(e[-1], list) else -1
                    for e in vec]
            if not any(t >= 0 for t in tags):
                tags = None
        return NV(s, s.from_tuples(vec, tags))

    def export(self, vec):
        if vec is None:
            return None
        return self._sync().to_tuples(vec.vid)

    def terminal_vector(self, diffs, num_minor_seqs=0):
        model = self.rt.model
        tuples = gl.terminal_node_genome_list(
            self.rt.refd, diffs,
            only_n_ambiguities=self.rt.cfg.onlyNambiguities,
            using_error_rate=model.using_error_rate,
            error_rate=model.error_rate,
            error_rates=model.error_rates,
            num_minor_seqs=num_minor_seqs)
        return self.import_tuples(tuples)

    # --- kernels ---
    def merge_vectors(self, v1, bl1, tip1, v2, bl2, tip2, return_lk=False,
                      is_up_down=False, n_minor1=0, n_minor2=0):
        s = self._sync()
        if return_lk:
            vid, lk = s.merge_lk(v1.vid, bl1 or 0.0, tip1, v2.vid,
                                 bl2 or 0.0, tip2, is_up_down=is_up_down,
                                 n_minor1=n_minor1, n_minor2=n_minor2)
            return NV(s, vid), lk
        vid = s.merge(v1.vid, bl1 or 0.0, tip1, v2.vid, bl2 or 0.0, tip2,
                      is_up_down=is_up_down)
        return None if vid is None else NV(s, vid)

    def append_prob_node(self, vP, vC, is_tip_c, blen):
        return self._sync().append(vP.vid, vC.vid, is_tip_c, blen or 0.0)

    def estimate_branch_length(self, vP, vC, from_tip_c=False):
        return self._sync().blen(vP.vid, vC.vid, from_tip_c)

    def root_vector_frame(self, v, blen, is_from_tip):
        s = self._sync()
        return NV(s, s.root_vector(v.vid, blen or 0.0, is_from_tip))

    def find_prob_root_frame(self, v):
        return self._sync().find_prob_root(v.vid)

    def are_vectors_different(self, v1, v2):
        return self._sync().different(v1.vid,
                                      None if v2 is None else v2.vid)

    def is_minor_sequence(self, v1, v2, only_find_identical=False):
        return self._sync().minor(v1.vid, v2.vid, only_find_identical)

    def update_pseudo_counts(self, v1, v2, counts):
        self._sync().pseudo_counts(v1.vid, v2.vid, counts)

    def pass_through_branch(self, v, mutations, dir_is_up=False):
        s = self._sync()
        return NV(s, s.pass_through(v.vid, mutations, dir_is_up=dir_is_up))

    def shorten(self, v):
        self._sync().shorten(v.vid)

    def num_non4(self, v):
        return self._sync().num_non4(v.vid)


def make_backend(rt, name: str):
    if name == "native":
        from ..native import native_available
        if native_available():
            return NativeBackend(rt)
        print("WARNING: native backend unavailable, using python kernels")
    elif name != "python":
        raise ValueError(
            f"unknown kernel backend {name!r}: use 'native' or 'python'")
    return PyBackend(rt)
