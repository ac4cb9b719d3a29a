"""ctypes binding for the native genome-list kernel library.

Builds ``native/maple_native.cpp`` on demand with g++ (no external build
system needed) and exposes a :class:`NativeStore` holding reference/model
state plus C++-owned genome-list vectors addressed by integer handles.

Tuple conversion: entry presence bits (has_bl1/has_bl2/flag) reproduce the
reference's variable-length tuple layouts exactly, so converting a vector to
tuples and back is lossless and native results remain byte-identical to the
Python host kernels.
"""
from __future__ import annotations

import ctypes as C
import fcntl
import os
import subprocess
import sys
from typing import List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                    "maple_native.cpp")
# this package's own build of the library, beside its CUDA kernels
_LIB = os.path.join(os.path.dirname(__file__), "..", "_build",
                    "libmaple_native.so")

_lib = None
_load_error: Optional[str] = None

BIT_BL1 = 1
BIT_BL2 = 2
BIT_FLAG = 4

TYPE_R, TYPE_N, TYPE_O = 4, 5, 6


def _build():
    # -ffp-contract=off: FMA contraction would break byte-level parity
    # with the Python kernels (1-ulp drift); -march=native is safe with
    # contraction off since -O3 alone never reassociates FP reductions.
    # g++ writes a temporary file that is then renamed over _LIB: another
    # process never loads a half-written library, and one that has the old
    # library loaded keeps its file.
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-fPIC",
           "-shared", "-std=c++17", "-pthread", "-o", tmp, _SRC]
    if os.environ.get("MAPLE_NATIVE_PROFILE"):
        cmd.insert(1, "-DMAPLE_PROFILE")
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stale() -> bool:
    return not os.path.exists(_LIB) \
        or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        if _stale():
            # one builder at a time: processes that start together (test
            # workers) wait here and then find the library built
            os.makedirs(os.path.dirname(_LIB), exist_ok=True)
            with open(_LIB + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if _stale():
                    _build()
        lib = C.CDLL(_LIB)
    except Exception as exc:  # pragma: no cover
        _load_error = repr(exc)
        return None
    d = C.c_double
    p = C.POINTER
    lib.store_create.restype = C.c_void_p
    lib.store_create.argtypes = [C.c_int]
    lib.store_free.argtypes = [C.c_void_p]
    lib.store_set_ref.argtypes = [C.c_void_p, p(C.c_int8), p(d),
                                  p(C.c_int32)]
    lib.store_set_params.argtypes = [C.c_void_p, d, d, d, d, d]
    lib.store_set_model.argtypes = [C.c_void_p, p(d), p(d), C.c_int, p(d),
                                    C.c_int, C.c_int, d, p(d), p(d), d,
                                    p(d)]
    lib.vec_create.restype = C.c_int64
    lib.vec_create.argtypes = [C.c_void_p, C.c_int, p(C.c_int8),
                               p(C.c_int32), p(d), p(d), p(C.c_uint8), p(d),
                               p(C.c_int32)]
    lib.vec_release.argtypes = [C.c_void_p, C.c_int64]
    lib.vec_size.restype = C.c_int
    lib.vec_size.argtypes = [C.c_void_p, C.c_int64]
    lib.vec_export.argtypes = [C.c_void_p, C.c_int64, p(C.c_int8),
                               p(C.c_int32), p(d), p(d), p(C.c_uint8), p(d)]
    lib.vec_export_tags.argtypes = [C.c_void_p, C.c_int64, p(C.c_int32)]
    lib.store_patch_tag.argtypes = [C.c_void_p, C.c_int32, p(d)]
    lib.k_merge.restype = C.c_int64
    lib.k_merge.argtypes = [C.c_void_p, C.c_int64, d, C.c_int, C.c_int64, d,
                            C.c_int, C.c_int, C.c_int]
    lib.k_merge_lk.restype = C.c_int64
    lib.k_merge_lk.argtypes = [C.c_void_p, C.c_int64, d, C.c_int, C.c_int64,
                               d, C.c_int, C.c_int, C.c_int, C.c_int,
                               C.c_int, p(d)]
    lib.k_append.restype = d
    lib.k_append.argtypes = [C.c_void_p, C.c_int64, C.c_int64, C.c_int, d]
    lib.k_shorten.argtypes = [C.c_void_p, C.c_int64]
    lib.k_blen.restype = d
    lib.k_blen.argtypes = [C.c_void_p, C.c_int64, C.c_int64, C.c_int]
    lib.k_pass.restype = C.c_int64
    lib.k_pass.argtypes = [C.c_void_p, C.c_int64, p(C.c_int32), C.c_int,
                           C.c_int, C.c_int]
    lib.k_root_vector.restype = C.c_int64
    lib.k_root_vector.argtypes = [C.c_void_p, C.c_int64, d, C.c_int,
                                  C.c_int]
    lib.k_find_prob_root.restype = d
    lib.k_find_prob_root.argtypes = [C.c_void_p, C.c_int64]
    lib.k_different.restype = C.c_int
    lib.k_different.argtypes = [C.c_void_p, C.c_int64, C.c_int64]
    lib.k_minor.restype = C.c_int
    lib.k_minor.argtypes = [C.c_void_p, C.c_int64, C.c_int64, C.c_int]
    lib.k_pseudo_counts.argtypes = [C.c_void_p, C.c_int64, C.c_int64, p(d)]
    lib.k_num_non4.restype = C.c_int
    lib.k_num_non4.argtypes = [C.c_void_p, C.c_int64]
    lib.engine_create.restype = C.c_void_p
    lib.engine_create.argtypes = [C.c_void_p, C.c_int64, C.c_int32, C.c_int,
                                  C.c_int, d, d, d, d, d, C.c_int, C.c_int,
                                  C.c_int, C.c_int]
    lib.engine_free.argtypes = [C.c_void_p]
    lib.engine_place.restype = C.c_int
    lib.engine_place.argtypes = [C.c_void_p, C.c_int64, C.c_int32]
    lib.engine_root.restype = C.c_int32
    lib.engine_root.argtypes = [C.c_void_p]
    lib.engine_node_count.restype = C.c_int32
    lib.engine_node_count.argtypes = [C.c_void_p]
    lib.engine_error.restype = C.c_char_p
    lib.engine_error.argtypes = [C.c_void_p]
    lib.engine_counts.argtypes = [C.c_void_p, p(d), C.c_int]
    lib.engine_stats.argtypes = [C.c_void_p, p(d)]
    lib.engine_export_nodes.argtypes = [
        C.c_void_p, p(C.c_int32), p(C.c_int32), p(C.c_int32), p(d),
        p(C.c_int32), p(C.c_int32), p(C.c_uint8), p(C.c_int64),
        p(C.c_int64), p(C.c_int64), p(C.c_int64), p(C.c_int32),
        p(C.c_int32)]
    lib.engine_export_minor.argtypes = [C.c_void_p, C.c_int32,
                                        p(C.c_int32)]
    lib.engine_export_muts.argtypes = [C.c_void_p, C.c_int32, p(C.c_int32)]
    lib.engine_import.argtypes = [
        C.c_void_p, C.c_int32, p(C.c_int32), p(C.c_int32), p(C.c_int32),
        p(d), p(C.c_int32), p(C.c_uint8), p(C.c_int32), p(C.c_int64),
        p(C.c_int64), p(C.c_int64), p(C.c_int64), p(C.c_int32),
        p(C.c_int32), p(C.c_int32), C.c_int32]
    lib.engine_recalculate.restype = C.c_int
    lib.engine_recalculate.argtypes = [C.c_void_p]
    lib.engine_recalculate_err.restype = C.c_int
    lib.engine_recalculate_err.argtypes = [C.c_void_p, p(C.c_int32),
                                           p(C.c_int32), p(d), C.c_int64]
    lib.engine_tree_lk.restype = C.c_int
    lib.engine_tree_lk.argtypes = [C.c_void_p, p(d)]
    lib.engine_blen_sweep.restype = C.c_int
    lib.engine_blen_sweep.argtypes = [C.c_void_p, C.c_int, p(C.c_int64)]
    lib.engine_blen_loop.restype = C.c_int
    lib.engine_blen_loop.argtypes = [C.c_void_p, C.c_int, p(C.c_int64)]
    lib.engine_root_search.restype = C.c_int
    lib.engine_root_search.argtypes = [
        C.c_void_p, C.c_int, C.c_int, d, d, d, p(C.c_int32), p(d),
        p(C.c_int32), p(d), p(C.c_int64)]
    lib.engine_set_hnz.restype = None
    lib.engine_set_hnz.argtypes = [C.c_void_p, C.c_int]
    lib.engine_set_search_budget.restype = None
    lib.engine_set_search_budget.argtypes = [C.c_void_p, C.c_int64]
    lib.engine_set_spr_budget.restype = None
    lib.engine_set_spr_budget.argtypes = [C.c_void_p, C.c_int64]
    lib.engine_set_root_budget.restype = None
    lib.engine_set_root_budget.argtypes = [C.c_void_p, C.c_int64]
    lib.engine_place_batch.restype = C.c_int
    lib.engine_place_batch.argtypes = [C.c_void_p, C.c_int, C.c_int64,
                                       C.POINTER(C.c_int64),
                                       C.POINTER(C.c_int32)]
    lib.engine_place_batch_seeded.restype = C.c_int
    lib.engine_place_batch_seeded.argtypes = [
        C.c_void_p, C.c_int, C.c_int64, p(C.c_int64), p(C.c_int32),
        p(C.c_int32), C.c_int32, C.c_int64]
    lib.engine_screen_log.restype = None
    lib.engine_screen_log.argtypes = [C.c_void_p, C.c_int]
    lib.engine_profile.restype = None
    lib.engine_profile.argtypes = [C.c_void_p, p(d)]
    lib.engine_screen_drain.restype = C.c_long
    lib.engine_screen_drain.argtypes = [C.c_void_p, p(C.c_int32),
                                        C.c_long]
    lib.engine_export_feats.restype = C.c_long
    lib.engine_export_feats.argtypes = [
        C.c_void_p, p(C.c_int32), C.c_long, C.c_int32, C.c_int32,
        C.c_int32, p(C.c_int32), p(C.c_float), p(C.c_int32),
        p(C.c_uint8), C.c_int]
    lib.engine_export_query_feats.restype = C.c_long
    lib.engine_export_query_feats.argtypes = [
        C.c_void_p, p(C.c_int64), C.c_long, C.c_int32, C.c_int32,
        C.c_int32, p(C.c_int32), p(C.c_float), p(C.c_int32)]
    lib.store_export_feats.restype = C.c_long
    lib.store_export_feats.argtypes = [
        C.c_void_p, p(C.c_int64), C.c_long, C.c_int, C.c_int32,
        C.c_int32, C.c_int32, p(C.c_int32), p(C.c_float), p(C.c_int32)]
    lib.k_append_grid.restype = None
    lib.k_append_grid.argtypes = [
        C.c_void_p, p(C.c_int64), p(C.c_int64), p(d), p(C.c_uint8),
        C.c_long, C.c_long, C.c_int, p(d)]
    lib.vec_from_diffs_batch.restype = None
    lib.vec_from_diffs_batch.argtypes = [
        C.c_void_p, C.c_int64, p(C.c_int64), p(C.c_int8), p(C.c_int32),
        p(C.c_int32), C.c_int, p(C.c_int64)]
    lib.engine_set_threads.restype = None
    lib.engine_set_threads.argtypes = [C.c_void_p, C.c_int]
    lib.engine_import_ndesc0.restype = None
    lib.engine_import_ndesc0.argtypes = [C.c_void_p, p(C.c_int32)]
    lib.engine_export_ndesc0.restype = None
    lib.engine_export_ndesc0.argtypes = [C.c_void_p, p(C.c_int32)]
    lib.engine_set_spr_params.argtypes = [C.c_void_p, d, d, d, C.c_int]
    lib.engine_spr_pass.restype = C.c_int
    lib.engine_spr_pass.argtypes = [C.c_void_p, C.c_int, C.c_int, d,
                                    p(C.c_int32), p(d), p(C.c_long),
                                    p(C.c_long)]
    lib.engine_export_replacements.argtypes = [C.c_void_p, p(C.c_int32)]
    lib.engine_count_dirty.restype = None
    lib.engine_count_dirty.argtypes = [C.c_void_p, p(C.c_int64)]
    lib.engine_set_all_dirty.restype = None
    lib.engine_set_all_dirty.argtypes = [C.c_void_p, C.c_int]
    lib.engine_spr_pass_parallel.restype = C.c_int
    lib.engine_spr_pass_parallel.argtypes = [
        C.c_void_p, C.c_int, C.c_int, C.c_int, d, p(C.c_int32), p(d),
        p(C.c_long), p(C.c_long), p(C.c_int64), p(C.c_int64),
        p(C.c_int64)]
    lib.engine_em.restype = C.c_int64
    lib.engine_em.argtypes = [C.c_void_p]
    lib.vec_type_counts.restype = None
    lib.vec_type_counts.argtypes = [C.c_void_p, C.c_int64, p(C.c_int64)]
    lib.vec_from_diffs.restype = C.c_int64
    lib.vec_from_diffs.argtypes = [C.c_void_p, C.c_int, p(C.c_int8),
                                   p(C.c_int32), p(C.c_int32), C.c_int]
    lib.em_reset.argtypes = [C.c_void_p]
    lib.em_branch.argtypes = [C.c_void_p, C.c_int64, C.c_int64, d, C.c_int,
                              C.c_int, p(C.c_int32), p(C.c_int8), C.c_int]
    lib.em_totals.argtypes = [C.c_void_p, p(d), p(d), p(d)]
    lib.em_site_arrays.argtypes = [C.c_void_p, p(d), p(d), p(d)]
    lib.em_error_arrays.argtypes = [C.c_void_p, p(d), p(d)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(C.POINTER(ctype))


class NativeStore:
    """One store per (reference, model) context; rebuild model state with
    set_model when the Python Model changes."""

    def __init__(self, refd, dc):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_load_error}")
        self.lib = lib
        self.refd = refd
        self.lRef = refd.lRef
        self.h = C.c_void_p(lib.store_create(refd.lRef))
        ref_idx = np.asarray(refd.ref_indices, dtype=np.int8)
        root_freqs = np.asarray(refd.root_freqs, dtype=np.float64)
        cum_bases = np.asarray(refd.cumulative_bases,
                               dtype=np.int32).reshape(-1)
        lib.store_set_ref(self.h, _as_ptr(ref_idx, C.c_int8),
                          _as_ptr(root_freqs, C.c_double),
                          _as_ptr(cum_bases, C.c_int32))
        self._keep = (ref_idx, root_freqs, cum_bases)
        lib.store_set_params(self.h, dc.thresholdProb, dc.minimumCarryOver,
                             dc.minBLenSensitivity, dc.thresholdDiffForUpdate,
                             dc.thresholdFoldChangeUpdate)
        self.model_version = -1
        self.using_error_rate = False

    def __del__(self):
        # Cycle GC may finalize the store before outstanding NV handles;
        # null the handle so late NV.release() calls become no-ops instead
        # of touching freed memory.
        try:
            h, self.h = self.h, None
            if h:
                self.lib.store_free(h)
        except Exception:
            pass

    def sync_model(self, model):
        if model.version == self.model_version:
            return
        d = C.c_double
        mut = np.asarray(model.mut_matrix, dtype=np.float64).reshape(-1)
        cum = getattr(model, "cumulative_rate_np", None)
        if cum is None:
            cum = np.asarray(model.cumulative_rate, dtype=np.float64)
        site = None
        if model.use_rate_variation and model.site_rates is not None:
            site = np.asarray(model.site_rates, dtype=np.float64)
        err_rates = cum_err = rfle = None
        if model.error_rates is not None:
            err_rates = np.asarray(model.error_rates, dtype=np.float64)
        if model.cumulative_error_rate is not None:
            cum_err = np.asarray(model.cumulative_error_rate,
                                 dtype=np.float64)
        if model.root_freqs_log_error_cumulative is not None:
            rfle = np.asarray(model.root_freqs_log_error_cumulative,
                              dtype=np.float64)
        nul = C.POINTER(d)()
        self.lib.store_set_model(
            self.h, _as_ptr(mut, d), _as_ptr(cum, d),
            1 if model.use_rate_variation else 0,
            _as_ptr(site, d) if site is not None else nul,
            1 if model.using_error_rate else 0,
            1 if model.error_rate_site_specific else 0,
            model.error_rate,
            _as_ptr(err_rates, d) if err_rates is not None else nul,
            _as_ptr(cum_err, d) if cum_err is not None else nul,
            model.tot_error or 0.0,
            _as_ptr(rfle, d) if rfle is not None else nul)
        self.model_version = model.version
        self.using_error_rate = model.using_error_rate

    # ------------------------------------------------------------------
    def from_tuples(self, vec, tags=None) -> int:
        """Upload a tuple-form genome list; returns the handle.  ``tags``
        optionally carries per-entry alias tags (shared-ambiguity-list ids,
        see store_patch_tag) for O entries; -1 elsewhere."""
        n = len(vec)
        types = np.empty(n, np.int8)
        vals = np.empty(n, np.int32)
        bl1 = np.zeros(n, np.float64)
        bl2 = np.zeros(n, np.float64)
        bits = np.zeros(n, np.uint8)
        probs = np.zeros((n, 4), np.float64)
        uer = self.using_error_rate
        for k, e in enumerate(vec):
            c = e[0]
            types[k] = c
            vals[k] = e[1]
            if c == TYPE_O:
                probs[k] = e[-1]
                if len(e) > 3:
                    bits[k] = BIT_BL1
                    bl1[k] = e[2]
            elif c != TYPE_N:
                n_extra = len(e) - 2 - (1 if (uer and len(e) > 2) else 0)
                b = 0
                if n_extra >= 1:
                    b |= BIT_BL1
                    bl1[k] = e[2]
                if n_extra >= 2:
                    b |= BIT_BL2
                    bl2[k] = e[3]
                if uer and len(e) > 2 and e[-1]:
                    b |= BIT_FLAG
                bits[k] = b
        tag_arr = None
        if tags is not None:
            tag_arr = np.asarray(tags, dtype=np.int32)
        return self.lib.vec_create(
            self.h, n, _as_ptr(types, C.c_int8), _as_ptr(vals, C.c_int32),
            _as_ptr(bl1, C.c_double), _as_ptr(bl2, C.c_double),
            _as_ptr(bits, C.c_uint8), _as_ptr(probs, C.c_double),
            _as_ptr(tag_arr, C.c_int32) if tag_arr is not None
            else C.POINTER(C.c_int32)())

    def to_tuples(self, vid: int):
        """Download a native vector as reference-layout tuples."""
        n = self.lib.vec_size(self.h, vid)
        types = np.empty(n, np.int8)
        vals = np.empty(n, np.int32)
        bl1 = np.empty(n, np.float64)
        bl2 = np.empty(n, np.float64)
        bits = np.empty(n, np.uint8)
        probs = np.empty((n, 4), np.float64)
        self.lib.vec_export(
            self.h, vid, _as_ptr(types, C.c_int8), _as_ptr(vals, C.c_int32),
            _as_ptr(bl1, C.c_double), _as_ptr(bl2, C.c_double),
            _as_ptr(bits, C.c_uint8), _as_ptr(probs, C.c_double))
        out = []
        uer = self.using_error_rate
        for k in range(n):
            c = int(types[k])
            v = int(vals[k])
            b = int(bits[k])
            if c == TYPE_N:
                out.append((c, v))
            elif c == TYPE_O:
                # .tolist() gives exact Python floats: np.float64 elements
                # would defeat builtin sum()'s Neumaier compensation in EM.
                pr = probs[k].tolist()
                if b & BIT_BL1:
                    out.append((c, v, float(bl1[k]), pr))
                else:
                    out.append((c, v, pr))
            else:
                entry = [c, v]
                if b & BIT_BL1:
                    entry.append(float(bl1[k]))
                if b & BIT_BL2:
                    entry.append(float(bl2[k]))
                if uer and (b & BIT_BL1):
                    entry.append(bool(b & BIT_FLAG))
                out.append(tuple(entry))
        return out

    def release(self, vid: int):
        if self.h is not None:
            self.lib.vec_release(self.h, vid)

    def type_counts(self, vid: int):
        """Entry-category counts (nucs, Rs, Ns, Os) without a tuple
        export — the genome-list statistics pass (reference :6299-6345)."""
        out = np.zeros(4, np.int64)
        self.lib.vec_type_counts(self.h, vid, _as_ptr(out, C.c_int64))
        return out.tolist()

    def patch_tag(self, tag: int, probs4):
        """Propagate a mutated shared tip probability list to every live
        native entry mirroring it (the reference mutates the aliased list
        in place, :3959)."""
        pr = np.asarray(probs4, dtype=np.float64)
        self.lib.store_patch_tag(self.h, tag, _as_ptr(pr, C.c_double))

    def export_tags(self, vid: int):
        n = self.lib.vec_size(self.h, vid)
        tags = np.empty(n, np.int32)
        self.lib.vec_export_tags(self.h, vid, _as_ptr(tags, C.c_int32))
        return tags.tolist()

    # ------------------------------------------------------------------
    def merge(self, v1, bl1, tip1, v2, bl2, tip2, is_up_down=False,
              shorten=False) -> Optional[int]:
        r = self.lib.k_merge(self.h, v1, bl1, 1 if tip1 else 0, v2, bl2,
                             1 if tip2 else 0, 1 if is_up_down else 0,
                             1 if shorten else 0)
        return None if r < 0 else r

    def merge_lk(self, v1, bl1, tip1, v2, bl2, tip2, is_up_down=False,
                 n_minor1=0, n_minor2=0, shorten=False):
        lk = C.c_double()
        r = self.lib.k_merge_lk(self.h, v1, bl1, 1 if tip1 else 0, v2, bl2,
                                1 if tip2 else 0, 1 if is_up_down else 0,
                                n_minor1, n_minor2, 1 if shorten else 0,
                                C.byref(lk))
        if r < 0:
            raise RuntimeError(f"merge_lk failed: code {r}")
        return r, lk.value

    def append(self, vP, vC, tip_c, blen) -> float:
        return self.lib.k_append(self.h, vP, vC, 1 if tip_c else 0, blen)

    def append_grid(self, vP, vC, blens, tips, n_threads=1) -> np.ndarray:
        """Batched appendProbNode: out[i, k] = append(vP[i, k], vC[i],
        tips[i], blens[i]); vP entries < 0 score -inf.  One native call
        for a whole screen re-score (the per-call ctypes overhead would
        otherwise dominate)."""
        vP = np.ascontiguousarray(vP, np.int64)
        n, m = vP.shape
        vC = np.ascontiguousarray(vC, np.int64)
        blens = np.ascontiguousarray(blens, np.float64)
        tips = np.ascontiguousarray(tips, np.uint8)
        out = np.empty((n, m), np.float64)
        p = C.POINTER
        self.lib.k_append_grid(
            self.h, vP.ctypes.data_as(p(C.c_int64)),
            vC.ctypes.data_as(p(C.c_int64)),
            blens.ctypes.data_as(p(C.c_double)),
            tips.ctypes.data_as(p(C.c_uint8)), n, m, n_threads,
            out.ctypes.data_as(p(C.c_double)))
        return out

    def export_feats(self, vids, query_side, d_hash, g_buckets, fmax):
        """Proxy-screen features of raw store handles (global frame);
        vids < 0 produce empty rows.  Returns (idx, w, counts)."""
        vids = np.ascontiguousarray(vids, np.int64)
        n = len(vids)
        idx = np.empty((n, fmax), np.int32)
        w = np.empty((n, fmax), np.float32)
        counts = np.empty(n, np.int32)
        p = C.POINTER
        self.lib.store_export_feats(
            self.h, vids.ctypes.data_as(p(C.c_int64)), n,
            1 if query_side else 0, d_hash, g_buckets, fmax,
            idx.ctypes.data_as(p(C.c_int32)),
            w.ctypes.data_as(p(C.c_float)),
            counts.ctypes.data_as(p(C.c_int32)))
        return idx, w, counts

    def shorten(self, vid):
        self.lib.k_shorten(self.h, vid)

    def blen(self, vP, vC, from_tip_c):
        """estimate_branch_length; returns False for "length 0 optimal"
        (native -1.0 sentinel)."""
        r = self.lib.k_blen(self.h, vP, vC, 1 if from_tip_c else 0)
        return False if r < 0 else r

    def pass_through(self, vid, mutations, dir_is_up=False, shorten=False):
        muts = np.asarray(mutations, dtype=np.int32).reshape(-1)
        return self.lib.k_pass(self.h, vid,
                               _as_ptr(muts, C.c_int32),
                               len(mutations), 1 if dir_is_up else 0,
                               1 if shorten else 0)

    def root_vector(self, vid, blen, from_tip, shorten=False):
        return self.lib.k_root_vector(self.h, vid, blen or 0.0,
                                      1 if from_tip else 0,
                                      1 if shorten else 0)

    def find_prob_root(self, vid):
        return self.lib.k_find_prob_root(self.h, vid)

    def different(self, v1, v2):
        return bool(self.lib.k_different(self.h, v1,
                                         -1 if v2 is None else v2))

    def minor(self, v1, v2, only_identical=False):
        return self.lib.k_minor(self.h, v1, v2,
                                1 if only_identical else 0)

    def pseudo_counts(self, v1, v2, counts_list):
        arr = np.asarray(counts_list, dtype=np.float64).reshape(-1)
        self.lib.k_pseudo_counts(self.h, v1, v2,
                                 _as_ptr(arr, C.c_double))
        out = arr.reshape(4, 4).tolist()
        for i in range(4):
            for j in range(4):
                counts_list[i][j] = out[i][j]

    def num_non4(self, vid):
        return self.lib.k_num_non4(self.h, vid)

    # --- EM accumulation (models/em.py native path) ---
    def em_reset(self):
        self.lib.em_reset(self.h)

    def em_branch(self, vP, vC, dist, node_is_leaf, n_minor,
                  mut_pos, mut_alt, n_mut):
        self.lib.em_branch(
            self.h, vP, vC, dist, 1 if node_is_leaf else 0, n_minor,
            _as_ptr(mut_pos, C.c_int32) if n_mut else None,
            _as_ptr(mut_alt, C.c_int8) if n_mut else None, n_mut)

    def em_totals(self):
        """(counts 4x4 lists, waiting_times list4, error_count,
        observed_tot, tot_tree_length) — all python floats (.tolist();
        np.float64 would defeat the compensated builtin sum() downstream)."""
        counts = np.zeros(16, np.float64)
        wt = np.zeros(4, np.float64)
        sc = np.zeros(3, np.float64)
        self.lib.em_totals(self.h, _as_ptr(counts, C.c_double),
                           _as_ptr(wt, C.c_double), _as_ptr(sc, C.c_double))
        return (counts.reshape(4, 4).tolist(), wt.tolist(),
                float(sc[0]), float(sc[1]), float(sc[2]))

    def em_site_arrays(self):
        """(waiting_times_sites lRef x [4], counts_sites, tracking_ns)."""
        n = self.lRef
        wts = np.zeros(n * 4, np.float64)
        cs = np.zeros(n, np.float64)
        tns = np.zeros(n + 1, np.float64)
        self.lib.em_site_arrays(self.h, _as_ptr(wts, C.c_double),
                                _as_ptr(cs, C.c_double),
                                _as_ptr(tns, C.c_double))
        return wts.reshape(n, 4).tolist(), cs.tolist(), tns.tolist()

    def em_error_arrays(self):
        """(observed_sites lRef+1, error_count_sites lRef)."""
        n = self.lRef
        obs = np.zeros(n + 1, np.float64)
        err = np.zeros(n, np.float64)
        self.lib.em_error_arrays(self.h, _as_ptr(obs, C.c_double),
                                 _as_ptr(err, C.c_double))
        return obs.tolist(), err.tolist()
