"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use and is keyed on a hash of the sources, the headers and the
flags, so an edited source builds a new library beside the old one: a
loaded ``.so`` is never overwritten in place (the compiler writes a
temporary file that is then renamed).  The compiler's output (the ptxas
report of registers and spills) is kept beside the library, so a later
process that finds the library built reads the same report.  A failed
build or load raises.

``csrc/append_walk_host.cpp``, the host loop around the merge walk that the
CPU tests call, is built the same way with ``g++`` (:func:`host_walk`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -ffp-contract=off: the host build of the walk rounds every product, as
# the package's other g++ builds do
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# P, C, prm, mm, rf, out, (scratch ...), N, K, B1, B2, uer, stream
_GRID_ARGS = [_PTR] * 6 + [_INT] * 5 + [_PTR]
_WALK_ARGS = [_PTR] * 8 + [_INT] * 5 + [_PTR]
_LONG_P = ctypes.POINTER(ctypes.c_longlong)
# every C function of the kernel library: name -> (argtypes, restype);
# ctypes would cut an undeclared pointer to 32 bits
_KERNEL_FUNCTIONS = {
    "append_pairs_f32": (_WALK_ARGS, _INT),
    "append_pairs_f64": (_WALK_ARGS, _INT),
    "append_pairs_scratch": ([_INT] * 4 + [_LONG_P] * 2, None),
    "maple_cuda_error_string": ([_INT], ctypes.c_char_p),
    "append_pairs_grid_f32": (_GRID_ARGS, _INT),
    "append_pairs_grid_f64": (_GRID_ARGS, _INT),
}
# P, C, prm, mm, rf, out, steps, pairs, n_p, n_c, N, K, B1, B2, uer
_HOST_WALK_ARGS = [_PTR] * 10 + [_INT] * 5
_HOST_FUNCTIONS = {
    "append_walk_host_f32": (_HOST_WALK_ARGS, _INT),
    "append_walk_host_f64": (_HOST_WALK_ARGS, _INT),
}


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float   # wall time of this process's build; 0 if cached
    log: str         # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of maple_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _load(stem: str, compiler, flags, sources, functions):
    """The library of ``sources``, compiled first where no build of them
    (and of the headers, with these flags) exists, with the argument types
    of ``functions`` declared.  ``compiler`` is called only for a build.
    Returns (library, path, build seconds, the compiler's output)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not (so.exists() and log_path.exists()):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        cmd = [compiler(), *flags, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)}\nfailed "
                               f"({proc.returncode}):\n{log}")
        # the report first: whoever finds the library finds its report
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in functions.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib, so, seconds, log_path.read_text()


@functools.cache
def library() -> Built:
    """The loaded kernel library, built first if no build of the current
    sources exists.  Cached for the life of the process."""
    return Built(*_load("libmaple_torch_kernels", _nvcc, NVCC_FLAGS,
                        _sources(), _KERNEL_FUNCTIONS))


@functools.cache
def host_walk() -> ctypes.CDLL:
    """The host loop around the merge walk (``append_walk_host_f32`` and
    ``_f64``), built with g++ at first use.  For tests: no path of the
    package calls it."""
    return _load("libmaple_walk_host", lambda: "g++", GXX_FLAGS,
                 [CSRC / "append_walk_host.cpp"], _HOST_FUNCTIONS)[0]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        msg = lib.maple_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
