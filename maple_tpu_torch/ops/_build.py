"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use and is keyed on a hash of the sources and flags, so an edited
source builds a new library beside the old one: a loaded ``.so`` is never
overwritten in place (nvcc writes a temporary file that is then renamed).
A failed build or load raises.
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

_KERNEL_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float   # nvcc wall time of this process's build; 0 if cached
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


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> Built:
    """The loaded kernel library, built first if no build of the current
    sources exists.  Cached for the life of the process."""
    sources = _sources()
    so = BUILD_DIR / f"libmaple_torch_kernels_{_digest(sources)}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name in ("append_pairs_f32", "append_pairs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _KERNEL_ARGS
        fn.restype = ctypes.c_int
    lib.maple_cuda_error_string.argtypes = [ctypes.c_int]
    lib.maple_cuda_error_string.restype = ctypes.c_char_p
    return Built(lib, so, seconds, log)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        msg = lib.maple_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
