"""Build and load the CUDA kernels at first use (no counterpart: the JAX package's kernels compile through Pallas).

The four kernel sources under ``csrc/`` compile with ``nvcc`` for
``sm_90a``, one ``nvcc -c`` per source, all started together, and link
into one shared library with a plain C interface that :mod:`ctypes`
loads.  The library lands in ``build/torch_kernels/<hash>/`` at the
repository root, keyed by a hash of every source and header, so an edit
rebuilds and an unchanged tree reuses the last build.  A failed build
raises with nvcc's stderr.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bcp.cu", "search.cu", "minimize.cu", "core.cu")
HEADERS = ("fixpoint.cuh", "dpll.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libdeppy_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# Seconds the last build took (0.0 when an earlier build was reused).
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "deppy_bcp_fixpoint": [_P] * 13 + [_I] * 5 + [_P],
    "deppy_search": [_P] * 13 + [_I] + [_P] * 7 + [_I] * 9 + [_P],
    "deppy_minimize": [_P] * 13 + [_I] + [_P] * 4 + [_I] * 6 + [_P],
    "deppy_core": [_P] * 12 + [_I] + [_P] * 3 + [_I] * 8 + [_P],
    "deppy_search_scratch_words": [_I] * 3,
    "deppy_minimize_scratch_words": [_I] * 2,
    "deppy_core_scratch_words": [_I] * 2,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir.parent))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = []
        failed = []
        for src, _, p in procs:
            out, err = p.communicate()
            log.append(f"== {src}\n{out}{err}")
            if p.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        (tmp / "ptxas.log").write_text("\n".join(log))
        os.replace(tmp, out_dir)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _compile(path.parent)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = (ctypes.c_size_t if name.endswith("_words")
                          else ctypes.c_int)
        _LIB = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
