"""Build ``csrc/graph_filter.cu`` with ``nvcc`` into a shared library with
a plain C interface, and load it with ``ctypes``.

The build runs at first use, from the repository's sources only, into
``build/`` at the repository root (gitignored). The library's name
carries a digest of the source and the flags, so an edited source is
never served by a stale build. Nothing here runs at import time: the
CPU tests import this module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc" / "graph_filter.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the graph-filter kernel is "
            f"built from {CSRC.name} at first use on a CUDA machine")
    return found


def build() -> dict:
    """Compile the kernel library unless this source's build exists.
    Returns ``{"path", "seconds", "log"}``; ``log`` holds ptxas's
    register and shared-memory report, ``seconds`` is 0.0 for a build
    found on disk."""
    digest = hashlib.sha256(CSRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"graph_filter-{digest[:16]}.so"
    if out.is_file():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builds never race
    return {"path": out, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def load():
    """The loaded library with its argument types declared (built first
    if needed); one per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()["path"]))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for name in ("graph_filter_f32", "graph_filter_bf16",
                         "graph_filter_t_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
                fn.restype = i32
            lib.graph_filter_error_string.argtypes = [i32]
            lib.graph_filter_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
