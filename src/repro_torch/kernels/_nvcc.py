"""Build a kernel's ``csrc/*.cu`` with ``nvcc`` into a shared library with
a plain C interface, and load it with ``ctypes``: one helper for every
kernel of the port.

The build runs at first use, from the repository's sources only, into
``build/`` at the repository root (gitignored). The library's name
carries a digest of the source, of every header it includes (``#include
"..."``, followed through the headers), and of the flags, so an edited
source or shared header is never served by a stale build, and it is renamed into place atomically,
so concurrent builds never race. Nothing here runs at import time: the
CPU tests import the kernels' modules on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built "
            "from their csrc/*.cu sources at first use on a CUDA machine")
    return found


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(src: Path) -> list:
    """``src`` and the headers it includes with ``#include "..."`` (paths
    relative to the including file), followed through the headers, each
    once, in the order first met."""
    found = []

    def walk(path):
        path = path.resolve()
        if path in found:
            return
        found.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            walk(path.parent / name)

    walk(Path(src))
    return found


def library_path(src: Path) -> Path:
    """Where the build of ``src`` lives: its name carries a digest of the
    source, its included headers and the flags."""
    h = hashlib.sha256()
    for path in sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(src: Path) -> dict:
    """Compile ``src`` unless this source's build exists. Returns
    ``{"path", "seconds", "log"}``; ``log`` holds ptxas's register and
    shared-memory report, ``seconds`` is 0.0 for a build found on disk."""
    out = library_path(src)
    if out.is_file():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


class Library:
    """One kernel library, built and loaded once per process.

    ``signatures`` maps each exported function to its ``argtypes``; every
    one returns an int (a ``cudaError_t``, 0 on success) except
    ``error_fn``, which turns that code into a message."""

    def __init__(self, src: Path, signatures: dict, error_fn: str):
        self.src = src
        self.signatures = signatures
        self.error_fn = error_fn
        self._lock = threading.Lock()
        self._lib = None

    def build(self) -> dict:
        return build(self.src)

    def load(self):
        if self._lib is not None:        # loaded: no lock on the hot path
            return self._lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(build(self.src)["path"]))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                err = getattr(lib, self.error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def check(self, err: int, what: str):
        """Raise if a launch returned an error code."""
        if err:
            msg = getattr(self.load(), self.error_fn)(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg}")
