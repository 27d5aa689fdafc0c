"""The kernel libraries' build names, on the CPU (nothing is compiled).

A library is built once per name, and its name carries a digest of what
the build reads: the source, every header it includes with ``#include
"..."`` (followed through the headers), and nvcc's flags. A stale library
would be loaded if an edited header left the name as it was."""
from pathlib import Path

from repro_torch.kernels import _nvcc
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.graph_filter import ops as gf_ops
from repro_torch.kernels.ssm_scan import ops as wkv_ops

import torch

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


def test_library_name_follows_every_included_header(tmp_path):
    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n  #  include "outer.cuh"\n'
                   '#include "inner.cuh"\n// #include "absent.cuh"\n')
    assert _nvcc.sources(src) == [src.resolve(),
                                  (tmp_path / "outer.cuh").resolve(),
                                  (tmp_path / "inner.cuh").resolve()]
    name = _nvcc.library_path(src)
    assert name.parent == _nvcc.BUILD_DIR and name.name.startswith("k-")
    assert _nvcc.library_path(src) == name           # deterministic
    (tmp_path / "inner.cuh").write_text("// inner, edited\n")
    edited = _nvcc.library_path(src)
    assert edited != name
    src.write_text(src.read_text() + "// a comment\n")
    assert _nvcc.library_path(src) not in (name, edited)


def test_both_flash_libraries_read_the_shared_header():
    """The forward and backward flash sources include ``hopper.cuh``
    (``kernels/csrc``), and the wkv sources include it through
    ``wkv_chunk.cuh``, so an edit there renames (rebuilds) all four; the
    graph filter's source includes nothing of the repository."""
    header = (Path(fa_ops.CSRC).parents[2] / "csrc" / "hopper.cuh").resolve()
    for lib in (fa_ops.LIB, fa_ops.BWD_LIB):
        assert _nvcc.sources(lib.src) == [lib.src.resolve(), header]
    chunk = wkv_ops.CSRC.with_name("wkv_chunk.cuh").resolve()
    for lib in (wkv_ops.LIB, wkv_ops.BWD_LIB):
        assert _nvcc.sources(lib.src) == [lib.src.resolve(), chunk, header]
    assert _nvcc.sources(gf_ops.LIB.src) == [gf_ops.LIB.src.resolve()]