"""Fused K-hop graph filter Y = Σ_k h_k S^k W: the hand-written CUDA
kernel (``csrc/graph_filter.cu``, built and loaded by ``loader``), its
wrapper and mixer (``ops``) and its plain version (``ref``)."""
from repro_torch.kernels.graph_filter.ops import (MAX_N, graph_filter,
                                                  make_cuda_mix)
from repro_torch.kernels.graph_filter.ref import graph_filter_ref

__all__ = ["MAX_N", "graph_filter", "graph_filter_ref", "make_cuda_mix"]
