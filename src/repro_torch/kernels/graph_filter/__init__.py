"""Fused K-hop graph filter Y = Σ_k h_k S^k W: the hand-written CUDA
kernel (``csrc/graph_filter.cu``), its wrapper and gradient (``ops``) and its plain version and plain
mixer (``ref``).

JAX-only: ``graph_filter_hsw`` and ``make_pallas_mix`` (see ``ops``).
"""
from repro_torch.kernels.graph_filter.ops import (RESIDENT_N,
                                                  bf16_error_bound,
                                                  graph_filter)
from repro_torch.kernels.graph_filter.ref import (graph_filter_ref,
                                                  make_plain_mix)

__all__ = ["RESIDENT_N", "bf16_error_bound", "graph_filter",
           "graph_filter_ref", "make_plain_mix"]
