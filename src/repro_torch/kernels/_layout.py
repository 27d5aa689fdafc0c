"""Tensor-layout predicates the kernels' wrappers pass to their kernels."""
from __future__ import annotations


def vector_loads(*tensors) -> bool:
    """True when every row (each index over the leading three axes) of each
    tensor starts on a 16-byte boundary and its last axis fills whole
    16-byte chunks: a kernel may then move rows with 16-byte ``cp.async``;
    otherwise it takes its per-element path."""
    for t in tensors:
        per = 16 // t.element_size()
        if (t.shape[-1] % per or t.data_ptr() % 16
                or any(s % per for s in t.stride()[:3])):
            return False
    return True
