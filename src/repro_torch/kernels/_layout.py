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


def tma_rows(t) -> bool:
    """True when TMA can read the rows of ``t`` (its last axis, over the
    leading three): unit stride over the last axis, which fills whole
    16-byte chunks, the base pointer on 16 bytes, and each stride over a
    leading axis of more than one entry a positive multiple of 16 bytes.
    The bf16 flash kernels read q, k and v (the backward also do) by TMA;
    the wrapper copies a tensor that fails this."""
    per = 16 // t.element_size()
    shape, stride = t.shape, t.stride()
    return (stride[-1] == 1 and shape[-1] % per == 0
            and t.data_ptr() % 16 == 0
            and all(n == 1 or (s > 0 and s % per == 0)
                    for n, s in zip(shape[:-1], stride[:-1])))
