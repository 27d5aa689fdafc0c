"""Plain PyTorch version of the K-hop graph filter Y = Σ_{k≤K} h_k S^k W.

It is the CPU path of ``ops.graph_filter`` and the reference the CUDA
kernel is held against on the card (``make_plain_mix`` wraps it as a
mixer for whole-path comparisons)."""
import torch


def graph_filter_ref(S, W, h):
    """S (B,n,n) or (n,n), W (B,n,d) or (n,d), h (K+1,). Horner's rule in
    f32 (the order of operations the kernel uses); the result is in W's
    dtype."""
    K = h.shape[0] - 1
    hf = h.to(torch.float32)
    Wf = W.to(torch.float32)
    Sf = S.to(torch.float32)
    Y = hf[K] * Wf
    for k in range(K - 1, -1, -1):
        Y = Sf @ Y + hf[k] * Wf
    return Y.to(W.dtype)


def make_plain_mix():
    """The plain filter as an explicit S-as-argument mixer
    (``mix_fn(S, W, h)``, ``takes_S = True``): the reference that the
    kernel path is held against in the tests and ``chip_smoke.py``. No
    entry point selects it by default; ``mix_fn=None`` goes through
    ``ops.graph_filter``, which launches the kernel on CUDA tensors."""
    def mix_fn(S, W, h):
        return graph_filter_ref(S, W, h)

    mix_fn.takes_S = True
    mix_fn.tag = ("plain",)
    return mix_fn
