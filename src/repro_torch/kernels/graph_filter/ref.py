"""Plain PyTorch version of the K-hop graph filter Y = Σ_{k≤K} h_k S^k W.

It is the CPU path of ``ops.graph_filter`` and the reference the CUDA
kernel is held against on the card."""
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
