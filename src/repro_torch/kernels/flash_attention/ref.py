"""Plain PyTorch version of the flash-attention kernel: full softmax
attention with causal and sliding-window masks and GQA, in the kernel's
(B, H, S, dh) layout (the port's copy of
``repro.kernels.flash_attention.ref``).

It is the CPU path of ``ops.flash_attention`` and the reference the CUDA
kernel is held against on the card."""
import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=0):
    """q (B,H,Sq,dh); k/v (B,KV,Skv,dh). H % KV == 0. window=0 => global.
    Computed in f32; the result is in q's dtype."""
    B, H, Sq, dh = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, dh).to(torch.float32)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg,
                          k.to(torch.float32)) * dh ** -0.5
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return out.reshape(B, H, Sq, dh).to(q.dtype)
