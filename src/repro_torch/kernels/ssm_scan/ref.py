"""Plain PyTorch version of the RWKV6 wkv recurrence (data-dependent
decay), the port's copy of ``repro.kernels.ssm_scan.ref``:

    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

It is the CPU path of ``ops.wkv`` and the reference the CUDA kernel is
held against on the card."""
import torch


def wkv_ref(r, k, v, w, u, S0=None):
    """r/k/v/w (B,H,T,dk); u (H,dk). Returns (y (B,H,T,dk) in r's dtype,
    S (B,H,dk,dk) f32). A step at a time, in f32."""
    B, H, T, dk = r.shape
    S = (torch.zeros((B, H, dk, dk), dtype=torch.float32, device=r.device)
         if S0 is None else S0)
    uf = u.to(torch.float32)[..., :, None]
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, :, t].to(torch.float32) for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, S + uf * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=2).to(r.dtype), S
