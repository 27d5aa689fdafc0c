"""RWKV6 'Finch' sequence mixer (data-dependent per-channel decay, matrix
state per head) and its channel-mix: the RWKV6 half of
``repro.models.ssm``.

The full-sequence path (the prefill) runs the recurrence through the
hand-written wkv kernel (``kernels.ssm_scan``), which returns the final
state the decode resumes from; ``plain=True`` runs it through the plain
version instead (the explicit reference run). The decode path is the
plain one-step recurrence over the carried state, as in the reference.

Mamba (ROADMAP queue 1 item 13) is not ported yet, nor are the
reference's sharding hints (``_hint``), which have no counterpart on one
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssm_scan import ops as WKV
from repro_torch.kernels.ssm_scan.ref import wkv_ref
from repro_torch.models import layers as L


def init_rwkv6(init: L.Init, d_model, s: SSMConfig):
    H = s.n_heads
    dk = d_model // H
    lora = max(32, d_model // 32)
    return {
        # time-mix interpolation coefficients (static mu per channel)
        "mu": init.uniform((5, d_model)),                    # r,k,v,w,g
        "wr": L.init_dense(init, d_model, d_model),
        "wk": L.init_dense(init, d_model, d_model),
        "wv": L.init_dense(init, d_model, d_model),
        "wg": L.init_dense(init, d_model, d_model),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x Wa) Wb))  (low-rank)
        "w0": init.full((d_model,), -2.0),
        "wa": L.init_dense(init, d_model, lora),
        "wb": L.init_dense(init, lora, d_model, scale=lora ** -0.5),
        "u": init.normal((H, dk), 0.1),                      # bonus
        "gn": L.init_layernorm(init, dk),                    # per-head group norm
        "out": L.init_dense(init, d_model, d_model, scale=d_model ** -0.5),
    }


def _shift(x, x_prev):
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_mix(p, x, x_prev):
    """Token-shift interpolation. x (B,T,d); x_prev (B,1,d) previous token of
    the first position. Returns the 5 mixed streams r,k,v,w,g inputs."""
    mu = p["mu"].to(L.ACC)
    xs, sh = x.to(L.ACC), _shift(x, x_prev).to(L.ACC)
    return [(xs + (sh - xs) * mu[i]).to(x.dtype) for i in range(5)]


def _rwkv_projections(p, x, x_prev, H):
    B, T, d = x.shape
    dk = d // H
    mr, mk, mv, mw, mg = _rwkv_mix(p, x, x_prev)
    r = L.dense(p["wr"], mr).reshape(B, T, H, dk)
    kk = L.dense(p["wk"], mk).reshape(B, T, H, dk)
    v = L.dense(p["wv"], mv).reshape(B, T, H, dk)
    g = F.silu(L.dense(p["wg"], mg).to(L.ACC))
    loraw = torch.tanh(L.dense(p["wa"], mw).to(L.ACC))
    wdec = p["w0"].to(L.ACC) + L.dense(p["wb"], loraw.to(x.dtype)).to(L.ACC)
    w = torch.exp(-torch.exp(wdec)).reshape(B, T, H, dk)   # decay in (0,1)
    return r, kk, v, g, w


def _rwkv_step(u, S, r, k, v, w):
    """One step of the recurrence; r, k, v, w (B,H,dk), S (B,H,dk,dv)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, S + u[..., None] * kv)
    return w[..., None] * S + kv, y


def _out(p, x, y, g):
    """Per-head group norm of y (B,T,H,dk), gate, output projection."""
    B, T, d = x.shape
    y = L.layernorm(p["gn"], y.to(x.dtype)).to(L.ACC)
    y = (y.reshape(B, T, d) * g).to(x.dtype)
    return L.dense(p["out"], y)


def rwkv6_full(p, s: SSMConfig, x, plain=False):
    """x (B,T,d) -> (y, state). The recurrence runs in f32 (r, k, v, w cast
    as the reference casts them) through ``kernels.ssm_scan.wkv``, or its
    plain version with ``plain``; its final state is the cache's S."""
    B, T, d = x.shape
    x_prev = torch.zeros((B, 1, d), dtype=L.ACC, device=x.device)
    r, k, v, g, w = _rwkv_projections(p, x, x_prev, s.n_heads)
    args = [a.to(L.ACC).transpose(1, 2) for a in (r, k, v, w)]
    u = p["u"].to(L.ACC)
    y, S = wkv_ref(*args, u) if plain else WKV.wkv(*args, u)
    return _out(p, x, y.transpose(1, 2), g), {
        "S": S, "x_prev": x[:, -1:, :].to(L.ACC)}


def init_rwkv6_state(batch, d_model, s: SSMConfig, device=None):
    H = s.n_heads
    dk = d_model // H
    return {"S": torch.zeros((batch, H, dk, dk), dtype=L.ACC, device=device),
            "x_prev": torch.zeros((batch, 1, d_model), dtype=L.ACC,
                                  device=device)}


def rwkv6_step(p, s: SSMConfig, x1, state):
    """One-token decode through the plain recurrence. x1 (B,1,d)."""
    r, k, v, g, w = _rwkv_projections(p, x1, state["x_prev"], s.n_heads)
    S, y = _rwkv_step(p["u"].to(L.ACC), state["S"],
                      *(a[:, 0].to(L.ACC) for a in (r, k, v, w)))
    return _out(p, x1, y[:, None], g), {"S": S, "x_prev": x1.to(L.ACC)}


# rwkv channel-mix (squared-relu FFN with token shift)
def init_rwkv_cmix(init: L.Init, d_model, d_ff):
    return {"mu": init.uniform((1, d_model)),
            "wk": L.init_dense(init, d_model, d_ff),
            "wv": L.init_dense(init, d_ff, d_model, scale=d_ff ** -0.5)}


def rwkv_cmix(p, x, x_prev):
    mu = p["mu"].to(L.ACC)
    xs = x.to(L.ACC)
    mixed = (xs + (_shift(x, x_prev).to(L.ACC) - xs) * mu).to(x.dtype)
    h = L.dense(p["wk"], mixed).to(L.ACC)
    h = torch.relu(h).square().to(x.dtype)
    return L.dense(p["wv"], h)
