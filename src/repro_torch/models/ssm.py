"""State-space sequence mixers: Mamba (selective SSM, Jamba's mixer) and
RWKV6 'Finch' (data-dependent per-channel decay, matrix state per head),
with RWKV6's channel-mix: the port of ``repro.models.ssm``.

Mamba's full-sequence path is the reference's chunked time scan
(``chunked_time_scan``): a Python loop over time in chunks of at most
128 steps, each chunk under ``layers.remat`` when a gradient is being
recorded (the reference checkpoints ``run_chunk``), so the backward
keeps one state per chunk and recomputes the chunk's steps. The
reference runs the scan as ``lax.scan`` outside any Pallas kernel, so
here it is plain PyTorch: a few elementwise launches per step, host-bound
by design. Decode is the one-step recurrence over the carried state
(``h`` and the last ``d_conv − 1`` rows of the conv input).

RWKV6's full-sequence path (the prefill, and every time-mix of a
training step) runs the recurrence through the hand-written wkv kernel
(``kernels.ssm_scan``), which returns the final state the decode resumes
from; when its inputs require a gradient, its backward is the
hand-written wkv backward kernel (the final state gets none: training
leaves it unused). ``plain=True`` runs it through the plain version
instead (the explicit reference run, differentiated by autograd). The
decode path is the plain one-step recurrence over the carried state, as
in the reference.

The reference's sharding hints (``_hint``) have no counterpart on one
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssm_scan import ops as WKV
from repro_torch.kernels.ssm_scan.ref import wkv_ref
from repro_torch.models import layers as L

_checkpoint = L.remat


def _pick_chunk(T, target=128):
    if T <= target:
        return T
    c = target
    while T % c:
        c //= 2
    return max(c, 1)


def _run_chunk(step, state, *xs):
    ys = []
    for t in range(xs[0].shape[0]):
        state, y = step(state, tuple(a[t] for a in xs))
        ys.append(y)
    return state, torch.stack(ys)


def chunked_time_scan(step, state, xs, chunk=128):
    """Scan ``step(state, x_t) -> (state, y_t)`` over the time-major tuple
    ``xs`` (each (T, ...)) in chunks of ``_pick_chunk(T, chunk)`` steps,
    each chunk checkpointed while a gradient is recorded. Returns (state,
    ys (T, ...))."""
    T = xs[0].shape[0]
    c = _pick_chunk(T, chunk)
    remat = torch.is_grad_enabled()
    ys = []
    for lo in range(0, T, c):
        xc = tuple(a[lo:lo + c] for a in xs)
        state, yc = (_checkpoint(_run_chunk, step, state, *xc) if remat
                     else _run_chunk(step, state, *xc))
        ys.append(yc)
    return state, torch.cat(ys)


# ======================================================================
# Mamba (selective SSM) — Jamba's non-attention mixer
# ======================================================================
def init_mamba(init: L.Init, d_model, s: SSMConfig):
    di = s.expand * d_model
    N = s.d_state
    log_n = torch.log(torch.arange(1, N + 1, dtype=L.ACC,
                                   device=init.device)).to(init.dtype)
    return {
        "in_x": L.init_dense(init, d_model, di),
        "in_z": L.init_dense(init, d_model, di),
        "conv": init.normal((s.d_conv, di), 0.2),
        "x_bc": L.init_dense(init, di, 2 * N),
        "x_dt": L.init_dense(init, di, 1),  # broadcast dt (rank-1 stand-in)
        "dt_bias": init.full((di,), -4.6),  # softplus^-1(0.01)
        "A_log": init.full((di, N), 0.0) + log_n,
        "D": init.full((di,), 1.0),
        "out": L.init_dense(init, di, d_model, scale=di ** -0.5),
    }


def _mamba_conv_full(p, x):
    """Causal depthwise conv over (B, T, di): the reference's
    ``conv_general_dilated`` (a cross-correlation, left padding
    d_conv − 1, one group per channel) as d_conv shifted products."""
    w = p["conv"].to(L.ACC)              # (d_conv, di)
    dc, T = w.shape[0], x.shape[1]
    xp = F.pad(x.to(L.ACC), (0, 0, dc - 1, 0))
    out = xp[:, 0:T] * w[0]
    for j in range(1, dc):
        out = out + xp[:, j:j + T] * w[j]
    return out.to(x.dtype)


def _mamba_scan_inputs(p, s: SSMConfig, xc):
    """Projection of conv output to per-step SSM tensors."""
    bc = L.dense(p["x_bc"], xc).to(L.ACC)                  # (B,T,2N)
    Bt, Ct = bc.chunk(2, dim=-1)
    dt = F.softplus(L.dense(p["x_dt"], xc).to(L.ACC)
                    + p["dt_bias"].to(L.ACC))               # (B,T,di)
    A = -torch.exp(p["A_log"].to(L.ACC))                    # (di, N)
    return dt, Bt, Ct, A


def _mamba_step(A, D):
    def step(h, inputs):
        xt, dt, Bt, Ct = inputs            # (B,di), (B,di), (B,N), (B,N)
        decay = torch.exp(dt[..., None] * A)               # (B,di,N)
        h = decay * h + (dt * xt)[..., None] * Bt[:, None, :]
        y = torch.sum(h * Ct[:, None, :], dim=-1) + D * xt
        return h, y
    return step


def mamba_full(p, s: SSMConfig, x, chunk=128):
    """x (B,T,d) -> (y (B,T,d), state {"h" (B,di,N), "conv"})."""
    B, T, d = x.shape
    xi = L.dense(p["in_x"], x)
    z = L.dense(p["in_z"], x)
    xc = F.silu(_mamba_conv_full(p, xi).to(L.ACC)).to(x.dtype)
    dt, Bt, Ct, A = _mamba_scan_inputs(p, s, xc)
    di = xi.shape[-1]
    h0 = torch.zeros((B, di, s.d_state), dtype=L.ACC, device=x.device)
    xs = tuple(a.movedim(1, 0) for a in (xc.to(L.ACC), dt, Bt, Ct))
    h, ys = chunked_time_scan(_mamba_step(A, p["D"].to(L.ACC)), h0, xs, chunk)
    y = ys.movedim(0, 1).to(x.dtype)                        # (B,T,di)
    y = y * F.silu(z.to(L.ACC)).to(x.dtype)
    return L.dense(p["out"], y), {
        "h": h, "conv": xi[:, -(s.d_conv - 1):, :].to(L.ACC)}


def init_mamba_state(batch, d_model, s: SSMConfig, device=None):
    di = s.expand * d_model
    return {"h": torch.zeros((batch, di, s.d_state), dtype=L.ACC,
                             device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, di), dtype=L.ACC,
                                device=device)}


def mamba_step(p, s: SSMConfig, x1, state):
    """One-token decode. x1 (B,1,d)."""
    xi = L.dense(p["in_x"], x1)                             # (B,1,di)
    z = L.dense(p["in_z"], x1)
    hist = torch.cat([state["conv"], xi.to(L.ACC)], dim=1)  # (B,dc,di)
    xc = torch.einsum("bcd,cd->bd", hist, p["conv"].to(L.ACC))
    xc = F.silu(xc).to(x1.dtype)[:, None, :]                # (B,1,di)
    dt, Bt, Ct, A = _mamba_scan_inputs(p, s, xc)
    step = _mamba_step(A, p["D"].to(L.ACC))
    h, y = step(state["h"], (xc[:, 0].to(L.ACC), dt[:, 0], Bt[:, 0],
                             Ct[:, 0]))
    y = y[:, None, :].to(x1.dtype) * F.silu(z.to(L.ACC)).to(x1.dtype)
    return L.dense(p["out"], y), {"h": h, "conv": hist[:, 1:]}


# ======================================================================
# RWKV6 'Finch' — data-dependent decay, matrix state per head
# ======================================================================
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
