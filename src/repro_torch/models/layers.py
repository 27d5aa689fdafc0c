"""Primitive neural layers in PyTorch: norms, dense, embeddings, RoPE,
MLPs (the port's copy of ``repro.models.layers``).

Parameters are plain dicts of tensors with the reference's keys and
layouts (``dense`` keeps the (d_in, d_out) weight). ``init_*`` functions
build them from an ``Init`` (generator, dtype, device and the leading
shape of stacked layers); the apply functions consume them. Statistics
and softmax-adjacent math run in f32 (``ACC``), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

ACC = torch.float32  # accumulation dtype


@dataclass(frozen=True)
class Init:
    """Where and how parameters are drawn: the reference's distributions
    from ``gen`` (a seeded ``torch.Generator`` on ``device``), stored in
    ``dtype``, each with the leading shape ``lead`` (the repeats axis of a
    stacked segment). On the ``meta`` device nothing is drawn: the tree
    holds shapes only."""
    gen: torch.Generator | None
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    lead: tuple = ()

    def _gen(self):
        return None if self.device.type == "meta" else self.gen

    def normal(self, shape, scale):
        t = torch.randn(self.lead + tuple(shape), generator=self._gen(),
                        device=self.device, dtype=ACC)
        return t.mul_(scale).to(self.dtype)

    def uniform(self, shape):
        return torch.rand(self.lead + tuple(shape), generator=self._gen(),
                          device=self.device, dtype=ACC).to(self.dtype)

    def full(self, shape, value):
        return torch.full(self.lead + tuple(shape), value, dtype=self.dtype,
                          device=self.device)


# --------------------------------------------------------------------- norms
def init_rmsnorm(init: Init, d):
    return {"scale": init.full((d,), 1.0)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.to(ACC)
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(ACC)).to(x.dtype)


def init_layernorm(init: Init, d):
    return {"scale": init.full((d,), 1.0), "bias": init.full((d,), 0.0)}


def layernorm(p, x, eps=1e-5):
    xf = x.to(ACC)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].to(ACC) + p["bias"].to(ACC)).to(x.dtype)


def init_norm(init: Init, kind, d):
    return init_rmsnorm(init, d) if kind == "rmsnorm" else init_layernorm(init, d)


def apply_norm(kind, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# --------------------------------------------------------------------- dense
def init_dense(init: Init, d_in, d_out, bias=False, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": init.normal((d_in, d_out), scale)}
    if bias:
        p["b"] = init.full((d_out,), 0.0)
    return p


def dense(p, x):
    """``x @ w`` (+ b in f32), in x's dtype. A plain product: the reference
    leaves it to XLA, the port to cuBLAS (TF32 off)."""
    y = x @ p["w"]
    if "b" in p:
        y = (y.to(ACC) + p["b"].to(ACC)).to(x.dtype)
    return y


# ---------------------------------------------------------------- embeddings
def init_embedding(init: Init, vocab, d):
    return {"table": init.normal((vocab, d), 0.02)}


def embed(p, ids):
    return p["table"][ids]


def unembed(p, x):
    """Tied unembedding: (..., d) @ (vocab, d)^T, f32 logits."""
    return (x @ p["table"].mT).to(ACC)


def sinusoidal_positions(positions, d, base=10000.0):
    """positions: int tensor (...,) -> (..., d) sinusoidal embedding, f32
    (the enc-dec decoder's positions)."""
    half = d // 2
    freqs = torch.exp(-torch.log(torch.tensor(base, dtype=ACC))
                      * torch.arange(half, dtype=ACC) / half)
    ang = positions.to(ACC)[..., None] * freqs.to(positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------- rope
def rope_angles(positions, d_head, theta):
    """positions (...,) int -> cos, sin (..., d_head//2), f32."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(half, dtype=ACC, device=positions.device)
                      / half)
    ang = positions.to(ACC)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., seq, heads, d_head); cos/sin: (..., seq, d_head//2). The
    half-split convention: (x1, x2) -> (x1 c - x2 s, x2 c + x1 s)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(ACC), x[..., half:].to(ACC)
    c = cos[..., None, :]  # broadcast over the heads axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------------------ mlp
def init_mlp(init: Init, d, d_ff, act, bias=False):
    if act == "swiglu":
        return {"wg": init_dense(init, d, d_ff, bias),
                "wu": init_dense(init, d, d_ff, bias),
                "wd": init_dense(init, d_ff, d, bias)}
    return {"wu": init_dense(init, d, d_ff, bias),
            "wd": init_dense(init, d_ff, d, bias)}


def mlp(p, x, act):
    """SwiGLU, or GELU with the tanh approximation (``jax.nn.gelu``'s
    default)."""
    if act == "swiglu":
        g = dense(p["wg"], x)
        u = dense(p["wu"], x)
        h = F.silu(g.to(ACC)).to(x.dtype) * u
    else:
        u = dense(p["wu"], x)
        h = F.gelu(u.to(ACC), approximate="tanh").to(x.dtype)
    return dense(p["wd"], h)
