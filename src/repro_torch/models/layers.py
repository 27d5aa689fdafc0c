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
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ACC = torch.float32  # accumulation dtype

# ``jax.checkpoint``'s counterpart: non-reentrant, so checkpoints nest and
# closures over parameters get their gradients; nothing in a layer draws
# random numbers.
remat = partial(checkpoint, use_reentrant=False, preserve_rng_state=False)


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


def matmul_acc(x, w):
    """``x @ w`` (x (..., k), w (k, n)) with an f32 result from operands
    of any dtype: the reference's ``preferred_element_type=ACC``. f32
    operands take the plain product. Otherwise a CUDA or ``meta`` product
    outside autograd is ``torch.mm(..., out_dtype=f32)`` (bf16 operands,
    f32 accumulation and output, no f32 copy of w); the CPU, which has
    no such product, and autograd, which has no derivative for it,
    multiply f32 copies (exact: a product of two bf16 values is an f32
    value)."""
    if x.dtype == ACC and w.dtype == ACC:
        return x @ w
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.device.type == "cpu" or grad:
        return x.to(ACC) @ w.to(ACC)
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=ACC)
    return y.reshape(x.shape[:-1] + w.shape[-1:])


def dense(p, x):
    """``x @ w`` (+ b), in x's dtype. A plain product: the reference
    leaves it to XLA, the port to cuBLAS (TF32 off). With a bias, as in
    the reference, the bias is added to the f32 product and the sum
    rounded once to x's dtype."""
    if "b" in p:
        return (matmul_acc(x, p["w"]) + p["b"].to(ACC)).to(x.dtype)
    return x @ p["w"]


# ---------------------------------------------------------------- embeddings
def init_embedding(init: Init, vocab, d):
    return {"table": init.normal((vocab, d), 0.02)}


def embed(p, ids):
    """Rows ``ids`` of the table. ``F.embedding``, not indexing: its
    backward sums repeated ids deterministically (indexing's backward
    accumulates in an order that changes from run to run), so a training
    step is reproducible bit for bit."""
    return F.embedding(ids, p["table"])


def unembed(p, x):
    """Tied unembedding: (..., d) @ (vocab, d)^T, f32 logits accumulated
    in f32 from operands of any dtype (``matmul_acc``)."""
    return matmul_acc(x, p["table"].mT)


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
