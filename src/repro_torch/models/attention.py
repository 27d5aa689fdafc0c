"""Grouped-query attention with QKV bias, qk-norm, sliding windows, RoPE
and KV caches (full and ring-buffer): the port's copy of
``repro.models.attention``.

Shapes: x (B, S, d_model); q (B, S, H, dh); k/v (B, S, KV, dh).

Causal self-attention over a whole sequence (the prefill) runs through
the hand-written flash-attention kernel (``kernels.flash_attention``),
reading the projections through transposed views. Decode (one query
against the cache) stays the plain grouped ``sdpa``, as in the
reference: the kernel's causal mask has no query offset. ``plain=True``
runs the prefill through ``sdpa`` too: the explicit reference run.

Caches are updated in place (``fill_cache_from_prefill``,
``decode_attention``): the reference returns new arrays, the port writes
the one slot a token adds instead of copying the cache.
Every ported layer is causal self-attention with RoPE: the reference's
non-causal, RoPE-free and cross-attention variants are the enc-dec path
(ROADMAP queue 1 item 14), and ``blockwise_sdpa`` (the
``flags.blockwise_prefill`` path) waits for item 17.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import layers as L

NEG_INF = -1e30


def init_attn(init: L.Init, d_model, a: AttnConfig):
    p = {
        "wq": L.init_dense(init, d_model, a.n_heads * a.d_head, a.qkv_bias),
        "wk": L.init_dense(init, d_model, a.n_kv_heads * a.d_head, a.qkv_bias),
        "wv": L.init_dense(init, d_model, a.n_kv_heads * a.d_head, a.qkv_bias),
        "wo": L.init_dense(init, a.n_heads * a.d_head, d_model, False),
    }
    if a.qk_norm:
        p["qn"] = L.init_rmsnorm(init, a.d_head)
        p["kn"] = L.init_rmsnorm(init, a.d_head)
    return p


def _project_q(p, a: AttnConfig, x, positions):
    B, S, _ = x.shape
    q = L.dense(p["wq"], x).reshape(B, S, a.n_heads, a.d_head)
    if a.qk_norm:
        q = L.rmsnorm(p["qn"], q)
    cos, sin = L.rope_angles(positions, a.d_head, a.rope_theta)
    return L.apply_rope(q, cos, sin)


def _project_kv(p, a: AttnConfig, x, positions):
    B, S, _ = x.shape
    k = L.dense(p["wk"], x).reshape(B, S, a.n_kv_heads, a.d_head)
    v = L.dense(p["wv"], x).reshape(B, S, a.n_kv_heads, a.d_head)
    if a.qk_norm:
        k = L.rmsnorm(p["kn"], k)
    cos, sin = L.rope_angles(positions, a.d_head, a.rope_theta)
    return L.apply_rope(k, cos, sin), v


def sdpa(q, k, v, mask, n_kv):
    """Grouped SDPA. q (B,Sq,H,dh), k/v (B,Skv,KV,dh), mask broadcastable to
    (B, Sq, Skv) or None. Scores in f32; the probabilities are cast to v's
    dtype before P·V, as in the reference."""
    B, Sq, H, dh = q.shape
    G = H // n_kv
    qg = q.reshape(B, Sq, n_kv, G, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(L.ACC), k.to(L.ACC))
    logits = logits * dh ** -0.5
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v).to(q.dtype)
    return out.reshape(B, Sq, H * dh)


def causal_window_mask(s, window, device=None):
    """(s, s) bool mask of a prefill: causal, optionally restricted to a
    local window (query i sees keys j with i - window < j <= i)."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    m = kj <= qi
    if window and window > 0:
        m = m & (kj > qi - window)
    return m


def full_attention(p, a: AttnConfig, x, positions, *, window=0, plain=False):
    """Full-sequence causal self-attention (the prefill), optionally within
    a local ``window``. Returns (y, (k, v)): k/v are the cache material
    (RoPE applied). Runs through ``kernels.flash_attention``, or with
    ``plain`` through the grouped ``sdpa`` under the causal-window mask
    (the reference's own path)."""
    B, S, _ = x.shape
    q = _project_q(p, a, x, positions)
    k, v = _project_kv(p, a, x, positions)
    if plain:
        y = sdpa(q, k, v, causal_window_mask(S, window, x.device)[None],
                 a.n_kv_heads)
    else:
        y = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True, window=window)
        y = y.transpose(1, 2).reshape(B, S, a.n_heads * a.d_head)
    return L.dense(p["wo"], y), (k, v)


# ------------------------------------------------------------------- caches
def init_cache(batch, cache_len, a: AttnConfig, dtype, device=None):
    shp = (batch, cache_len, a.n_kv_heads, a.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def fill_cache_from_prefill(cache, k, v, ring):
    """Write prefill-computed k/v (B, S, KV, dh) into ``cache`` (in place)
    and return it. A ring cache keeps the last W positions at slot
    pos % W."""
    W = cache["k"].shape[1]
    S = k.shape[1]
    if not ring or S <= W:
        n = min(S, W)
        cache["k"][:, :n] = k[:, :n]
        cache["v"][:, :n] = v[:, :n]
        return cache
    slots = torch.arange(S - W, S, device=k.device) % W
    cache["k"][:, slots] = k[:, -W:]
    cache["v"][:, slots] = v[:, -W:]
    return cache


def _slot_positions(pos, W, ring, device=None):
    """Absolute position held by each cache slot after writing token ``pos``.
    Ring slot s holds q = pos - ((pos - s) mod W); full cache slot s holds s."""
    s = torch.arange(W, device=device)
    if not ring:
        return s
    return pos - torch.remainder(pos - s, W)


def decode_attention(p, a: AttnConfig, x1, pos, cache, *, ring=False,
                     window=0):
    """One-token decode. x1 (B, 1, d); ``pos`` the token's position (an
    int); ``cache`` {'k','v'} (B, W, KV, dh). The new k/v is written in
    place at slot ``pos`` (``pos % W`` for a ring cache), and attention
    runs over the valid slots through the plain ``sdpa``.
    Returns (y, cache)."""
    B = x1.shape[0]
    W = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x1.device)
    q = _project_q(p, a, x1, positions)
    k1, v1 = _project_kv(p, a, x1, positions)
    slot = pos % W if ring else pos
    cache["k"][:, slot] = k1[:, 0]
    cache["v"][:, slot] = v1[:, 0]
    spos = _slot_positions(pos, W, ring, x1.device)
    valid = (spos >= 0) & (spos <= pos)
    if window and not ring:
        valid = valid & (spos > pos - window)
    y = sdpa(q, cache["k"], cache["v"], valid[None, None, :], a.n_kv_heads)
    return L.dense(p["wo"], y), cache
