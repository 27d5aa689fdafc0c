"""Grouped-query attention with QKV bias, qk-norm, sliding windows, RoPE,
KV caches (full and ring-buffer) and cross-attention (enc-dec): the
port's copy of ``repro.models.attention``.

Shapes: x (B, S, d_model); q (B, S, H, dh); k/v (B, S, KV, dh).

Every attention over a whole sequence (the prefill, every attention of a
training step, the enc-dec model's encoder and its cross-attention to the
encoder's frames) runs through the hand-written flash-attention kernel
(``kernels.flash_attention``), causal or not as the layer is, reading
the projections through transposed views; when the projections require a
gradient, its backward is the hand-written backward kernel. RoPE is
applied where ``use_rope`` says (the enc-dec layers use none). The kernel
is blockwise by construction (it never holds the Sq × Skv scores), so
the ``blockwise`` flag does not change the kernel path. Decode (one
query against the cache) stays the plain grouped ``sdpa``, as in the
reference: the kernel's causal mask has no query offset. ``plain=True``
runs the full-sequence attention through ``sdpa`` too (the explicit
reference run); with ``blockwise``, a causal call on the plain path
(``plain`` or a CPU tensor) takes ``blockwise_sdpa``, the reference's
query-chunked path (a non-causal one never does, as in the reference).

Caches are updated in place (``fill_cache_from_prefill``,
``decode_attention``): the reference returns new arrays, the port writes
the one slot a token adds instead of copying the cache. A cross-attention
cache (the encoder's K/V) is only read.
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


def _project_q(p, a: AttnConfig, x, positions, use_rope=True):
    B, S, _ = x.shape
    q = L.dense(p["wq"], x).reshape(B, S, a.n_heads, a.d_head)
    if a.qk_norm:
        q = L.rmsnorm(p["qn"], q)
    if use_rope:
        cos, sin = L.rope_angles(positions, a.d_head, a.rope_theta)
        q = L.apply_rope(q, cos, sin)
    return q


def _project_kv(p, a: AttnConfig, x, positions, use_rope=True):
    B, S, _ = x.shape
    k = L.dense(p["wk"], x).reshape(B, S, a.n_kv_heads, a.d_head)
    v = L.dense(p["wv"], x).reshape(B, S, a.n_kv_heads, a.d_head)
    if a.qk_norm:
        k = L.rmsnorm(p["kn"], k)
    if use_rope:
        cos, sin = L.rope_angles(positions, a.d_head, a.rope_theta)
        k = L.apply_rope(k, cos, sin)
    return k, v


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


def causal_window_mask(s, window, device=None, skv=None):
    """(s, skv) bool mask of a prefill (skv defaults to s): causal,
    optionally restricted to a local window (query i sees keys j with
    i - window < j <= i)."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s if skv is None else skv, device=device)[None, :]
    m = kj <= qi
    if window and window > 0:
        m = m & (kj > qi - window)
    return m


def full_attention(p, a: AttnConfig, x, positions, *, causal=True, window=0,
                   use_rope=True, kv_x=None, kv_positions=None, plain=False,
                   blockwise=False, q_chunk=512):
    """Full-sequence attention (the prefill and training; the enc-dec
    model's encoder and cross-attention), causal or not, optionally within
    a local ``window``, with RoPE where ``use_rope``. Cross-attention:
    ``kv_x`` (the encoder's states, B × Skv × d) and ``kv_positions``
    give the keys and values. Returns (y, (k, v)): k/v are the cache
    material (RoPE applied). Runs through ``kernels.flash_attention``
    (blockwise by construction, whatever ``blockwise`` says), or with
    ``plain`` through the grouped ``sdpa`` under the reference's mask
    (causal-window, or none when not causal). ``blockwise`` on a causal
    call on the plain path (``plain`` or a CPU tensor) takes
    ``blockwise_sdpa`` in query chunks of ``q_chunk``."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    src_pos = positions if kv_positions is None else kv_positions
    q = _project_q(p, a, x, positions, use_rope)
    k, v = _project_kv(p, a, src, src_pos, use_rope)
    if causal and blockwise and (plain or x.device.type == "cpu"):
        y = blockwise_sdpa(q, k, v, a.n_kv_heads, causal=True, window=window,
                           q_chunk=q_chunk)
    elif plain:
        mask = (causal_window_mask(S, window, x.device, src.shape[1])[None]
                if causal else None)
        y = sdpa(q, k, v, mask, a.n_kv_heads)
    else:
        y = FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window)
        y = y.transpose(1, 2).reshape(B, S, a.n_heads * a.d_head)
    return L.dense(p["wo"], y), (k, v)


def blockwise_sdpa(q, k, v, n_kv, *, causal=True, window=0, q_chunk=512):
    """Memory-bounded attention (the reference's ``blockwise_sdpa``): a loop
    over query chunks, so scores are (B, KV, G, qc, Skv) instead of
    (…, Sq, Skv). For sliding-window layers each chunk reads only the
    (qc + W) kv slice it can see. The same softmax and masking as ``sdpa``
    with the causal-window mask. Returns (B, Sq, H·dh)."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    qc = min(q_chunk, Sq)
    if Sq % qc:
        qc = next(c for c in range(qc, 0, -1) if Sq % c == 0)
    use_slice = bool(window) and window + qc < Skv
    if use_slice:
        # pad kv by W in front so slice [q_lo, q_lo + qc + W) covers
        # positions q_lo - W … q_lo + qc - 1 with in-bounds indices.
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, window, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, window, 0))
    ys = []
    for q_lo in range(0, Sq, qc):
        if use_slice:
            k_c = kp[:, q_lo:q_lo + qc + window]
            v_c = vp[:, q_lo:q_lo + qc + window]
            kj = q_lo - window + torch.arange(qc + window, device=q.device)
        else:
            k_c, v_c = k, v
            kj = torch.arange(Skv, device=q.device)
        kj = kj[None, :]
        qi = q_lo + torch.arange(qc, device=q.device)[:, None]
        mask = kj >= 0
        if causal:
            mask = mask & (kj <= qi)
        if window:
            mask = mask & (kj > qi - window)
        ys.append(sdpa(q[:, q_lo:q_lo + qc], k_c, v_c, mask[None], n_kv))
    return torch.cat(ys, dim=1)


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
                     window=0, use_rope=True, cross=False):
    """One-token decode. x1 (B, 1, d); ``pos`` the token's position (an
    int); ``cache`` {'k','v'} (B, W, KV, dh). Self-attention writes the
    new k/v in place at slot ``pos`` (``pos % W`` for a ring cache) and
    attends over the valid slots; cross-attention (``cross``) reads the
    encoder's K/V cache, every slot valid, and never writes it. Attention
    runs through the plain ``sdpa``. Returns (y, cache)."""
    B = x1.shape[0]
    W = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x1.device)
    q = _project_q(p, a, x1, positions, use_rope)
    if cross:
        y = sdpa(q, cache["k"], cache["v"], None, a.n_kv_heads)
        return L.dense(p["wo"], y), cache
    k1, v1 = _project_kv(p, a, x1, positions, use_rope)
    slot = pos % W if ring else pos
    cache["k"][:, slot] = k1[:, 0]
    cache["v"][:, slot] = v1[:, 0]
    spos = _slot_positions(pos, W, ring, x1.device)
    valid = (spos >= 0) & (spos <= pos)
    if window and not ring:
        valid = valid & (spos > pos - window)
    y = sdpa(q, cache["k"], cache["v"], valid[None, None, :], a.n_kv_heads)
    return L.dense(p["wo"], y), cache
