"""Segmented decoder stacks: the port's copy of ``repro.models.stack``.

A model is a list of *segments*; each segment is ``(name, repeats, kinds)``
where ``kinds`` is the tuple of sub-layer kinds making up one repeated body
(e.g. Gemma3's ``(local,)*5 + (global,)`` superblock). Each segment's
parameters are stacked on a leading repeats axis, as in the reference, so
the two packages' parameter trees map one to one; the port runs a body
per repeat in a Python loop where the reference runs ``lax.scan``.

Sub-layer kinds ported here:
  ('attn', 'dense', window)  window=0 => global attention
  ('rwkv',)
The kinds ``('attn', 'moe', w)``, ``('mamba', ffn)``, ``('enc',)`` and
``('dec',)`` raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

_UNPORTED = {
    "moe": "MoE FFN layers: ROADMAP queue 1 item 12 (models/moe.py)",
    "mamba": "mamba layers: ROADMAP queue 1 item 13",
    "enc": "enc-dec layers: ROADMAP queue 1 item 14",
    "dec": "enc-dec layers: ROADMAP queue 1 item 14",
}


def _ported(kind):
    """Raise for a kind the port does not run yet."""
    key = "moe" if kind[0] in ("attn", "mamba") and kind[1] == "moe" else kind[0]
    if key in _UNPORTED:
        raise NotImplementedError(f"{kind}: {_UNPORTED[key]}")
    if kind[0] not in ("attn", "rwkv"):
        raise ValueError(kind)


# ---------------------------------------------------------------- segments
def _tiles(kinds, p):
    return all(kinds[j] == kinds[j % p] for j in range(len(kinds)))


def _group(kinds):
    segs, i, n = [], 0, len(kinds)
    while i < n:
        rem = n - i
        placed = False
        for tail in range(0, min(8, rem)):
            body = rem - tail
            for p in range(1, min(12, body) + 1):
                if body % p == 0 and _tiles(kinds[i:i + body], p):
                    segs.append((f"seg{len(segs)}", body // p,
                                 tuple(kinds[i:i + p])))
                    i += body
                    placed = True
                    break
            if placed:
                break
        if not placed:
            segs.append((f"seg{len(segs)}", 1, (kinds[i],)))
            i += 1
    return segs


def build_segments(cfg: ArchConfig):
    """Per-layer kind list -> grouped segments for the decoder stack."""
    if cfg.layout == "encdec":
        return [("dec", cfg.n_layers, (("dec",),))]
    if cfg.ssm is not None and cfg.attn is None:
        return [("blocks", cfg.n_layers, (("rwkv",),))]
    a = cfg.attn
    kinds = []
    layer_kinds = cfg._layer_kinds()
    for i in range(cfg.n_layers):
        mixer, ffn = layer_kinds[i]
        if mixer == "ssm":
            kinds.append(("mamba", ffn))
        else:
            if a.pattern_period and not cfg.is_global_layer(i):
                w = a.window
            else:
                w = 0 if a.pattern_period else a.window
            kinds.append(("attn", ffn, w))
    return _group(kinds)


# ------------------------------------------------------------------ context
@dataclass
class Ctx:
    mode: str = "full"            # 'full' | 'decode'
    want_cache: bool = False
    cache_len: int = 0
    pos: Optional[int] = None     # decode position
    # The explicit reference run: attention and the RWKV recurrence go
    # through the kernels' plain versions even on CUDA tensors. Only the
    # caller sets it (chip_smoke.py and the card tests); never implied.
    plain_kernels: bool = False


# ------------------------------------------------------------- layer bodies
def init_layer(init: L.Init, cfg: ArchConfig, kind):
    _ported(kind)
    d = cfg.d_model
    if kind[0] == "attn":
        return {"ln1": L.init_norm(init, cfg.norm, d),
                "attn": A.init_attn(init, d, cfg.attn),
                "ln2": L.init_norm(init, cfg.norm, d),
                "ffn": L.init_mlp(init, d, cfg.d_ff, cfg.act)}
    return {"ln1": L.init_layernorm(init, d),
            "tmix": S.init_rwkv6(init, d, cfg.ssm),
            "ln2": L.init_layernorm(init, d),
            "cmix": S.init_rwkv_cmix(init, d, cfg.d_ff)}


def _cache_len(kind, cache_len):
    w = kind[2]
    return min(w, cache_len) if w else cache_len


def init_layer_cache(cfg: ArchConfig, kind, batch, cache_len, dtype,
                     device=None):
    _ported(kind)
    if kind[0] == "attn":
        return A.init_cache(batch, _cache_len(kind, cache_len), cfg.attn,
                            dtype, device)
    st = S.init_rwkv6_state(batch, cfg.d_model, cfg.ssm, device)
    st["cm_prev"] = torch.zeros((batch, 1, cfg.d_model), dtype=L.ACC,
                                device=device)
    return st


def apply_layer_full(cfg: ArchConfig, kind, p, x, ctx: Ctx):
    """Full-sequence sub-layer. Returns (x, cache_entry)."""
    _ported(kind)
    B, Sq, d = x.shape
    cache = {}
    if kind[0] == "attn":
        _, _, w = kind
        positions = torch.arange(Sq, device=x.device).expand(B, Sq)
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        y, (k, v) = A.full_attention(p["attn"], cfg.attn, h, positions,
                                     window=w, plain=ctx.plain_kernels)
        x = x + y
        if ctx.want_cache:
            cache = A.fill_cache_from_prefill(
                A.init_cache(B, _cache_len(kind, ctx.cache_len), cfg.attn,
                             x.dtype, x.device), k, v,
                ring=bool(w) and w < ctx.cache_len)
        h2 = L.apply_norm(cfg.norm, p["ln2"], x)
        return x + L.mlp(p["ffn"], h2, cfg.act), cache
    h = L.layernorm(p["ln1"], x)
    y, st = S.rwkv6_full(p["tmix"], cfg.ssm, h, plain=ctx.plain_kernels)
    x = x + y
    h2 = L.layernorm(p["ln2"], x)
    y2 = S.rwkv_cmix(p["cmix"], h2,
                     torch.zeros((B, 1, d), dtype=L.ACC, device=x.device))
    if ctx.want_cache:
        st["cm_prev"] = h2[:, -1:, :].to(L.ACC)
        cache = st
    return x + y2, cache


def apply_layer_decode(cfg: ArchConfig, kind, p, x1, cache, ctx: Ctx):
    """Single-token sub-layer. Returns (x1, new_cache)."""
    _ported(kind)
    if kind[0] == "attn":
        _, _, w = kind
        ring = bool(w) and cache["k"].shape[1] < ctx.cache_len
        h = L.apply_norm(cfg.norm, p["ln1"], x1)
        y, cache = A.decode_attention(p["attn"], cfg.attn, h, ctx.pos, cache,
                                      ring=ring, window=w)
        x1 = x1 + y
        h2 = L.apply_norm(cfg.norm, p["ln2"], x1)
        return x1 + L.mlp(p["ffn"], h2, cfg.act), cache
    h = L.layernorm(p["ln1"], x1)
    tm_state = {"S": cache["S"], "x_prev": cache["x_prev"]}
    y, tm_state = S.rwkv6_step(p["tmix"], cfg.ssm, h, tm_state)
    x1 = x1 + y
    h2 = L.layernorm(p["ln2"], x1)
    y2 = S.rwkv_cmix(p["cmix"], h2, cache["cm_prev"])
    new_cache = {"S": tm_state["S"], "x_prev": tm_state["x_prev"],
                 "cm_prev": h2.to(L.ACC)}
    return x1 + y2, new_cache


# ----------------------------------------------------------- segment runner
def _index(tree, r):
    """Repeat ``r`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _write(dst, src):
    """Copy ``src``'s leaves into the matching views of ``dst`` (in place),
    skipping leaves that already are those views."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


def init_segment_params(init: L.Init, cfg, kinds, repeats):
    """One segment's parameters, each stacked on a leading repeats axis."""
    stacked = L.Init(init.gen, init.dtype, init.device, (repeats,))
    return {f"s{j}": init_layer(stacked, cfg, kind)
            for j, kind in enumerate(kinds)}


def init_segment_cache(cfg, kinds, repeats, batch, cache_len, dtype,
                       device=None):
    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return t.expand((repeats,) + t.shape).clone()
    return {f"s{j}": stack(init_layer_cache(cfg, kind, batch, cache_len,
                                            dtype, device))
            for j, kind in enumerate(kinds)}


def _stack_like(entry, repeats):
    if isinstance(entry, dict):
        return {k: _stack_like(v, repeats) for k, v in entry.items()}
    return entry.new_empty((repeats,) + entry.shape)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def apply_segment(cfg, kinds, params, x, cache, ctx: Ctx):
    """Run one segment, repeat by repeat. In decode mode ``cache`` (stacked
    like the parameters) is updated in place; in full mode with
    ``ctx.want_cache`` a new stacked cache is built. Returns
    (x, cache or None)."""
    decode = ctx.mode == "decode"
    reps = _first_leaf(params).shape[0]
    out = {}
    for r in range(reps):
        p = _index(params, r)
        for j, kind in enumerate(kinds):
            name = f"s{j}"
            if decode:
                cj = _index(cache[name], r)
                x, new = apply_layer_decode(cfg, kind, p[name], x, cj, ctx)
                _write(cj, new)
            else:
                x, new = apply_layer_full(cfg, kind, p[name], x, ctx)
                if ctx.want_cache:
                    if name not in out:
                        out[name] = _stack_like(new, reps)
                    _write(_index(out[name], r), new)
    if decode:
        return x, cache
    return x, (out if ctx.want_cache else None)
