"""Segmented decoder stacks: the port's copy of ``repro.models.stack``.

A model is a list of *segments*; each segment is ``(name, repeats, kinds)``
where ``kinds`` is the tuple of sub-layer kinds making up one repeated body
(e.g. Gemma3's ``(local,)*5 + (global,)`` superblock). Each segment's
parameters are stacked on a leading repeats axis, as in the reference, so
the two packages' parameter trees map one to one; the port runs a body
per repeat in a Python loop where the reference runs ``lax.scan``.

Sub-layer kinds:
  ('attn', ffn, window)  window=0 => global attention
  ('mamba', ffn)
  ('rwkv',)
  ('enc',)               whisper encoder layer (bidirectional, no RoPE)
  ('dec',)               whisper decoder layer (causal self-attention,
                         then cross-attention to the encoder's output)
ffn ∈ {'dense', 'moe'}. An encoder runs its own segments
(``encoder_segments``); the decoder's layers read the encoder's output
from ``Ctx.enc``. Any other kind raises ``ValueError``.

Training: with ``Ctx.remat`` each repeat's body runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
after the forward and recomputed in the backward, as the reference's
``jax.checkpoint`` does. So in a step with remat the forward kernels
(flash attention, wkv) launch twice per call site (the forward, then the
recompute) and their backward kernels once. ``flags.nested_remat_group``
= g > 1 checkpoints groups of g checkpointed repeats, on the reference's
condition (full mode, no cache, g divides the repeats and is smaller);
then a layer's forward runs three times. Every layer also returns the
auxiliary losses {"lb", "z"} (nonzero on a MoE FFN layer, zero
elsewhere), summed over the segment; decode drops them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import flags
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

KINDS = ("attn", "mamba", "rwkv", "enc", "dec")


def _known(kind):
    if kind[0] not in KINDS:
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


def encoder_segments(cfg: ArchConfig):
    return [("enc", cfg.n_encoder_layers, (("enc",),))]


def attention_calls(cfg: ArchConfig):
    """Full-sequence attentions in one forward (each a flash launch on the
    card): one per attention and encoder layer, two per decoder layer
    (self and cross)."""
    per_kind = {"attn": 1, "enc": 1, "dec": 2}
    segs = build_segments(cfg) + (encoder_segments(cfg)
                                  if cfg.layout == "encdec" else [])
    return sum(reps * per_kind.get(kind[0], 0)
               for _, reps, body in segs for kind in body)


# ------------------------------------------------------------------ context
@dataclass
class Ctx:
    mode: str = "full"            # 'full' | 'decode'
    want_cache: bool = False
    cache_len: int = 0
    pos: Optional[int] = None     # decode position
    enc: Optional[torch.Tensor] = None   # encoder output (cross-attention)
    # The explicit reference run: attention and the RWKV recurrence go
    # through the kernels' plain versions even on CUDA tensors. Only the
    # caller sets it (chip_smoke.py and the card tests); never implied.
    plain_kernels: bool = False
    remat: bool = False           # checkpoint each repeat (training)


def _zero_aux(device):
    return {"lb": torch.zeros((), dtype=L.ACC, device=device),
            "z": torch.zeros((), dtype=L.ACC, device=device)}


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


_checkpoint = L.remat


# ------------------------------------------------------------- layer bodies
def _init_ffn(init: L.Init, cfg: ArchConfig, ffn):
    d = cfg.d_model
    if ffn == "moe":
        return M.init_moe(init, d, cfg.moe, cfg.d_ff, cfg.act)
    return L.init_mlp(init, d, cfg.d_ff, cfg.act)


def init_layer(init: L.Init, cfg: ArchConfig, kind):
    _known(kind)
    d = cfg.d_model
    if kind[0] == "enc":
        return {"ln1": L.init_layernorm(init, d),
                "attn": A.init_attn(init, d, cfg.attn),
                "ln2": L.init_layernorm(init, d),
                "ffn": L.init_mlp(init, d, cfg.d_ff, "gelu", bias=True)}
    if kind[0] == "dec":
        return {"ln1": L.init_layernorm(init, d),
                "self": A.init_attn(init, d, cfg.attn),
                "ln_x": L.init_layernorm(init, d),
                "cross": A.init_attn(init, d, cfg.attn),
                "ln2": L.init_layernorm(init, d),
                "ffn": L.init_mlp(init, d, cfg.d_ff, "gelu", bias=True)}
    if kind[0] in ("attn", "mamba"):
        name, mixer = (("attn", A.init_attn(init, d, cfg.attn))
                       if kind[0] == "attn" else
                       ("mixer", S.init_mamba(init, d, cfg.ssm)))
        return {"ln1": L.init_norm(init, cfg.norm, d), name: mixer,
                "ln2": L.init_norm(init, cfg.norm, d),
                "ffn": _init_ffn(init, cfg, kind[1])}
    return {"ln1": L.init_layernorm(init, d),
            "tmix": S.init_rwkv6(init, d, cfg.ssm),
            "ln2": L.init_layernorm(init, d),
            "cmix": S.init_rwkv_cmix(init, d, cfg.d_ff)}


def _cache_len(kind, cache_len):
    w = kind[2]
    return min(w, cache_len) if w else cache_len


def init_layer_cache(cfg: ArchConfig, kind, batch, cache_len, dtype,
                     device=None, *, enc_len=0):
    """One layer's zero cache; a decoder layer's is {"self", "cross"}, the
    cross cache ``enc_len`` long. An encoder layer keeps none."""
    _known(kind)
    if kind[0] == "enc":
        raise ValueError(f"{kind}: an encoder layer keeps no cache")
    if kind[0] == "dec":
        return {"self": A.init_cache(batch, cache_len, cfg.attn, dtype,
                                     device),
                "cross": A.init_cache(batch, enc_len, cfg.attn, dtype,
                                      device)}
    if kind[0] == "attn":
        return A.init_cache(batch, _cache_len(kind, cache_len), cfg.attn,
                            dtype, device)
    if kind[0] == "mamba":
        return S.init_mamba_state(batch, cfg.d_model, cfg.ssm, device)
    st = S.init_rwkv6_state(batch, cfg.d_model, cfg.ssm, device)
    st["cm_prev"] = torch.zeros((batch, 1, cfg.d_model), dtype=L.ACC,
                                device=device)
    return st


def _apply_ffn(p, cfg: ArchConfig, ffn, x):
    """The FFN sub-layer: (y, {"lb", "z"})."""
    if ffn == "moe":
        y, lb, z = M.moe_apply(p, x, cfg.moe, cfg.act)
        return y, {"lb": lb, "z": z}
    return L.mlp(p, x, cfg.act), _zero_aux(x.device)


def apply_layer_full(cfg: ArchConfig, kind, p, x, ctx: Ctx):
    """Full-sequence sub-layer. Returns (x, cache_entry, aux)."""
    _known(kind)
    B, Sq, d = x.shape
    cache = {}
    positions = torch.arange(Sq, device=x.device).expand(B, Sq)
    if kind[0] in ("enc", "dec"):
        return _apply_encdec_full(cfg, kind, p, x, positions, ctx)
    if kind[0] == "attn":
        _, ffn, w = kind
        f = flags.get()
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        y, (k, v) = A.full_attention(p["attn"], cfg.attn, h, positions,
                                     window=w, plain=ctx.plain_kernels,
                                     blockwise=(f.blockwise_prefill
                                                and Sq >= 2048),
                                     q_chunk=f.q_chunk)
        x = x + y
        if ctx.want_cache:
            cache = A.fill_cache_from_prefill(
                A.init_cache(B, _cache_len(kind, ctx.cache_len), cfg.attn,
                             x.dtype, x.device), k, v,
                ring=bool(w) and w < ctx.cache_len)
        h2 = L.apply_norm(cfg.norm, p["ln2"], x)
        y2, aux = _apply_ffn(p["ffn"], cfg, ffn, h2)
        return x + y2, cache, aux
    if kind[0] == "mamba":
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        y, state = S.mamba_full(p["mixer"], cfg.ssm, h)
        x = x + y
        if ctx.want_cache:
            cache = state
        h2 = L.apply_norm(cfg.norm, p["ln2"], x)
        y2, aux = _apply_ffn(p["ffn"], cfg, kind[1], h2)
        return x + y2, cache, aux
    h = L.layernorm(p["ln1"], x)
    y, st = S.rwkv6_full(p["tmix"], cfg.ssm, h, plain=ctx.plain_kernels)
    x = x + y
    h2 = L.layernorm(p["ln2"], x)
    y2 = S.rwkv_cmix(p["cmix"], h2,
                     torch.zeros((B, 1, d), dtype=L.ACC, device=x.device))
    if ctx.want_cache:
        st["cm_prev"] = h2[:, -1:, :].to(L.ACC)
        cache = st
    return x + y2, cache, _zero_aux(x.device)


def _apply_encdec_full(cfg: ArchConfig, kind, p, x, positions, ctx: Ctx):
    """An encoder layer (non-causal self-attention) or a decoder layer
    (causal self-attention, then cross-attention from its tokens to
    ``ctx.enc``), neither with RoPE, each with a biased GELU MLP. A
    decoder layer's prefill cache holds its self K/V in a ``cache_len``
    cache and the encoder's projected K/V as its cross cache."""
    B = x.shape[0]
    a, plain = cfg.attn, ctx.plain_kernels
    cache = {}
    h = L.layernorm(p["ln1"], x)
    if kind[0] == "enc":
        y, _ = A.full_attention(p["attn"], a, h, positions, causal=False,
                                use_rope=False, plain=plain)
        x = x + y
    else:
        y, (k, v) = A.full_attention(p["self"], a, h, positions,
                                     causal=True, use_rope=False,
                                     plain=plain)
        x = x + y
        hx = L.layernorm(p["ln_x"], x)
        n_frames = ctx.enc.shape[1]
        enc_pos = torch.arange(n_frames, device=x.device).expand(B, n_frames)
        yx, (ck, cv) = A.full_attention(p["cross"], a, hx, positions,
                                        causal=False, use_rope=False,
                                        kv_x=ctx.enc, kv_positions=enc_pos,
                                        plain=plain)
        x = x + yx
        if ctx.want_cache:
            cache = {"self": A.fill_cache_from_prefill(
                A.init_cache(B, ctx.cache_len, a, x.dtype, x.device), k, v,
                False), "cross": {"k": ck, "v": cv}}
    h2 = L.layernorm(p["ln2"], x)
    return x + L.mlp(p["ffn"], h2, "gelu"), cache, _zero_aux(x.device)


def apply_layer_decode(cfg: ArchConfig, kind, p, x1, cache, ctx: Ctx):
    """Single-token sub-layer. Returns (x1, new_cache)."""
    _known(kind)
    if kind[0] == "enc":
        raise ValueError(f"{kind}: an encoder layer has no decode step")
    if kind[0] == "dec":
        h = L.layernorm(p["ln1"], x1)
        y, self_c = A.decode_attention(p["self"], cfg.attn, h, ctx.pos,
                                       cache["self"], use_rope=False)
        x1 = x1 + y
        hx = L.layernorm(p["ln_x"], x1)
        yx, cross_c = A.decode_attention(p["cross"], cfg.attn, hx, ctx.pos,
                                         cache["cross"], use_rope=False,
                                         cross=True)
        x1 = x1 + yx
        h2 = L.layernorm(p["ln2"], x1)
        return (x1 + L.mlp(p["ffn"], h2, "gelu"),
                {"self": self_c, "cross": cross_c})
    if kind[0] in ("attn", "mamba"):
        h = L.apply_norm(cfg.norm, p["ln1"], x1)
        if kind[0] == "attn":
            w = kind[2]
            ring = bool(w) and cache["k"].shape[1] < ctx.cache_len
            y, cache = A.decode_attention(p["attn"], cfg.attn, h, ctx.pos,
                                          cache, ring=ring, window=w)
        else:
            y, cache = S.mamba_step(p["mixer"], cfg.ssm, h, cache)
        x1 = x1 + y
        h2 = L.apply_norm(cfg.norm, p["ln2"], x1)
        y2, _ = _apply_ffn(p["ffn"], cfg, kind[1], h2)
        return x1 + y2, cache
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
                       device=None, *, enc_len=0):
    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return t.expand((repeats,) + t.shape).clone()
    return {f"s{j}": stack(init_layer_cache(cfg, kind, batch, cache_len,
                                            dtype, device, enc_len=enc_len))
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
    ``ctx.want_cache`` a new stacked cache is built; with ``ctx.remat``
    (and grad mode on) each repeat, or each group of
    ``flags.nested_remat_group`` repeats, is checkpointed. Returns
    (x, cache or None, aux sums)."""
    decode = ctx.mode == "decode"
    reps = _first_leaf(params).shape[0]
    aux = _zero_aux(x.device)
    if decode:
        for r in range(reps):
            p = _index(params, r)
            for j, kind in enumerate(kinds):
                cj = _index(cache[f"s{j}"], r)
                x, new = apply_layer_decode(cfg, kind, p[f"s{j}"], x, cj, ctx)
                _write(cj, new)
        return x, cache, aux

    def body(r, x):
        """Repeat ``r``: (x, its cache entries, its aux sum)."""
        p = _index(params, r)
        entries, aux_r = {}, _zero_aux(x.device)
        for j, kind in enumerate(kinds):
            x, entries[f"s{j}"], a = apply_layer_full(cfg, kind, p[f"s{j}"],
                                                      x, ctx)
            aux_r = _add_aux(aux_r, a)
        return x, entries, aux_r

    remat = ctx.remat and not ctx.want_cache and torch.is_grad_enabled()
    g = flags.get().nested_remat_group
    if remat and g > 1 and reps % g == 0 and reps > g:
        # nested (sqrt) remat: checkpointed groups of g checkpointed
        # repeats store reps/g + g hiddens instead of reps.
        def group(r0, x):
            aux_g = _zero_aux(x.device)
            for r in range(r0, r0 + g):
                x, _, a = _checkpoint(body, r, x)
                aux_g = _add_aux(aux_g, a)
            return x, aux_g

        for r0 in range(0, reps, g):
            x, a = _checkpoint(group, r0, x)
            aux = _add_aux(aux, a)
        return x, None, aux
    out = {}
    for r in range(reps):
        x, entries, a = _checkpoint(body, r, x) if remat else body(r, x)
        aux = _add_aux(aux, a)
        if ctx.want_cache:
            for name, new in entries.items():
                if name not in out:
                    out[name] = _stack_like(new, reps)
                _write(_index(out[name], r), new)
    return x, (out if ctx.want_cache else None), aux
