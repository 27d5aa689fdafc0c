"""Top-level language-model API for serving: init / forward / prefill
cache / decode (the port's copy of the serving half of
``repro.models.model``).

Works for every ported architecture through the segments of
``stack.py``. Parameters are a nested dict with the reference's keys
(``segments.seg0.s0.attn.wq.w``, ...), segments stacked on a leading
repeats axis, so ``checkpoint.convert.lm_params_from_numpy`` maps the
reference's tree one to one. The reference's third return value (the
MoE auxiliary losses) arrives with MoE (ROADMAP queue 1 item 12);
``lm_loss``, ``chunked_ce_from_hidden`` and ``encode`` with the training
and enc-dec slices (items 15 and 14).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import stack as ST
from repro_torch.utils.device import resolve_device


def init_lm(cfg: ArchConfig, seed, dtype=torch.float32, device=None):
    """Random parameters of ``cfg`` in ``dtype`` on ``device`` (None: the
    CUDA card), drawn from a ``torch.Generator`` seeded with ``seed`` with
    the reference's distributions (not its numbers: the tests convert the
    reference's parameters with ``lm_params_from_numpy``). On the ``meta``
    device it returns the shapes only."""
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(int(seed)))
    init = L.Init(gen, dtype, device)
    params = {
        "embed": L.init_embedding(init, cfg.vocab, cfg.d_model),
        "final_norm": L.init_norm(init, cfg.norm, cfg.d_model),
        "segments": {name: ST.init_segment_params(init, cfg, kinds, reps)
                     for name, reps, kinds in ST.build_segments(cfg)},
    }
    if not cfg.tie_embeddings:
        params["head"] = L.init_dense(init, cfg.d_model, cfg.vocab)
    return params


def _logits(cfg, params, x):
    """f32 logits of hidden states x (..., d)."""
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return (x @ params["head"]["w"]).to(L.ACC)


def forward_hidden(cfg: ArchConfig, params, tokens, *, want_cache=False,
                   cache_len=0, plain_kernels=False):
    """Full-sequence forward up to the final norm (pre-logits). tokens
    (B, S) int. Returns (hidden, cache|None). ``plain_kernels`` runs the
    kernels' plain versions (the explicit reference run)."""
    x = L.embed(params["embed"], tokens)
    ctx = ST.Ctx(mode="full", want_cache=want_cache,
                 cache_len=cache_len or tokens.shape[1],
                 plain_kernels=plain_kernels)
    cache = {}
    for name, reps, kinds in ST.build_segments(cfg):
        x, c = ST.apply_segment(cfg, kinds, params["segments"][name], x,
                                None, ctx)
        cache[name] = c
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return x, (cache if want_cache else None)


def forward(cfg: ArchConfig, params, tokens, *, want_cache=False,
            cache_len=0, plain_kernels=False):
    """Full-sequence forward. Returns (logits (B, S, V) f32, cache|None)."""
    x, cache = forward_hidden(cfg, params, tokens, want_cache=want_cache,
                              cache_len=cache_len,
                              plain_kernels=plain_kernels)
    return _logits(cfg, params, x), cache


def init_cache(cfg: ArchConfig, batch, cache_len, dtype=torch.float32,
               device=None):
    device = resolve_device(device)
    return {name: ST.init_segment_cache(cfg, kinds, reps, batch, cache_len,
                                        dtype, device)
            for name, reps, kinds in ST.build_segments(cfg)}


def decode_step(cfg: ArchConfig, params, token, cache, pos, cache_len):
    """One-token decode. token (B, 1) int; ``pos`` the token's position (an
    int); ``cache_len`` the logical context capacity (ring caches are
    smaller than it). ``cache`` is updated in place. Returns
    (logits (B, 1, V) f32, cache)."""
    x = L.embed(params["embed"], token)
    ctx = ST.Ctx(mode="decode", pos=int(pos), cache_len=cache_len)
    for name, reps, kinds in ST.build_segments(cfg):
        x, _ = ST.apply_segment(cfg, kinds, params["segments"][name], x,
                                cache[name], ctx)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(cfg, params, x), cache
