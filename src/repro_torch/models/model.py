"""Top-level language-model API: init / forward / prefill cache / decode
/ loss (the port's copy of ``repro.models.model``).

Works for every ported architecture through the segments of
``stack.py``. Parameters are a nested dict with the reference's keys
(``segments.seg0.s0.attn.wq.w``, ...), segments stacked on a leading
repeats axis, so ``checkpoint.convert.lm_params_from_numpy`` maps the
reference's tree one to one. ``forward_hidden`` and ``forward`` return
the reference's third value, the auxiliary losses {"lb", "z"} of the
MoE FFN layers summed over the stack (zero without MoE), which
``lm_loss`` weighs in.
``encode`` arrives with the enc-dec slice (item 14).
"""
from __future__ import annotations

import torch

from repro_torch import flags
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import stack as ST
from repro_torch.utils.device import resolve_device

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3


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
                   cache_len=0, remat=False, plain_kernels=False):
    """Full-sequence forward up to the final norm (pre-logits). tokens
    (B, S) int. Returns (hidden, cache|None, aux). ``remat`` checkpoints
    the layers (``stack.apply_segment``); ``plain_kernels`` runs the
    kernels' plain versions (the explicit reference run)."""
    x = L.embed(params["embed"], tokens)
    ctx = ST.Ctx(mode="full", want_cache=want_cache,
                 cache_len=cache_len or tokens.shape[1],
                 plain_kernels=plain_kernels, remat=remat)
    cache = {}
    aux_total = ST._zero_aux(x.device)
    for name, reps, kinds in ST.build_segments(cfg):
        x, c, aux = ST.apply_segment(cfg, kinds, params["segments"][name], x,
                                     None, ctx)
        cache[name] = c
        aux_total = ST._add_aux(aux_total, aux)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return x, (cache if want_cache else None), aux_total


def forward(cfg: ArchConfig, params, tokens, *, want_cache=False,
            cache_len=0, remat=False, plain_kernels=False):
    """Full-sequence forward. Returns (logits (B, S, V) f32, cache|None,
    aux)."""
    x, cache, aux = forward_hidden(cfg, params, tokens,
                                   want_cache=want_cache,
                                   cache_len=cache_len, remat=remat,
                                   plain_kernels=plain_kernels)
    return _logits(cfg, params, x), cache, aux


def _nll_sum(cfg, params, hidden, labels):
    """Σ over positions of −log softmax(logits)[label], in f32."""
    logp = torch.log_softmax(_logits(cfg, params, hidden).to(L.ACC), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0].sum()


def chunked_ce_from_hidden(cfg: ArchConfig, params, hidden, labels, chunk):
    """Mean cross-entropy computed per sequence chunk of ``chunk``
    positions (the largest divisor of S not above it) under remat: the
    full (B, S, V) f32 logits never exist (``flags.chunked_ce``). The chunk
    sums are added in order, as the reference's scan adds them."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    total = torch.zeros((), dtype=L.ACC, device=hidden.device)
    for lo in range(0, S, c):
        args = (cfg, params, hidden[:, lo:lo + c], labels[:, lo:lo + c])
        total = total + (ST._checkpoint(_nll_sum, *args)
                         if torch.is_grad_enabled() else _nll_sum(*args))
    return total / (B * S)


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
        x, _, _ = ST.apply_segment(cfg, kinds, params["segments"][name], x,
                                   cache[name], ctx)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(cfg, params, x), cache


def cross_entropy(logits, labels, mask=None):
    """Mean (or ``mask``-weighted mean) −log softmax(logits)[label], f32."""
    logp = torch.log_softmax(logits.to(L.ACC), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def lm_loss(cfg: ArchConfig, params, batch, remat=False,
            plain_kernels=False):
    """Next-token loss of ``batch`` ({"tokens", "labels"}, (B, S) ints) plus
    the weighted auxiliary losses; returns (loss, aux). Cross-entropy per
    chunk when ``flags.chunked_ce`` is set."""
    ce_chunk = flags.get().chunked_ce
    if ce_chunk:
        hidden, _, aux = forward_hidden(cfg, params, batch["tokens"],
                                        remat=remat,
                                        plain_kernels=plain_kernels)
        loss = chunked_ce_from_hidden(cfg, params, hidden, batch["labels"],
                                      ce_chunk)
    else:
        logits, _, aux = forward(cfg, params, batch["tokens"], remat=remat,
                                 plain_kernels=plain_kernels)
        loss = cross_entropy(logits, batch["labels"])
    loss = loss + MOE_LB_WEIGHT * aux["lb"] + MOE_Z_WEIGHT * aux["z"]
    return loss, aux
