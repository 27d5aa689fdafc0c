"""Top-level language-model API: init / forward / prefill cache / decode
/ loss (the port's copy of ``repro.models.model``).

Works for every ported architecture through the segments of
``stack.py``; the enc-dec model (whisper) also runs an encoder
(``encode``) over stubbed audio-frame embeddings, and its decoder reads
the encoder's output through cross-attention. Parameters are a nested dict with the reference's keys
(``segments.seg0.s0.attn.wq.w``, ...), segments stacked on a leading
repeats axis, so ``checkpoint.convert.lm_params_from_numpy`` maps the
reference's tree one to one. ``forward_hidden`` and ``forward`` return
the reference's third value, the auxiliary losses {"lb", "z"} of the
MoE FFN layers summed over the stack (zero without MoE), which
``lm_loss`` weighs in.
"""
from __future__ import annotations

import torch

from repro_torch import flags
from repro_torch.configs.base import ArchConfig
from repro_torch.models import frontend as F
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
    if cfg.layout == "encdec":
        params["enc"] = {
            "segments": {name: ST.init_segment_params(init, cfg, kinds, reps)
                         for name, reps, kinds in ST.encoder_segments(cfg)},
            "ln_post": L.init_layernorm(init, cfg.d_model)}
    return params


def _logits(cfg, params, x):
    """f32 logits of hidden states x (..., d), accumulated in f32 whatever
    the parameters' dtype (``layers.matmul_acc``)."""
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.matmul_acc(x, params["head"]["w"])


def encode(cfg: ArchConfig, params, frames, remat=False, plain_kernels=False):
    """The enc-dec model's encoder over stubbed frame embeddings frames
    (B, F, d): sinusoidal positions, the encoder layers (non-causal
    attention), then ``ln_post``. Returns (B, F, d)."""
    x = F.add_positions(frames)
    ctx = ST.Ctx(mode="full", remat=remat, plain_kernels=plain_kernels)
    for name, reps, kinds in ST.encoder_segments(cfg):
        x, _, _ = ST.apply_segment(cfg, kinds, params["enc"]["segments"][name],
                                   x, None, ctx)
    return L.layernorm(params["enc"]["ln_post"], x)


def forward_hidden(cfg: ArchConfig, params, tokens, frames=None, *,
                   want_cache=False, cache_len=0, remat=False,
                   plain_kernels=False):
    """Full-sequence forward up to the final norm (pre-logits). tokens
    (B, S) int; ``frames`` (B, F, d) the enc-dec model's frame embeddings
    (required there, ignored elsewhere). Returns (hidden, cache|None,
    aux). ``remat`` checkpoints the layers (``stack.apply_segment``), the
    encoder's too; ``plain_kernels`` runs the kernels' plain versions (the
    explicit reference run)."""
    x = L.embed(params["embed"], tokens)
    enc = None
    if cfg.layout == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             "frames (B, F, d_model)")
        enc = encode(cfg, params, frames, remat=remat,
                     plain_kernels=plain_kernels)
        x = F.add_positions(x)
    ctx = ST.Ctx(mode="full", want_cache=want_cache,
                 cache_len=cache_len or tokens.shape[1], enc=enc,
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


def forward(cfg: ArchConfig, params, tokens, frames=None, *,
            want_cache=False, cache_len=0, remat=False, plain_kernels=False):
    """Full-sequence forward. Returns (logits (B, S, V) f32, cache|None,
    aux)."""
    x, cache, aux = forward_hidden(cfg, params, tokens, frames,
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
               device=None, *, enc_len=0):
    """Zero caches of the decoder's segments; an enc-dec model's cross
    caches are ``enc_len`` long."""
    device = resolve_device(device)
    return {name: ST.init_segment_cache(cfg, kinds, reps, batch, cache_len,
                                        dtype, device, enc_len=enc_len)
            for name, reps, kinds in ST.build_segments(cfg)}


def decode_step(cfg: ArchConfig, params, token, cache, pos, cache_len):
    """One-token decode. token (B, 1) int; ``pos`` the token's position (an
    int); ``cache_len`` the logical context capacity (ring caches are
    smaller than it). ``cache`` is updated in place (an enc-dec model's
    cross caches only read). Returns (logits (B, 1, V) f32, cache)."""
    x = L.embed(params["embed"], token)
    if cfg.layout == "encdec":
        posv = torch.full((token.shape[0], 1), int(pos), device=x.device)
        x = x + L.sinusoidal_positions(posv, cfg.d_model).to(x.dtype)
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
    """Next-token loss of ``batch`` ({"tokens", "labels"}, (B, S) ints, and
    the enc-dec model's "frames") plus the weighted auxiliary losses;
    returns (loss, aux). Cross-entropy per chunk when
    ``flags.chunked_ce`` is set."""
    ce_chunk = flags.get().chunked_ce
    frames = batch.get("frames")
    if ce_chunk:
        hidden, _, aux = forward_hidden(cfg, params, batch["tokens"], frames,
                                        remat=remat,
                                        plain_kernels=plain_kernels)
        loss = chunked_ce_from_hidden(cfg, params, hidden, batch["labels"],
                                      ce_chunk)
    else:
        logits, _, aux = forward(cfg, params, batch["tokens"], frames,
                                 remat=remat, plain_kernels=plain_kernels)
        loss = cross_entropy(logits, batch["labels"])
    loss = loss + MOE_LB_WEIGHT * aux["lb"] + MOE_Z_WEIGHT * aux["z"]
    return loss, aux
