"""Step functions for serving (the prefill and decode halves of
``repro.launch.steps``): greedy next token plus cache.

The reference jits them with mesh shardings; the port runs them eagerly
on one card, so they are plain closures. ``make_train_step`` arrives
with LM training (ROADMAP queue 1 item 15)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ArchConfig, cache_len):
    """``prefill_step(params, batch) -> (next_tok (B, 1) int32, cache)``.
    Only the last position's logits are computed: the reference computes
    all of them and keeps the last, the same next token."""
    def prefill_step(params, batch):
        hidden, cache = M.forward_hidden(cfg, params, batch["tokens"],
                                         want_cache=True,
                                         cache_len=cache_len)
        logits = M._logits(cfg, params, hidden[:, -1:])
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return prefill_step


def make_decode_step(cfg: ArchConfig, cache_len):
    """``decode_step(params, cache, token, pos) -> (next_tok, cache)``; the
    cache is updated in place."""
    def decode_step(params, cache, token, pos):
        logits, cache = M.decode_step(cfg, params, token, cache, pos,
                                      cache_len)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return decode_step
