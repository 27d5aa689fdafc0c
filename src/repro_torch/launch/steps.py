"""Step functions (the port of ``repro.launch.steps``): the LM train step
with gradient accumulation, and the serving steps (greedy next token plus
cache).

The reference jits them with mesh shardings; the port runs them eagerly
on one card, so they are plain closures. ``auto_microbatches`` and
``jitted_step`` arrive with the dry-run slice (ROADMAP queue 1)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import adam, apply_updates, clip_by_global_norm
from repro_torch.utils.tree import _leaves, _map


def loss_and_grads(cfg: ArchConfig, params, batch, remat=True,
                   plain_kernels=False):
    """((loss, aux), grads) of ``M.lm_loss`` at ``params``, gradients as a
    tree like ``params`` (f32 for f32 parameters); the parameters are not
    modified. ``plain_kernels`` differentiates the kernels' plain versions
    (the explicit reference run)."""
    leaves = _leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tree = _map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, aux = M.lm_loss(cfg, tree, batch, remat=remat,
                              plain_kernels=plain_kernels)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, live))
    return ((loss.detach(), {k: a.detach() for k, a in aux.items()}),
            _map(lambda _: next(it), params))


def make_train_step(cfg: ArchConfig, lr=1e-4, remat=True, microbatches=1):
    """Adam train step with optional gradient accumulation over
    ``microbatches`` equal slices of the batch, each of its entries
    (tokens, labels, an enc-dec model's frames) split on its first axis
    (activation memory scales
    with batch / microbatches). Returns ``(train_step, opt)``;
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "moe_lb"})`` returns new trees and leaves its
    inputs as they are. As in the reference, accumulated gradients are
    summed in f32 and divided by ``microbatches``, the loss is the mean of
    the microbatches' losses and the aux values their mean; then the
    global-norm clip at 1.0 and Adam."""
    opt = adam(lr)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, aux), grads = loss_and_grads(cfg, params, batch, remat)
        else:
            mb = {k: a.reshape((microbatches, a.shape[0] // microbatches)
                               + tuple(a.shape[1:]))
                  for k, a in batch.items()}
            grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
            loss, auxs = 0.0, []
            for i in range(microbatches):
                (l_i, aux_i), g = loss_and_grads(
                    cfg, params, {k: a[i] for k, a in mb.items()}, remat)
                grads = _map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss = loss + l_i
                auxs.append(aux_i)
            grads = _map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            aux = {k: torch.mean(torch.stack([a[k] for a in auxs]))
                   for k in auxs[0]}
        grads, gn = clip_by_global_norm(grads, 1.0)
        upd, opt_state = opt.update(grads, opt_state)
        params = apply_updates(params, upd)
        return params, opt_state, {"loss": loss, "grad_norm": gn,
                                   "moe_lb": aux["lb"]}
    return train_step, opt


def make_prefill_step(cfg: ArchConfig, cache_len):
    """``prefill_step(params, batch) -> (next_tok (B, 1) int32, cache)``;
    ``batch`` holds "tokens" (B, S) and, for the enc-dec model, "frames"
    (B, F, d). Only the last position's logits are computed: the
    reference computes all of them and keeps the last, the same next
    token."""
    def prefill_step(params, batch):
        hidden, cache, _ = M.forward_hidden(cfg, params, batch["tokens"],
                                            batch.get("frames"),
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
