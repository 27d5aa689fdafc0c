"""Step functions (the port of ``repro.launch.steps``): the LM train step
with gradient accumulation, and the serving steps (greedy next token plus
cache).

The reference jits them with mesh shardings; the port runs them eagerly
on one card, so they are plain closures. ``jitted_step`` keeps the
reference's name for what stands in for its jitted, sharded step: the
step function, its ``meta`` arguments and their partition specs on a
mesh (``sharding.rules``), which the dry run counts and describes."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import flags
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import specs as SP
from repro_torch.models import model as M
from repro_torch.optim import (adam, apply_updates, clip_by_global_norm,
                               donated_adam_step_)
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


def make_train_step(cfg: ArchConfig, lr=1e-4, remat=True, microbatches=1,
                    plain_kernels=False, donate=False):
    """Adam train step with optional gradient accumulation over
    ``microbatches`` equal slices of the batch, each of its entries
    (tokens, labels, an enc-dec model's frames) split on its first axis
    (activation memory scales
    with batch / microbatches). Returns ``(train_step, opt)``;
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "moe_lb"})``. As in the reference, accumulated
    gradients are summed in f32 and divided by ``microbatches``, the loss
    is the mean of the microbatches' losses and the aux values their
    mean; then the global-norm clip at 1.0 and Adam. ``plain_kernels``
    differentiates the kernels' plain versions (``loss_and_grads``).

    ``donate`` is the port's counterpart of the reference's
    ``donate_argnums=(0, 1)``: the step updates ``params`` and
    ``opt_state`` in place and returns the same tree objects, the
    accumulation adds into one f32 tree, and the clip and Adam run leaf by
    leaf (``optim.donated_adam_step_``), each leaf's gradient freed once
    its parameter is updated; the results are bit-equal to the undonated
    step's. With ``donate=False`` the step returns new trees and leaves
    its inputs as they are."""
    opt = adam(lr)
    kw = {"plain_kernels": True} if plain_kernels else {}

    def grads_of(params, batch):
        if microbatches == 1:
            return loss_and_grads(cfg, params, batch, remat, **kw)
        mb = {k: a.reshape((microbatches, a.shape[0] // microbatches)
                           + tuple(a.shape[1:]))
              for k, a in batch.items()}
        grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        loss, auxs = 0.0, []
        for i in range(microbatches):
            (l_i, aux_i), g = loss_and_grads(
                cfg, params, {k: a[i] for k, a in mb.items()}, remat, **kw)
            if donate:
                for a, b in zip(_leaves(grads), _leaves(g)):
                    a.add_(b.to(a.dtype))
                del a, b
            else:
                grads = _map(lambda a, b: a + b.to(a.dtype), grads, g)
            del g
            loss = loss + l_i
            auxs.append(aux_i)
        if donate:
            for g in _leaves(grads):
                g.div_(microbatches)
        else:
            grads = _map(lambda g: g / microbatches, grads)
        aux = {k: torch.mean(torch.stack([a[k] for a in auxs]))
               for k in auxs[0]}
        return (loss / microbatches, aux), grads

    def train_step(params, opt_state, batch):
        (loss, aux), grads = grads_of(params, batch)
        if donate:
            params, opt_state, gn = donated_adam_step_(grads, opt_state,
                                                       params, lr)
        else:
            grads, gn = clip_by_global_norm(grads, 1.0)
            upd, opt_state = opt.update(grads, opt_state)
            params = apply_updates(params, upd)
        return params, opt_state, {"loss": loss, "grad_norm": gn,
                                   "moe_lb": aux["lb"]}
    return train_step, opt


def make_prefill_step(cfg: ArchConfig, cache_len, plain_kernels=False):
    """``prefill_step(params, batch) -> (next_tok (B, 1) int32, cache)``;
    ``batch`` holds "tokens" (B, S) and, for the enc-dec model, "frames"
    (B, F, d). Only the last position's logits are computed: the
    reference computes all of them and keeps the last, the same next
    token. ``plain_kernels`` runs the kernels' plain versions."""
    def prefill_step(params, batch):
        hidden, cache, _ = M.forward_hidden(cfg, params, batch["tokens"],
                                            batch.get("frames"),
                                            want_cache=True,
                                            cache_len=cache_len,
                                            plain_kernels=plain_kernels)
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


def auto_microbatches(shape: ShapeConfig, mesh, target_local=None):
    """Pick a gradient-accumulation factor so the per-device microbatch is
    ~``target_local`` sequences (``flags.microbatch_target`` when None)."""
    from repro_torch.sharding.rules import axis_size, data_axes
    if target_local is None:
        target_local = flags.get().microbatch_target
    dp = axis_size(mesh, data_axes(mesh))
    B = shape.global_batch
    mb = max(1, B // (dp * target_local))
    while B % (mb * dp) and mb > 1:     # keep microbatch dp-divisible
        mb //= 2
    return mb


class Step(NamedTuple):
    """One (arch × shape) step on a mesh, described: ``fn(*args)`` runs it
    (on the ``meta`` arguments, shapes only); ``in_specs`` and
    ``out_specs`` are the partition specs of its arguments and results,
    trees like them (the reference's ``in_shardings`` /
    ``out_shardings``); ``replicated`` marks a spec of no split."""
    fn: Callable
    args: tuple
    in_specs: tuple
    out_specs: tuple
    microbatches: int = 1
    weight_stationary: bool = False


def jitted_step(cfg: ArchConfig, shape: ShapeConfig, mesh, lr=1e-4,
                microbatches=None) -> Step:
    """The (arch × shape) step with its ``meta`` example arguments and
    their partition specs on ``mesh``: the counterpart of the reference's
    jitted, sharded step (``repro.launch.steps.jitted_step``). Nothing is
    compiled or allocated; ``launch.dryrun`` counts ``fn(*args)``. The
    step runs the kernels' plain versions (``plain_kernels=True``): the
    reference's models run plain ``sdpa`` and their own scans, which is
    what its compiled step counts. The train step is the donated one
    (``donate=True``), the counterpart of the reference's
    ``donate_argnums=(0, 1)``: it updates the parameters and the Adam
    state in place and frees each gradient leaf once its parameter is
    updated, so the count sees no new trees beside the arguments."""
    from repro_torch.sharding.rules import (PartitionSpec, axis_size,
                                            batch_shardings, cache_shardings,
                                            params_shardings)
    specs = SP.input_specs(cfg, shape)
    p_spec = SP.params_spec(cfg)
    p_sh = params_shardings(p_spec, mesh)
    rep = PartitionSpec()

    if shape.mode == "train":
        if microbatches is None:
            microbatches = auto_microbatches(shape, mesh)
        step, opt = make_train_step(cfg, lr, microbatches=microbatches,
                                    plain_kernels=True, donate=True)
        o_spec = opt.init(p_spec)
        # adam moments mirror params; step counter replicated
        o_sh = {"m": params_shardings(o_spec["m"], mesh),
                "v": params_shardings(o_spec["v"], mesh), "t": rep}
        b_sh = batch_shardings(specs, mesh)
        return Step(step, (p_spec, o_spec, specs), (p_sh, o_sh, b_sh),
                    (p_sh, o_sh, rep), microbatches)

    if shape.mode == "prefill":
        step = make_prefill_step(cfg, shape.seq_len, plain_kernels=True)
        b_sh = batch_shardings(specs, mesh)
        c_spec = SP.cache_spec_tree(cfg, shape.global_batch, shape.seq_len)
        return Step(step, (p_spec, specs), (p_sh, b_sh),
                    (rep, cache_shardings(c_spec, mesh)))

    # decode
    stationary = False
    if flags.get().serve_weight_stationary:
        # weight-stationary serving: replicate weights over the data axes
        # when the model-sharded copy fits (<= ~10 GB bf16 per chip)
        per_chip = (cfg.param_count() * 2) / axis_size(mesh, "model")
        if per_chip <= 10e9:
            p_sh = params_shardings(p_spec, mesh, data_shard=False)
            stationary = True
    decode = make_decode_step(cfg, shape.seq_len)

    def step(params, cache, token, pos):
        # the port's decode takes the position as an int: a meta pos
        # stands for the last slot (attention reads the whole cache,
        # masked, at every position, as in the reference)
        if isinstance(pos, torch.Tensor) and pos.device.type == "meta":
            pos = shape.seq_len - 1
        return decode(params, cache, token, pos)
    c_spec = specs["cache"]
    c_sh = cache_shardings(c_spec, mesh)
    t_sh = batch_shardings({"t": specs["token"]}, mesh)["t"]
    return Step(step, (p_spec, c_spec, specs["token"], specs["pos"]),
                (p_sh, c_sh, t_sh, rep), (t_sh, c_sh),
                weight_stationary=stationary)
