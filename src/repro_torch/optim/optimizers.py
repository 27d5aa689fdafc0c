"""Plain-tensor optimizers on dicts of tensors: SGD, momentum, Adam; the
port of ``repro.optim.optimizers``.

An optimizer is a pair of functions bundled in ``Optimizer``:
  init(params) -> state
  update(grads, state, params) -> (updates, state)
``apply_updates`` adds updates to params. They are written as tensor
code, not ``torch.optim``, so Adam's state is the reference's
``{"m", "v", "t"}`` (f32 moments whatever the parameters' dtype, ``t`` a
0-d int32 tensor) and converts across (``checkpoint.convert``). Every
function returns new tensors and leaves its inputs as they are, as the
reference does; updates are elementwise passes over each tensor, in the
reference's order of operations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _zeros_f32(params):
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def apply_updates(params, updates):
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``;
    returns (clipped grads, the norm before clipping)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gn


def sgd(lr):
    def init(params):
        return ()

    def update(grads, state, params=None):
        return {k: -lr * g for k, g in grads.items()}, state
    return Optimizer(init, update)


def momentum(lr, beta=0.9):
    def init(params):
        return _zeros_f32(params)

    def update(grads, state, params=None):
        new_m = {k: beta * m + grads[k].to(torch.float32)
                 for k, m in state.items()}
        return {k: -lr * m for k, m in new_m.items()}, new_m
    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        device = next(iter(params.values())).device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        g32 = {k: g.to(torch.float32) for k, g in grads.items()}
        m = {k: b1 * m_ + (1 - b1) * g32[k] for k, m_ in state["m"].items()}
        v = {k: b2 * v_ + (1 - b2) * torch.square(g32[k])
             for k, v_ in state["v"].items()}
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)
        upd = {k: -lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
               for k in m}
        return upd, {"m": m, "v": v, "t": t}
    return Optimizer(init, update)
