"""Plain-tensor optimizers on trees of tensors (nested dicts: U-DGD's θ,
an LM's parameters): SGD, momentum, Adam; the port of
``repro.optim.optimizers``.

An optimizer is a pair of functions bundled in ``Optimizer``:
  init(params) -> state
  update(grads, state, params) -> (updates, state)
``apply_updates`` adds updates to params. They are written as tensor
code, not ``torch.optim``, so Adam's state is the reference's
``{"m", "v", "t"}`` (f32 moments whatever the parameters' dtype, ``t`` a
0-d int32 tensor) and converts across (``checkpoint.convert``). Every
function returns new tensors and leaves its inputs as they are, as the
reference does; updates are elementwise passes over each tensor, in the
reference's order of operations. Leaves are visited in the trees' own
order (``utils.tree``); the global norm sums them in that order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.utils.tree import _leaves, _map


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _zeros_f32(params):
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def apply_updates(params, updates):
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``;
    returns (clipped grads, the norm before clipping)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in _leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return _map(lambda g: g * scale, grads), gn


def sgd(lr):
    def init(params):
        return ()

    def update(grads, state, params=None):
        return _map(lambda g: -lr * g, grads), state
    return Optimizer(init, update)


def momentum(lr, beta=0.9):
    def init(params):
        return _zeros_f32(params)

    def update(grads, state, params=None):
        new_m = _map(lambda m, g: beta * m + g.to(torch.float32), state,
                     grads)
        return _map(lambda m: -lr * m, new_m), new_m
    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        device = _leaves(params)[0].device
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                 state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2)
                 * torch.square(g.to(torch.float32)), state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)
        upd = _map(lambda m_, v_: -lr * (m_ / bc1)
                   / (torch.sqrt(v_ / bc2) + eps), m, v)
        return upd, {"m": m, "v": v, "t": t}
    return Optimizer(init, update)
