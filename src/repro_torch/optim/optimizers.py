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

``donated_adam_step_`` is the port's counterpart of the reference's
donated buffers (``jax.jit(..., donate_argnums=(0, 1))``): the clip,
Adam and ``apply_updates`` in place on the trees it is given, one leaf at
a time, so that only one leaf's f32 temporaries are alive at once, with
the same operations in the same order as the three functions, so its
results are bit-equal to theirs.
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


def _clip_scale(grads, max_norm):
    """(the global L2 norm of ``grads`` in f32, the clip factor)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in _leaves(grads)))
    return gn, torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def _clipped(g, scale):
    """g · scale in the promoted dtype, as the reference's ``g * scale``
    (a bf16 gradient times the f32 factor is f32 there)."""
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``;
    returns (clipped grads, in f32 for bf16 ones, the norm before
    clipping)."""
    gn, scale = _clip_scale(grads, max_norm)
    return _map(lambda g: _clipped(g, scale), grads), gn


def _adam_leaf_(p, g, m, v, scale, lr, b1, b2, eps, bc1, bc2):
    """One leaf of the clip, Adam and ``apply_updates``, in place on m, v
    and p, in ``clip_by_global_norm``'s, ``adam``'s and
    ``apply_updates``'s order of operations (so bit-equal to them); its
    f32 temporaries are freed on return."""
    g = _clipped(g, scale).to(torch.float32)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    del g
    upd = m / bc1
    upd.mul_(-lr)
    den = v / bc2
    den.sqrt_().add_(eps)
    upd.div_(den)
    del den
    p.add_(upd.to(p.dtype))


def donated_adam_step_(grads, state, params, lr, max_norm=1.0, b1=0.9,
                       b2=0.999, eps=1e-8):
    """``clip_by_global_norm``, ``adam(lr, b1, b2, eps).update`` and
    ``apply_updates`` on donated trees: ``state`` (m, v, t) and ``params``
    are updated in place, one leaf at a time, and each leaf's gradient is
    freed (its slot in ``grads``, a tree of dicts and lists as
    ``loss_and_grads`` returns, set to None) once its parameter is
    updated. Bit-equal to the three functions. Returns (params, state,
    the norm before clipping)."""
    gn, scale = _clip_scale(grads, max_norm)
    state["t"].add_(1)
    tf = state["t"].to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, tf), 1 - torch.pow(b2, tf)
    for p, (box, key), m, v in zip(_leaves(params), _slots(grads),
                                   _leaves(state["m"]), _leaves(state["v"])):
        _adam_leaf_(p, box[key], m, v, scale, lr, b1, b2, eps, bc1, bc2)
        box[key] = None
    return params, state, gn


def _slots(tree):
    """(container, key) of every leaf of a tree of dicts and lists, in
    ``_leaves``'s order."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, x in items:
        if isinstance(x, (dict, list)):
            yield from _slots(x)
        else:
            yield tree, key


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
