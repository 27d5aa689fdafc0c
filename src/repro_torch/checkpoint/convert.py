"""Convert the reference package's parameters into the port's: U-DGD's θ
and training state, and an LLM's parameter tree.

The reference's θ is a dict of stacked per-layer arrays
{h (L,K+1), M (L,din,d), d (L,d)}; as numpy (for example
``jax.tree.map(np.asarray, state.theta)``) it becomes the port's dict of
tensors, so both packages compute the same function. A whole
``TrainState`` (θ, λ, Adam's ``{m, v, t}``, step) converts the same way,
so both packages can train on from one state. An LLM's tree (the
reference's ``init_lm``, segments stacked on a leading repeats axis)
maps key for key onto the port's (``lm_params_from_numpy``), and so does
its Adam state ``{"m", "v", "t"}`` (``lm_opt_state_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.engine.core import TrainState
from repro_torch.models.model import init_lm
from repro_torch.utils.device import resolve_device, to_tensor
from repro_torch.utils.tree import _map

KEYS = ("h", "M", "d")


def theta_from_numpy(theta_np, device=None) -> dict:
    """{"h","M","d"} numpy arrays -> tensors on ``device`` (None: the CUDA
    card), dtype kept. Raises on missing keys or inconsistent shapes."""
    if set(theta_np) != set(KEYS):
        raise ValueError(f"theta must have keys {KEYS}, got "
                         f"{sorted(theta_np)}")
    h, M, d = (np.asarray(theta_np[k]) for k in KEYS)
    if not (h.ndim == 2 and M.ndim == 3 and d.ndim == 2
            and h.shape[0] == M.shape[0] == d.shape[0]
            and M.shape[2] == d.shape[1]):
        raise ValueError(f"inconsistent theta shapes: h {h.shape}, "
                         f"M {M.shape}, d {d.shape}")
    device = resolve_device(device)
    return {k: to_tensor(a, device) for k, a in zip(KEYS, (h, M, d))}


def state_from_numpy(theta, lam, opt_state, step, device=None):
    """A reference ``TrainState`` as numpy -> the port's ``TrainState`` on
    ``device`` (None: the CUDA card): θ as in ``theta_from_numpy``, λ (L,)
    f32, Adam's state ``{"m": θ-like, "v": θ-like, "t": int}`` with f32
    moments and ``t`` a 0-d int32 tensor, ``step`` a Python int."""
    device = resolve_device(device)
    theta = theta_from_numpy(theta, device)
    lam = np.asarray(lam, np.float32)
    if lam.shape != (theta["h"].shape[0],):
        raise ValueError(f"lam must be (L,) = ({theta['h'].shape[0]},), "
                         f"got {lam.shape}")
    if set(opt_state) != {"m", "v", "t"}:
        raise ValueError(f"opt_state must have keys m, v, t, got "
                         f"{sorted(opt_state)}")
    moments = {}
    for name in ("m", "v"):
        mom = theta_from_numpy(opt_state[name], device)
        for k in KEYS:
            if mom[k].shape != theta[k].shape:
                raise ValueError(f"opt_state[{name!r}][{k!r}] has shape "
                                 f"{tuple(mom[k].shape)}, theta "
                                 f"{tuple(theta[k].shape)}")
        moments[name] = {k: v.to(torch.float32) for k, v in mom.items()}
    t = torch.tensor(int(np.asarray(opt_state["t"])), dtype=torch.int32,
                     device=device)
    return TrainState(theta=theta, lam=to_tensor(lam, device),
                      opt_state={**moments, "t": t}, step=int(step))


def _paths(path, keys):
    """The dotted paths of ``keys`` under ``path``."""
    return [f"{path}.{k}".lstrip(".") for k in sorted(keys)]


def lm_params_from_numpy(cfg: ArchConfig, tree, device=None) -> dict:
    """The reference's ``init_lm`` tree for ``cfg`` as numpy (for example
    ``jax.tree.map(np.asarray, params)``) -> the port's parameters on
    ``device`` (None: the CUDA card), dtype kept. The keys
    are the same (``segments.seg0.s0.attn.wq.w``, ...; an enc-dec model's
    encoder under ``enc.segments`` and ``enc.ln_post``); raises on a
    missing or extra key, naming its dotted path, or a shape other than
    the port's ``init_lm`` gives for ``cfg``."""
    device = resolve_device(device)

    def convert(ref, want, path):
        if isinstance(want, dict):
            if not isinstance(ref, dict) or set(ref) != set(want):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                have = set(ref) if isinstance(ref, dict) else set()
                raise ValueError(f"{path or 'params'}: keys {got}, expected "
                                 f"{sorted(want)} (missing "
                                 f"{_paths(path, set(want) - have)}, "
                                 f"unexpected {_paths(path, have - set(want))})")
            return {k: convert(ref[k], want[k], f"{path}.{k}".lstrip("."))
                    for k in want}
        a = np.asarray(ref)
        if a.shape != tuple(want.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected "
                             f"{tuple(want.shape)}")
        return to_tensor(a, device)

    return convert(tree, init_lm(cfg, 0, device="meta"), "")


def lm_opt_state_from_numpy(cfg: ArchConfig, opt_state, device=None) -> dict:
    """The reference's LM Adam state ``{"m": params-like, "v": params-like,
    "t": int}`` as numpy -> the port's on ``device`` (None: the CUDA
    card): f32 moments checked against ``cfg``'s parameter tree as
    ``lm_params_from_numpy`` checks parameters, ``t`` a 0-d int32
    tensor."""
    if set(opt_state) != {"m", "v", "t"}:
        raise ValueError(f"opt_state must have keys m, v, t, got "
                         f"{sorted(opt_state)}")
    device = resolve_device(device)
    moments = {k: _map(lambda a: a.to(torch.float32),
                       lm_params_from_numpy(cfg, opt_state[k], device))
               for k in ("m", "v")}
    t = torch.tensor(int(np.asarray(opt_state["t"])), dtype=torch.int32,
                     device=device)
    return {**moments, "t": t}
