"""Convert the reference package's U-DGD parameters into the port's θ.

The reference's θ is a dict of stacked per-layer arrays
{h (L,K+1), M (L,din,d), d (L,d)}; as numpy (for example
``jax.tree.map(np.asarray, state.theta)``) it becomes the port's dict of
tensors, so both packages compute the same function.
"""
from __future__ import annotations

import numpy as np

from repro_torch.utils.device import resolve_device, to_tensor

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
