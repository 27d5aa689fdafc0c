"""Shape-and-dtype stand-ins for every model input, on the ``meta``
device: the port of ``repro.launch.specs``. A ``meta`` tensor carries a
shape and a dtype and allocates nothing, as the reference's
``jax.ShapeDtypeStruct`` (which ``jax.eval_shape`` returns) does.
``input_specs(cfg, shape)`` is the single source of truth the dry run
and the roofline share.

long_500k eligibility: sub-quadratic archs only; callers consult
``shape_supported`` before describing a step.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import frontend as F
from repro_torch.models import model as M

PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")


def shape_supported(cfg: ArchConfig, shape: ShapeConfig):
    """(ok, reason) — which (arch × shape) pairs run."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention architecture without a sliding-window/"
                       "block-sparse variant; long_500k skipped per task rules")
    return True, ""


def params_spec(cfg: ArchConfig, dtype=PARAM_DTYPE):
    """``init_lm``'s tree on the ``meta`` device (nothing drawn)."""
    return M.init_lm(cfg, 0, dtype, device=META)


def cache_spec_tree(cfg: ArchConfig, batch, cache_len, dtype=PARAM_DTYPE):
    enc_len = F.AUDIO_FRAMES if cfg.layout == "encdec" else 0
    return M.init_cache(cfg, batch, cache_len, dtype, device=META,
                        enc_len=enc_len)


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=PARAM_DTYPE):
    """Step inputs (excluding params/opt state) for (arch × shape)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.mode in ("train", "prefill"):
        specs = {"tokens": _spec((B, S), i32)}
        if shape.mode == "train":
            specs["labels"] = _spec((B, S), i32)
        if cfg.layout == "encdec":
            specs["frames"] = F.audio_frames_spec(B, cfg.d_model, dtype)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"token": _spec((B, 1), i32), "pos": _spec((), i32),
            "cache": cache_spec_tree(cfg, B, S, dtype)}
