"""Modality frontend stubs (the port's copy of ``repro.models.frontend``).

[audio] whisper-small: the mel-spectrogram + 2×conv feature extractor is
stubbed: the model takes precomputed frame embeddings of shape
(B, AUDIO_FRAMES, d_model), what the conv frontend would emit for 30 s of
audio. ``audio_frames_spec`` gives their shape and dtype as a ``meta``
tensor (the reference's ``ShapeDtypeStruct``).
"""
import torch

from repro_torch.models import layers as L

AUDIO_FRAMES = 1500


def audio_frames_spec(batch, d_model, dtype=torch.bfloat16):
    """(batch, AUDIO_FRAMES, d_model) frame embeddings, shape and dtype
    only (on the ``meta`` device)."""
    return torch.empty((batch, AUDIO_FRAMES, d_model), dtype=dtype,
                       device="meta")


def add_positions(x):
    """x (B, S, d) plus the sinusoidal positions 0..S-1, in x's dtype (the
    positions of whisper's encoder and decoder streams, which use no
    RoPE)."""
    _, S, d = x.shape
    pos = L.sinusoidal_positions(torch.arange(S, device=x.device), d)
    return x + pos[None].to(x.dtype)
