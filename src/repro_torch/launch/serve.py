"""Batched serving driver: prefill a prompt batch, then greedy-decode with
the KV / state cache (the port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --tokens 32 --device cpu

The prefill runs every full-sequence attention (for whisper: the
encoder's, the decoder's causal self-attention and its cross-attention)
through the flash-attention kernel and every RWKV6 time-mix through the
wkv kernel (on the card); decode is plain PyTorch. Prompts are drawn by a
numpy generator seeded with ``--seed``, or passed in (``prompts=``), so
the tests can feed both packages the same ids; an enc-dec model's frame
embeddings likewise (the reference's 0.02 · N(0, 1) of shape
(batch, 24, d_model), or ``frames=``); parameters come from ``init_lm``
seeded with ``--seed``, or are passed in (``params=``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import model as M
from repro_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's parser, exposed so wrappers override defaults via
    ``parser.set_defaults(...)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, parser=None, *, prompts=None, params=None, frames=None):
    """Serve one batch; returns the generated ids (batch, tokens) as a
    numpy array. ``prompts`` (batch, prompt_len) ints, ``params``
    (``init_lm``'s tree) and, for an enc-dec model, ``frames``
    (batch, F, d_model) floats replace the seeded draws."""
    args = (parser or build_parser()).parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    cache_len = args.prompt_len + args.tokens
    if params is None:
        params = M.init_lm(cfg, args.seed, device=device)
    if prompts is None:
        prompts = np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (args.batch, args.prompt_len))
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                             device=device)
    if tokens.shape != (args.batch, args.prompt_len):
        raise ValueError(f"prompts {tuple(tokens.shape)} != (batch, "
                         f"prompt_len) = {(args.batch, args.prompt_len)}")

    batch = {"tokens": tokens}
    if cfg.layout == "encdec":
        if frames is None:
            frames = 0.02 * np.random.default_rng(args.seed).standard_normal(
                (args.batch, 24, cfg.d_model))
        batch["frames"] = torch.as_tensor(np.asarray(frames),
                                          dtype=torch.float32, device=device)
        if (batch["frames"].dim() != 3 or batch["frames"].shape[0]
                != args.batch or batch["frames"].shape[2] != cfg.d_model):
            raise ValueError(f"frames {tuple(batch['frames'].shape)} != "
                             f"(batch, F, d_model) = ({args.batch}, F, "
                             f"{cfg.d_model})")

    prefill = make_prefill_step(cfg, cache_len)
    decode = make_decode_step(cfg, cache_len)
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        tok, cache = prefill(params, batch)
        _sync(device)
        print(f"prefill {args.batch}x{args.prompt_len}: "
              f"{time.perf_counter() - t0:.3f}s")

        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.tokens - 1):
            tok, cache = decode(params, cache, tok, args.prompt_len + i)
            out.append(tok)
        gen = torch.cat(out, dim=1).cpu().numpy()
        dt = time.perf_counter() - t0
    print(f"decoded {args.tokens - 1} tokens/seq x {args.batch} seqs in "
          f"{dt:.3f}s ({(args.tokens - 1) * args.batch / max(dt, 1e-9):.1f} "
          f"tok/s)")
    print("sample ids:", gen[0, :12].tolist())
    if gen.shape != (args.batch, args.tokens) or not (
            (gen >= 0).all() and (gen < cfg.vocab).all()):
        raise AssertionError(f"generated ids {gen.shape} out of range")
    return gen


if __name__ == "__main__":
    main()
