"""End-to-end LM training driver (the port of ``repro.launch.train``).

Trains any ported ``--arch`` (the reduced variant by default, ``--full``
for the full config) on the synthetic token pipeline for N steps with an
optional checkpoint, through the flash-attention and wkv kernels (forward
and backward) on the card:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --full --steps 20 --ckpt build/rwkv6_ckpt

The reference's flags, plus ``--device`` (default: the CUDA card),
``--seed`` (``init_lm``'s generator; the pipeline keeps the reference's
seed 0) and ``--opts`` (``flags.parse_opts``, e.g. ``chunked_ce=512``).
For an enc-dec model each step also draws its frame embeddings, the
reference's 0.02 · N(0, 1) of shape (batch, 24, d_model), from a numpy
generator seeded with (``--seed``, step), or takes them from
``frames=``. As in the reference the step runs without remat and is
donated (``make_train_step(donate=True)``: parameters and Adam state
updated in place; a caller's ``params`` are copied first). ``--ckpt`` writes
{"params", "step"} in the reference's npz + json format
(``checkpoint.io``). The run ends with the reference's own check: the
mean loss of the last 5 steps is below that of the first 5.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import checkpoint as CKPT
from repro_torch import flags
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import _map, tree_size


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--opts", default="",
                    help="flags, e.g. 'chunked_ce=512,blockwise_prefill'")
    return ap


def main(argv=None, *, params=None, state=None, frames=None):
    """Train; returns the per-step losses. ``params`` (``init_lm``'s tree)
    replaces the seeded draw, and ``frames`` (a function of the step t
    returning (batch, F, d_model) floats) an enc-dec model's per-step
    draws; a ``state`` dict receives the final "params" and "opt_state".
    ``--opts`` holds for this run only: the flags are restored on
    return."""
    args = build_parser().parse_args(argv)
    prev = flags.get()
    flags.parse_opts(args.opts)
    try:
        return _train(args, params, state, frames)
    finally:
        flags.set_flags(**dataclasses.asdict(prev))


def _train(args, params, state, frames):
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab}")

    if params is None:
        params = M.init_lm(cfg, args.seed, device=device)
    else:       # the step donates its trees: leave the caller's as they are
        params = _map(torch.clone, params)
    print(f"params: {tree_size(params)/1e6:.2f}M")
    # donated, as the reference's driver jits its step with
    # donate_argnums=(0, 1)
    step_fn, opt = make_train_step(cfg, lr=args.lr, remat=False,
                                   donate=True)
    opt_state = opt.init(params)

    if cfg.layout == "encdec" and frames is None:
        def frames(t):
            rng = np.random.default_rng([args.seed, t])
            return 0.02 * rng.standard_normal((args.batch, 24, cfg.d_model))

    pipe = iter(TokenPipeline(cfg.vocab, args.batch, args.seq, seed=0))
    losses = []
    t0 = time.time()
    for t in range(args.steps):
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                 for k, v in next(pipe).items()}
        if cfg.layout == "encdec":
            batch["frames"] = torch.as_tensor(
                np.array(frames(t), np.float32), device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if t % args.log_every == 0 or t == args.steps - 1:
            print(f"step {t:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{(time.time()-t0)/(t+1):.3f}s/step", flush=True)
    if args.ckpt:
        CKPT.save(args.ckpt, {"params": params, "step": args.steps})
        print(f"saved checkpoint to {args.ckpt}")
    if state is not None:
        state.update(params=params, opt_state=opt_state)
    head = sum(losses[:5]) / min(5, len(losses))
    tail = sum(losses[-5:]) / min(5, len(losses))
    if not tail < head:
        raise AssertionError(f"loss did not decrease: {head:.4f} -> "
                             f"{tail:.4f}")
    print(f"done: loss {head:.4f} -> {tail:.4f} (5-step means)")
    return losses


if __name__ == "__main__":
    main()
