"""Where whisper-small's f32 training gradient sits against an f64 step, on
one CUDA card.

    python3 scripts/whisper_grad_f64.py [--out FILE]
    python3 scripts/whisper_grad_f64.py --reduced --device cpu   # seconds

It draws whisper-small at full width and depth (``init_lm`` seed 0), takes
``chip_smoke.py`` phase 19's batch (the token pipeline's first batch,
B=4, S=448, and 1500 seeded frames per row) and computes one remat step's
loss and gradients (``launch.steps.loss_and_grads``, ``chunked_ce=512``)
several ways, all from the same parameters and batch:

  * ``kernel``: the flash kernels, forward and backward (phase 19's step);
  * ``plain``: every attention through the plain ``sdpa``
    (``plain_kernels=True``, phase 19's reference);
  * ``plain_<kind>`` for kind in encoder, self, cross: the kernels but for
    that kind of attention call, which goes through the plain ``sdpa``;
  * ``f64``: the plain step with the parameters, the frames and the
    accumulation dtype (``layers.ACC``) in f64.

It prints one JSON line (and appends it to ``--out``) with the card's
name and power limit: each path's loss, global gradient norm, and its
largest and median per-tensor distance from the f64 step (max |g - g64|
over max |g64|, the key projections' biases aside: their gradient is
zero analytically); and, for the tensor farthest between the kernel and
plain steps and every ``ln_x.bias`` (phase 19's worst), each path's
distance from the f64 step and from the plain step, per layer too for a
layer's stacked tensor (each layer's max |g - g64| over the whole
tensor's max |g64|). A path nearer the f64 step than another is the more
accurate of the two on that tensor.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _rel(got, ref, scale):
    return ((got.double() - ref.double()).abs().max() / scale).item()


def main(argv=None):
    import chip_smoke as CS
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config, B=2, S=16, 24 frames (a CPU check)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(CS.WHISPER)
    B, S, n_frames = CS.TRAIN_BATCH, CS.WHISPER_SEQ, None
    if args.reduced:
        cfg, B, S, n_frames = cfg.reduced(), 2, 16, 24
    prev = flags.get()
    flags.parse_opts(CS.TRAIN_OPTS)
    try:
        params = M.init_lm(cfg, 0, device=device)
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                 for k, v in next(TokenPipeline(cfg.vocab, B, S,
                                                seed=0)).items()}
        batch["frames"] = CS.whisper_frames(cfg, B, device, n_frames)
        full_attention = A.full_attention

        def plain_for(kind):
            def full(*a, causal=True, kv_x=None, plain=False, **kw):
                this = ("self" if causal else "encoder" if kv_x is None
                        else "cross")
                return full_attention(*a, causal=causal, kv_x=kv_x,
                                      plain=plain or this == kind, **kw)
            return mock.patch.object(A, "full_attention", full)

        grads, losses = {}, {}
        for name in ("kernel", "plain", "plain_encoder", "plain_self",
                     "plain_cross"):
            if name.startswith("plain_"):
                with plain_for(name[len("plain_"):]):
                    (loss, _), g = loss_and_grads(cfg, params, batch,
                                                  remat=True)
            else:
                (loss, _), g = loss_and_grads(cfg, params, batch, remat=True,
                                              plain_kernels=name == "plain")
            losses[name], grads[name] = loss.item(), g
        with mock.patch.object(L, "ACC", torch.float64):
            b64 = dict(batch, frames=batch["frames"].double())
            (loss, _), g = loss_and_grads(cfg, _to(params, torch.float64),
                                          b64, remat=True, plain_kernels=True)
        losses["f64"], grads["f64"] = loss.item(), g
        del b64
        if any(t.dtype != torch.float64 for _, t in CS._named(g)):
            raise AssertionError("the f64 step left a gradient in f32")
    finally:
        flags.set_flags(**dataclasses.asdict(prev))

    ref = grads["f64"]
    kp = CS._grad_rows(grads["kernel"], grads["plain"])
    worst = max(kp, key=kp.get)
    names = [n for n, _ in CS._named(ref)
             if not CS._key_bias(n)
             and (n == worst or n.endswith("ln_x.bias"))]
    rec = {"card": CS.card() if device.type == "cuda" else "cpu",
           "arch": cfg.name, "reduced": args.reduced, "batch": B, "seq": S,
           "frames": batch["frames"].shape[1],
           "kernel_vs_plain_worst": worst,
           "kernel_vs_plain_worst_rel": kp[worst], "paths": {},
           "tensors": {}}
    for name, g in grads.items():
        rows = CS._grad_rows(g, ref)
        rec["paths"][name] = {
            "loss": losses[name], "grad_norm": CS._global_norm(g),
            "vs_f64_worst": max(rows, key=rows.get),
            "vs_f64_worst_rel": max(rows.values()),
            "vs_f64_median_rel": float(np.median(list(rows.values())))}
    tensors = {name: dict(CS._named(g)) for name, g in grads.items()}
    for n in names:
        r64, rp = tensors["f64"][n], tensors["plain"][n]
        s64, sp = r64.abs().max().double(), rp.abs().max().double()
        rec["tensors"][n] = {
            "shape": list(r64.shape), "max_abs_f64": s64.item(),
            **{name: {"vs_f64": _rel(t[n], r64, s64),
                      "vs_plain": _rel(t[n], rp, sp),
                      **({"vs_f64_per_layer": [_rel(t[n][i], r64[i], s64)
                                               for i in range(len(r64))]}
                         if ".segments." in f".{n}" else {})}
               for name, t in tensors.items() if name != "f64"}}
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
