"""How reproducible rwkv6-1.6b's f32 training gradient is, on one CUDA card.

    python3 scripts/rwkv_grad_conditioning.py [--cases 24:512,12:512]
                                              [--out FILE]

For each case (layers:sequence length) it draws rwkv6-1.6b at full width
with that depth (``init_lm`` seed 0), takes the token pipeline's first
batch (B=4, S=2048: ``chip_smoke.py`` phase 13's) cut to the length,
and computes one remat step's loss and gradients
(``launch.steps.loss_and_grads``, ``chunked_ce=512``) four ways, all
from the same parameters and batch:

  * ``kernel``: the flash / wkv kernels, forward and backward;
  * ``plain``: the plain wkv recurrence (``plain_kernels=True``);
  * ``plain_bonus_apart``: the plain recurrence with the bonus term
    (r · (u ⊙ k)) v summed apart, the order the kernel sums y in;
  * ``f64``: the plain recurrence evaluated in f64.

It prints one JSON line per case (and appends it to ``--out``): each
path's loss, global gradient norm, and largest and median per-tensor
distance from the f64 step (max |g − g64| over max |g64|), with the
card's name and power limit. Three f32 evaluations scattering far
around the f64 step mean the f32 gradient is not a reproducible quantity
at that depth (``chip_smoke.py`` phase 13 gates it only where it is).
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


def wkv_bonus_apart(r, k, v, w, u):
    """The plain f32 recurrence with y_t = r_t S_{t-1} + (r_t · (u ⊙ k_t))
    v_t, the bonus term summed apart (as the kernel sums it)."""
    B, H, T, dk = r.shape
    S = torch.zeros((B, H, dk, dk), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, :, t] for a in (r, k, v, w))
        c = (rt * u * kt).sum(-1, keepdim=True)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, S) + c * vt)
        S = wt[..., :, None] * S + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=2), S


def main(argv=None):
    import chip_smoke as CS
    from repro_torch import flags
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="24:512,24:128,18:512,12:512,6:512")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    resolve_device()
    card = CS.card()
    flags.parse_opts("chunked_ce=512")
    for case in args.cases.split(","):
        L, S = (int(x) for x in case.split(":"))
        cfg = dataclasses.replace(get_config("rwkv6-1.6b"), n_layers=L)
        params = M.init_lm(cfg, 0, device="cuda")
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device="cuda")
                 [:, :S] for k, v in next(TokenPipeline(
                     cfg.vocab, 4, 2048, seed=0)).items()}
        paths = {"kernel": None, "plain": None,
                 "plain_bonus_apart": wkv_bonus_apart, "f64": CS._wkv_f64}
        out = {}
        for name, recurrence in paths.items():
            if recurrence is None:
                (loss, _), g = loss_and_grads(cfg, params, batch, remat=True,
                                              plain_kernels=name == "plain")
            else:
                with mock.patch.object(ssm, "wkv_ref", recurrence):
                    (loss, _), g = loss_and_grads(cfg, params, batch,
                                                  remat=True,
                                                  plain_kernels=True)
            out[name] = (loss.item(), g)
        ref = out["f64"][1]
        rec = {"card": card, "layers": L, "seq": S, "batch": 4}
        for name, (loss, g) in out.items():
            rows = CS._grad_rows(g, ref)
            rec[name] = {"loss": loss, "grad_norm": CS._global_norm(g),
                         "vs_f64_worst_rel": max(rows.values()),
                         "vs_f64_worst": max(rows, key=rows.get),
                         "vs_f64_median_rel": float(np.median(
                             list(rows.values())))}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        del out, ref, params, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
