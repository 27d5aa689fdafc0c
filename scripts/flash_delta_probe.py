"""How the flash backward kernel's dq moves when every key gains one
constant vector, on one CUDA card.

    python3 scripts/flash_delta_probe.py [--root CHECKOUT] [--out FILE]
    python3 scripts/flash_delta_probe.py --dtype bf16 [--out FILE]
    python3 scripts/flash_delta_probe.py --device cpu --small   # seconds

softmax(q (k + c)ᵀ) = softmax(q kᵀ): a constant vector c added to every
key shifts each score row by q·c, so o, dq, dk and dv do not move
analytically. The backward kernel forms dS = P (dP − δ) with δ =
rowsum(dO ∘ O) from the forward's O and P from its own scores; where
the two roundings differ by ε_i, dq_i = Σ_j dS_ij k_j gains
−ε_i Σ_j P_ij k_j, which carries c (the kernel now reads the keys
centred on their mean, which removes it). This script draws q, k, v and dO (numpy, seed 13, as
``chip_smoke.py`` 5b draws them) at whisper-small's cross-attention shape
(B=4, H=KV=12, Sq=448, Skv=1500, dh=64, non-causal), adds c = m · r · u
to every key (u a seeded unit vector, r the keys' rms row norm) for each
multiple m, and prints one JSON line per m with the card's name and power
limit: the kernel's and plain f32 autograd's (through ``attention_ref``)
distance from an f64 autograd step on the same f32 inputs, max |g − g64|
over max |g64| for dq, dk and dv; how far the kernel's dq moved from its
value at m = 0 (same measure); and Σ_j dk_j, zero analytically (a key
bias's gradient), for the kernel, plain f32 and f64 (max over batch
items, heads and columns, over max |dk64|). ``--root`` runs another checkout's
kernel (``git archive`` of a parent unpacked under build/), so two
versions compare in one call; ``--device cpu`` runs the plain version in
both roles (a check of the script, not of a kernel).

``--dtype bf16`` draws the same inputs rounded to bf16 (the shifted keys
rounded after the shift) and runs the kernel's bf16 entry; the f64 step
and plain autograd take the same bf16 values. Beside them it prints two
plain-torch emulations of the bf16 entry's arithmetic (P and dS rounded
to bf16 as operands, f32 sums, each gradient rounded once): its design
(dq's product on the centred keys, dk less its mean over the keys) and
the same without either, which shows what the two corrections are for.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPE = (4, 12, 12, 448, 1500, 64)      # chip_smoke.FLASH_WHISPER["cross"]
SMALL = (1, 2, 2, 40, 90, 16)
MULTIPLES = (0.0, 1.0, 3.0, 10.0, 30.0)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _attention64(q, k, v):
    """Non-causal softmax(q kᵀ / sqrt(dh)) v in f64 (``attention_ref``
    computes in f32 whatever its inputs), head h reading kv head h // G."""
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = (q @ k.mT) * q.shape[-1] ** -0.5
    return torch.softmax(s, dim=-1) @ v


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def _key_sum(dk, dk64):
    return (dk.double().sum(2).abs().max() / dk64.abs().max()).item()


def _emulated_bf16(q, k, v, do, corrected):
    """The bf16 backward entry's arithmetic in plain torch (non-causal),
    from bf16 q, k, v, do: the forward's o (P rounded to bf16 before P·V,
    o rounded once), delta = do·o, P and dP in f32, then P and dS rounded
    to bf16 as operands; dq on bf16(k − k̄) and dk less its key mean when
    ``corrected``, else dq on k and dk as summed. (dq, dk, dv) in f32."""
    B, H, Sq, dh = q.shape
    G = H // k.shape[1]
    bf = lambda t: t.to(torch.bfloat16).float()
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    ke, ve = (t.repeat_interleave(G, dim=1) for t in (kf, vf))
    p = torch.softmax((qf @ ke.mT) * dh ** -0.5, dim=-1)
    o = bf(bf(p) @ ve)
    ds = p * (dof @ ve.mT - (dof * o).sum(-1, keepdim=True))
    kk = bf(kf - kf.mean(2, keepdim=True)) if corrected else kf
    dq = bf(ds) @ kk.repeat_interleave(G, dim=1) * dh ** -0.5
    fold = lambda t: t.reshape(B, -1, G, *t.shape[2:]).sum(2)
    dk = fold(bf(ds).mT @ qf) * dh ** -0.5
    if corrected:
        dk = dk - dk.mean(2, keepdim=True)
    dv = fold(bf(p).mT @ dof)
    return [bf(t) for t in (dq, dk, dv)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help=f"shape {SMALL} instead of {SHAPE}")
    ap.add_argument("--out", default="")
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels.flash_attention import attention_ref, ops

    dev = torch.device(args.device)
    B, H, KV, Sq, Skv, dh = SMALL if args.small else SHAPE
    rng = np.random.default_rng(13)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh)).astype(
        np.float32), device=dev) for n, s in ((H, Sq), (KV, Skv), (KV, Skv),
                                             (H, Sq)))
    u = rng.standard_normal(dh)
    u = torch.tensor(u / np.linalg.norm(u), dtype=torch.float32, device=dev)
    r = k.square().sum(-1).mean().sqrt()
    tag = card() if dev.type == "cuda" else "cpu"
    bf16 = args.dtype == "bf16"
    if bf16:
        q, v, do = (t.to(torch.bfloat16) for t in (q, v, do))
    dq0 = None
    for m in MULTIPLES:
        kc = k + (m * r) * u
        if bf16:
            kc = kc.to(torch.bfloat16)
        if dev.type == "cuda":
            o, lse = ops._launch(q, kc, v, False, 0, want_lse=True)
            got = ops._launch_bwd(q, kc, v, o, lse, do, False, 0)
        else:
            xs = [t.clone().requires_grad_() for t in (q, kc, v)]
            got = torch.autograd.grad(attention_ref(*xs, causal=False), xs,
                                      do)
        xs = [t.clone().requires_grad_() for t in (q, kc, v)]
        plain = torch.autograd.grad(attention_ref(*xs, causal=False), xs, do)
        x64 = [t.double().requires_grad_() for t in (q, kc, v)]
        g64 = torch.autograd.grad(_attention64(*x64), x64, do.double())
        if dq0 is None:
            dq0 = got[0].double()
        rec = {"card": tag, "root": args.root, "shape": [B, H, KV, Sq, Skv,
                                                         dh],
               "dtype": args.dtype,
               "c_over_key_rms": m, "c_norm": (m * r).item(),
               "kernel_vs_f64": {n: _rel(g, r64) for n, g, r64 in
                                 zip(("dq", "dk", "dv"), got, g64)},
               "plain_vs_f64": {n: _rel(g, r64) for n, g, r64 in
                                zip(("dq", "dk", "dv"), plain, g64)},
               "kernel_dq_moved": _rel(got[0], dq0),
               "dk_key_sum": {"kernel": _key_sum(got[1], g64[1]),
                              "plain": _key_sum(plain[1], g64[1]),
                              "f64": _key_sum(g64[1], g64[1])}}
        if bf16:
            for name, corrected in (("emulated_design", True),
                                    ("emulated_uncorrected", False)):
                em = _emulated_bf16(q, kc, v, do, corrected)
                rec[f"{name}_vs_f64"] = {n: _rel(g, r64) for n, g, r64 in
                                         zip(("dq", "dk", "dv"), em, g64)}
                rec["dk_key_sum"][name] = _key_sum(em[1], g64[1])
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del got, plain, g64, xs, x64
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
