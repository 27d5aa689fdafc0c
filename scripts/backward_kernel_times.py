"""Device time of the port's backward kernels (or its forward kernels) by
part, on one CUDA card.

    python3 scripts/backward_kernel_times.py [--dtype f32|bf16] [--root DIR]
                                             [--label NAME] [--reps N]
                                             [--out FILE] [--forward]
                                             [--only flash|wkv]

Each backward launch is several CUDA kernels: flash attention's f32 entry
is ``kmean_part_kernel``, ``kmean_sum_kernel``, ``centre_kernel``,
``delta_f32_kernel``, ``dkdv_tf32_kernel`` and ``dq_tf32_kernel`` (the
split-TF32 wgmma design; before it, on mma.sync: ``kmean_kernel``,
``centre_kernel``, ``delta_kernel``, ``dkdv_kernel`` and ``dq_kernel``);
its bf16 entry ``kmean_part_kernel``,
``kmean_sum_kernel``, ``centre8_kernel``, ``delta_tiles_kernel``,
``dkdv_wgmma_kernel`` and ``dq_wgmma_kernel`` (before the wgmma design:
``kmean_kernel``, ``centre_kernel``, ``delta_kernel``, ``dkdv_bf16_kernel``,
``dq_bf16_kernel``); wkv's is ``wkv_bwd_state_kernel`` (the gradients
at every 64-step chunk boundary, split TF32 on wgmma; the states there
are those the forward launch returned, as the training path through
``WKV`` passes them), ``wkv_bwd_chunk_kernel`` (the chunks in parallel)
and ``wkv_du_kernel`` (before the chunked design: ``wkv_bwd_kernel`` and
``wkv_reduce_kernel``, which took no states).
For each case it prints one JSON line (and appends it to ``--out`` when
given): the CUDA-event time per launch over ``--reps`` back-to-back
launches (``event_ms``), each part's device time per launch from
``torch.profiler`` over the same number of launches (``parts_ms``), for
wkv the device memory one call allocates (``peak_gb``: outputs and
scratch), and the card's name and power limit. Each flash case also times
``scaled_dot_product_attention``'s backward in the same dtype
(memory-efficient, K/V expanded to H heads, a boolean mask for a window:
``sdpa_ms``), the yardstick ``chip_smoke.py`` 5b uses.

``--forward`` times the forward kernels instead, in ``--dtype``: one launch
of ``ops._launch`` per call at phase 5's five shapes (qwen3-4b, gemma3's
window-1024 and global layers, H=64/KV=8 and H=KV=40; B=4, S=2048,
dh=128, causal) and whisper-small's encoder and cross shapes
(non-causal), by part: in f32 ``fwd_tf32_kernel`` (the split-TF32 wgmma
design) and ``split_kv_kernel`` (its split pass; the mma.sync kernel
before it: ``flash_attention_kernel``), in bf16 ``fwd_wgmma_kernel`` (the
wgmma design; ``flash_attention_kernel`` before it), and in either any
copy the wrapper makes (``elementwise_kernel``). Beside each shape
``scaled_dot_product_attention``'s forward in the same dtype
(``sdpa_ms``), as ``chip_smoke.py`` 5 times it: bf16 in its default
dispatch (GQA by ``enable_gqa``), f32 on the memory-efficient backend with
K/V expanded to H heads (f32's default dispatch takes the math
fallback); a boolean mask for the window. Then the wkv forward at the
rwkv6-1.6b prefill shape by part: ``wkv_state_kernel`` (the chunk states)
and ``wkv_chunk_kernel`` (y, the chunks in parallel; ``wkv_kernel``
before the chunked design).

``--only`` times one kernel family's cases (default: both).

``--root`` is the checkout whose ``src/repro_torch`` is timed (default:
this one), so two versions can be timed in turns inside one run on one
card (``scripts/graph_filter_times.py`` does the same).

Cases: flash attention at the qwen3-4b training shape (B=4, H=32, KV=8,
S=2048, dh=128, causal), the gemma3 window-1024 shape (KV=16), gemma3's
global shape (KV=16, no window) and whisper-small's encoder (B=4,
H=KV=12, S=1500, dh=64, non-causal) and cross-attention (Sq=448,
Skv=1500), in either dtype; wkv at the rwkv6-1.6b training shape (B=4,
H=32, T=2048, dk=64), in either dtype; inputs drawn with numpy from a
fixed seed, as ``chip_smoke.py`` 5b and 6b draw them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (B, H, KV, Sq, Skv, dh, window, causal)
FLASH = {"flash qwen3-4b": (4, 32, 8, 2048, 2048, 128, 0, True),
         "flash gemma3 window 1024": (4, 32, 16, 2048, 2048, 128, 1024,
                                      True),
         "flash gemma3 global": (4, 32, 16, 2048, 2048, 128, 0, True),
         "flash whisper encoder": (4, 12, 12, 1500, 1500, 64, 0, False),
         "flash whisper cross": (4, 12, 12, 448, 1500, 64, 0, False)}
# wkv (B, H, T, dk): the rwkv6-1.6b training and prefill shape
WKV = {"wkv rwkv6-1.6b": (4, 32, 2048, 64)}
# The flash forward's cases (B, H, KV, Sq, Skv, dh, window, causal):
# chip_smoke.py 5's full-width shapes and its whisper shapes.
FORWARD = {"flash qwen3-4b": (4, 32, 8, 2048, 2048, 128, 0, True),
           "flash gemma3 window 1024": (4, 32, 16, 2048, 2048, 128, 1024,
                                        True),
           "flash gemma3 global": (4, 32, 16, 2048, 2048, 128, 0, True),
           "flash H=64 KV=8": (4, 64, 8, 2048, 2048, 128, 0, True),
           "flash H=KV=40": (4, 40, 40, 2048, 2048, 128, 0, True),
           "flash whisper encoder": (4, 12, 12, 1500, 1500, 64, 0, False),
           "flash whisper cross": (4, 12, 12, 448, 1500, 64, 0, False)}
PARTS = ("fwd_wgmma_kernel", "fwd_tf32_kernel", "split_kv_kernel",
         "flash_attention_kernel", "elementwise_kernel",
         "delta_kernel", "delta_tiles_kernel", "delta_f32_kernel",
         "dkdv_tf32_kernel", "dq_tf32_kernel", "kmean_kernel",
         "kmean_part_kernel", "kmean_sum_kernel", "centre_kernel",
         "centre8_kernel", "dkdv_kernel", "dq_kernel", "dkdv_bf16_kernel",
         "dq_bf16_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel",
         "wkv_bwd_kernel", "wkv_reduce_kernel", "wkv_kernel",
         "wkv_state_kernel", "wkv_chunk_kernel", "wkv_bwd_state_kernel",
         "wkv_bwd_chunk_kernel", "wkv_du_kernel")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def measure(fn, reps):
    """(CUDA-event ms per call, {part: profiled device ms per call})."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    event_ms = a.elapsed_time(b) / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        part = _part(e.key)
        if part is not None and e.device_time_total > 0:
            parts[part] = parts.get(part, 0.0) + e.device_time_total
    return event_ms, {k: v / 1e3 / reps for k, v in parts.items()}


def _part(key):
    """The PARTS entry a profiler key names (the longest that matches)."""
    found = [p for p in PARTS if p + "<" in key or key.endswith(p)
             or p + "(" in key]
    return max(found, key=len) if found else None


def sdpa_backward_ms(q, k, v, do, causal, window, reps):
    """``scaled_dot_product_attention``'s backward in q's dtype,
    memory-efficient, K/V expanded to H heads (a boolean mask for a
    window)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    H, KV, Sq = q.shape[1], k.shape[1], q.shape[2]
    mask = None
    if window:
        i = torch.arange(Sq, device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
    xe = [t.clone().requires_grad_() for t in (q, ke, ve)]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        oe = torch.nn.functional.scaled_dot_product_attention(
            *xe, attn_mask=mask, is_causal=causal and not window)
        ms, _ = measure(lambda: torch.autograd.grad(oe, xe, do,
                                                    retain_graph=True), reps)
    return ms


def sdpa_forward_ms(q, k, v, causal, window, reps):
    """``scaled_dot_product_attention``'s forward in q's dtype (a boolean
    mask for a window): bf16 in its default dispatch, GQA by
    ``enable_gqa``; f32 on the memory-efficient backend with K/V expanded
    to H heads outside the timed call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None
    if window:
        i = torch.arange(q.shape[2], device="cuda")
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    is_causal = causal and not window
    if q.dtype == torch.bfloat16:
        ms, _ = measure(lambda: sdpa(q, k, v, attn_mask=mask,
                                     is_causal=is_causal, enable_gqa=True),
                        reps)
        return ms
    G = q.shape[1] // k.shape[1]
    ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        ms, _ = measure(lambda: sdpa(q, ke, ve, attn_mask=mask,
                                     is_causal=is_causal), reps)
    return ms


def forward_rows(fa, args, tag, rng, dtype):
    """One row per ``FORWARD`` case: the forward by part and SDPA's."""
    rows = []
    with torch.no_grad():
        for name, (B, H, KV, Sq, Skv, dh, win, causal) in FORWARD.items():
            q, k, v = (torch.tensor(rng.standard_normal((B, n, s, dh))
                                    .astype(np.float32), device="cuda")
                       .to(dtype)
                       for n, s in ((H, Sq), (KV, Skv), (KV, Skv)))
            ms, parts = measure(lambda: fa._launch(q, k, v, causal, win),
                                args.reps)
            rows.append({"case": name, "dtype": args.dtype,
                         "pass": "forward", "label": args.label,
                         "root": args.root,
                         "shape": [B, H, KV, Sq, Skv, dh, win, causal],
                         "event_ms": ms, "parts_ms": parts,
                         "sdpa_ms": sdpa_forward_ms(q, k, v, causal, win,
                                                    args.reps),
                         "card": tag})
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def peak_gb(fn):
    """Device memory one call allocates beyond what is held before it
    (outputs and scratch), GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def wkv_rows(wk, args, tag, rng, dtype, name, B, H, T, dk):
    """The wkv forward (``--forward``) or backward at one shape, by part,
    with the device memory a call allocates (``peak_gb``); the backward
    with the forward's chunk states where the tree's wrapper returns them,
    as its autograd Function calls it."""
    def mk():
        return 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
    u = torch.tensor((0.1 * rng.standard_normal((H, dk))).astype(np.float32),
                     device="cuda")
    xs = [torch.tensor(a, device="cuda").to(dtype) for a in (r, k, v, w)]
    xs.append(u)
    dy = torch.tensor(mk(), device="cuda").to(dtype)
    base = {"case": name, "dtype": args.dtype, "label": args.label,
            "root": args.root, "shape": [B, H, T, dk], "card": tag}
    if args.forward:
        fn = lambda: wk._launch(*xs)
        ms, parts = measure(fn, args.reps)
        return [dict(base, **{"pass": "forward", "event_ms": ms,
                              "parts_ms": parts, "peak_gb": peak_gb(fn)})]
    out = wk._launch(*xs)
    if len(out) == 3:                    # the chunked design's wrapper
        fn = lambda: wk._launch_bwd(*xs, dy, None, out[2])
    else:
        fn = lambda: wk._launch_bwd(*xs, dy)
    ms, parts = measure(fn, args.reps)
    return [dict(base, event_ms=ms, parts_ms=parts, peak_gb=peak_gb(fn))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--only", choices=("flash", "wkv"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("backward_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as wk
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    tag = card()
    rng = np.random.default_rng(5)
    flash = args.only in (None, "flash")
    rows = (forward_rows(fa, args, tag, rng, dtype)
            if args.forward and flash else [])
    cases = FLASH if flash and not args.forward else {}
    for name, (B, H, KV, Sq, Skv, dh, win, causal) in cases.items():
        q, k, v, do = (torch.tensor(rng.standard_normal((B, n, s, dh))
                                    .astype(np.float32), device="cuda")
                       .to(dtype)
                       for n, s in ((H, Sq), (KV, Skv), (KV, Skv), (H, Sq)))
        o, lse = fa._launch(q, k, v, causal, win, want_lse=True)
        ms, parts = measure(lambda: fa._launch_bwd(q, k, v, o, lse, do,
                                                   causal, win), args.reps)
        row = {"case": name, "dtype": args.dtype, "label": args.label,
               "root": args.root, "shape": [B, H, KV, Sq, Skv, dh, win,
                                            causal],
               "event_ms": ms, "parts_ms": parts, "card": tag}
        row["sdpa_ms"] = sdpa_backward_ms(q, k, v, do, causal, win,
                                          args.reps)
        rows.append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for name, (B, H, T, dk) in (WKV if args.only in (None, "wkv")
                                else {}).items():
        rows += wkv_rows(wk, args, tag, rng, dtype, name, B, H, T, dk)
    for row in rows:
        line = json.dumps(row)
        print(line)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
