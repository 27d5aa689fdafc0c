"""Device time of the port's backward kernels by part, on one CUDA card.

    python3 scripts/backward_kernel_times.py [--reps N] [--out FILE]

Each backward launch is several CUDA kernels: flash attention's is
``delta_kernel``, ``dkdv_kernel`` and ``dq_kernel``; wkv's is
``wkv_bwd_kernel`` and ``wkv_reduce_kernel``. For each case it prints
one JSON line (and appends it to ``--out`` when given): the CUDA-event
time per launch over ``--reps`` back-to-back launches (``event_ms``),
each part's device time per launch from ``torch.profiler`` over the same
number of launches (``parts_ms``), and the card's name and power limit.

Cases: flash attention at the qwen3-4b training shape (B=4, H=32, KV=8,
S=2048, dh=128, causal) and the gemma3 window-1024 shape (KV=16); wkv at
the rwkv6-1.6b training shape (B=4, H=32, T=2048, dk=64); f32 inputs
drawn with numpy from a fixed seed, as ``chip_smoke.py`` 5b and 6b draw
them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

FLASH = {"flash qwen3-4b": (4, 32, 8, 2048, 128, 0),
         "flash gemma3 window 1024": (4, 32, 16, 2048, 128, 1024)}
WKV = {"wkv rwkv6-1.6b": (4, 32, 2048, 64)}
PARTS = ("delta_kernel", "dkdv_kernel", "dq_kernel", "wkv_bwd_kernel",
         "wkv_reduce_kernel")


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
        for part in PARTS:
            if part in e.key and e.device_time_total > 0:
                parts[part] = parts.get(part, 0.0) + e.device_time_total
    return event_ms, {k: v / 1e3 / reps for k, v in parts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("backward_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssm_scan import ops as wk
    tag = card()
    rng = np.random.default_rng(5)
    rows = []
    for name, (B, H, KV, S, dh, win) in FLASH.items():
        q, k, v, do = (torch.tensor(rng.standard_normal((B, n, S, dh))
                                    .astype(np.float32), device="cuda")
                       for n in (H, KV, KV, H))
        o, lse = fa._launch(q, k, v, True, win, want_lse=True)
        ms, parts = measure(lambda: fa._launch_bwd(q, k, v, o, lse, do, True,
                                                   win), args.reps)
        rows.append({"case": name, "shape": [B, H, KV, S, dh, win],
                     "event_ms": ms, "parts_ms": parts, "card": tag})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for name, (B, H, T, dk) in WKV.items():
        def mk():
            return 0.5 * rng.standard_normal((B, H, T, dk)).astype(np.float32)
        r, k, v = mk(), mk(), mk()
        w = (0.5 + 0.5 / (1 + np.exp(-mk()))).astype(np.float32)
        u = (0.1 * rng.standard_normal((H, dk))).astype(np.float32)
        xs = [torch.tensor(a, device="cuda") for a in (r, k, v, w, u)]
        dy = torch.tensor(mk(), device="cuda")
        ms, parts = measure(lambda: wk._launch_bwd(*xs, dy), args.reps)
        rows.append({"case": name, "shape": [B, H, T, dk], "event_ms": ms,
                     "parts_ms": parts, "card": tag})
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
