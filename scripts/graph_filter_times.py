"""Device and host times of the port's graph-filter kernel on one CUDA card.

    python3 scripts/graph_filter_times.py [--root DIR] [--label NAME]
                                          [--out FILE]

``--root`` is the checkout whose ``src/repro_torch`` is timed (default:
this one), so two versions can be timed in turns inside one run on one
card. For each case it prints one JSON line (and appends it to ``--out``
when given):

  * ``device_us``: the kernel's own time per launch, from
    ``torch.profiler`` (CUPTI): the summed device time of the
    ``graph_filter_kernel*`` entries over ``--reps`` calls, divided by the
    launch count;
  * ``event_us``: CUDA-event time over ``--reps`` back-to-back calls,
    divided by the count (host cost included where it exceeds the
    kernel's);
  * ``host_us``: the wrapper's host time per call, ``time.perf_counter``
    over ``--reps`` calls without a synchronisation (the enqueue);
  * the card's name and power limit.

Cases: (B, n, d, K) = (8, 128, 5130, 2) and (8, 64, 5130, 2), the serve
tick's filter at PAPER width; (1, 100, 5130, 2) forward and dW (the
single-cohort solve and meta-step); (8, 256, 5130, 2) and
(1, 256, 5130, 2). A version that refuses a case records the refusal.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CASES = [("fwd", 8, 128, 5130, 2), ("fwd", 8, 64, 5130, 2),
         ("fwd", 1, 100, 5130, 2), ("dW", 1, 100, 5130, 2),
         ("fwd", 8, 256, 5130, 2), ("fwd", 1, 256, 5130, 2)]


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def inputs(B, n, d, K, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if B == 1 else (B,)
    S = rng.random(lead + (n, n)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    W = rng.standard_normal(lead + (n, d)).astype(np.float32)
    h = (0.5 * rng.standard_normal(K + 1)).astype(np.float32)
    return [torch.tensor(x, device="cuda") for x in (S, W, h)]


def time_case(fn, reps):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_us = 1e3 * start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "graph_filter_kernel" in e.key):
            total += e.self_device_time_total
            count += e.count
    device_us = total / count if count else "not measured"
    return {"device_us": device_us, "launches_profiled": count,
            "event_us": event_us, "host_us": host_us}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default="this tree")
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("graph_filter_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(args.root, "src"))
    from repro_torch.kernels.graph_filter import graph_filter, ops
    ops.LIB.build()
    tag = card()
    for kind, B, n, d, K in CASES:
        S, W, h = inputs(B, n, d, K)
        if kind == "fwd":
            def fn():
                return graph_filter(S, W, h)
        else:
            def fn():
                return ops.graph_filter_bwd(S, W, h)
        row = {"label": args.label, "root": args.root, "card": tag,
               "case": kind, "B": B, "n": n, "d": d, "K": K}
        try:
            row.update(time_case(fn, args.reps))
        except (ValueError, RuntimeError) as e:
            row["refused"] = str(e)[:200]
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del S, W, h
    return 0


if __name__ == "__main__":
    sys.exit(main())
