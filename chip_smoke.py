"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``repro``. Phases, in
order; any failure exits non-zero:

  1. environment — torch version, the card's name and power limit, the
     TF32 switches (both off);
  2. build — the graph-filter kernel from ``csrc/graph_filter.cu``;
  3. kernel vs plain — the kernel against its plain PyTorch version on
     the same inputs (numpy, seeded) at the reference's test shapes and
     at every PAPER shape: one serve tick layer per bucket the serve run
     warms (derived from the same ``BucketSpec``) and the single-cohort
     solve, with the kernel's and the plain version's times there;
  4. serve — ``FederationServer`` at PAPER width (n=100, F=512, C=10,
     L=10, K=2) through the kernel: 24 requests over two buckets; the
     kernel's launch count must be ticks × L, every request's loss and
     accuracy must match ``solve_federation`` of the same cohort and
     seed through the plain filter, and its served W the plain forward
     on the same draws.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): memory and non-tensor
# f32 — the kernel runs FFMA in full f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

F32_TOL = 5e-5       # tests/test_kernels.py: f32 forward
BF16_TOL = 5e-2      # tests/test_kernels.py: bf16 forward
TEST_SHAPES = [(8, 16, 1), (100, 650, 2), (64, 128, 4), (33, 100, 2),
               (9, 5, 1)]
MAX_BATCH = 8
SIZES = (100, 60)    # served cohorts: 16 of SIZES[0] agents, 8 of SIZES[1]


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def paper_shapes(cfg, spec):
    """The buckets the serve run warms, and the (B, n, d, K) of the
    filter at ``cfg``'s widths: one serve tick layer per bucket
    (B = MAX_BATCH, n = the bucket's padded agent count), then one
    single-cohort solve layer (B = 1, n = SIZES[0])."""
    d, K = cfg.head_dim, cfg.filter_taps
    buckets = spec.buckets_for([(n, cfg.test_per_agent) for n in SIZES])
    return buckets, ([(MAX_BATCH, b.n_agents, d, K) for b in buckets]
                     + [(1, SIZES[0], d, K)])


def filter_inputs(rng, B, n, d, K):
    """Row-stochastic S, Gaussian W and taps from numpy; B=0 unbatched."""
    lead = () if B == 0 else (B,)
    S = rng.random(lead + (n, n)).astype(np.float32)
    S /= S.sum(-1, keepdims=True)
    W = rng.standard_normal(lead + (n, d)).astype(np.float32)
    h = (0.5 * rng.standard_normal(K + 1)).astype(np.float32)
    return [torch.tensor(x, device="cuda") for x in (S, W, h)]


def filter_bound_ms(B, n, d, K, w_bytes=4):
    """Least time for one filter call: each input read once, the output
    written once, against 2Kn²dB + (2K+1)ndB f32 operations."""
    B = max(B, 1)
    nbytes = 4 * B * n * n + 2 * w_bytes * B * n * d + 4 * (K + 1)
    flops = 2 * K * n * n * d * B + (2 * K + 1) * n * d * B
    t_mem, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem > t_ops
                                     else "operations")


def median_ms(fn, reps=15, inner=20):
    """Median over ``reps`` of CUDA-event time over ``inner`` calls."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def check_kernel(tag, paper):
    """Kernel vs plain at the test shapes and the ``paper`` shapes; times
    the latter. Returns the largest f32 |error| and {shape: times}."""
    from repro_torch.kernels.graph_filter import graph_filter, graph_filter_ref
    rng = np.random.default_rng(0)
    max_err, timing = 0.0, {}
    shapes = [(0,) + s for s in TEST_SHAPES] + list(paper)
    for B, n, d, K in shapes:
        S, W, h = filter_inputs(rng, B, n, d, K)
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            Wt = W.to(dtype)
            y = graph_filter(S, Wt, h)
            torch.cuda.synchronize()
            yr = graph_filter_ref(S, Wt, h)
            err = (y.float() - yr.float()).abs().max().item()
            if not torch.allclose(y.float(), yr.float(), atol=tol, rtol=tol):
                raise AssertionError(f"kernel != plain at B={B} n={n} d={d} "
                                     f"K={K} {dtype}: max |err| {err}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
            print(f"kernel vs plain B={B} n={n} d={d} K={K} {dtype}: "
                  f"max |err| {err:.3e} (tol {tol})")
        if (B, n, d, K) in paper:
            ms = median_ms(lambda: graph_filter(S, W, h))
            plain_ms = median_ms(lambda: graph_filter_ref(S, W, h))
            bound_ms, bound_by = filter_bound_ms(B, n, d, K)
            timing[(B, n, d, K)] = (ms, plain_ms, bound_ms, bound_by)
            print(f"[{tag}] graph_filter f32 B={B} n={n} d={d} K={K}: "
                  f"kernel {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                  f"({bound_by}), plain PyTorch version {plain_ms * 1e3:.2f} "
                  "us (labelled, no yardstick; no single PyTorch call "
                  "computes this function)")
    return max_err, timing


def serve(tag, cfg, spec, buckets, device="cuda", sizes=SIZES):
    """Serve 24 requests (16 of ``sizes[0]`` agents, 8 of ``sizes[1]``)
    at ``cfg``'s widths through the kernel, over ``spec``'s ``buckets``
    (the ones the kernel was checked at); returns the launch count."""
    from repro_torch.core import surf, unroll
    from repro_torch.core.tasks import resolve_task
    from repro_torch.data.synthetic import sample_dataset
    from repro_torch.engine.core import TrainState
    from repro_torch.kernels.graph_filter import graph_filter
    from repro_torch.serve import FederationServer

    gen = torch.Generator(device=device).manual_seed(0)
    theta = unroll.init_udgd(gen, cfg, init="dgd")
    server = FederationServer(cfg, theta, mix="cuda", buckets=spec,
                              max_batch=MAX_BATCH, device=device)
    warmed = server.warm([(n, cfg.test_per_agent) for n in sizes])
    if list(warmed) != list(buckets):
        raise AssertionError(f"warmed {warmed}, kernel checked at {buckets}")
    print(f"warmed buckets {warmed}")

    requests = []
    graph_filter.launches = 0
    for i in range(24):
        n = sizes[1] if i % 3 == 2 else sizes[0]
        cfg_r = dataclasses.replace(cfg, n_agents=n)
        _, S = surf.make_problem(cfg_r, seed=i, device=device)
        ds = sample_dataset(cfg_r, seed=1000 + i)
        requests.append((cfg_r, S, ds, server.submit(S, ds, seed=i)))
    server.drain()
    launches = graph_filter.launches
    ticks = server.metrics.ticks
    if launches != ticks * cfg.n_layers:
        raise AssertionError(f"kernel launches {launches} != ticks {ticks} "
                             f"x L {cfg.n_layers}")
    print(f"graph_filter launches {launches} = {ticks} ticks x "
          f"{cfg.n_layers} layers")

    # Held against the single-cohort solve at the true shape through the
    # plain filter. Loss and W: the kernel's f32 tolerance. Accuracy: an
    # argmax over logits that agree to ~1e-6 can flip on a near-tie, so
    # at most one test row per layer may differ: 1.5 / (n t).
    task = resolve_task(cfg)
    worst_loss, worst_acc, worst_w = 0.0, 0.0, 0.0
    for i, (cfg_r, S, ds, fut) in enumerate(requests):
        res = fut.result()
        ref = surf.solve_federation(cfg_r, TrainState(theta), S, ds, seed=i,
                                    device=device)
        L_, n, t = cfg.n_layers, cfg_r.n_agents, cfg_r.test_per_agent
        for k in ("loss_per_layer", "acc_per_layer"):
            if res[k].shape != (L_,) or not np.isfinite(res[k]).all():
                raise AssertionError(f"request {i}: bad {k} {res[k]}")
        if res["W"].shape != (n, cfg.head_dim):
            raise AssertionError(f"request {i}: W {res['W'].shape}")
        with torch.no_grad():
            draws = unroll.featurize_cohort(
                unroll.solve_generator(i, 0, device),
                task.to_batch(ds, device), cfg_r, task=task)
            W_ref = unroll.udgd_forward(theta, S, *draws, cfg_r,
                                        task=task)[0].cpu().numpy()
        np.testing.assert_allclose(res["W"], W_ref, atol=F32_TOL,
                                   rtol=F32_TOL)
        worst_w = max(worst_w, float(np.abs(res["W"] - W_ref).max()))
        np.testing.assert_allclose(res["loss_per_layer"],
                                   ref["loss_per_layer"],
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(res["acc_per_layer"],
                                   ref["acc_per_layer"],
                                   atol=1.5 / (n * t), rtol=0)
        worst_loss = max(worst_loss, float(np.abs(
            res["loss_per_layer"] - ref["loss_per_layer"]).max()))
        worst_acc = max(worst_acc, float(np.abs(
            res["acc_per_layer"] - ref["acc_per_layer"]).max()))
    final = [round(float(r[-1].result()["final_acc"]), 4) for r in requests]
    print(f"24 requests match solve_federation (plain filter): max |dloss| "
          f"{worst_loss:.3e}, max |dacc| {worst_acc:.3e}, max |dW| "
          f"{worst_w:.3e}; final acc {final}")
    summ = server.metrics.summary()
    summ["ms_per_tick"] = 1e3 * server.metrics.solve_time / ticks
    print(f"[{tag}] serve {cfg.n_layers} layers, d={cfg.head_dim}: "
          f"{json.dumps(summ)}")
    profile_tick(tag, server, cfg, device, sizes[0])
    return launches


def profile_tick(tag, server, cfg, device, n):
    """Where one full tick's device time goes: one more tick of
    ``max_batch`` n-agent requests under ``torch.profiler`` (after the
    launch count was read), device time summed by kind. The busy share
    is kernel time over the solve's wall time between two
    synchronizations; the copy of the results to the host follows the
    solve and is reported apart."""
    from repro_torch.core import surf
    from repro_torch.data.synthetic import sample_dataset
    cfg_r = dataclasses.replace(cfg, n_agents=n)
    for i in range(server.max_batch):
        _, S = surf.make_problem(cfg_r, seed=100 + i, device=device)
        server.submit(S, sample_dataset(cfg_r, seed=2000 + i), seed=i)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = server.metrics.solve_time
    with torch.profiler.profile(activities=acts) as prof:
        server.tick()
    solve_ms = 1e3 * (server.metrics.solve_time - before)
    kinds = {"graph_filter": 0.0, "gemm": 0.0, "other": 0.0, "copy": 0.0}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue                  # host-side ops; kernels are counted
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = ("graph_filter" if "graph_filter_kernel" in name
                else "copy" if name.startswith(("memcpy", "memset"))
                else "gemm" if "gemm" in name else "other")
        kinds[kind] += ms
        kernels.append((round(ms, 4), e.count, e.key[:60]))
    busy = kinds["graph_filter"] + kinds["gemm"] + kinds["other"]
    out = {"solve_ms_profiled": solve_ms,
           "device_ms": kinds if busy > 0 else "not measured",
           "device_busy_share": busy / solve_ms if busy > 0
           else "not measured",
           "top_kernels": sorted(kernels, reverse=True)[:8]}
    print(f"[{tag}] profiled tick (B={server.max_batch}, n={n}): "
          f"{json.dumps(out)}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.surf_paper import PAPER
    from repro_torch.kernels.graph_filter import loader
    from repro_torch.serve import BucketSpec
    from repro_torch.utils.device import resolve_device

    # 1. environment
    resolve_device()
    tag = card()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); card "
          f"{tag}; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 must be off")

    # 2. build
    info = loader.build()
    print(f"[{tag}] built {info['path'].name} in {info['seconds']:.1f} s")
    print(info["log"])

    # 3. kernel vs plain, at every shape the serve run launches
    spec = BucketSpec()
    buckets, paper = paper_shapes(PAPER, spec)
    max_err, timing = check_kernel(tag, paper)

    # 4. serve
    launches = serve(tag, PAPER, spec, buckets)

    # The record's times are those of the largest bucket's tick layer.
    ms, plain_ms, bound_ms, bound_by = timing[paper[0]]
    print(tag)
    print(json.dumps({"kernels": [{
        "name": "graph_filter", "route": "cuda",
        "source": "src/repro_torch/kernels/graph_filter/csrc/graph_filter.cu",
        "replaces": "src/repro/kernels/graph_filter/kernel.py:27",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
