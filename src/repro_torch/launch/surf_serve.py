"""Amortized-solver serving driver (the port of
``repro.launch.surf_serve``): meta-train once, then replay a synthetic
request trace — NEW federations (fresh topology + cohort dataset per
request, ragged sizes) — through ``repro_torch.serve``'s
continuous-batching server, and write ``BENCH_serve.json`` under
``--out``.

The run ASSERTS the three claims that make the numbers trustworthy:

  1. build economy — warming k shape buckets builds the bucket solver
     EXACTLY k times (misses of the server's bucket cache), and the whole
     replay builds none;
  2. parity — EVERY request's served result matches the single-cohort
     solve (``core.surf.solve_federation`` at the request's true shape,
     same generator) despite bucket padding and batching;
  3. coverage — the trace spans >= 2 shape buckets (the default trace
     has 220 requests, over the serving claim's floor of 200).

A ``sharded_async`` section then replays a trace prefix per shard count
through a MESH-SHARDED server (the request axis split over the devices
of the mesh's 'agent' axis, ``serve.request_shardings``) driven by
``serve.AsyncDriver``: federations/s against shards, tick utilization
and a parity spot-check, with the mesh fingerprint stamped. Shard counts
come from the visible CUDA cards (1, 2, 4, 8 that divide their count
and ``--max-batch``), or, with ``--simulate-shards K``, from K copies of
the run's one device: every row then says ``"simulated": true``, because
shards of one device show the cost of the decomposition, not scaling.

  PYTHONPATH=src python -m repro_torch.launch.surf_serve --device cpu \\
      --requests 220 --simulate-shards 4

On the card (the default device) every layer's graph filter runs through
the CUDA kernel; the JSON names the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs.surf_paper import SMOKE, SPARSE_SMOKE
from repro_torch.core import surf
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.launch.mesh import host_device_count, make_surf_mesh
from repro_torch.serve import AsyncDriver, BucketSpec, FederationServer
from repro_torch.sharding.surf_rules import mesh_fingerprint
from repro_torch.utils.device import resolve_device

DEFAULT_OUT = os.path.join("build", "bench_torch")
BUCKETS = BucketSpec(agent_sizes=(8, 16, 32), row_sizes=(4, 8, 16))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=220,
                    help="trace length (acceptance floor: 200)")
    ap.add_argument("--sizes", default="6,8,12,16",
                    help="cohort sizes the trace draws from")
    ap.add_argument("--rows", default="4,6",
                    help="test-rows-per-agent values the trace draws from")
    ap.add_argument("--dist", choices=("uniform", "zipf"), default="zipf",
                    help="cohort-size distribution (zipf skews small)")
    ap.add_argument("--mix", choices=tuple(m for m in U.DENSE_MIXES if m),
                    default="dense",
                    help="serve mixer (on the card every name runs the "
                    "graph-filter kernel)")
    ap.add_argument("--task", choices=("classification", "sparse"),
                    default="classification")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--sharded-requests", type=int, default=64,
                    help="trace prefix replayed per sharded+async row "
                         "(0 disables the sharded section)")
    ap.add_argument("--simulate-shards", type=int, default=0,
                    help="build the sharded rows' meshes from this many "
                         "copies of the run's device (simulated shards; "
                         "default: the visible CUDA cards)")
    ap.add_argument("--steps", type=int, default=40,
                    help="meta-training steps before serving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output dir (default: {DEFAULT_OUT})")
    return ap


def _size_probs(sizes, dist):
    if dist == "uniform":
        return np.full(len(sizes), 1.0 / len(sizes))
    ranks = np.argsort(np.argsort(sizes)) + 1.0      # small sizes first
    w = 1.0 / ranks ** 1.2
    return w / w.sum()


def synth_trace(cfg, task, sizes, rows, dist, n_requests, seed, device):
    """The synthetic request stream: per request a cohort size n and
    test-rows t from the configured distribution, a FRESH topology
    (request-indexed graph seed) and a FRESH dataset — every request is
    a federation the model has never seen (the amortization claim)."""
    rng = np.random.default_rng(seed)
    probs = _size_probs(sizes, dist)
    out = []
    for i in range(n_requests):
        n = int(rng.choice(sizes, p=probs))
        t = int(rng.choice(rows))
        cfg_r = dataclasses.replace(cfg, n_agents=n, test_per_agent=t)
        _, S = surf.make_problem(cfg_r, seed=10_000 + i, device=device)
        ds = task.synth_datasets(cfg_r, 1, seed=20_000 + i)[0]
        out.append({"cfg": cfg_r, "S": S, "ds": ds, "seed": i % 16})
    return out


def _max_delta(state, reqs, futs, device):
    """Largest |Δ final_loss| and |Δ final_acc| of served results against
    the single-cohort solve of each request."""
    dloss = dacc = 0.0
    for req, fut in zip(reqs, futs):
        ref = surf.solve_federation(req["cfg"], state, req["S"], req["ds"],
                                    seed=req["seed"], device=device)
        res = fut.result()
        dloss = max(dloss, abs(float(res["final_loss"] - ref["final_loss"])))
        dacc = max(dacc, abs(float(res["final_acc"] - ref["final_acc"])))
    return dloss, dacc


def bench_sharded_async(cfg, state, trace, args, sizes, rows, tol, device):
    """The sharded+async rows: replay a trace prefix through a
    mesh-sharded server driven by ``AsyncDriver``, one row per shard
    count, with a parity spot-check against the solo solve. The meshes
    span the visible CUDA cards, or ``--simulate-shards`` copies of
    ``device`` (rows stamped ``simulated``)."""
    if args.simulate_shards:
        ndev, devices = args.simulate_shards, [device] * args.simulate_shards
    else:
        ndev = host_device_count() if device.type == "cuda" else 1
        devices = None
    shard_counts = [s for s in (1, 2, 4, 8)
                    if s <= ndev and ndev % s == 0
                    and args.max_batch % s == 0]
    sub = trace[:args.sharded_requests]
    out = []
    for shards in shard_counts:
        mesh = (make_surf_mesh(1, shards, devices=devices) if shards > 1
                else None)
        server = FederationServer(cfg, state.theta, mix=args.mix,
                                  max_batch=args.max_batch, buckets=BUCKETS,
                                  device=device, mesh=mesh)
        server.warm((n, t) for n in sizes for t in rows)
        driver = AsyncDriver(server)
        with driver:
            t0 = time.perf_counter()
            futs = [driver.submit(req["S"], req["ds"], seed=req["seed"])
                    for req in sub]
            driver.wait(futs, timeout_s=300.0)
            wall = time.perf_counter() - t0
        max_d = max(_max_delta(state, sub[:8], futs[:8], device))
        if max_d >= tol:
            raise AssertionError(
                f"sharded serve (shards={shards}) diverged from the "
                f"single-cohort solve: {max_d:.2e} (tol {tol})")
        stats = driver.stats()
        summary = server.metrics.summary()
        row = {"shards": shards,
               "mesh_fingerprint": mesh_fingerprint(mesh),
               "simulated": bool(mesh is not None and mesh.simulated),
               "requests": len(sub),
               "federations_per_sec": summary["federations_per_sec"],
               "async_wall_s": wall,
               "async_federations_per_sec": (len(sub) / wall
                                             if wall > 0 else 0.0),
               "tick_utilization": stats["tick_utilization"],
               "ticks": stats["ticks"], "parity_spot_max_delta": max_d,
               "bucket_cache": server.cache_stats()}
        out.append(row)
        sim = " (simulated shards of one device)" if row["simulated"] else ""
        print(f"sharded+async shards={shards}{sim}: "
              f"{row['async_federations_per_sec']:.1f} federations/s "
              f"util={row['tick_utilization']:.2f} parity={max_d:.2e}")
    return out


def main(argv=None, parser=None):
    args = (parser or build_parser()).parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = [int(r) for r in args.rows.split(",")]
    device = resolve_device(args.device)
    cfg = SPARSE_SMOKE if args.task == "sparse" else SMOKE
    task = resolve_task(cfg)
    print(f"serve bench: device={device} mix={args.mix} task={args.task} "
          f"requests={args.requests}")

    # ---- meta-train once; the trained theta serves EVERY cohort size
    # (shared perceptron => permutation equivariance, Remark 5.1)
    mds = task.synth_datasets(cfg, 4, seed=args.seed)
    state, _, _ = surf.train_surf(cfg, mds, steps=args.steps,
                                  seed=args.seed, log_every=0, device=device)

    trace = synth_trace(cfg, task, sizes, rows, args.dist, args.requests,
                        args.seed, device)
    server = FederationServer(cfg, state.theta, mix=args.mix,
                              max_batch=args.max_batch, buckets=BUCKETS,
                              device=device)

    # ---- warm every bucket the trace can hit, counting solver builds
    warmed = server.warm((n, t) for n in sizes for t in rows)
    warm_builds = server.cache_stats()["misses"]
    n_buckets = len(warmed)
    print(f"warmed {n_buckets} buckets "
          f"{[f'n{b.n_agents}xt{b.rows}' for b in warmed]}: "
          f"{warm_builds} solver build(s)")
    if n_buckets < 2:                                            # claim 3
        raise AssertionError(f"trace must span >= 2 buckets, got "
                             f"{n_buckets}")
    if warm_builds != n_buckets:                                 # claim 1a
        raise AssertionError(f"expected ONE build per warm bucket, got "
                             f"{warm_builds} for {n_buckets} buckets")

    # ---- replay: interleave submits and ticks (continuous batching)
    futures = []
    t0 = time.perf_counter()
    for i, req in enumerate(trace):
        futures.append(server.submit(req["S"], req["ds"], seed=req["seed"]))
        if (i + 1) % args.max_batch == 0:
            server.tick()
    server.drain()
    replay_wall = time.perf_counter() - t0
    replay_builds = server.cache_stats()["misses"] - warm_builds
    if replay_builds:                                            # claim 1b
        raise AssertionError(f"replay built {replay_builds} solvers — warm "
                             "buckets must serve the whole trace")
    if not all(f.done() for f in futures):
        raise AssertionError("replay left requests pending")

    # ---- parity: every request vs the single-cohort solve
    tol = 5e-5
    max_dloss, max_dacc = _max_delta(state, trace, futures, device)
    if not (max_dloss < tol and max_dacc < tol):                 # claim 2
        raise AssertionError(f"serve/solve divergence: dloss="
                             f"{max_dloss:.2e} dacc={max_dacc:.2e} "
                             f"(tol {tol})")
    print(f"parity over {len(trace)} requests: max dloss={max_dloss:.2e} "
          f"max dacc={max_dacc:.2e}")

    summary = server.metrics.summary()
    print(f"{summary['federations_per_sec']:.1f} federations/s  "
          f"p50={summary['latency_p50_ms']:.1f}ms "
          f"p99={summary['latency_p99_ms']:.1f}ms  "
          f"occupancy={summary['occupancy']:.2f} "
          f"pad_waste={summary['pad_waste']:.2f}")

    sharded_rows = (bench_sharded_async(cfg, state, trace, args, sizes,
                                        rows, tol, device)
                    if args.sharded_requests > 0 else [])

    out = {
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "timing_caveat": ("card timing" if device.type == "cuda" else
                          "CPU correctness-path timing, not a device "
                          "number"),
        "mix": args.mix, "task": args.task,
        "requests": len(trace), "sizes": sizes, "rows": rows,
        "dist": args.dist, "max_batch": args.max_batch,
        "buckets": [f"n{b.n_agents}xt{b.rows}" for b in warmed],
        "build_counts": {"warm_buckets": n_buckets,
                         "warm_builds": int(warm_builds),
                         "replay_builds": int(replay_builds)},
        "parity": {"checked": len(trace), "tol": tol,
                   "max_dloss": max_dloss, "max_dacc": max_dacc},
        "replay_wall_s": replay_wall,
        "serve": summary,
        "bucket_cache": server.cache_stats(),
        "sharded_async": sharded_rows,
    }
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "BENCH_serve.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
