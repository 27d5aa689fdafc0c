"""Convergence-adaptive depth driver (the port of
``repro.launch.surf_earlyexit``): meta-train one overprovisioned-depth
model (descending constraints tightened so intermediate iterates are
anytime-usable), sweep ``exit_threshold`` through the early-exit solver,
and write ``BENCH_earlyexit.json`` under ``--out``.

The run ASSERTS the claims that make adaptive depth trustworthy — they
are hard failures, not recorded numbers:

  1. exit_threshold=0 parity — the adaptive path consumes the SAME
     per-layer batch stack (featurization is a pure function of the
     generator's seed), runs depth == L exactly, and its W_L is bit-equal
     to ``udgd_forward``'s; the adaptive ``evaluate_surf`` matches the
     fixed one;
  2. build economy — the early-exit evaluator is built ONCE per distinct
     threshold (misses of the "surf-eval" cache,
     ``repro_torch.cache_stats()``), and re-evaluating a swept threshold
     builds nothing;
  3. the frontier — at least one swept threshold achieves mean realized
     depth strictly < L with eval accuracy within ``--eps`` of the
     fixed-L baseline. This one is a property of the trained θ, not of
     the code: the port reproduces the reference's frontier from the
     reference's θ and draws (``tests/test_torch_surf_launch.py``), and
     at the default seed neither package's own random stream meets it
     today. ``--frontier report`` records its verdict in the JSON and
     goes on to claim 4 (with the deepest-saving threshold below L)
     instead of failing; the default, ``assert``, fails as the
     reference does;
  4. serve-path depth telemetry — replaying requests through an adaptive
     ``FederationServer`` populates the depth histogram (every request
     lands a realized depth) at one solver build per warm bucket and none
     at request rate.

  PYTHONPATH=src python -m repro_torch.launch.surf_earlyexit --device cpu \\
      --steps 600

On the card (the default device) every layer's graph filter runs through
the CUDA kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import cache_stats, clear_caches
from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.data import synthetic
from repro_torch.serve import BucketSpec, FederationServer
from repro_torch.utils.device import resolve_device

DEFAULT_OUT = os.path.join("build", "bench_torch")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=12,
                    help="unrolled depth L (overprovisioned on purpose)")
    ap.add_argument("--min-layers", type=int, default=8,
                    help="realized-depth floor: stochastic unrolling "
                    "makes single-layer grad ratios noisy, so the "
                    "certificate is armed only past the depth where "
                    "this smoke model's iterates have converged")
    ap.add_argument("--thresholds", default="0.02,0.05,0.1,0.3",
                    help="exit_threshold sweep (fig5 frontier points)")
    ap.add_argument("--eps", type=float, default=0.04,
                    help="max |acc - fixed-L acc| for a threshold to "
                    "count as matched accuracy")
    ap.add_argument("--steps", type=int, default=600,
                    help="meta-training steps (needs enough dual-ascent "
                    "pressure for anytime iterates)")
    ap.add_argument("--pool", type=int, default=8,
                    help="downstream evaluation datasets")
    ap.add_argument("--eval-seeds", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12,
                    help="adaptive serve mini-trace length")
    ap.add_argument("--mix", choices=("dense", "pallas", "cuda"),
                    default="dense",
                    help="serve-leg mixer (on the card every name runs "
                    "the graph-filter kernel)")
    ap.add_argument("--frontier", choices=("assert", "report"),
                    default="assert",
                    help="claim 3: fail when no threshold meets it "
                    "(assert), or record its verdict and go on (report)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output dir (default: {DEFAULT_OUT})")
    return ap


def sweep_config(layers=12, min_layers=8):
    """The swept model's config: SMOKE widths at depth ``layers``, with
    dual ascent tightened (lr_lambda, eps) against the SMOKE defaults:
    the descending constraints must BIND for intermediate iterates to be
    anytime-usable — with loose duals all the accuracy arrives at layer L
    and no early exit can match it."""
    return dataclasses.replace(SMOKE, n_layers=int(layers),
                               min_layers=int(min_layers), probe_size=4,
                               lr_lambda=0.3, eps=0.1)


def _mean(res, key):
    return float(np.mean(res[key]))


def _eval_builds():
    return cache_stats()["surf-eval"]["misses"]


def main(argv=None, parser=None):
    """Run the sweep; returns the JSON record."""
    args = (parser or build_parser()).parse_args(argv)
    thresholds = [float(t) for t in args.thresholds.split(",")]
    if not all(t > 0 for t in thresholds):
        raise ValueError("sweep thresholds must be > 0")
    device = resolve_device(args.device)
    L = int(args.layers)
    cfg = sweep_config(L, args.min_layers)
    task = resolve_task(cfg, None)
    print(f"earlyexit bench: device={device} L={L} "
          f"min_layers={args.min_layers} thresholds={thresholds}")

    mds = synthetic.make_meta_dataset(cfg, 4, seed=args.seed)
    state, _, S = surf.train_surf(cfg, mds, steps=args.steps,
                                  seed=args.seed, log_every=0,
                                  device=device)
    theta = {k: v.to(device) for k, v in state.theta.items()}
    pool = synthetic.make_meta_dataset(cfg, args.pool, seed=77)
    seeds = list(range(args.eval_seeds))

    # ---- fixed-L baseline (the paper's forward)
    fixed = surf.evaluate_surf(cfg, state, S, pool, seeds=seeds,
                               device=device)
    fixed_acc = _mean(fixed, "final_acc")
    fixed_loss = _mean(fixed, "final_loss")
    print(f"fixed-L baseline: acc={fixed_acc:.4f} loss={fixed_loss:.4f}")

    # ---- claim 1: exit_threshold=0 parity (depth==L, same stream/W_L)
    batch = task.to_batch(pool[0], device)
    with torch.no_grad():
        W0, Xl, Yl = U.featurize_cohort(
            U.solve_generator(args.seed, 0, device), batch, cfg, task=task)
        W0b, Xlb, Ylb = U.featurize_cohort(
            U.solve_generator(args.seed, 0, device), batch, cfg, task=task)
        if not (torch.equal(Xl, Xlb) and torch.equal(Yl, Ylb)
                and torch.equal(W0, W0b)):
            raise AssertionError("featurization is not a pure function of "
                                 "the generator's seed — stream parity is "
                                 "broken")
        Xp, Yp = U.probe_batch(batch, cfg)
        W_fix, _ = U.udgd_forward(theta, S, W0, Xl, Yl, cfg, task=task)
        W_ad, depth0 = U.udgd_forward_adaptive(theta, S, W0, Xl, Yl, Xp, Yp,
                                               cfg, task=task)
    if depth0 != L:
        raise AssertionError(f"exit_threshold=0 must run all layers: depth "
                             f"{depth0} != {L}")
    if not torch.equal(W_ad, W_fix):
        raise AssertionError("exit_threshold=0: W_L is not bit-equal to "
                             "udgd_forward's")
    r0 = surf.evaluate_surf(cfg, state, S, pool, seeds=seeds,
                            depth="adaptive", device=device)
    if _mean(r0, "depth") != float(L):
        raise AssertionError(f"thr=0 mean depth {_mean(r0, 'depth')} != {L}")
    np.testing.assert_allclose(_mean(r0, "final_acc"), fixed_acc,
                               rtol=1e-5, atol=1e-5)
    print(f"threshold=0 parity: depth=={L}, W_L bit-equal, stream exact")

    # ---- threshold sweep (claims 2 + 3), from a cold evaluator cache
    clear_caches("surf-eval")
    base = _eval_builds()
    frontier = []
    for thr in thresholds:
        cfg_t = dataclasses.replace(cfg, exit_threshold=thr)
        r = surf.evaluate_surf(cfg_t, state, S, pool, seeds=seeds,
                               depth="adaptive", device=device)
        row = {"threshold": thr,
               "mean_depth": _mean(r, "depth"),
               "final_acc": _mean(r, "final_acc"),
               "final_loss": _mean(r, "final_loss"),
               "acc_gap": fixed_acc - _mean(r, "final_acc"),
               "layers_saved_frac": 1.0 - _mean(r, "depth") / L}
        frontier.append(row)
        print(f"thr={thr}: depth={row['mean_depth']:.4f}/{L} "
              f"acc={row['final_acc']:.4f} (gap {row['acc_gap']:+.4f})")
    sweep_builds = _eval_builds() - base
    if sweep_builds != len(thresholds):                          # claim 2a
        raise AssertionError(f"expected ONE adaptive build per threshold, "
                             f"got {sweep_builds} for {len(thresholds)}")
    base = _eval_builds()
    surf.evaluate_surf(dataclasses.replace(cfg, exit_threshold=thresholds[0]),
                       state, S, pool, seeds=seeds, depth="adaptive",
                       device=device)
    if _eval_builds() != base:                                   # claim 2b
        raise AssertionError("re-evaluating a swept threshold rebuilt the "
                             "early-exit evaluator")
    print(f"build economy: {sweep_builds} builds for {len(thresholds)} "
          "thresholds, none on re-eval")

    matched = [row for row in frontier
               if row["mean_depth"] < L and abs(row["acc_gap"]) <= args.eps]
    if not matched:                                              # claim 3
        msg = (f"no swept threshold achieved mean depth < {L} within "
               f"eps={args.eps} of the fixed-L accuracy {fixed_acc:.4f}: "
               + json.dumps(frontier))
        if args.frontier == "assert":
            raise AssertionError(msg)
        print(f"claim 3 NOT MET (--frontier report): {msg}")
    candidates = matched or [row for row in frontier if row["mean_depth"] < L]
    if not candidates:
        raise AssertionError(f"no swept threshold exits before L={L}: "
                             + json.dumps(frontier))
    chosen = max(candidates, key=lambda row: row["layers_saved_frac"])
    print(f"chosen threshold {chosen['threshold']}: "
          f"{chosen['layers_saved_frac']:.0%} layers saved at "
          f"acc gap {chosen['acc_gap']:+.4f}")

    # ---- claim 4: adaptive serve mini-trace (depth telemetry + builds)
    cfg_s = dataclasses.replace(cfg, exit_threshold=chosen["threshold"])
    server = FederationServer(
        cfg_s, theta, mix=args.mix, max_batch=4,
        buckets=BucketSpec(agent_sizes=(cfg.n_agents,),
                           row_sizes=(cfg.test_per_agent,)),
        depth="adaptive", device=device)
    server.warm([(cfg.n_agents, cfg.test_per_agent)])
    warm_builds = server.cache_stats()["misses"]
    if warm_builds != 1:
        raise AssertionError(f"adaptive serve warm built {warm_builds}x, "
                             "expected 1")
    futs = []
    for i in range(args.requests):
        _, S_r = surf.make_problem(cfg_s, seed=10_000 + i, device=device)
        ds = synthetic.sample_dataset(cfg_s, seed=20_000 + i)
        futs.append(server.submit(S_r, ds, seed=i % 8))
    server.drain()
    replay_builds = server.cache_stats()["misses"] - warm_builds
    if replay_builds or not all(f.done() for f in futs):
        raise AssertionError(f"serve replay built {replay_builds} solvers "
                             "or left requests pending")
    ssum = server.metrics.summary()
    n_hist = sum(ssum["depth_hist"].values())
    if n_hist != args.requests or not 0 < ssum["mean_depth"] <= L:
        raise AssertionError(f"depth histogram {ssum['depth_hist']} covers "
                             f"{n_hist} of {args.requests} requests")
    print(f"serve depth_hist={ssum['depth_hist']} "
          f"mean_depth={ssum['mean_depth']:.2f} "
          f"request_flops_saved={ssum['request_flops_saved']:.2f} "
          f"batch_flops_saved={ssum['batch_flops_saved']:.2f}")

    out = {
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "n_layers": L, "min_layers": int(args.min_layers),
        "probe_size": int(cfg.probe_size), "steps": int(args.steps),
        "eps": float(args.eps), "mix": args.mix,
        "fixed": {"final_acc": fixed_acc, "final_loss": fixed_loss,
                  "depth": float(L)},
        "fig5_frontier": frontier,
        "frontier_claim": {"mode": args.frontier, "met": bool(matched)},
        "chosen": chosen,
        "parity_thr0": {"depth": int(depth0), "w_bit_equal": True,
                        "stream_bit_identical": True},
        "build_counts": {
            "thresholds_swept": len(thresholds),
            "adaptive_sweep_builds": int(sweep_builds),
            "adaptive_reeval_builds": 0,
            "serve_warm_builds": int(warm_builds),
            "serve_replay_builds": int(replay_builds)},
        "serve": ssum,
    }
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "BENCH_earlyexit.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
