"""The port's SURF launchers on the CPU (``launch.surf_serve``,
``launch.surf_earlyexit``), with ``--device cpu`` and ``--out`` under the
test's temporary directory: their own assertions are the gates, and the
JSON they write is read back. Then the early-exit frontier at the
launcher's defaults, held against the reference's from the reference's θ
and draws.

Tolerances: the frontier's mean depths exactly and its accuracies within
1e-5 of the reference's (``tests/test_earlyexit.py``'s evaluation
tolerance)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.surf_paper import SMOKE as JSMOKE
from repro.core import surf as jsurf
from repro.core import unroll as JU
from repro.data import synthetic
from repro.launch import surf_earlyexit as jlaunch
from repro_torch.checkpoint.convert import theta_from_numpy
from repro_torch.core import surf
from repro_torch.engine.core import TrainState
from repro_torch.launch import surf_earlyexit, surf_serve

import torch

# One intra-op thread per process: the suite runs its files on several
# workers of one machine, and torch at every core in each of them
# oversubscribes it (a thread count changes only the order of CPU sums).
torch.set_num_threads(1)


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_surf_serve_main_at_its_defaults(tmp_path):
    """220 requests over four buckets, the one-shard async row."""
    out = surf_serve.main(["--device", "cpu", "--out", str(tmp_path)])
    assert out == _read(tmp_path / "BENCH_serve.json")
    assert out["requests"] == out["parity"]["checked"] == 220
    assert out["build_counts"] == {"warm_buckets": 4, "warm_builds": 4,
                                   "replay_builds": 0}
    assert out["serve"]["requests_completed"] == 220
    (row,) = out["sharded_async"]
    assert row["shards"] == 1 and row["requests"] == 64
    assert 0 < row["tick_utilization"] <= 1
    assert out["device_name"] == "cpu"


def test_surf_serve_small_trace_without_async_rows(tmp_path):
    out = surf_serve.main(["--device", "cpu", "--out", str(tmp_path),
                           "--requests", "20", "--steps", "3",
                           "--sharded-requests", "0", "--dist", "uniform",
                           "--mix", "cuda"])
    assert out["requests"] == 20 and out["sharded_async"] == []
    assert out["parity"]["max_dloss"] < out["parity"]["tol"]


def test_surf_serve_sparse_task_names_its_roadmap_item(tmp_path):
    """ROADMAP item 5 is ported: ``--task sparse`` serves SPARSE_SMOKE
    (federated LASSO) under the launcher's own claims: one build per
    bucket, and every padded request's NMSE equal to the unpadded solve
    within the launcher's 5e-5."""
    out = surf_serve.main(["--device", "cpu", "--out", str(tmp_path),
                           "--task", "sparse", "--requests", "40",
                           "--steps", "4", "--sharded-requests", "8"])
    assert out["task"] == "sparse" and out["requests"] == 40
    assert out["build_counts"]["replay_builds"] == 0
    assert out["parity"]["max_dacc"] < out["parity"]["tol"]
    assert out == _read(tmp_path / "BENCH_serve.json")


def test_surf_earlyexit_main_short_run(tmp_path):
    """A 100-step run exercises all four claims. Its duals have not bound
    yet, so its frontier sits further from the fixed-L accuracy than a
    600-step run's: ``--eps 0.2`` here (the default of 0.04 stands for the
    default run, held against the reference below)."""
    out = surf_earlyexit.main(["--device", "cpu", "--out", str(tmp_path),
                               "--steps", "100", "--pool", "4",
                               "--eval-seeds", "2", "--requests", "6",
                               "--eps", "0.2"])
    assert out == _read(tmp_path / "BENCH_earlyexit.json")
    assert out["parity_thr0"] == {"depth": 12, "w_bit_equal": True,
                                  "stream_bit_identical": True}
    assert out["build_counts"] == {
        "thresholds_swept": 4, "adaptive_sweep_builds": 4,
        "adaptive_reeval_builds": 0, "serve_warm_builds": 1,
        "serve_replay_builds": 0}
    assert sum(out["serve"]["depth_hist"].values()) == 6
    assert out["chosen"]["mean_depth"] < 12


def test_surf_earlyexit_main_at_its_defaults(tmp_path):
    """The default run, with claim 3 reported rather than asserted: its
    verdict in the JSON is that of the frontier rows, claims 1, 2 and 4
    hold."""
    out = surf_earlyexit.main(["--device", "cpu", "--out", str(tmp_path),
                               "--frontier", "report"])
    met = any(row["mean_depth"] < 12 and abs(row["acc_gap"]) <= 0.04
              for row in out["fig5_frontier"])
    assert out["frontier_claim"] == {"mode": "report", "met": met}
    assert out["steps"] == 600 and out["eps"] == 0.04
    assert out["build_counts"]["adaptive_sweep_builds"] == 4
    assert sum(out["serve"]["depth_hist"].values()) == 12
    assert out["chosen"]["mean_depth"] < 12


def test_surf_earlyexit_asserts_the_frontier_by_default(tmp_path):
    """Without ``--frontier report`` an unmet claim 3 fails the run (an
    eps below zero cannot be met)."""
    with pytest.raises(AssertionError, match="no swept threshold"):
        surf_earlyexit.main(["--device", "cpu", "--out", str(tmp_path),
                             "--steps", "20", "--pool", "2",
                             "--eval-seeds", "1", "--eps", "-1"])


def test_surf_earlyexit_rejects_nonpositive_thresholds(tmp_path):
    with pytest.raises(ValueError, match="> 0"):
        surf_earlyexit.main(["--device", "cpu", "--out", str(tmp_path),
                             "--thresholds", "0.0,0.1"])


def test_port_reproduces_reference_frontier_at_launcher_defaults():
    """The early-exit launcher's model at its defaults (L=12, min_layers
    8, 600 steps, seed 0), meta-trained by the reference; the port's
    adaptive ``evaluate_surf`` on the reference's θ and draws gives the
    reference's frontier: every threshold's mean depth exactly, its
    accuracy within 1e-5, and so the same verdict on claim 3 (mean depth
    < L within --eps 0.04 of the fixed-L accuracy), whichever it is."""
    args = surf_earlyexit.build_parser().parse_args([])
    jargs = jlaunch.build_parser().parse_args([])
    assert (args.steps, args.thresholds, args.eps, args.layers) == (
        jargs.steps, jargs.thresholds, jargs.eps, jargs.layers)
    tcfg = surf_earlyexit.sweep_config(args.layers, args.min_layers)
    # the reference launcher's config, as its main() builds it
    jcfg = dataclasses.replace(JSMOKE, n_layers=jargs.layers,
                               min_layers=jargs.min_layers, probe_size=4,
                               lr_lambda=0.3, eps=0.1)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    mds = synthetic.make_meta_dataset(jcfg, 4, seed=args.seed)
    state, _, S = jsurf.train_surf(jcfg, mds, steps=args.steps,
                                   seed=args.seed, log_every=0)
    S = np.asarray(S)
    theta = theta_from_numpy(jax.tree.map(np.asarray, state.theta), "cpu")
    pool = synthetic.make_meta_dataset(jcfg, args.pool, seed=77)
    seeds = list(range(args.eval_seeds))
    draws = {s: [tuple(np.asarray(a) for a in JU.featurize_cohort(
        jax.random.fold_in(jax.random.PRNGKey(1000 + s), q),
        {k: jnp.asarray(v) for k, v in ds.items()}, jcfg))
        for q, ds in enumerate(pool)] for s in seeds}

    def port(cfg, depth=None):
        rows = [surf.evaluate_surf(cfg, TrainState(theta), S, pool, seed=s,
                                   draws=draws[s], device="cpu",
                                   depth=depth) for s in seeds]
        return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}

    fixed = port(tcfg)
    jfixed = jsurf.evaluate_surf(jcfg, state, S, pool, seeds=seeds)
    np.testing.assert_allclose(fixed["final_acc"],
                               np.mean(jfixed["final_acc"]), atol=1e-5)
    verdicts = []
    for thr in (float(t) for t in args.thresholds.split(",")):
        r = port(dataclasses.replace(tcfg, exit_threshold=thr), "adaptive")
        jr = jsurf.evaluate_surf(dataclasses.replace(jcfg,
                                                     exit_threshold=thr),
                                 state, S, pool, seeds=seeds,
                                 depth="adaptive")
        assert r["depth"] == float(np.mean(jr["depth"]))
        np.testing.assert_allclose(r["final_acc"], np.mean(jr["final_acc"]),
                                   atol=1e-5)
        for acc, base in ((r["final_acc"], fixed["final_acc"]),
                          (np.mean(jr["final_acc"]),
                           np.mean(jfixed["final_acc"]))):
            verdicts.append(r["depth"] < args.layers
                            and abs(base - acc) <= args.eps)
    assert verdicts[0::2] == verdicts[1::2]
