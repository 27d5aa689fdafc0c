"""Quickstart on the PyTorch port: meta-train a U-DGD optimizer with SURF,
then use it to 'train' a fresh downstream classifier in 8 unrolled layers
(= 16 communication rounds) — the paper's core loop end to end, as
``examples/quickstart.py`` runs it on the JAX package.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --seeds 4 --eval-every 50
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

It runs on the CUDA card unless ``--device`` names another torch device;
every layer's graph filter goes through the hand-written CUDA kernel
there. ``--seeds N`` meta-trains N init/topology seeds in lockstep
(``repro_torch.engine.seeds``) and reports mean±std error bars over
training seeds; ``--eval-every M`` evaluates held-out snapshots every M
meta-steps (``repro_torch.engine.snapshots``). ``--steps`` sets the
meta-step count (250, the reference's).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import engine as E
from repro_torch.configs.base import SURFConfig
from repro_torch.core import surf
from repro_torch.data import synthetic
from repro_torch.topology import families as F

STEPS = 250


def main(n_seeds=1, eval_every=0, steps=STEPS, device=None):
    # A small decentralized FL problem: 20 agents on a 3-regular graph,
    # each holding 45 train / 15 test examples of 32-d frozen features.
    cfg = SURFConfig(n_agents=20, n_layers=8, filter_taps=2, feature_dim=32,
                     n_classes=10, batch_per_agent=8, topology="regular",
                     degree=3, eps=0.01)

    print("1) building meta-training pool (class-imbalanced datasets)...")
    meta_train = synthetic.make_meta_dataset(cfg, 20, seed=0)
    meta_test = synthetic.make_meta_dataset(cfg, 5, seed=123)

    seeds = tuple(range(n_seeds)) if n_seeds > 1 else None
    kw = {}
    if eval_every:
        kw = {"eval_every": eval_every, "eval_datasets": meta_test}
    print(f"2) meta-training U-DGD via SURF (primal-dual, Algorithm 1, "
          f"{steps} meta-steps"
          + (f", {n_seeds} seeds in lockstep" if seeds else "")
          + (f", eval snapshot every {eval_every} steps" if eval_every
             else "") + ")...")
    out = surf.train_surf(cfg, meta_train, steps=steps, log_every=50,
                          engine="scan", seeds=seeds, device=device, **kw)
    snaps = out[2] if eval_every else []
    state, hist, S = out[0], out[1], out[-1]
    S0 = (S[0] if seeds else S).cpu().numpy()
    print(f"   graph diagnostics (seed 0): SLEM(S)="
          f"{F.second_eigenvalue(S0):.3f} "
          f"(per-round consensus contraction; <1 = mixing)")
    for h in hist:
        acc, slack, lam = (np.mean(h["test_acc"]), np.mean(h["slack_mean"]),
                           np.mean(h["lam_sum"]))
        bar = (f" ±{np.std(h['test_acc']):.3f} over {n_seeds} seeds"
               if seeds else "")
        print(f"   step {h['step']:4d}  test_acc={acc:.3f}{bar}  "
              f"slack_mean={slack:+.4f}  λ·1={lam:.4f}")
    for sn in snaps:
        acc = np.mean(sn["final_acc"])
        bar = (f" ±{np.std(sn['final_acc']):.3f}" if seeds else "")
        print(f"   [snapshot] step {sn['step']:4d}  "
              f"held-out final_acc={acc:.3f}{bar}")

    print("3) deploying the trained optimizer on UNSEEN downstream tasks")
    print("   (4 evaluation seeds)...")
    if seeds:
        # each trained seed's model on the 4-seed eval battery;
        # (n_train_seeds, n_eval_seeds, L) accuracy stack
        acc_l = np.stack([
            surf.evaluate_surf(cfg, E.state_for_seed(state, i), S[i],
                               meta_test, seeds=(0, 1, 2, 3),
                               device=device)["acc_per_layer"]
            for i in range(n_seeds)])
        acc_l = acc_l.reshape(-1, cfg.n_layers)
        finals = acc_l[:, -1]
    else:
        res = surf.evaluate_surf(cfg, state, S, meta_test,
                                 seeds=(0, 1, 2, 3), device=device)
        acc_l = res["acc_per_layer"]                    # (n_seeds, L)
        finals = res["final_acc"]
    for l, (acc, std) in enumerate(zip(acc_l.mean(0), acc_l.std(0))):
        rounds = (l + 1) * cfg.filter_taps
        print(f"   layer {l+1:2d} ({rounds:2d} comm rounds): "
              f"acc={acc:.3f} ±{std:.3f}")
    final_acc = float(np.mean(finals))
    print(f"\nfinal accuracy after {cfg.n_layers * cfg.filter_taps} "
          f"communication rounds: {final_acc:.3f} "
          f"(±{float(np.std(finals)):.3f} over {len(finals)} "
          f"train×eval seeds)")
    assert final_acc > 0.5
    print("quickstart OK")
    return final_acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of training seeds trained in lockstep "
                         "(error bars; default 1)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out evaluation snapshot cadence (0 = off)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"meta-steps (default {STEPS})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(n_seeds=args.seeds, eval_every=args.eval_every, steps=args.steps,
         device=args.device)
