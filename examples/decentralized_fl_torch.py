"""Decentralized FL head-to-head (paper Fig. 5 left/middle, compressed) on
the PyTorch port, as ``examples/decentralized_fl.py`` runs it on the JAX
package: U-DGD trained via SURF vs DGD / DSGD / DFedAvgM on a 3-regular
graph — prints accuracy at matched communication-round budgets.

``--scenario`` meta-trains U-DGD under a TIME-VARYING topology
(``repro_torch.topology.schedule``):

  static        the paper's fixed graph (default),
  link-failure  every link drops i.i.d. w.p. 0.2 per meta-step,
  dropout       n/10 agents drop out (hold their value) per meta-step.

Evaluation always runs on the nominal static graph — the robustness
protocol of Hadou et al. (train perturbed, test nominal). The baselines
are topology-schedule-free by construction, so their columns are
unchanged; compare the U-DGD row across scenarios.

``--seeds N`` meta-trains N seeds in lockstep (each with its own
init/topology/perturbation stream) and reports the U-DGD row as mean±std
over training seeds. ``--steps`` sets the meta-step count (800, the
reference's). It runs on the CUDA card unless ``--device`` names another
torch device.

  PYTHONPATH=src python examples/decentralized_fl_torch.py --scenario dropout
  PYTHONPATH=src python examples/decentralized_fl_torch.py --seeds 4
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import engine as E
from repro_torch.configs.base import SURFConfig
from repro_torch.core import baselines as BL
from repro_torch.core import surf, unroll as U
from repro_torch.data import synthetic
from repro_torch.topology import families as F
from repro_torch.utils.device import resolve_device

STEPS = 800


def main(scenario="static", n_seeds=1, steps=STEPS, device=None):
    device = resolve_device(device)
    cfg = SURFConfig(n_agents=30, n_layers=8, filter_taps=2, feature_dim=32,
                     n_classes=10, batch_per_agent=8, topology="regular",
                     degree=3)
    meta_train = synthetic.make_meta_dataset(cfg, 60, seed=0)
    train_seeds = tuple(range(n_seeds)) if n_seeds > 1 else None
    state, _, S = surf.train_surf(cfg, meta_train, steps=steps, log_every=0,
                                  engine="scan", scenario=scenario,
                                  seeds=train_seeds, device=device)
    states = ([E.state_for_seed(state, i) for i in range(n_seeds)]
              if train_seeds else [state])
    S_list = list(S) if train_seeds else [S]
    S = S_list[0]
    S0 = S.cpu().numpy()
    A = S0 > 0
    np.fill_diagonal(A, False)
    print(f"scenario={scenario}: base graph (seed 0) SLEM="
          f"{F.second_eigenvalue(S0):.3f}, "
          f"algebraic connectivity={F.algebraic_connectivity(A):.3f}")
    test = synthetic.make_meta_dataset(cfg, 5, seed=42)

    # 4 eval seeds per trained model
    finals = np.concatenate([
        surf.evaluate_surf(cfg, st, Si, test, seeds=(0, 1, 2, 3),
                           device=device)["final_acc"]
        for st, Si in zip(states, S_list)])
    budget = cfg.n_layers * cfg.filter_taps
    tag = "U-DGD(SURF)" if scenario == "static" else \
        f"U-DGD({scenario})"
    print(f"{tag:12s} @{budget:3d} rounds: "
          f"acc={float(np.mean(finals)):.3f} "
          f"±{float(np.std(finals)):.3f} "
          f"({len(states)} train x 4 eval seeds)")

    out = {"U-DGD": float(np.mean(finals))}
    lrs = {"dgd": 0.5, "dsgd": 0.2, "dfedavgm": 0.05}
    for name, fn in BL.DECENTRALIZED.items():
        accs_at_budget, accs_200 = [], []
        for d in test:
            W0 = U.sample_w0(U.seeded_generator(0, device), cfg)
            run = fn(S, W0, d, U.seeded_generator(1, device), cfg,
                     rounds=200, lr=lrs[name], device=device)
            accs_at_budget.append(run["acc"][budget - 1])
            accs_200.append(run["acc"][-1])
        print(f"{name:12s} @{budget:3d} rounds: "
              f"acc={np.mean(accs_at_budget):.3f}   "
              f"@200 rounds: acc={np.mean(accs_200):.3f}")
        out[name] = float(np.mean(accs_at_budget))
    print("\n(The paper's claim: U-DGD at ~20 rounds beats baselines at "
          "200 — check the first column against the last.)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="static",
                    choices=("static", "link-failure", "dropout"),
                    help="topology schedule U-DGD meta-trains under "
                         "(evaluation stays on the nominal graph)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="training seeds trained in lockstep (default 1)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"meta-steps (default {STEPS})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(args.scenario, n_seeds=args.seeds, steps=args.steps,
         device=args.device)
