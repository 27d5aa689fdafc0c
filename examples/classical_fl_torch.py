"""Classical (server-based) FL with U-DGD on a star graph (paper §5.2 +
Fig. 5 right) on the PyTorch port, as ``examples/classical_fl.py`` runs
it on the JAX package: the server node only aggregates (graph-filter
row), agents do the local perceptron updates; K is constrained to 1.

  PYTHONPATH=src python examples/classical_fl_torch.py
  PYTHONPATH=src python examples/classical_fl_torch.py --device cpu

It runs on the CUDA card unless ``--device`` names another torch device.
``--steps`` sets the meta-step count (300, the reference's).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.base import SURFConfig
from repro_torch.core import baselines as BL
from repro_torch.core import surf, unroll as U
from repro_torch.data import synthetic
from repro_torch.utils.device import resolve_device

STEPS = 300


def main(steps=STEPS, device=None):
    device = resolve_device(device)
    cfg = SURFConfig(n_agents=30, n_layers=8, filter_taps=1, feature_dim=32,
                     n_classes=10, batch_per_agent=8, topology="star",
                     eps=0.1, lr_theta=1e-3)
    meta_train = synthetic.make_meta_dataset(cfg, 20, seed=0)
    state, _, S = surf.train_surf(cfg, meta_train, steps=steps, log_every=0,
                                  device=device)
    test = synthetic.make_meta_dataset(cfg, 5, seed=7)

    res = surf.evaluate_surf(cfg, state, S, test, device=device)
    budget = cfg.n_layers
    print(f"U-DGD(SURF, star) @{budget:2d} rounds: acc={res['final_acc']:.3f}")

    out = {"U-DGD": float(res["final_acc"])}
    for name, fn in BL.CLASSICAL.items():
        accs = []
        for d in test:
            W0 = U.sample_w0(U.seeded_generator(0, device), cfg)
            run = fn(W0, d, U.seeded_generator(1, device), cfg, rounds=25,
                     lr=0.5, participate=10, device=device)
            accs.append(run["acc"])
        acc = np.mean(accs, axis=0)
        print(f"{name:10s} @{budget:2d} rounds: acc={acc[budget-1]:.3f}   "
              f"@25 rounds: acc={acc[-1]:.3f}")
        out[name] = float(acc[budget - 1])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"meta-steps (default {STEPS})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(steps=args.steps, device=args.device)
