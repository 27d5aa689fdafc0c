"""Serve NEW federations with a meta-trained amortized solver on the
PyTorch port, as ``examples/serve_federations.py`` does on the JAX
package.

  PYTHONPATH=src python examples/serve_federations_torch.py
  PYTHONPATH=src python examples/serve_federations_torch.py --device cpu

It runs on the CUDA card unless ``--device`` names another torch device
(the served solve runs its graph filters through the hand-written CUDA
kernel there). ``--steps`` sets the meta-step count (30, the
reference's).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.surf_paper import SMOKE
from repro_torch.core import surf
from repro_torch.data.synthetic import make_meta_dataset, sample_dataset
from repro_torch.serve import FederationServer

STEPS = 30


def main(steps=STEPS, device=None):
    state, _, _ = surf.train_surf(SMOKE, make_meta_dataset(SMOKE, 4),
                                  steps=steps, log_every=0, device=device)
    server = FederationServer(SMOKE, state.theta,   # serves ANY cohort size
                              device=device)
    server.warm([(SMOKE.n_agents, SMOKE.test_per_agent)])
    _, S_new = surf.make_problem(SMOKE, seed=99, device=device)  # unseen
    fut = server.submit(S_new, sample_dataset(SMOKE, seed=99))
    server.drain()
    acc = float(fut.result()["final_acc"])
    print(f"solved in one forward pass: final_acc={acc:.3f} "
          f"({fut.latency * 1e3:.1f} ms enqueue->complete)")
    return acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help=f"meta-steps (default {STEPS})")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(steps=args.steps, device=args.device)
