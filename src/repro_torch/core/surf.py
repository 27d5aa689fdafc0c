"""Public SURF API of the port: build the FL problem, evaluate a trained
U-DGD model, and solve one new federation (the port of the evaluation
half of ``repro.core.surf``). Meta-training (``train_surf``) and the
asynchronous-agent study land with later slices.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import _eval_core
from repro_torch.topology.families import build_topology
from repro_torch.utils.device import resolve_device, to_tensor


def make_problem(cfg: SURFConfig, seed=0, device=None):
    """Returns (adjacency, mixing matrix S as an f32 tensor on ``device``)."""
    A, S = build_topology(cfg.topology, cfg.n_agents, degree=cfg.degree,
                          p=cfg.er_p, seed=seed)
    return A, torch.as_tensor(S, dtype=torch.float32,
                              device=resolve_device(device))


def evaluate_surf(cfg: SURFConfig, state, S, datasets, seed=0,
                  activation="relu", mix_fn=None, task=None, device=None,
                  draws=None):
    """Per-layer loss/metric trajectories averaged over the downstream
    ``datasets``. Dataset q draws from ``unroll.solve_generator(seed, q)``
    unless ``draws`` (one ``(W0, Xl, Yl)`` per dataset) replaces them.
    Returns numpy arrays: ``loss_per_layer`` / ``acc_per_layer`` (L,),
    ``final_loss`` / ``final_acc``."""
    device = resolve_device(device)
    task = resolve_task(cfg, task)
    if draws is not None and len(draws) != len(datasets):
        raise ValueError(f"{len(draws)} draws for {len(datasets)} datasets")
    evaluate_s = _eval_core(cfg, activation, mix_fn=mix_fn, task=task)
    S = to_tensor(S, device, torch.float32)
    theta = {k: to_tensor(v, device) for k, v in state.theta.items()}
    with torch.no_grad():
        outs = [evaluate_s(S, theta, task.to_batch(ds, device),
                           U.solve_generator(seed, q, device),
                           None if draws is None else draws[q])
                for q, ds in enumerate(datasets)]
    return {k: torch.stack([o[k] for o in outs]).mean(0).cpu().numpy()
            for k in outs[0]}


def solve_federation(cfg: SURFConfig, state, S, dataset, seed=0,
                     activation="relu", mix_fn=None, task=None, device=None,
                     draws=None):
    """Solve ONE new federation with the trained model: the amortization
    primitive (paper §4) as a single call, and the reference the serving
    layer is held against. ``FederationServer.submit(S, dataset,
    seed=seed)`` draws from the same ``solve_generator(seed, 0)``.
    ``cfg.n_agents`` must match the cohort. ``draws=(W0, Xl, Yl)``
    replaces the random draws."""
    return evaluate_surf(cfg, state, S, [dataset], seed=seed,
                         activation=activation, mix_fn=mix_fn, task=task,
                         device=device,
                         draws=None if draws is None else [draws])
