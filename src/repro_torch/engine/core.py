"""The evaluation body of the SURF engine and the state it reads; the
port of ``repro.engine.core`` (``TrainState``, ``_eval_core``).

The meta-step (``_meta_step_core``) and the training loops land with the
training slice, and with them the other ``TrainState`` fields (λ, the
optimizer state, the step).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task


class TrainState(NamedTuple):
    theta: dict


def _eval_core(cfg: SURFConfig, activation="relu", mix_fn=None, task=None):
    """Evaluation body ``evaluate_s(S, theta, batch, generator,
    draws=None)``: featurize the cohort, run the L layers and report the
    test loss and ``task.fl_metric`` after every layer."""
    task = resolve_task(cfg, task)
    if cfg.topology == "star":
        raise NotImplementedError(
            "star-topology layers (udgd_layer_star) are not ported yet: "
            "they land with the training slice")

    def evaluate_s(S, theta, batch, generator, draws=None):
        W, Xl, Yl = U.featurize_cohort(generator, batch, cfg, task=task,
                                       draws=draws)
        losses, accs = [], []
        for l in range(cfg.n_layers):
            W = U.udgd_layer(U.layer_params(theta, l), S, W, Xl[l], Yl[l],
                             cfg, activation, mix_fn=mix_fn, task=task)
            losses.append(task.fl_loss(W, batch["Xte"], batch["Yte"]))
            accs.append(task.fl_metric(W, batch["Xte"], batch["Yte"]))
        losses, accs = torch.stack(losses), torch.stack(accs)
        return {"loss_per_layer": losses, "acc_per_layer": accs,
                "final_loss": losses[-1], "final_acc": accs[-1]}

    return evaluate_s
