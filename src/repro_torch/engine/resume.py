"""Resume training from a checkpoint: the port of
``repro.engine.resume``.

Every per-step selection of the drivers (dataset, draws, S_t, snapshot
and checkpoint cadences) indexes the CARRIED ``state.step``, so a
restored state continues the exact streams of the interrupted run:
running ``k`` then ``steps − k`` meta-steps, with a save and a restore
in between, equals the uninterrupted ``steps``-long run bit for bit.
Checkpoints are ``checkpoint.io`` payloads in the reference's format,
``<dir>/ckpt_<step>`` for one seed and ``<dir>/ckpt_<step>/seeds`` for a
seed-batched run, so a state trained in either package resumes in the
other. History and snapshots of a resumed run record ABSOLUTE steps, and
``checkpoint_every`` re-arms on the same ``ckpt_<step>`` grid.
"""
from __future__ import annotations

import os

import torch

from repro_torch.checkpoint import io
from repro_torch.configs.base import SURFConfig
from repro_torch.core import unroll as U
from repro_torch.core.tasks import resolve_task
from repro_torch.engine.core import TrainState
from repro_torch.engine.scan import train_scan
from repro_torch.engine.seeds import _seed_list, train_scan_seeds
from repro_torch.utils.device import resolve_device

PREFIX = "ckpt_"


def state_template(cfg: SURFConfig, task=None):
    """The engine's ``TrainState`` with its leaves on the ``meta`` device
    (shapes and dtypes only): the restore template. ``task`` shapes θ for
    non-default inner problems."""
    task = resolve_task(cfg, task)
    L_, K, d = cfg.n_layers, cfg.filter_taps, task.dim
    din = U.perceptron_in_dim(cfg, task)

    def theta():
        return {"h": torch.empty((L_, K + 1), device="meta"),
                "M": torch.empty((L_, din, d), device="meta"),
                "d": torch.empty((L_, d), device="meta")}
    return TrainState(
        theta=theta(), lam=torch.empty((L_,), device="meta"),
        opt_state={"m": theta(), "v": theta(),
                   "t": torch.empty((), dtype=torch.int32, device="meta")},
        step=0)


def checkpoint_path(directory, step, prefix=PREFIX):
    return os.path.join(directory, f"{prefix}{int(step)}")


def save_state(directory, state, prefix=PREFIX):
    """Checkpoint a TrainState under ``directory`` keyed by its own
    carried step. Returns the checkpoint path (without extensions)."""
    step = int(state.step)
    path = checkpoint_path(directory, step, prefix)
    io.save(path, state, step=step)
    return path


def restore_state(directory, cfg: SURFConfig, step=None, prefix=PREFIX,
                  task=None, device=None):
    """The TrainState of the latest checkpoint under ``directory`` (or
    ``step``'s), on ``device`` (None: the CUDA card)."""
    if step is None:
        step = io.latest_step(directory, prefix)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {directory!r} (prefix {prefix!r})")
    path = checkpoint_path(directory, step, prefix)
    state = io.restore(path, state_template(cfg, task=task), device=device)
    if state.step != int(step):
        raise ValueError(
            f"checkpoint {path!r} carries step {state.step}, expected "
            f"{int(step)} — was it saved with engine.resume.save_state?")
    return state


def _remaining(start, steps):
    remaining = int(steps) - int(start)
    if remaining < 0:
        raise ValueError(f"checkpoint is at step {start}, beyond the "
                         f"requested {steps}-step run")
    return remaining


def resume_train_scan(cfg: SURFConfig, S, meta_datasets, steps, seed,
                      directory, *, constrained=True, activation="relu",
                      log_every=0, mix_fn=None, eval_every=0,
                      eval_datasets=None, S_eval=None, step=None,
                      prefix=PREFIX, checkpoint_every=0,
                      checkpoint_dir=None, task=None, device=None):
    """Resume a ``steps``-long run of seed ``seed`` from its latest
    checkpoint (or ``step``'s): restore the state and run the REMAINING
    meta-steps through ``train_scan``. Returns (state, history), or
    (state, history, snapshots) with ``eval_every``; entries record
    absolute steps. ``checkpoint_every``/``checkpoint_dir`` re-arm the
    periodic checkpoints on the interrupted run's grid."""
    device = resolve_device(device)
    state = restore_state(directory, cfg, step=step, prefix=prefix,
                          task=task, device=device)
    return train_scan(cfg, S, meta_datasets,
                      _remaining(state.step, steps), seed=seed,
                      constrained=constrained, activation=activation,
                      log_every=log_every, mix_fn=mix_fn, task=task,
                      device=device, state=state, eval_every=eval_every,
                      eval_datasets=eval_datasets, S_eval=S_eval,
                      checkpoint_every=checkpoint_every,
                      checkpoint_dir=checkpoint_dir)


# ------------------------------------------------------- seed-batched
def seed_checkpoint_path(directory, step, prefix=PREFIX):
    """Path (without extensions) of the stacked per-seed payload:
    ``<directory>/<prefix><step>/seeds``."""
    return os.path.join(directory, f"{prefix}{int(step)}", "seeds")


def latest_seed_step(directory, prefix=PREFIX):
    """Highest seed-batched checkpoint step under ``directory`` (the
    ``<prefix><step>/`` subdirectories holding a ``seeds`` payload), or
    None when there are none."""
    if not directory or not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if not (d.startswith(prefix)
                and os.path.isfile(os.path.join(directory, d, "seeds.json"))):
            continue
        try:
            steps.append(int(d[len(prefix):]))
        except ValueError:
            continue
    return max(steps) if steps else None


def seed_state_template(cfg: SURFConfig, n_seeds, task=None):
    """The stacked per-seed TrainState template: every leaf with a
    leading ``n_seeds`` axis, the step a (n_seeds,) int32 vector as the
    reference writes it."""
    one = state_template(cfg, task)
    n_seeds = int(n_seeds)
    return io.unflatten(one, iter(
        torch.empty((n_seeds,) + tuple(x.shape), dtype=x.dtype,
                    device="meta") if isinstance(x, torch.Tensor)
        else torch.empty((n_seeds,), dtype=torch.int32, device="meta")
        for _, x in io.flatten(one)))


def restore_seed_states(directory, cfg: SURFConfig, n_seeds, step=None,
                        prefix=PREFIX, task=None, device=None):
    """The stacked per-seed TrainState of a seed-batched checkpoint
    (``ckpt_<step>/seeds``, latest under ``directory`` or ``step``'s), on
    ``device``; its step is the lockstep int."""
    if step is None:
        step = latest_seed_step(directory, prefix)
        if step is None:
            raise FileNotFoundError(
                f"no seed-batched checkpoints under {directory!r} "
                f"(prefix {prefix!r})")
    path = seed_checkpoint_path(directory, step, prefix)
    n_seeds = int(n_seeds)
    states = io.restore(path, seed_state_template(cfg, n_seeds, task=task),
                        device=device)
    got = states.step.tolist()
    if got != [int(step)] * n_seeds:
        raise ValueError(
            f"seed checkpoint {path!r} carries steps {got}, expected "
            f"lockstep {int(step)} — was it saved by the seed-batched "
            "driver's checkpoint cadence?")
    return states._replace(step=int(step))


def resume_train_scan_seeds(cfg: SURFConfig, S_stack, meta_datasets, steps,
                            seeds, directory, *, constrained=True,
                            activation="relu", log_every=0, mix_fn=None,
                            eval_every=0, eval_datasets=None,
                            S_eval_stack=None, step=None, prefix=PREFIX,
                            checkpoint_every=0, checkpoint_dir=None,
                            task=None, device=None):
    """Resume a seed-batched ``steps``-long run from its latest stacked
    checkpoint: restore every seed's state and run the REMAINING lockstep
    meta-steps through ``train_scan_seeds``. Equal to the uninterrupted
    run bit for bit; entries record absolute steps; ``checkpoint_every``
    re-arms on the same ``ckpt_<step>`` grid. The stack is restored on
    the host, so the device holds the seeds' own copies only."""
    seeds = _seed_list(seeds)
    device = resolve_device(device)
    states = restore_seed_states(directory, cfg, len(seeds), step=step,
                                 prefix=prefix, task=task, device="cpu")
    return train_scan_seeds(
        cfg, S_stack, meta_datasets, _remaining(states.step, steps), seeds,
        constrained=constrained, activation=activation, log_every=log_every,
        mix_fn=mix_fn, eval_every=eval_every, eval_datasets=eval_datasets,
        S_eval_stack=S_eval_stack, checkpoint_every=checkpoint_every,
        checkpoint_dir=checkpoint_dir, task=task, device=device,
        states=states)
