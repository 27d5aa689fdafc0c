"""The SURF engine (the port of ``repro.engine``):

  * ``engine.core``      — ``TrainState``, the S-as-argument meta-step
                           and evaluation bodies, the cache keys;
  * ``engine.scan``      — the single-seed drivers (``train_scan``,
                           ``train``): static S or a ``TopologySchedule``,
                           in-loop snapshots, periodic checkpoints;
  * ``engine.seeds``     — seed-batched training (lockstep over the
                           seeds, stacked states);
  * ``engine.snapshots`` — in-loop evaluation at an ``eval_every``
                           cadence;
  * ``engine.resume``    — restore from a checkpoint and train on.
"""
from repro_torch.engine import resume, seeds, snapshots  # noqa: F401
from repro_torch.engine.core import (TrainState,  # noqa: F401
                                     _adaptive_eval_core, _check_static_s,
                                     _engine_cache_key, _eval_core,
                                     _meta_step_core, adaptive_variant,
                                     init_state, make_eval, make_meta_step)
from repro_torch.engine.scan import (_decimate_history,  # noqa: F401
                                     train, train_scan)
from repro_torch.engine.seeds import (init_states,  # noqa: F401
                                      stack_schedules, state_for_seed,
                                      train_scan_seeds)
from repro_torch.engine.snapshots import (  # noqa: F401
    decimate_snapshots, make_snapshot_fn, snapshot_reference)

__all__ = [
    "TrainState", "adaptive_variant", "init_state", "make_meta_step",
    "make_eval", "train", "train_scan", "train_scan_seeds", "init_states",
    "state_for_seed", "stack_schedules", "make_snapshot_fn",
    "snapshot_reference", "decimate_snapshots", "resume", "seeds",
    "snapshots",
]
