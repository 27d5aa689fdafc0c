"""The SURF engine: ``core`` holds ``TrainState``, the meta-step and the
evaluation body; ``scan`` the training drivers (``train_scan``,
``train``), which take a static S or a ``TopologySchedule``."""
from repro_torch.engine.core import (TrainState,  # noqa: F401
                                     _adaptive_eval_core, _check_static_s,
                                     _engine_cache_key, _eval_core,
                                     adaptive_variant, init_state,
                                     make_eval, make_meta_step)
from repro_torch.engine.scan import (_decimate_history,  # noqa: F401
                                     train, train_scan)
