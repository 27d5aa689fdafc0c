"""Compatibility shim: the meta-training engine lives in
``repro_torch.engine``; the port of ``repro.core.trainer``.

It re-exports the engine's objects (the same objects, not copies), the
private hooks included (``_eval_core``, ``_meta_step_core``,
``_engine_cache_key``), so ``from repro_torch.core import trainer as TR``
keeps working. The reference's compiled-engine cache and trace counters
(``_ENGINE_CACHE``, ``TRACE_COUNTS``, ``make_train_scan``) have no
counterpart: PyTorch runs the drivers eagerly. New code imports
``repro_torch.engine``.
"""
from repro_torch.engine.core import (  # noqa: F401
    _check_static_s, _engine_cache_key, _eval_core, _meta_step_core,
    TrainState, init_state, make_eval, make_meta_step)
from repro_torch.engine.scan import (  # noqa: F401
    _decimate_history, train, train_scan)

__all__ = [
    "TrainState", "init_state", "make_meta_step", "make_eval",
    "train_scan", "train",
]
