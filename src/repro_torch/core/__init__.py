"""SURF core: tasks, the unrolled U-DGD network (``unroll``), the
descending constraints, the FL baselines (``baselines``), the ring mixer
(``ring``), the public solve API (``surf``) and the compatibility shims
``graph``, ``task`` and ``trainer``.

``trainer`` and ``surf`` depend on the engine package, which itself
imports ``core.constraints`` and ``core.unroll``, so they are not
imported eagerly here (that would close the cycle when
``repro_torch.engine`` is imported first); they resolve on first
attribute access, as in the reference.
"""
from repro_torch.core import (baselines, constraints, graph,  # noqa: F401
                              task, unroll)

__all__ = ["graph", "task", "unroll", "constraints", "trainer",
           "baselines", "surf"]

_LAZY = ("trainer", "surf")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f"repro_torch.core.{name}")
        globals()[name] = module
        return module
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")
