"""SURF core: tasks, the unrolled U-DGD network (``unroll``), the
descending constraints, the FL baselines (``baselines``) and the public
solve API (``surf``).

``surf`` depends on the engine package, which itself imports
``core.constraints`` and ``core.unroll``, so it is not imported eagerly
here (that would close the cycle when ``repro_torch.engine`` is imported
first); ``repro_torch.core.surf`` resolves on first attribute access, as
in the reference.
"""
from repro_torch.core import baselines, constraints, unroll  # noqa: F401

__all__ = ["unroll", "constraints", "baselines", "surf"]

_LAZY = ("surf",)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f"repro_torch.core.{name}")
        globals()[name] = module
        return module
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")
