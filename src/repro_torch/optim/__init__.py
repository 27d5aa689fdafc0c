"""Plain-tensor optimizers (``optimizers``): the port of ``repro.optim``."""
from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          clip_by_global_norm, momentum, sgd)

__all__ = ["Optimizer", "adam", "apply_updates", "clip_by_global_norm",
           "momentum", "sgd"]
