"""The SURF engine: ``core`` holds ``TrainState`` and the evaluation
body; the meta-step and training loops land with the training slice."""
from repro_torch.engine.core import TrainState, _eval_core  # noqa: F401
