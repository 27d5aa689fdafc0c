"""Weights in and out of the port: ``io`` reads and writes checkpoints
in the reference's npz + json format (each package restores the
other's), and ``convert`` turns the reference's θ, training state and
LLM parameters, as numpy, into the port's."""
from repro_torch.checkpoint.io import (latest_step, restore, save,
                                       state_save_callback)

__all__ = ["save", "restore", "latest_step", "state_save_callback"]
