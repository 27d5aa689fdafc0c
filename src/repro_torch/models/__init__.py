"""The LLM substrate for serving and training: layers, attention (the
flash-attention kernel on every full-sequence attention), the RWKV6
mixer (wkv kernel), MoE and Mamba, segmented stacks, the audio frontend
stub of the enc-dec model and the model API."""
from repro_torch.models import (attention, frontend, layers, model, moe, ssm,
                                stack)

__all__ = ["layers", "attention", "moe", "ssm", "stack", "model", "frontend"]
