"""The LLM substrate for serving: layers, attention (flash-attention
kernel in the prefill), the RWKV6 mixer (wkv kernel in the prefill),
segmented stacks and the model API."""
from repro_torch.models import attention, layers, model, ssm, stack

__all__ = ["layers", "attention", "ssm", "stack", "model"]
