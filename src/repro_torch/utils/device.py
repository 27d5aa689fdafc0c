"""Device placement for the port's entry points.

Every entry point takes ``device=``; ``None`` means the CUDA card. There
is no silent CPU path: without a CUDA device the caller must ask for the
CPU explicitly (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device`` (None -> ``"cuda"``). Raises when
    CUDA is asked for and absent.

    On CUDA it also switches TF32 off for cuBLAS and cuDNN: the
    perceptron product and the graph-filter kernel stay full f32, as in
    the reference, so the f32 tolerances of the tests hold on the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` (tensor, numpy array or anything ``np.array`` takes) as a
    tensor on ``device``. Non-tensor input is copied first, so read-only
    arrays (such as views of another framework's buffers) are safe. A
    numpy ``bfloat16`` array (the ``ml_dtypes`` type another framework's
    bf16 arrays convert to, which torch cannot read) is carried across
    as its 16-bit patterns and stays bf16."""
    if not isinstance(x, torch.Tensor):
        a = np.array(x)
        if a.dtype.name == "bfloat16":
            x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(a)
    return x.to(device, dtype)
