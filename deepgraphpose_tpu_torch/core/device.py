"""Device and dtype resolution shared by the port's entry points."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one this raises: the entry points
    never continue on the CPU unless the caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def resolve_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name as pose_cfg.yaml spells it."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype
