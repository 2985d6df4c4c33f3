"""Device resolution for every entry point of the port.

Entry points take ``device=None``, which means the CUDA card.  A caller
that wants the CPU says so with ``device="cpu"``; there is no silent CPU
fallback.  The float32 precision pins live here and only here: TF32 keeps
about three decimal digits, which at km-scale map coordinates moves points
by metres (the same trap as the TPU's bf16 matmul default).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is asked for and absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ltm_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
