"""Device resolution for every entry point of the port.

The port runs on an NVIDIA GPU. ``device=None`` means ``cuda``; without a
CUDA device that raises instead of quietly running on the CPU, so a
measurement or a server can never mistake a CPU run for a GPU one. The CPU
is used only when a caller asks for it by name, as the tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tensorhive_tpu_torch needs a CUDA device (none is available); "
            "pass device='cpu' to run the plain PyTorch path explicitly")
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {resolved}")
    return resolved
