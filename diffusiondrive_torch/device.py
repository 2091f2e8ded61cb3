"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU explicitly
(`device="cpu"`, as the CPU tests do). Without a GPU and without that
request they raise: there is no silent CPU path.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` -> the current CUDA device (raises without one); else `device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "diffusiondrive_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
