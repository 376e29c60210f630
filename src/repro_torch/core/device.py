"""Device resolution for the port's entry points.

The port runs on CUDA. A caller that wants the plain PyTorch versions on
the CPU (the tests) says so with ``device="cpu"``; there is no silent
fallback from a missing GPU to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no GPU is visible); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA and no GPU is visible; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
