"""Where the package runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The entry points' device rule: `cuda` by default, the CPU only when a
    caller passes `device="cpu"`. A CUDA device on a machine without one,
    or a card index the machine does not have, raises instead of quietly
    running elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the kernels' plain versions on the host")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} requested but this machine has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
