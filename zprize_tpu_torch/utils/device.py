"""Where the port's entry points run: on the card unless the caller asks
for the CPU (where the kernel wrappers take their plain versions)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when none is given; raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run the plain versions")
    return torch.device("cuda")


def on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (a wrapper launches its kernel), False for CPU
    tensors (it takes the plain version); tensors on several devices or on
    another kind of device raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of t's card, for a launcher."""
    return torch.cuda.current_stream(t.device).cuda_stream
