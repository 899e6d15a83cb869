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
