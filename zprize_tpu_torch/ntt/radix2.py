"""Radix-2 NTT along any axis: A[k] = sum_j a_j w^(jk) (the textbook
convention of the prize2 reference model, `cosic/testvectors/
testvectors.py:28-44`), the inverse scaled by n^-1.

Coefficient planes are (..., n, n_words) Montgomery words with the limb
words last; `axis` names the coefficient axis.  Every transform is one
call of the Fr NTT kernel (`fr_kernel.fr_ntt`) over the other axes as its
batch: on the card the hand-written kernel, on the CPU its plain version.
"""

from __future__ import annotations

import torch

from . import fr_kernel
from .domain import Domain


def _transform(dom: Domain, a: torch.Tensor, axis: int, inverse: bool
               ) -> torch.Tensor:
    x = torch.movedim(a, axis, -2)
    lead = x.shape[:-2]
    flat = x.reshape(-1, *x.shape[-2:]).contiguous()
    out = fr_kernel.fr_ntt(dom, flat, inverse)
    return torch.movedim(out.reshape(*lead, *out.shape[-2:]), -2, axis)


def ntt(dom: Domain, a: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Forward NTT along `axis` (which indexes the n coefficients)."""
    return _transform(dom, a, axis, inverse=False)


def intt(dom: Domain, a: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse NTT along `axis` (includes the 1/n scale)."""
    return _transform(dom, a, axis, inverse=True)
