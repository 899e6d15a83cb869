"""Radix-2 NTT along any axis: A[k] = sum_j a_j w^(jk) (the textbook
convention of the prize2 reference model, `cosic/testvectors/
testvectors.py:28-44`), the inverse scaled by n^-1.

Coefficient planes are (..., n, n_words) Montgomery words with the limb
words last; `axis` names the coefficient axis.  Every transform runs over
the other axes as its batch: for the 8-word scalar fields one call of the
Fr NTT kernel (`fr_kernel.fr_ntt`); for Goldilocks the words become
canonical u64 values (`gl_ops`), go through `gl_kernel.ntt_packed` (one
launch of the Goldilocks kernel up to 2^12, four-step above) and come back
as words.  On the card these are the hand-written kernels, on the CPU
their plain versions.
"""

from __future__ import annotations

import torch

from ..field.spec import GOLDILOCKS
from . import fr_kernel, gl_kernel, gl_ops
from .domain import Domain


def _goldilocks(dom: Domain, a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, n, 2) Montgomery words -> their transforms, as words."""
    if a.device != dom.device:
        raise ValueError(f"a on {a.device}, domain tables on {dom.device}")
    if a.dim() != 3 or tuple(a.shape[1:]) != (dom.n, 2):
        raise ValueError(f"a: expected (B, {dom.n}, 2), got "
                         f"{tuple(a.shape)}")
    x = gl_ops.from_words(a).t().contiguous()
    y = gl_kernel.ntt_packed(dom.log_n, x, inverse, dom.device)
    return gl_ops.to_words(y.t())


def _transform(dom: Domain, a: torch.Tensor, axis: int, inverse: bool
               ) -> torch.Tensor:
    x = torch.movedim(a, axis, -2)
    lead = x.shape[:-2]
    flat = x.reshape(-1, *x.shape[-2:]).contiguous()
    if dom.spec.name == GOLDILOCKS.name:
        out = _goldilocks(dom, flat, inverse)
    else:
        out = fr_kernel.fr_ntt(dom, flat, inverse)
    return torch.movedim(out.reshape(*lead, *out.shape[-2:]), -2, axis)


def ntt(dom: Domain, a: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Forward NTT along `axis` (which indexes the n coefficients)."""
    return _transform(dom, a, axis, inverse=False)


def intt(dom: Domain, a: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse NTT along `axis` (includes the 1/n scale)."""
    return _transform(dom, a, axis, inverse=True)
