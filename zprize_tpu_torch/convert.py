"""Carry the reference package's state across into this port's form.

The reference keeps field elements as (n, 26) redundant base-2^15 limb
planes (limbs < 2^16, value reduced mod p only lazily), scalars as (n, 17)
limb planes or the uint16 compact form of the benchmark, and its prepared
window-collapse table u16-packed and column-major.  Everything here takes
numpy arrays and returns this port's tensors, reducing values mod p
exactly through python ints (fine at test sizes; the main path never
converts a large table).  Like the other entry points, they return
tensors on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve import sw
from .curve.spec import CurveSpec
from .field import fp
from .field.spec import BASE_BITS, FieldSpec
from .msm.pippenger import PreparedTe
from .utils.device import resolve_device


def _ints(planes: np.ndarray) -> np.ndarray:
    """(..., L) base-2^15 limbs (any per-limb value) -> object ints."""
    planes = np.asarray(planes)
    weights = np.array([1 << (BASE_BITS * j) for j in range(planes.shape[-1])],
                       dtype=object)
    return planes.astype(object) @ weights


def elements_from_reference(spec: FieldSpec, planes, device=None
                            ) -> torch.Tensor:
    """Reference field planes (..., n_limbs), limbs < 2^16 -> Montgomery
    words (..., n_words)."""
    return fp.from_ints(spec, _ints(planes), resolve_device(device))


def points_from_reference(curve: CurveSpec, x_planes, y_planes, inf,
                          device=None) -> sw.Affine:
    """Reference affine planes (n, 26) + inf mask -> `sw.Affine`."""
    f = curve.field
    device = resolve_device(device)
    return sw.Affine(elements_from_reference(f, x_planes, device),
                     elements_from_reference(f, y_planes, device),
                     torch.as_tensor(np.asarray(inf, bool), device=device))


def scalars_from_reference(curve: CurveSpec, planes, device=None
                           ) -> torch.Tensor:
    """Reference scalar planes -> canonical (n, L) int32 base-2^15 limbs.
    uint16 planes are the compact form, canonical by contract; other
    planes may be redundant and are reduced mod r."""
    device = resolve_device(device)
    planes = np.asarray(planes)
    if planes.dtype == np.uint16:
        return torch.from_numpy(planes.astype(np.int32)).to(device)
    r = curve.order
    n_limbs = curve.scalar.n_limbs
    vals = [int(v) % r for v in _ints(planes).reshape(-1)]
    limbs = [[(v >> (BASE_BITS * j)) & ((1 << BASE_BITS) - 1)
              for j in range(n_limbs)] for v in vals]
    out = np.asarray(limbs, np.int32).reshape(*planes.shape[:-1], n_limbs)
    return torch.from_numpy(out).to(device)


def prepared_from_reference(curve: CurveSpec, packed, c: int, g: int, m: int,
                            n: int, device=None) -> PreparedTe:
    """The reference `PreparedTe.packed` table, (3h, m*n) column-major with
    each plane's 26 limbs u16-packed in split-half order (limb j in the
    low half of word j, limb j+h in the high half), -> this port's
    `PreparedTe` with a (m*n, 3, nw) table."""
    device = resolve_device(device)
    packed = np.asarray(packed, dtype=np.uint32)
    n_limbs = curve.field.n_limbs
    h = (n_limbs + 1) // 2
    if packed.shape != (3 * h, m * n):
        raise ValueError(f"expected a ({3 * h}, {m * n}) table, got "
                         f"{packed.shape}")
    rows = packed.T
    planes = []
    for q in range(3):
        words = rows[:, q * h:(q + 1) * h]
        limbs = np.concatenate([words & 0xFFFF, words >> 16], axis=1)
        planes.append(elements_from_reference(curve.field,
                                              limbs[:, :n_limbs], device))
    return PreparedTe(torch.stack(planes, dim=1).contiguous(), c, g, m, n)
