"""Short-Weierstrass point containers and the host affine conversion.

The group law of this form is not ported yet (the SW MSM route raises; see
``msm/pippenger.py``).  Coordinates are Montgomery word planes of
``field/fp.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..field import fp
from .spec import CurveSpec


class Point(NamedTuple):
    """Homogeneous projective point (X : Y : Z); the identity is (0 : 1 : 0)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class Affine(NamedTuple):
    """Affine points with an explicit infinity mask (batch-shaped bool)."""
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


def to_affine_ints(curve: CurveSpec, p: Point):
    """One projective point -> affine python ints (x, y), or None for the
    identity (the form of the python-int oracle)."""
    f = curve.field
    x, y, z = (int(fp.to_ints(f, a)[()]) for a in p)
    if z == 0:
        return None
    zinv = pow(z, f.p - 2, f.p)
    return (x * zinv % f.p, y * zinv % f.p)
