"""Competition-shaped MSM API: an init step that uploads and preprocesses
the fixed point set, then batched MSMs against it (the benchmark harness
calls with a batch of 4 scalar vectors).

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; with no card and no device asked for, they raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..curve import sw
from ..curve.spec import CurveSpec
from ..field import fp
from ..utils.device import resolve_device
from . import pippenger


@dataclasses.dataclass
class MsmContext:
    """Device-resident preprocessed points: `prepared` holds the TE
    window-collapse table built once at init (untimed); its window width
    is `prepared.c`."""
    curve: CurveSpec
    points: sw.Affine
    prepared: pippenger.PreparedTe

    @property
    def device(self) -> torch.device:
        return self.prepared.table.device


def multi_scalar_mult_init(curve: CurveSpec, points_xy,
                           window_bits: int | None = None,
                           device=None) -> MsmContext:
    """points_xy: python int pairs [(x, y) | None], or an `sw.Affine` of
    Montgomery word planes.  Builds the table once, on `device`."""
    dev = resolve_device(device)
    if isinstance(points_xy, sw.Affine):
        aff = sw.Affine(*(a.to(dev) for a in points_xy))
    else:
        f = curve.field
        aff = sw.Affine(
            fp.from_ints(f, [0 if p is None else p[0] for p in points_xy],
                         dev),
            fp.from_ints(f, [1 if p is None else p[1] for p in points_xy],
                         dev),
            torch.tensor([p is None for p in points_xy], device=dev))
    prepared = pippenger.prepare_points(curve, aff, window_bits)
    return MsmContext(curve, aff, prepared)


def multi_scalar_mult(ctx: MsmContext, scalars) -> list[sw.Point]:
    """Batched MSM: scalars (batch, n, L) or (n, L) canonical base-2^15
    limb planes (torch or numpy, e.g. the uint16 compact form); returns one
    SW projective result per batch."""
    if isinstance(scalars, np.ndarray):
        scalars = torch.from_numpy(scalars.astype(np.int32))
    scalars = scalars.to(ctx.device)
    if scalars.dim() == 2:
        scalars = scalars[None]
    return [pippenger.msm(ctx.curve, ctx.points, s, prepared=ctx.prepared)
            for s in scalars]
