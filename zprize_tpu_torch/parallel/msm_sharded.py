"""Points-sharded MSM over a world of ranks.

Each rank runs the whole windowed Pippenger MSM (`msm_jit_static`, the SW
kernels) on its own shard of points and scalars; the ranks' partial
results, one projective point each, are all-gathered and tree-added, so
every rank holds the sum.  The collective moves a few hundred bytes a
rank: the analog of the reference's result copies and host reduction
(`MSM.cu:480-494`, `HostReduce.cpp`).
"""

from __future__ import annotations

import torch

from ..curve import sw
from ..curve.spec import CurveSpec
from ..msm.pippenger import msm_jit_static
from .mesh import World, all_gather_rows


def msm_sharded(curve: CurveSpec, points_local: sw.Affine,
                scalars_local: torch.Tensor, world: World, c: int = 10,
                cap_total: int | None = None) -> sw.Point:
    """sum_i s_i·P_i over the points and scalars of every rank, each rank
    giving its shard ((n_local, ...) planes on its device, one n_local on
    all ranks); the projective sum, replicated on every rank.
    `cap_total` is each rank's bucket-occupancy bound (see
    `msm_jit_static`), by default the local n."""
    n_local = points_local.x.shape[0]
    if cap_total is None:
        cap_total = n_local
    res = msm_jit_static(curve, points_local, scalars_local, c, cap_total)
    parts = all_gather_rows(sw.pack(res)[None], world)       # (D, 3, nw)
    return sw.sum_points(curve, sw.unpack(parts), axis=0)
