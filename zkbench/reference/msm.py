"""The expected MSM over a point set of `base` distinct points
P_j = (j + 1)·G, row i holding P_{class_i} with class_i drawn from the
seed: sum_i s_i·P_{class_i} = (sum_i (class_i + 1)·s_i)·G.  Scalars are
the compact form the program takes: (n, 17) uint16 base-2^15 limbs,
canonical.  The sum over rows is taken limb by limb in int64 over blocks
of rows (plain PyTorch, on the device the run uses), exact: a block's
limb sum stays below 2^15 · base · block."""

from __future__ import annotations

import numpy as np
import torch

from . import curve

LIMB_BITS = 15
BLOCK_ROWS = 1 << 22


def weighted_limb_sums(batch: np.ndarray, classes: np.ndarray, device,
                       low_bits: int = 0) -> list[int]:
    """Per limb l, sum_i (classes[i] + 1)·batch[i, l] as Python ints; with
    `low_bits` (15 < low_bits < 30), of the scalars with that many low
    bits cleared (the control)."""
    n, n_limbs = batch.shape
    if classes.shape != (n,):
        raise ValueError(f"{n} rows but {classes.shape} classes")
    keep = 0x7FFF & ~((1 << (low_bits - LIMB_BITS)) - 1) if low_bits else 0
    out = [0] * n_limbs
    for a in range(0, n, BLOCK_ROWS):
        s = torch.from_numpy(batch[a:a + BLOCK_ROWS].view(np.int16)).to(
            device).to(torch.int64)
        if low_bits:
            s[:, 0] = 0
            s[:, 1] &= keep
        w = torch.from_numpy(classes[a:a + BLOCK_ROWS]).to(device).to(
            torch.int64) + 1
        sums = (s * w[:, None]).sum(dim=0).tolist()
        out = [x + y for x, y in zip(out, sums)]
    return out


def expected(sums: list[int]):
    """(sum_l sums[l]·2^(15 l))·G as affine ints (None for the identity)."""
    return curve.mul(curve.G, sum(v << (LIMB_BITS * i)
                                  for i, v in enumerate(sums)))


def base_points(base: int) -> list:
    """The distinct points (j + 1)·G, j < base, one affine add each."""
    out, cur = [], None
    for _ in range(base):
        cur = curve.add(cur, curve.G)
        out.append(cur)
    return out
