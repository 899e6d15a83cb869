"""Twisted-Edwards MSM stages around the kernels: the point tables (one
operand per point, or the window-collapse table), the bucket merges and
the window combine.

Points travel as packed ``(..., 4, n_words)`` int32 tensors (see
``curve/te.py``); every group operation goes through the kernel wrappers
of ``accum_kernel.py``, so on the card each stage is a handful of kernel
launches and on the CPU it runs the plain versions.

The table is row-major ``(m*n, 3, n_words)``: row j*n + i is the
precomputed operand (Y+X, Y-X, 2d·X·Y) of 2^(shift*j)·P_i (m = 1: row i
is P_i's operand).
"""

from __future__ import annotations

import torch

from ..curve import te
from ..curve.spec import CurveSpec
from ..field import fp
from .accum_kernel import te_combine, te_dbl_chain, te_full_add


# points per block of the m = 1 table build: the plain engine's
# temporaries are a few KB a lane, so a block holds a few GB at most
_PREP_BLOCK = 1 << 20


def _te_affine(curve: CurveSpec, x, y, inf):
    """SW affine planes -> TE affine planes; raises ValueError if a point
    has no TE image."""
    tx, ty, bad = te.sw_to_te(curve, x, y, inf)
    if bool(bad.any()):
        raise ValueError(
            "input contains exceptional points with no twisted-Edwards "
            "image; rerun with te=False for the short-Weierstrass route")
    return tx, ty


def prepare_points(curve: CurveSpec, x, y, inf) -> torch.Tensor:
    """SW affine planes (n, nw) -> the m = 1 table (n, 3, nw), one
    operand per point.  Built `_PREP_BLOCK` points at a time (conversion
    with its batched inversion, then the operand), so the plain engine
    never holds temporaries for every point at once.  Raises ValueError
    if a point has no TE image."""
    f = curve.field
    n = x.shape[0]
    table = torch.empty((n, 3, fp.n_words(f)), dtype=torch.int32,
                        device=x.device)
    for lo in range(0, n, _PREP_BLOCK):
        hi = min(n, lo + _PREP_BLOCK)
        tx, ty = _te_affine(curve, x[lo:hi], y[lo:hi], inf[lo:hi])
        table[lo:hi] = te.pack(te.precompute(curve, tx, ty))
    return table


def prepare_points_collapsed(curve: CurveSpec, x, y, inf, shift: int,
                             m: int):
    """SW affine planes (n, nw) -> table (m*n, 3, nw).

    The m blocks 2^(shift*j)·P (the window-collapse trick: with
    shift = c*g the MSM folds its windows onto g bucket sets, and the
    doublings move into this untimed init) come from chains of doublings
    in extended coordinates (`te_dbl_chain`, one launch per block), then
    one batched inversion normalises all m*n points to affine.  Raises
    ValueError, before any doubling, if a point has no TE image."""
    f = curve.field
    tx, ty = _te_affine(curve, x, y, inf)
    one = fp.ones(f, tx.shape[:-1], tx.device)
    blocks = [te.pack(te.TePoint(tx, ty, one, fp.mul(f, tx, ty)))]
    for _ in range(m - 1):
        blocks.append(te_dbl_chain(curve, blocks[-1], shift))
    pts = te.unpack(torch.stack(blocks))                 # (m, n, nw) planes
    del blocks
    zinv = fp.batch_inv(f, pts.z)
    ax = fp.mul(f, pts.x, zinv)
    ay = fp.mul(f, pts.y, zinv)
    table = te.pack(te.precompute(curve, ax, ay))
    return table.reshape(-1, 3, fp.n_words(f))


# total chunk lanes of the triangle merge (W * C), the reference's default
_TRI_LANES = 4096


def triangle_split(n_win: int, n_buckets: int) -> tuple[int, int] | None:
    """The (chunks C, chunk size S) split of the triangle merge: C lanes
    wide (pow2, >= 128), S = B/C sequential steps.  None if the bucket
    range is too small to be worth it.  Same choice as the reference
    package, so both run the same merge for the same plan."""
    if n_buckets < 1024:
        return None
    c_lanes = 128
    while (c_lanes * 2 <= n_buckets // 8
           and n_win * c_lanes * 2 <= _TRI_LANES):
        c_lanes *= 2
    s = n_buckets // c_lanes
    if s < 8:
        return None
    return c_lanes, s


def _identity(curve: CurveSpec, device) -> torch.Tensor:
    return te.pack(te.identity(curve, (), device))       # (4, nw)


def _add(curve: CurveSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane-wise full add of two equal-shape point tensors."""
    shape = a.shape
    a2 = a.reshape(-1, *shape[-2:]).contiguous()
    b2 = b.reshape(-1, *shape[-2:]).contiguous()
    skip = torch.zeros(a2.shape[0], dtype=torch.int32, device=a.device)
    return te_full_add(curve, a2, b2, skip).reshape(shape)


def sum_axis(curve: CurveSpec, pts: torch.Tensor, axis: int) -> torch.Tensor:
    """Tree-reduce packed points along `axis` (log-depth full adds)."""
    pts = pts.movedim(axis, 0)
    n = pts.shape[0]
    while n > 1:
        half = (n + 1) // 2
        merged = _add(curve, pts[:n - half], pts[half:])
        if half > n - half:  # odd: the middle row rides along unmerged
            merged = torch.cat([merged, pts[n - half:half]])
        pts, n = merged, half
    return pts[0]


def _bit_sums(curve: CurveSpec, pts: torch.Tensor, first: int
              ) -> torch.Tensor:
    """pts (W, B, 4, nw) with weights first..first+B-1 -> the per-bit sums
    S_j = sum over the b whose weight has bit j of pts[:, b], as
    (n_bits, W, 4, nw)."""
    n_bits = max(1, (first + pts.shape[1] - 1).bit_length())
    ids = torch.arange(first, first + pts.shape[1], device=pts.device)
    bits = torch.arange(n_bits, device=pts.device)
    mask = ((ids[None, :] >> bits[:, None]) & 1).bool()  # (n_bits, B)
    expanded = torch.where(mask[None, :, :, None, None], pts[:, None],
                           _identity(curve, pts.device))
    return sum_axis(curve, expanded, 2).transpose(0, 1).contiguous()


def merge_buckets_te(curve: CurveSpec, c: int, bucket_sums: torch.Tensor
                     ) -> torch.Tensor:
    """sum_b b*B_b per window by bit decomposition: bucket_sums
    (W, nbe, 4, nw) -> (W, 4, nw).  The per-bit sums are wide full-add
    trees; the fold sum_j 2^j S_j is a c=1 combine."""
    return te_combine(curve, _bit_sums(curve, bucket_sums, 1), 1)


def merge_buckets_te_triangle(curve: CurveSpec, c: int,
                              bucket_sums: torch.Tensor) -> torch.Tensor:
    """sum_b b*B_b per window by the chunked running sum:

      b = q*S + (j+1):  sum_b b*B_b = sum_q U_q + S * sum_q q*T_q
      U_q = sum_j (j+1) B_{qS+j+1}  (running suffix, 2 full adds a step,
                                     S steps over all W*C chunk lanes)
      T_q = sum_j B_{qS+j+1}

    bucket_sums (W, nbe, 4, nw) -> (W, 4, nw)."""
    n_win, nbe = bucket_sums.shape[:2]
    split = triangle_split(n_win, nbe)
    if split is None:
        raise ValueError(f"no triangle split for {n_win} x {nbe} buckets")
    c_lanes, s = split
    lanes = n_win * c_lanes
    dev = bucket_sums.device
    planes = bucket_sums.reshape(lanes, s, *bucket_sums.shape[-2:])
    skip = torch.zeros(lanes, dtype=torch.int32, device=dev)
    acc_s = _identity(curve, dev).expand(lanes, -1, -1).contiguous()
    acc_u = acc_s
    for j in range(s - 1, -1, -1):
        acc_s = te_full_add(curve, acc_s, planes[:, j].contiguous(), skip)
        acc_u = te_full_add(curve, acc_u, acc_s, skip)
    t_q = acc_s.reshape(n_win, c_lanes, *acc_s.shape[-2:])
    u_tot = sum_axis(curve, acc_u.reshape(t_q.shape), 1)        # (W, 4, nw)
    # V = sum_q q*T_q (chunk 0 has weight 0), folded MSB-first
    v = te_combine(curve, _bit_sums(curve, t_q, 0), 1)          # (W, 4, nw)
    # U_tot + 2^log2(S) * V: a combine with c = log2(S) over [U_tot; V]
    return te_combine(curve, torch.stack([u_tot, v]),
                      max(1, s.bit_length() - 1))


def combine_windows_te(curve: CurveSpec, c: int, window_sums: torch.Tensor
                       ) -> torch.Tensor:
    """sum_w 2^(c*w) W_w: window_sums (n_win, 4, nw) -> (4, nw)."""
    return te_combine(curve, window_sums[:, None].contiguous(), c)[0]
