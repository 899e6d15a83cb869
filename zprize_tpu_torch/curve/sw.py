"""Short-Weierstrass group law (y^2 = x^3 + b, a = 0), branch-free and
complete, in plain PyTorch on the ``field/fp.py`` engine.

The Renes–Costello–Batina complete homogeneous-projective formulas for
a = 0 (eprint 2015/1060, §4): one op sequence handles addition, doubling,
the identity and inverse pairs with no select.  The formulas and their
order are the reference package's (`curve/sw.py`), and the kernels of
``csrc/msm_sw.cu`` run the same sequences; every field result is fully
reduced, so kernel and plain version agree word for word.

A point is three Montgomery word planes (X, Y, Z) of shape (..., n_words);
the identity is (0 : 1 : 0).  A point packs into one ``(..., 3, n_words)``
int32 tensor (`pack`), the row layout the SW kernels in
``msm/accum_kernel.py`` read and write.
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


def pack(p: Point) -> torch.Tensor:
    """Point -> one (..., 3, n_words) contiguous tensor."""
    return torch.stack(tuple(p), dim=-2).contiguous()


def unpack(a: torch.Tensor) -> Point:
    """(..., 3, n_words) -> Point of (..., n_words) planes."""
    return Point(*a.unbind(-2))


def identity(curve: CurveSpec, shape=(), device="cpu") -> Point:
    f = curve.field
    zero = fp.zeros(f, shape, device)
    return Point(zero, fp.ones(f, shape, device), zero)


def generator(curve: CurveSpec, shape=(), device="cpu") -> Point:
    f = curve.field
    return Point(fp.constant(f, curve.gen_x, shape, device),
                 fp.constant(f, curve.gen_y, shape, device),
                 fp.ones(f, shape, device))


def from_affine(curve: CurveSpec, a: Affine) -> Point:
    """Affine -> projective with Z = 1; infinity lanes -> (0 : 1 : 0)."""
    f = curve.field
    shape, dev = a.x.shape[:-1], a.x.device
    one, zero = fp.ones(f, shape, dev), fp.zeros(f, shape, dev)
    return Point(fp.select(a.inf, zero, a.x), fp.select(a.inf, one, a.y),
                 fp.select(a.inf, zero, one))


def neg(curve: CurveSpec, p: Point) -> Point:
    return Point(p.x, fp.neg(curve.field, p.y), p.z)


def add(curve: CurveSpec, p: Point, q: Point) -> Point:
    """Complete projective addition (RCB a = 0): 12M + two products by 3b.

    X3 = (X1Y2+X2Y1)(Y1Y2-3bZ1Z2) - 3b(Y1Z2+Y2Z1)(X1Z2+X2Z1)
    Y3 = (Y1Y2+3bZ1Z2)(Y1Y2-3bZ1Z2) + 3b(3X1X2)(X1Z2+X2Z1)
    Z3 = (Y1Z2+Y2Z1)(Y1Y2+3bZ1Z2) + (X1Y2+X2Y1)(3X1X2)
    """
    f = curve.field
    pxy, qxy, pyz, qyz, pxz, qxz = fp.stacked(fp.add, f, [
        (p.x, p.y), (q.x, q.y), (p.y, p.z), (q.y, q.z), (p.x, p.z),
        (q.x, q.z)])
    t0, t1, t2, s_xy, s_yz, s_xz = fp.stacked(fp.mul, f, [
        (p.x, q.x), (p.y, q.y), (p.z, q.z), (pxy, qxy), (pyz, qyz),
        (pxz, qxz)])
    m_xy, m_yz, m_xz = fp.stacked(fp.sub, f, zip(
        (s_xy, s_yz, s_xz), fp.stacked(fp.add, f, [(t0, t1), (t1, t2),
                                                   (t0, t2)])))
    return _add_tail(curve, t0, t1, t2, m_xy, m_yz, m_xz)


def add_mixed(curve: CurveSpec, p: Point, a: Affine) -> Point:
    """Complete mixed addition p + a (11M + two products by 3b); `a.inf`
    lanes pass `p` through."""
    f = curve.field
    pxy, axy = fp.stacked(fp.add, f, [(p.x, p.y), (a.x, a.y)])
    t0, t1, s_xy, yz, xz = fp.stacked(fp.mul, f, [
        (p.x, a.x), (p.y, a.y), (pxy, axy), (a.y, p.z), (a.x, p.z)])
    t01, m_yz, m_xz = fp.stacked(fp.add, f, [(t0, t1), (yz, p.y), (xz, p.x)])
    m_xy = fp.sub(f, s_xy, t01)
    return select(a.inf, p, _add_tail(curve, t0, t1, p.z, m_xy, m_yz, m_xz))


def _add_tail(curve: CurveSpec, t0, t1, t2, m_xy, m_yz, m_xz) -> Point:
    f = curve.field
    b3 = fp.constant(f, curve.b3, (), t0.device)
    b3t2, w = fp.stacked(fp.mul, f, [(t2, b3), (m_xz, b3)])
    u = fp.sub(f, t1, b3t2)
    v, t00 = fp.stacked(fp.add, f, [(t1, b3t2), (t0, t0)])
    t3 = fp.add(f, t00, t0)
    a, b, c, d, e, g = fp.stacked(fp.mul, f, [
        (m_xy, u), (m_yz, w), (v, u), (t3, w), (m_yz, v), (m_xy, t3)])
    y3, z3 = fp.stacked(fp.add, f, [(c, d), (e, g)])
    return Point(fp.sub(f, a, b), y3, z3)


def dbl(curve: CurveSpec, p: Point) -> Point:
    """2p through the complete add (as the reference package does)."""
    return add(curve, p, p)


def dbl_a0(curve: CurveSpec, p: Point) -> Point:
    """2p by the dedicated a = 0 doubling (Renes–Costello–Batina,
    Algorithm 9): 6M + 2S and a product by 3b, complete (the identity
    doubles to the identity); the projective words differ from `dbl`'s,
    the point does not.  The doubling of the `sw_combine` kernel.

    X3 = 2XY (Y^2 - 9bZ^2),  Z3 = 8 Y^3 Z
    Y3 = (Y^2 - 9bZ^2)(Y^2 + 3bZ^2) + 24b Y^2 Z^2
    """
    f = curve.field
    k = fp.constant(f, curve.b3, (), p.x.device)
    t0, t1, zz, xy = fp.stacked(fp.mul, f, [(p.y, p.y), (p.y, p.z),
                                          (p.z, p.z), (p.x, p.y)])
    t2 = fp.mul(f, zz, k)                            # 3b Z^2
    z8 = fp.mul(f, t0, fp.constant(f, 8, (), p.x.device))
    x3, z3 = fp.stacked(fp.mul, f, [(t2, z8), (t1, z8)])
    y3 = fp.add(f, t0, t2)
    t0 = fp.sub(f, t0, fp.add(f, fp.add(f, t2, t2), t2))
    ty, tx = fp.stacked(fp.mul, f, [(t0, y3), (t0, xy)])
    return Point(fp.add(f, tx, tx), fp.add(f, x3, ty), z3)


def select(cond: torch.Tensor, p: Point, q: Point) -> Point:
    """cond ? p : q, per lane."""
    return Point(*(fp.select(cond, a, b) for a, b in zip(p, q)))


def is_identity(curve: CurveSpec, p: Point) -> torch.Tensor:
    return fp.is_zero(curve.field, p.z)


def eq(curve: CurveSpec, p: Point, q: Point) -> torch.Tensor:
    """Projective equality by cross-multiplication."""
    f = curve.field
    same_x = fp.eq(f, fp.mul(f, p.x, q.z), fp.mul(f, q.x, p.z))
    same_y = fp.eq(f, fp.mul(f, p.y, q.z), fp.mul(f, q.y, p.z))
    pi, qi = is_identity(curve, p), is_identity(curve, q)
    return torch.where(pi | qi, pi == qi, same_x & same_y)


def to_affine(curve: CurveSpec, p: Point) -> Affine:
    """Projective -> affine with one batched inversion; identity lanes
    come out as (0, 0) with inf set."""
    f = curve.field
    zinv = fp.batch_inv(f, p.z)                  # 0 -> 0
    return Affine(fp.mul(f, p.x, zinv), fp.mul(f, p.y, zinv),
                  is_identity(curve, p))


def affine_neg(curve: CurveSpec, a: Affine) -> Affine:
    return Affine(a.x, fp.neg(curve.field, a.y), a.inf)


def is_on_curve(curve: CurveSpec, a: Affine) -> torch.Tensor:
    f = curve.field
    lhs = fp.mul(f, a.y, a.y)
    rhs = fp.add(f, fp.mul(f, fp.mul(f, a.x, a.x), a.x),
                 fp.constant(f, curve.b, (), a.x.device))
    return fp.eq(f, lhs, rhs) | a.inf


def _scalar_bits(curve: CurveSpec, s: torch.Tensor, n_bits: int
                 ) -> torch.Tensor:
    """Scalar-field Montgomery words (..., nw) -> their canonical bits
    (n_bits, ...) as bool, least significant first."""
    w = fp.from_mont(curve.scalar, s).to(torch.int64) & 0xFFFFFFFF
    j = torch.arange(n_bits, device=s.device)
    bits = (w[..., j // 32] >> (j % 32)) & 1                # (..., n_bits)
    return bits.movedim(-1, 0).bool()


def mul_scalar(curve: CurveSpec, p: Point, s: torch.Tensor,
               nbits: int | None = None) -> Point:
    """Branch-free MSB-first double-and-add per lane; s holds scalar-field
    Montgomery words (..., nw) of p's batch shape.  For SRS generation and
    tests, not the MSM path."""
    nbits = nbits or curve.scalar.p.bit_length()
    bits = _scalar_bits(curve, s, nbits)
    acc = identity(curve, p.x.shape[:-1], p.x.device)
    for i in range(nbits - 1, -1, -1):
        acc = dbl(curve, acc)
        acc = select(bits[i], add(curve, acc, p), acc)
    return acc


def mul_scalar_int(curve: CurveSpec, p: Point, k: int) -> Point:
    """k·p for a fixed non-negative python int k (k may exceed the group
    order, e.g. the order itself for subgroup checks)."""
    if k < 0:
        raise ValueError("k must be non-negative")
    if k == 0:
        return identity(curve, p.x.shape[:-1], p.x.device)
    acc = p                       # the MSB is 1
    for bit in bin(k)[3:]:
        acc = dbl(curve, acc)
        if bit == "1":
            acc = add(curve, acc, p)
    return acc


def _cat(a: Point, b: Point) -> Point:
    return Point(*(torch.cat([u, v]) for u, v in zip(a, b)))


def sum_points(curve: CurveSpec, p: Point, axis: int = 0) -> Point:
    """Log-depth tree reduction of points along `axis` (any length): the
    first half plus the second, an odd last row riding along."""
    p = Point(*(a.movedim(axis, 0) for a in p))
    m = p.x.shape[0]
    while m > 1:
        half = m // 2
        merged = add(curve, Point(*(a[:half] for a in p)),
                     Point(*(a[half:2 * half] for a in p)))
        if m % 2:
            merged = _cat(merged, Point(*(a[m - 1:m] for a in p)))
        p, m = merged, half + m % 2
    return Point(*(a[0] for a in p))


def sum_points_scan(curve: CurveSpec, p: Point, axis: int = 0,
                    group: int = 256) -> Point:
    """The reference's bounded-trace reduction, same order: a scan over
    slabs of `group` rows into `group` running sums, then a tree over
    them; lengths up to 2 * group go straight to the tree."""
    p = Point(*(a.movedim(axis, 0) for a in p))
    m = p.x.shape[0]
    if m <= 2 * group:
        return sum_points(curve, p, axis=0)
    steps = -(-m // group)
    pad = steps * group - m
    if pad:
        p = _cat(p, identity(curve, (pad, *p.x.shape[1:-1]), p.x.device))
    slabs = Point(*(a.reshape(steps, group, *a.shape[1:]) for a in p))
    acc = identity(curve, slabs.x.shape[1:-1], p.x.device)
    for t in range(steps):
        acc = add(curve, acc, Point(*(a[t] for a in slabs)))
    return sum_points(curve, acc, axis=0)


def to_affine_ints(curve: CurveSpec, p: Point):
    """One projective point -> affine python ints (x, y), or None for the
    identity (the form of the python-int oracle)."""
    f = curve.field
    x, y, z = (int(fp.to_ints(f, a)[()]) for a in p)
    if z == 0:
        return None
    zinv = pow(z, f.p - 2, f.p)
    return (x * zinv % f.p, y * zinv % f.p)
