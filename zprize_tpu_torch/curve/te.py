"""Twisted-Edwards (a = -1, extended coordinates) form of BLS12-377 G1.

The MSM accumulates in this form: the strongly unified mixed add costs
7 multiplications and needs no select for the identity or for doubling.
The chain of maps from y^2 = x^3 + b (a = 0) is

  SW -> Montgomery  B v^2 = u^3 + A u^2 + u
          u = s (x - alpha), v = s y,  s = 1/sqrt(3 alpha^2), A = 3 alpha s
     -> twisted Edwards  X = u / v, Y = (u - 1)/(u + 1)
     -> scaled to a = -1 with X' = ts X, ts = sqrt(-a_te), d = -d_te / a_te

and a point enters the accumulate as the precomputed affine operand
(Y+X, Y-X, 2d·X·Y), the identity being (1, 1, 0).  Exceptional points
(Montgomery v = 0 or u = -1) have no image; `sw_to_te` flags them.

Points are tuples of Montgomery word planes of ``field/fp.py``.  A point
packs into one ``(..., 4, n_words)`` int32 tensor (`pack`), the row layout
the kernels in ``msm/accum_kernel.py`` read.  The formulas here and in
``csrc/msm_te.cu`` are the same op sequences: keep them in lockstep.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..field import fp
from .spec import CurveSpec


# ---------------------------------------------------------------------------
# host-side parameter derivation
# ---------------------------------------------------------------------------


def _sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli–Shanks; None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general case
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


class TeParams(NamedTuple):
    curve: CurveSpec
    alpha: int      # 2-torsion x-coordinate (root of x^3 + b)
    s: int          # Montgomery scale
    mont_a: int
    ts: int         # x-scale onto the a=-1 curve
    d: int          # TE d parameter (a = -1)
    k: int          # 2d (folded into the precomputed T plane)

    def __hash__(self):
        return hash((self.curve.name, self.d))


@functools.lru_cache(maxsize=None)
def te_params(curve: CurveSpec) -> TeParams:
    """Derive the scaled-TE parameters for an a=0 SW curve whose -b is a
    cube with a 2-torsion point over Fp (true for BLS12-377 G1, b=1,
    alpha=-1).  Raises if any required root is missing."""
    p = curve.field.p
    b = curve.b % p
    # alpha: root of x^3 + b = 0. For b=1 alpha = -1; otherwise search the
    # three cube roots of -b via the cubic-residue structure.
    alpha = None
    if pow(p - b, (p - 1) // 3, p) == 1 if p % 3 == 1 else True:
        # x^3 = -b solvable; find a root deterministically
        if b == 1:
            alpha = p - 1
        else:
            # p = 1 mod 3: cube roots via x = (-b)^((2p-1)/9)-style exponents
            # only needed for curves beyond BLS12-377; handle the easy case
            # p = 2 mod 3 (cubing is a bijection).
            if p % 3 == 2:
                alpha = pow(p - b, (2 * p - 1) // 3, p)
    if alpha is None or (pow(alpha, 3, p) + b) % p != 0:
        raise ValueError(f"no rational 2-torsion for curve {curve.name}")
    s_inv = _sqrt_mod(3 * alpha * alpha % p, p)
    if s_inv is None:
        raise ValueError(f"sqrt(3 alpha^2) does not exist for {curve.name}")
    s = pow(s_inv, p - 2, p)
    mont_a = 3 * alpha * s % p
    mont_b = s
    binv = pow(mont_b, p - 2, p)
    a_te = (mont_a + 2) * binv % p
    d_te = (mont_a - 2) * binv % p
    ts = _sqrt_mod(p - a_te, p)
    if ts is None:
        raise ValueError(f"-a_te is a non-residue for {curve.name}")
    d = (p - d_te) * pow(a_te, p - 2, p) % p
    return TeParams(curve, alpha, s, mont_a, ts, d, 2 * d % p)


# ---------------------------------------------------------------------------
# point containers
# ---------------------------------------------------------------------------


class TePoint(NamedTuple):
    """Extended (a=-1) twisted-Edwards point (X : Y : Z : T), T = XY/Z."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


class TePre(NamedTuple):
    """Precomputed-affine operand: (Y+X, Y-X, 2d·X·Y); identity=(1,1,0)."""
    yp: torch.Tensor
    ym: torch.Tensor
    kt: torch.Tensor


def pack(p) -> torch.Tensor:
    """TePoint / TePre -> one (..., 4 or 3, n_words) contiguous tensor."""
    return torch.stack(tuple(p), dim=-2).contiguous()


def unpack(a: torch.Tensor) -> TePoint:
    """(..., 4, n_words) -> TePoint of (..., n_words) planes."""
    return TePoint(*a.unbind(-2))


def unpack_pre(a: torch.Tensor) -> TePre:
    """(..., 3, n_words) -> TePre of (..., n_words) planes."""
    return TePre(*a.unbind(-2))


def identity(curve: CurveSpec, shape=(), device="cpu") -> TePoint:
    f = curve.field
    zero, one = fp.zeros(f, shape, device), fp.ones(f, shape, device)
    return TePoint(zero, one, one, zero)


def identity_pre(curve: CurveSpec, shape=(), device="cpu") -> TePre:
    f = curve.field
    one = fp.ones(f, shape, device)
    return TePre(one, one, fp.zeros(f, shape, device))


def select(cond, a: TePoint, b: TePoint) -> TePoint:
    return TePoint(*(fp.select(cond, x, y) for x, y in zip(a, b)))


def is_identity(curve: CurveSpec, p1: TePoint) -> torch.Tensor:
    """(0 : Y : Y : 0): X = 0 and Y = Z, lane by lane."""
    f = curve.field
    return fp.is_zero(f, p1.x) & fp.eq(f, p1.y, p1.z)


def neg_pre(curve: CurveSpec, q: TePre) -> TePre:
    """-(X, Y) = (-X, Y): swaps the Y±X planes and negates the 2dXY plane."""
    return TePre(q.ym, q.yp, fp.neg(curve.field, q.kt))


def select_neg_pre(curve: CurveSpec, sign, q: TePre) -> TePre:
    """Lane select of q / -q."""
    return TePre(*(fp.select(sign, n, a)
                   for n, a in zip(neg_pre(curve, q), q)))


# ---------------------------------------------------------------------------
# group law (plain form; the kernels in csrc/msm_te.cu run the same ops)
# ---------------------------------------------------------------------------


def add_mixed(curve: CurveSpec, p1: TePoint, q: TePre) -> TePoint:
    """Strongly-unified mixed add (madd-2008-hwcd-3, a=-1): 7M + 8A.
    Handles doubling and either-operand-identity with no selects.
    Independent products and sums share one plain-engine call
    (`fp.stacked`)."""
    f = curve.field
    ymx = fp.sub(f, p1.y, p1.x)
    ypx, d = fp.stacked(fp.add, f, [(p1.y, p1.x), (p1.z, p1.z)])
    a, b, c = fp.stacked(fp.mul, f, [(ymx, q.ym), (ypx, q.yp),
                                     (p1.t, q.kt)])
    return _finish(f, a, b, c, d)


def add(curve: CurveSpec, p1: TePoint, p2: TePoint) -> TePoint:
    """Strongly-unified full add (add-2008-hwcd-3, a=-1): 8M + 1k + 8A."""
    f = curve.field
    k = fp.constant(f, te_params(curve).k, (), p1.x.device)
    ymx1, ymx2 = fp.stacked(fp.sub, f, [(p1.y, p1.x), (p2.y, p2.x)])
    ypx1, ypx2 = fp.stacked(fp.add, f, [(p1.y, p1.x), (p2.y, p2.x)])
    a, b, tt, zz = fp.stacked(fp.mul, f, [(ymx1, ymx2), (ypx1, ypx2),
                                          (p1.t, p2.t), (p1.z, p2.z)])
    c = fp.mul(f, tt, k)
    d = fp.double(f, zz)
    return _finish(f, a, b, c, d)


def dbl(curve: CurveSpec, p1: TePoint) -> TePoint:
    """dbl-2008-hwcd (a=-1): 4M + 4S + 1 double."""
    f = curve.field
    xy = fp.add(f, p1.x, p1.y)
    a, b, zz, s = fp.stacked(fp.mul, f, [(p1.x, p1.x), (p1.y, p1.y),
                                         (p1.z, p1.z), (xy, xy)])
    c, ab = fp.stacked(fp.add, f, [(zz, zz), (a, b)])
    # a = -1: D = -A, G = D + B = B - A, H = D - B = -(A + B)
    e, g, h = fp.stacked(fp.sub, f, [(s, ab), (b, a),
                                     (torch.zeros_like(ab), ab)])
    ff = fp.sub(f, g, c)
    return TePoint(*fp.stacked(fp.mul, f, [(e, ff), (g, h), (ff, g),
                                           (e, h)]))


def _finish(f, a, b, c, d) -> TePoint:
    """Shared tail of the hwcd-3 adds: E=B-A, F=D-C, G=D+C, H=B+A."""
    e, ff = fp.stacked(fp.sub, f, [(b, a), (d, c)])
    g, h = fp.stacked(fp.add, f, [(d, c), (b, a)])
    return TePoint(*fp.stacked(fp.mul, f, [(e, ff), (g, h), (ff, g),
                                           (e, h)]))


# ---------------------------------------------------------------------------
# SW <-> TE conversions
# ---------------------------------------------------------------------------


def sw_to_te(curve: CurveSpec, x, y, inf):
    """SW affine planes -> (te_x, te_y, bad) affine TE planes.

    bad marks exceptional lanes (Montgomery v = 0 or u = -1) that have no
    TE image; callers must check it (identity lanes are NOT bad: they map
    to the TE identity (0, 1)).  One batched inversion."""
    f = curve.field
    pr = te_params(curve)
    dev = x.device
    one = fp.ones(f, (), dev)
    u = fp.mul(f, fp.constant(f, pr.s, (), dev),
               fp.sub(f, x, fp.constant(f, pr.alpha, (), dev)))
    v = fp.mul(f, fp.constant(f, pr.s, (), dev), y)
    up1 = fp.add(f, u, one)
    bad = ~inf & (fp.is_zero(f, v) | fp.is_zero(f, up1))
    denom = fp.select(bad | inf, one.expand_as(v), fp.mul(f, v, up1))
    dinv = fp.batch_inv(f, denom)
    te_x = fp.mul(f, fp.mul(f, fp.constant(f, pr.ts, (), dev), u),
                  fp.mul(f, up1, dinv))
    te_y = fp.mul(f, fp.sub(f, u, one), fp.mul(f, v, dinv))
    te_x = fp.select(inf, torch.zeros_like(te_x), te_x)
    te_y = fp.select(inf, one.expand_as(te_y), te_y)
    return te_x, te_y, bad


def precompute(curve: CurveSpec, te_x, te_y) -> TePre:
    """Affine TE -> precomputed accumulate operand (Y+X, Y-X, 2d·X·Y)."""
    f = curve.field
    k = fp.constant(f, te_params(curve).k, (), te_x.device)
    return TePre(fp.add(f, te_y, te_x), fp.sub(f, te_y, te_x),
                 fp.mul(f, k, fp.mul(f, te_x, te_y)))


def te_to_sw_affine(curve: CurveSpec, pts: torch.Tensor):
    """Packed extended TE points (..., 4, nw) -> SW affine planes
    (x, y, inf) on their device, with one batched inversion.

    The map of `te_to_sw_host` with the divisions gathered over one
    denominator D = (Z - Y)·X·s:  u = (Z + Y)/(Z - Y) and v = u·ts·Z/X give
    x = u/s + alpha = (Z + Y)·X/D + alpha and y = v/s = (Z + Y)·ts·Z/D.
    D is zero only for the identity (flagged inf) and the 2-torsion point,
    which comes out as (alpha, 0) since the inverse of 0 is 0."""
    f = curve.field
    pr = te_params(curve)
    p = unpack(pts)
    dev = pts.device
    zpy = fp.add(f, p.z, p.y)
    d = fp.mul(f, fp.mul(f, fp.sub(f, p.z, p.y), p.x),
               fp.constant(f, pr.s, (), dev))
    dinv = fp.batch_inv(f, d)
    x = fp.add(f, fp.mul(f, fp.mul(f, zpy, p.x), dinv),
               fp.constant(f, pr.alpha, (), dev))
    y = fp.mul(f, fp.mul(f, zpy, fp.mul(f, p.z, fp.constant(f, pr.ts, (),
                                                           dev))), dinv)
    return x, y, is_identity(curve, p)


def te_to_sw_host(curve: CurveSpec, x: int, y: int, z: int
                  ) -> tuple[int, int, int]:
    """Exact host-int TE->SW conversion of ONE point (the MSM result):
    three python modular inverses.  Returns SW projective (x, y, z) with z
    in {0, 1}."""
    pr = te_params(curve)
    p = curve.field.p
    x, y, z = x % p, y % p, z % p
    if x == 0 and y == z:
        return (0, 1, 0)                         # identity
    zinv = pow(z, p - 2, p)
    ax, ay = x * zinv % p, y * zinv % p
    x_plain = ax * pow(pr.ts, p - 2, p) % p
    if x_plain == 0:                             # TE (0,-1): the 2-torsion
        return (pr.alpha, 0, 1)
    num, den = (1 + ay) % p, (1 - ay) % p
    u = num * pow(den, p - 2, p) % p             # den != 0 off-identity
    v = u * pow(x_plain, p - 2, p) % p
    sinv = pow(pr.s, p - 2, p)
    return ((u * sinv + pr.alpha) % p, v * sinv % p, 1)
