"""Host (python-int) pairing engine: tower arithmetic, Miller loop, final exp.

This is the framework's L0/L3 "host reduce"-class component for pairings: the
final product-of-pairings check of every reference verifier
(`winderica/plonk/src/proof_system/verifier.rs:229`,
`snarkVM algorithms/src/polycommit/kzg10/mod.rs` `check`) involves a handful
of group elements — a few hundred bytes — so, exactly like the reference's
host-side final reduction (`yrrid-msm/HostReduce.cpp`), it runs on the host
next to the device-side heavy lifting.  There is deliberately no device-side
Fq12 tower: pairing counts per proof are tiny (one multi-pairing), so this
host engine IS the production path, verified by bilinearity/known-answer
tests in `tests/test_pairing.py`.

Everything is plain python ints; no tensors.  Structure: Fq2 as (c0, c1) tuples,
Fq6 as (Fq2, Fq2, Fq2), Fq12 as (Fq6, Fq6).  The Miller loop runs on the
sextic twist with explicit untwist embedding into E(Fq12) — chosen for
auditability over speed (the host check is microseconds-scale regardless).
"""

from __future__ import annotations

import functools

from .params import PairingSpec

Fq2 = tuple  # (int, int)
Fq6 = tuple  # (Fq2, Fq2, Fq2)
Fq12 = tuple  # (Fq6, Fq6)


class HostPairing:
    """Pairing engine over a `PairingSpec`; all methods are host-side ints."""

    def __init__(self, spec: PairingSpec):
        self.spec = spec
        self.p = spec.p
        self.r = spec.r
        self.beta = spec.fq2_nonresidue % self.p
        self.xi = (spec.fq6_nonresidue[0] % self.p,
                   spec.fq6_nonresidue[1] % self.p)

    # ---- Fq2 -------------------------------------------------------------

    def f2_add(self, a, b):
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def f2_sub(self, a, b):
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def f2_neg(self, a):
        p = self.p
        return (-a[0] % p, -a[1] % p)

    def f2_mul(self, a, b):
        p = self.p
        return ((a[0] * b[0] + self.beta * a[1] * b[1]) % p,
                (a[0] * b[1] + a[1] * b[0]) % p)

    def f2_sqr(self, a):
        return self.f2_mul(a, a)

    def f2_inv(self, a):
        p = self.p
        norm = (a[0] * a[0] - self.beta * a[1] * a[1]) % p
        ninv = pow(norm, p - 2, p)
        return (a[0] * ninv % p, -a[1] * ninv % p)

    def f2_muli(self, a, k: int):
        p = self.p
        return (a[0] * k % p, a[1] * k % p)

    F2_ZERO = (0, 0)
    F2_ONE = (1, 0)

    def f2_mul_xi(self, a):
        return self.f2_mul(a, self.xi)

    # ---- Fq6 = Fq2[v]/(v^3 - xi) ----------------------------------------

    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_neg(self, a):
        return tuple(self.f2_neg(x) for x in a)

    def f6_mul(self, a, b):
        m, xi = self.f2_mul, self.f2_mul_xi
        add = self.f2_add
        c0 = add(m(a[0], b[0]), xi(add(m(a[1], b[2]), m(a[2], b[1]))))
        c1 = add(add(m(a[0], b[1]), m(a[1], b[0])), xi(m(a[2], b[2])))
        c2 = add(add(m(a[0], b[2]), m(a[1], b[1])), m(a[2], b[0]))
        return (c0, c1, c2)

    def f6_mul_v(self, a):
        """v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2."""
        return (self.f2_mul_xi(a[2]), a[0], a[1])

    def f6_inv(self, a):
        m, xi, sub = self.f2_mul, self.f2_mul_xi, self.f2_sub
        t0 = sub(self.f2_sqr(a[0]), xi(m(a[1], a[2])))
        t1 = sub(xi(self.f2_sqr(a[2])), m(a[0], a[1]))
        t2 = sub(self.f2_sqr(a[1]), m(a[0], a[2]))
        d = self.f2_add(m(a[0], t0),
                        xi(self.f2_add(m(a[2], t1), m(a[1], t2))))
        dinv = self.f2_inv(d)
        return (m(t0, dinv), m(t1, dinv), m(t2, dinv))

    @property
    def f6_zero(self):
        return (self.F2_ZERO,) * 3

    @property
    def f6_one(self):
        return (self.F2_ONE, self.F2_ZERO, self.F2_ZERO)

    # ---- Fq12 = Fq6[w]/(w^2 - v) -----------------------------------------

    @property
    def one(self):
        return (self.f6_one, self.f6_zero)

    def mul(self, a, b):
        c0 = self.f6_add(self.f6_mul(a[0], b[0]),
                         self.f6_mul_v(self.f6_mul(a[1], b[1])))
        c1 = self.f6_add(self.f6_mul(a[0], b[1]), self.f6_mul(a[1], b[0]))
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def conj(self, a):
        """a^(p^6): the nontrivial automorphism of Fq12/Fq6."""
        return (a[0], self.f6_neg(a[1]))

    def inv(self, a):
        d = self.f6_sub(self.f6_mul(a[0], a[0]),
                        self.f6_mul_v(self.f6_mul(a[1], a[1])))
        dinv = self.f6_inv(d)
        return (self.f6_mul(a[0], dinv), self.f6_neg(self.f6_mul(a[1], dinv)))

    def pow(self, a, e: int):
        if e < 0:
            return self.pow(self.inv(a), -e)
        out = self.one
        for bit in bin(e)[2:]:
            out = self.sqr(out)
            if bit == "1":
                out = self.mul(out, a)
        return out

    def eq(self, a, b):
        return a == b

    # ---- untwist embedding Fq2 point -> E(Fq12) ---------------------------

    def _lift2(self, a: Fq2) -> Fq12:
        return ((a, self.F2_ZERO, self.F2_ZERO), self.f6_zero)

    def lift_fq(self, a: int) -> Fq12:
        return self._lift2((a % self.p, 0))

    @property
    def w(self) -> Fq12:
        return (self.f6_zero, (self.F2_ONE, self.F2_ZERO, self.F2_ZERO))

    @functools.cached_property
    def _w2_w3(self):
        """(w^2, w^3) for D twists, (w^-2, w^-3) for M twists."""
        w = self.w
        w2 = self.mul(w, w)
        w3 = self.mul(w2, w)
        if self.spec.twist_type == "D":
            return w2, w3
        return self.inv(w2), self.inv(w3)

    def embed_g2(self, q: tuple[Fq2, Fq2]) -> tuple[Fq12, Fq12]:
        """Twist point (x', y') -> (x'·w^±2, y'·w^±3) on E(Fq12): y^2=x^3+b."""
        w2, w3 = self._w2_w3
        return (self.mul(self._lift2(q[0]), w2),
                self.mul(self._lift2(q[1]), w3))

    # ---- Miller loop + final exponentiation -------------------------------

    def _line(self, xp, yp, t, q=None):
        """Chord/tangent line through t (and q; tangent if q is None)
        evaluated at the G1 point (xp, yp); returns (l, t_next).
        All coordinates are Fq12; affine formulas (host-side, clarity)."""
        xt, yt = t
        if q is None:
            num = self.mul(self.lift_fq(3), self.sqr(xt))
            den = self.mul(self.lift_fq(2), yt)
        else:
            xq, yq = q
            num = self.f12_sub(yt, yq)
            den = self.f12_sub(xt, xq)
        lam = self.mul(num, self.inv(den))
        other_x = xt if q is None else q[0]
        x3 = self.f12_sub(self.f12_sub(self.sqr(lam), xt), other_x)
        y3 = self.f12_sub(self.mul(lam, self.f12_sub(xt, x3)), yt)
        l = self.f12_sub(self.f12_sub(yp, yt),
                         self.mul(lam, self.f12_sub(xp, xt)))
        return l, (x3, y3)

    def f12_sub(self, a, b):
        return (self.f6_sub(a[0], b[0]), self.f6_sub(a[1], b[1]))

    def miller_loop(self, p1: tuple[int, int], q2: tuple[Fq2, Fq2]) -> Fq12:
        """f_{|x|,Q}(P) (inverted for negative x), Q given on the twist."""
        xp, yp = self.lift_fq(p1[0]), self.lift_fq(p1[1])
        q = self.embed_g2(q2)
        t = q
        f = self.one
        ax = abs(self.spec.x)
        for bit in bin(ax)[3:]:
            l, t = self._line(xp, yp, t)
            f = self.mul(self.sqr(f), l)
            if bit == "1":
                l, t = self._line(xp, yp, t, q)
                f = self.mul(f, l)
        if self.spec.x < 0:
            # f_{-|x|} = 1/f_{|x|}; exact inversion here (conjugation is only
            # an inverse for unitary elements, which f is not pre-final-exp).
            f = self.inv(f)
        return f

    @functools.cached_property
    def _hard_exp(self) -> int:
        p = self.p
        return (p ** 4 - p ** 2 + 1) // self.r

    def final_exp(self, f: Fq12) -> Fq12:
        p = self.p
        f = self.mul(self.conj(f), self.inv(f))        # ^(p^6 - 1)
        f = self.mul(self.pow(f, p * p), f)            # ^(p^2 + 1)
        return self.pow(f, self._hard_exp)             # ^((p^4-p^2+1)/r)

    def pairing(self, p1: tuple[int, int], q2: tuple[Fq2, Fq2]) -> Fq12:
        """Full ate pairing e(P, Q); P affine G1 ints, Q affine twist Fq2."""
        return self.final_exp(self.miller_loop(p1, q2))

    def multi_pairing_is_one(self, pairs) -> bool:
        """prod_i e(P_i, Q_i) == 1, sharing one final exponentiation —
        the check shape of `verifier.rs:229` (multi_pairing == Fqk::one())."""
        f = self.one
        for p1, q2 in pairs:
            f = self.mul(f, self.miller_loop(p1, q2))
        return self.final_exp(f) == self.one

    # ---- G2 (twist) group ops, host side ---------------------------------

    def g2_is_on_curve(self, q) -> bool:
        x, y = q
        lhs = self.f2_sqr(y)
        rhs = self.f2_add(self.f2_mul(self.f2_sqr(x), x),
                          (self.spec.g2_b[0] % self.p,
                           self.spec.g2_b[1] % self.p))
        return lhs == rhs

    def g2_add(self, a, b):
        """Affine twist-point addition; None is the identity."""
        if a is None:
            return b
        if b is None:
            return a
        (x1, y1), (x2, y2) = a, b
        if x1 == x2:
            if (y1[0] + y2[0]) % self.p == 0 and (y1[1] + y2[1]) % self.p == 0:
                return None
            num = self.f2_muli(self.f2_sqr(x1), 3)
            den = self.f2_muli(y1, 2)
        else:
            num = self.f2_sub(y2, y1)
            den = self.f2_sub(x2, x1)
        lam = self.f2_mul(num, self.f2_inv(den))
        x3 = self.f2_sub(self.f2_sub(self.f2_sqr(lam), x1), x2)
        y3 = self.f2_sub(self.f2_mul(lam, self.f2_sub(x1, x3)), y1)
        return (x3, y3)

    def g2_neg(self, a):
        if a is None:
            return None
        return (a[0], self.f2_neg(a[1]))

    def g2_mul(self, a, k: int):
        k %= self.r
        out, base = None, a
        while k:
            if k & 1:
                out = self.g2_add(out, base)
            base = self.g2_add(base, base)
            k >>= 1
        return out

    @property
    def g2_gen(self):
        return ((self.spec.g2_gen_x[0] % self.p, self.spec.g2_gen_x[1] % self.p),
                (self.spec.g2_gen_y[0] % self.p, self.spec.g2_gen_y[1] % self.p))


@functools.lru_cache(maxsize=None)
def host_pairing(spec: PairingSpec) -> HostPairing:
    return HostPairing(spec)


# ---------------------------------------------------------------------------
# Host G1 affine helpers (python ints; None = identity).  The verifier-side
# group combinations involve a handful of points — host arithmetic here is
# the direct analog of `HostReduce.cpp`'s CPU final reduction.
# ---------------------------------------------------------------------------


def g1_add(p_mod: int, a, b):
    if a is None:
        return b
    if b is None:
        return a
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if (y1 + y2) % p_mod == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, p_mod - 2, p_mod) % p_mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, p_mod - 2, p_mod) % p_mod
    x3 = (lam * lam - x1 - x2) % p_mod
    y3 = (lam * (x1 - x3) - y1) % p_mod
    return (x3, y3)


def g1_neg(p_mod: int, a):
    if a is None:
        return None
    return (a[0], -a[1] % p_mod)


def g1_mul(p_mod: int, a, k: int):
    out, base = None, a
    while k:
        if k & 1:
            out = g1_add(p_mod, out, base)
        base = g1_add(p_mod, base, base)
        k >>= 1
    return out
