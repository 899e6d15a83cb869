"""Python-int reference for the MSM: affine short-Weierstrass group law,
the generator chain k·G, the map onto the twisted-Edwards form, and the
seeded scalar batches of the benchmark; and for the NTT: the direct
transform and a recursive radix-2 one.

Points are affine int pairs with None as the identity.  When the base
points are the chain P_i = (i+1)·G, an MSM collapses to one scalar
multiplication: sum_i s_i·P_i = (sum_i s_i·(i+1) mod r)·G.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..curve import te
from ..curve.spec import CurveSpec


def ec_add(p, q, prime, a=0):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % prime == 0:
            return None
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, prime) % prime
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, prime) % prime
    x3 = (lam * lam - x1 - x2) % prime
    y3 = (lam * (x1 - x3) - y1) % prime
    return (x3, y3)


def _jdbl(q, prime, a):
    """Doubling of a Jacobian point (X, Y, Z) = (X/Z^2, Y/Z^3); Z = 0 is
    the identity."""
    x, y, z = q
    if not z or not y:
        return (1, 1, 0)
    yy = y * y % prime
    s = 4 * x * yy % prime
    m = (3 * x * x + a * pow(z, 4, prime)) % prime
    x3 = (m * m - 2 * s) % prime
    return (x3, (m * (s - x3) - 8 * yy * yy) % prime, 2 * y * z % prime)


def _jadd_affine(q, p, prime, a):
    """Jacobian q plus affine p."""
    x, y, z = q
    if not z:
        return (p[0], p[1], 1)
    zz = z * z % prime
    h = (p[0] * zz - x) % prime
    r = (p[1] * z * zz - y) % prime
    if h == 0:
        return _jdbl(q, prime, a) if r == 0 else (1, 1, 0)
    hh = h * h % prime
    hhh = h * hh % prime
    x3 = (r * r - hhh - 2 * x * hh) % prime
    return (x3, (r * (x * hh - x3) - y * hhh) % prime, z * h % prime)


def ec_mul(p, k, prime, a=0):
    """k·p for k >= 0: MSB-first double-and-add in Jacobian coordinates,
    one inversion at the end."""
    if p is None or k == 0:
        return None
    q = (p[0], p[1], 1)
    for bit in bin(k)[3:]:
        q = _jdbl(q, prime, a)
        if bit == "1":
            q = _jadd_affine(q, p, prime, a)
    x, y, z = q
    if not z:
        return None
    zinv = pow(z, -1, prime)
    zinv2 = zinv * zinv % prime
    return (x * zinv2 % prime, y * zinv2 * zinv % prime)


def generator(curve: CurveSpec):
    return (curve.gen_x, curve.gen_y)


def subgroup_points(curve: CurveSpec, count: int, seed: int = 0) -> list:
    """Seeded points of the prime-order subgroup: k·G for k drawn by
    random.Random(seed).randrange(1, order), one after another."""
    rng = random.Random(seed)
    return [ec_mul(generator(curve), rng.randrange(1, curve.order),
                   curve.field.p) for _ in range(count)]


def generator_chain(curve: CurveSpec, n: int) -> list:
    """[(i+1)·G for i in range(n)]: one affine add per point."""
    g = generator(curve)
    out, cur = [], None
    for _ in range(n):
        cur = ec_add(cur, g, curve.field.p)
        out.append(cur)
    return out


def te_affine_ints(curve: CurveSpec, pt) -> tuple:
    """An affine SW point (or None) -> its affine TE image (x, y) by the
    formulas of `te.sw_to_te` (u = s(x - alpha), v = s y, X = ts u / v,
    Y = (u - 1) / (u + 1)); the identity maps to (0, 1)."""
    if pt is None:
        return (0, 1)
    pr, p = te.te_params(curve), curve.field.p
    u, v = pr.s * (pt[0] - pr.alpha) % p, pr.s * pt[1] % p
    return (pr.ts * u * pow(v, -1, p) % p,
            (u - 1) * pow(u + 1, -1, p) % p)


def chain_msm(curve: CurveSpec, scalars) -> tuple | None:
    """sum_i scalars[i]·(i+1)·G for the generator chain (python ints)."""
    k = sum(int(s) * (i + 1) for i, s in enumerate(scalars)) % curve.order
    return ec_mul(generator(curve), k, curve.field.p)


def scalar_batch_np(curve: CurveSpec, rng_np, n: int) -> np.ndarray:
    """Seeded canonical scalar batch: (n, L) uint16 base-2^15 limb planes,
    uniform in [0, order) by limb-wise rejection sampling (the benchmark's
    compact scalar form, canonical, limbs < 2^15)."""
    fr = curve.scalar
    L = fr.n_limbs
    order = curve.order
    r_limbs = [(order >> (15 * k)) & 0x7FFF for k in range(L)]
    top_bits = order.bit_length() - 15 * (L - 1)
    assert top_bits > 0
    out = np.zeros((n, L), np.uint16)
    need = np.ones(n, bool)
    while need.any():
        k = int(need.sum())
        cand = rng_np.integers(0, 1 << 15, size=(k, L), dtype=np.uint16)
        cand[:, L - 1] &= (1 << top_bits) - 1
        lt = np.zeros(k, bool)
        eq = np.ones(k, bool)
        for j in range(L - 1, -1, -1):
            lt |= eq & (cand[:, j] < r_limbs[j])
            eq &= cand[:, j] == r_limbs[j]
        out[need] = cand
        nxt = need.copy()
        nxt[need] = ~lt
        need = nxt
    return out


def scalar_batch_torch(curve: CurveSpec, n: int, generator: torch.Generator
                       ) -> torch.Tensor:
    """A seeded canonical scalar batch made on the generator's device: the
    compact form of `scalar_batch_np` (uniform in [0, order) by rejection,
    limbs < 2^15) as its (n, L) int16 view, for batches too large to draw
    on the host in good time (2^26 x 17 limbs).  Rows are compared with
    the order from the top limb down, reading a lower limb only for the
    rows that tie on every limb above it.  Other draws than
    `scalar_batch_np`'s for the same seed."""
    L = curve.scalar.n_limbs
    order = curve.order
    r_limbs = [(order >> (15 * k)) & 0x7FFF for k in range(L)]
    top_bits = order.bit_length() - 15 * (L - 1)
    dev = generator.device
    out = torch.empty((n, L), dtype=torch.int16, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        cand = torch.randint(0, 1 << 15, (todo.numel(), L),
                             generator=generator, dtype=torch.int16,
                             device=dev)
        cand[:, L - 1] &= (1 << top_bits) - 1
        lt = cand[:, L - 1] < r_limbs[L - 1]
        tie = torch.nonzero(cand[:, L - 1] == r_limbs[L - 1])[:, 0]
        for j in range(L - 2, -1, -1):
            if not tie.numel():
                break
            col = cand[tie, j]
            lt[tie[col < r_limbs[j]]] = True
            tie = tie[col == r_limbs[j]]
        out[todo] = cand
        todo = todo[~lt]
    return out


def oracle_agg(curve: CurveSpec, batch_u16: np.ndarray, n_base: int) -> list:
    """Per-base-point scalar sums (mod order) for a point set made of
    `n_base` base points tiled n // n_base times."""
    n, L = batch_u16.shape
    reps = n // n_base
    # summed in int64 without an int64 copy of the batch (9 GB at 2^26)
    sums = batch_u16.reshape(reps, n_base, L).sum(axis=0, dtype=np.int64)
    assert reps < (1 << 48)  # int64 headroom: limb < 2^15, sum < reps*2^15
    return [sum(int(sums[i, k]) << (15 * k) for k in range(L)) % curve.order
            for i in range(n_base)]


def dft_ints(values: list, w: int, p: int) -> list:
    """A[k] = sum_j a_j w^(jk) mod p, term by term (O(n^2))."""
    n = len(values)
    pw = [pow(w, e, p) for e in range(n)]
    return [sum(a * pw[j * k % n] for j, a in enumerate(values)) % p
            for k in range(n)]


def ntt_ints(values: list, w: int, p: int) -> list:
    """The same transform, w of order len(values) (a power of two), by the
    recursive even/odd split (O(n log n))."""
    n = len(values)
    if n == 1:
        return [values[0] % p]
    even = ntt_ints(values[0::2], w * w % p, p)
    odd = ntt_ints(values[1::2], w * w % p, p)
    out = [0] * n
    t = 1
    for k in range(n // 2):
        v = odd[k] * t % p
        out[k] = (even[k] + v) % p
        out[k + n // 2] = (even[k] - v) % p
        t = t * w % p
    return out
