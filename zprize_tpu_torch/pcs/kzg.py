"""KZG10 polynomial commitments: commit, open and the pairing check, on top
of the port's MSM.

Semantics follow KZG10 as jf-plonk and snarkVM use it
(`snarkVM algorithms/src/polycommit/kzg10/mod.rs:216-402`): commit is an
MSM over the SRS G1 powers; the opening witness is p(X) - p(z) divided by
(X - z); `verify` is the pairing check e(C - y·G + z·W, H) · e(-W, tau·H)
== 1 (`winderica/plonk/src/proof_system/verifier.rs:229`), on the host
(`pairing/host.py`): a handful of points.  `verify_with_trapdoor` checks
the same equation in G1 with a test SRS's tau (the reference tests' fast
gate).

Coefficients are (n, n_words) Montgomery words of the scalar field;
points come back as SW projective host words (`sw.Point`, what
`pippenger.msm` returns; `commit_batch` gives (B,) lanes on the device)
and are compared as affine ints (`point_ints`).
"""

from __future__ import annotations

import dataclasses
import math
import random

import numpy as np
import torch

from ..curve import sw, te
from ..curve.spec import CurveSpec
from ..field import fp
from ..msm import pippenger
from ..msm.accum_kernel import sw_full_add, te_dbl_chain, te_full_add
from ..pairing.host import g1_add, g1_mul, g1_neg, host_pairing
from ..pairing.params import pairing_for_curve
from ..poly import ops as poly_ops
from ..utils.device import resolve_device
from . import lincomb


@dataclasses.dataclass
class Srs:
    """G1 powers of tau on the device, plus the two G2 elements (H, tau·H)
    of the pairing check as host ints.  `tau` is kept only by a test SRS."""
    curve: CurveSpec
    g1_powers: sw.Affine              # (size,) affine planes: tau^i·G
    h: tuple | None = None            # G2 generator, affine Fq2 int pairs
    tau_h: tuple | None = None        # tau·H
    tau: int | None = None
    _prepared: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return self.g1_powers.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.g1_powers.x.device

    def table_length(self, n: int, shift: int = 0) -> int:
        """Length of the SRS slice [shift, shift + length) whose prepared
        table serves a commit of n coefficients: the next power of two, or
        the whole slice if that is shorter.  Zero coefficients add nothing,
        so a commit pads to its table, and the prover's lengths n+2 .. n+6
        share one table (the SRS holds n+8 powers)."""
        room = self.size - shift
        if n > room:
            raise ValueError(f"polynomial of {n} coefficients is larger "
                             f"than the SRS slice of {room}")
        return min(room, 1 << (n - 1).bit_length())

    def prepared(self, length: int, shift: int = 0
                 ) -> pippenger.PreparedTe | pippenger.PreparedSw:
        """The MSM preprocessing of the SRS slice [shift, shift + length)
        (TE conversion and window-collapse table, or on a curve with no TE
        form the SW route's affine planes), built once: the analog of
        the reference's cached per-size tables (`kzg.py:49`).  `shift > 0`
        is the shifted-powers slice of degree-bound commitments."""
        key = (shift, length)
        if key not in self._prepared:
            self._prepared[key] = pippenger.prepare_points(
                self.curve, self.slice(length, shift))
        return self._prepared[key]

    def slice(self, length: int, shift: int = 0) -> sw.Affine:
        return sw.Affine(*(a[shift:shift + length] for a in self.g1_powers))


def _skip_bits(curve: CurveSpec, scalars: list[int], device
               ) -> torch.Tensor:
    """(n_bits, n) int32: 1 where bit b of scalars[i] is 0 (the skip mask
    of a double-and-add), n_bits that of the group order."""
    n = len(scalars)
    n_bits = curve.order.bit_length()
    raw = np.frombuffer(b"".join(k.to_bytes(32, "little") for k in scalars),
                        np.uint8).reshape(n, 32)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, :n_bits]
    return torch.from_numpy((1 - bits.T).astype(np.int32)).to(device)


def scalar_mul_te(curve: CurveSpec, base: sw.Affine, scalars: list[int],
                  device) -> torch.Tensor:
    """k_i·base_i for every lane, as packed extended TE points
    (n, 4, nw): a lane-parallel MSB-first double-and-add on the MSM kernels,
    one `te_dbl_chain` of one doubling and one `te_full_add` (its skip mask
    is the scalar bit) per bit of the group order."""
    f = curve.field
    n = len(scalars)
    tx, ty, bad = te.sw_to_te(curve, base.x, base.y, base.inf)
    if bool(bad.any()):
        raise ValueError("a base point has no twisted-Edwards image")
    one = fp.ones(f, tx.shape[:-1], device)
    g = te.pack(te.TePoint(tx, ty, one, fp.mul(f, tx, ty)))
    g = g.expand(n, *g.shape[-2:]).contiguous()
    skip = _skip_bits(curve, scalars, device)
    acc = te.pack(te.identity(curve, (n,), device))
    for b in range(skip.shape[0] - 1, -1, -1):
        acc = te_dbl_chain(curve, acc, 1)
        acc = te_full_add(curve, acc, g, skip[b].contiguous())
    return acc


def scalar_mul_sw(curve: CurveSpec, base: sw.Affine, scalars: list[int],
                  device) -> torch.Tensor:
    """k_i·base_i for every lane, as packed SW projective points
    (n, 3, nw): the lane-parallel MSB-first double-and-add of
    `sw.mul_scalar` on `sw_full_add`, two launches (p + p, then p + base
    with the scalar bit as the skip mask) per bit of the group order."""
    n = len(scalars)
    g = sw.pack(sw.from_affine(curve, base))
    g = g.expand(n, *g.shape[-2:]).contiguous()
    skip = _skip_bits(curve, scalars, device)
    dbl_skip = torch.zeros(n, dtype=torch.int32, device=device)
    acc = sw.pack(sw.identity(curve, (n,), device))
    for b in range(skip.shape[0] - 1, -1, -1):
        sw_full_add(curve, acc, acc, dbl_skip)
        sw_full_add(curve, acc, g, skip[b].contiguous())
    return acc


def setup_test_srs(curve: CurveSpec, size: int, seed: int = 0,
                   device=None) -> Srs:
    """Deterministic test SRS: tau from a seeded host RNG (the reference's
    `random.Random(seed ^ 0x5EED)`, so both packages make the same SRS),
    tau^i·G for i < size on the device (`scalar_mul_te` where the curve
    has a TE form, else `scalar_mul_sw`; then one batched inversion to SW
    affine), and the G2 side on the host."""
    dev = resolve_device(device)
    rng = random.Random(seed ^ 0x5EED)
    tau = rng.randrange(1, curve.order)
    pows = [1] * size
    for i in range(1, size):
        pows[i] = pows[i - 1] * tau % curve.order
    f = curve.field
    gen = sw.Affine(fp.from_ints(f, [curve.gen_x], dev),
                    fp.from_ints(f, [curve.gen_y], dev),
                    torch.zeros(1, dtype=torch.bool, device=dev))
    if pippenger.has_te_form(curve):
        x, y, inf = te.te_to_sw_affine(curve, scalar_mul_te(curve, gen, pows,
                                                            dev))
    else:
        x, y, inf = sw.to_affine(curve, sw.unpack(scalar_mul_sw(curve, gen,
                                                                pows, dev)))
    hp = host_pairing(pairing_for_curve(curve))
    h = hp.g2_gen
    return Srs(curve, sw.Affine(x, y, inf), h, hp.g2_mul(h, tau), tau)


def commit(srs: Srs, coeffs: torch.Tensor, shift: int = 0) -> sw.Point:
    """MSM(srs[shift : shift + n], coeffs) for coefficients (n, n_words) on
    the SRS's device; with `shift` this commits X^shift·p(X)."""
    n = coeffs.shape[0]
    length = srs.table_length(n, shift)
    scalars = pippenger.scalar_limbs(
        srs.curve, poly_ops.pad_to(srs.curve.scalar, coeffs, length))
    return pippenger.msm(srs.curve, srs.slice(length, shift), scalars,
                         prepared=srs.prepared(length, shift))


def commit_batch(srs: Srs, coeffs: torch.Tensor, c: int | None = None,
                 cap: int | None = None, shift: int = 0) -> sw.Point:
    """Batched commit: coefficients (B, n, n_words) on the SRS's device ->
    a (B,)-lane projective point on the device, one commitment per row,
    through `pippenger.msm_jit_batch` (the windows of all B rows share
    each accumulate launch).  `c` defaults to `default_window_bits(n)` and
    `cap`, the occupancy bound whose excess raises, to four times the
    uniform mean (at least 16), as in the reference; with `shift` each row
    commits X^shift·p(X)."""
    curve = srs.curve
    bsz, n = coeffs.shape[:2]
    if shift + n > srs.size:
        raise ValueError(f"polynomial of {n} coefficients at shift {shift} "
                         f"is larger than the SRS of {srs.size}")
    if c is None:
        c = pippenger.default_window_bits(n)
    if cap is None:
        mean = max(1, n // (1 << (c - 1)))
        cap = max(16, 1 << math.ceil(math.log2(mean * 4 + 8)))
    scalars = pippenger.scalar_limbs(curve, coeffs.reshape(bsz * n, -1))
    return pippenger.msm_jit_batch(curve, srs.slice(n, shift),
                                   scalars.reshape(bsz, n, -1), c,
                                   min(cap, n))


def open_at(srs: Srs, coeffs: torch.Tensor, z: torch.Tensor):
    """(witness commitment, evaluation y = p(z)) for a scalar row z."""
    q, y = poly_ops.divide_linear(srs.curve.scalar, coeffs, z)
    return commit(srs, q), y


def point_ints(curve: CurveSpec, p: sw.Point):
    """Projective point -> host affine int pair (None for the identity)."""
    return sw.to_affine_ints(curve, p)


def fr_int(curve: CurveSpec, x: torch.Tensor) -> int:
    return int(fp.to_ints(curve.scalar, x)[()])


def _opening_ints(curve: CurveSpec, commitment, z, y, witness):
    """An opening's points as affine int pairs (None = identity) and its z,
    y as ints, from `sw.Point`s or pairs and scalar rows or ints."""
    def pt(a):
        return point_ints(curve, a) if isinstance(a, sw.Point) else a

    def scalar(a):
        return a if isinstance(a, int) else fr_int(curve, a)

    return pt(commitment), scalar(z), scalar(y), pt(witness)


def verify(srs: Srs, commitment, z, y, witness) -> bool:
    """KZG verification by the ate pairing:
        e(C - y·G + z·W, H) · e(-W, tau·H) == 1.
    Points may be `sw.Point`s or affine int pairs (None = identity), z and
    y scalar rows or python ints; the group combination and the Miller
    loops run on the host."""
    if srs.h is None or srs.tau_h is None:
        raise ValueError("SRS lacks its G2 side")
    curve = srs.curve
    p = curve.field.p
    c_pt, z_i, y_i, w_pt = _opening_ints(curve, commitment, z, y, witness)
    g = (curve.gen_x, curve.gen_y)
    a_pt = g1_add(p, c_pt, g1_neg(p, g1_mul(p, g, y_i)))
    if w_pt is not None:
        a_pt = g1_add(p, a_pt, g1_mul(p, w_pt, z_i))
    hp = host_pairing(pairing_for_curve(curve))
    pairs = []
    if a_pt is not None:
        pairs.append((a_pt, hp.g2_gen))
    if w_pt is not None:
        pairs.append((g1_neg(p, w_pt), srs.tau_h))
    if not pairs:
        return True
    return hp.multi_pairing_is_one(pairs)


def verify_with_trapdoor(srs: Srs, commitment, z, y, witness) -> bool:
    """The KZG equation in G1 with a test SRS's trapdoor:
        ((tau - z) mod r)·W == C - (y mod r)·G,
    the equation `verify` checks in the exponent.  The same inputs as
    `verify`; one point a side on host ints (`pairing/host.py`), as
    `te.te_to_sw_host` does for the MSM result: the work is a few scalar
    ladders, latency-bound, so the card has no part in it."""
    if srs.tau is None:
        raise ValueError("trapdoor verification needs a test SRS (tau)")
    curve = srs.curve
    p, r = curve.field.p, curve.order
    c_pt, z_i, y_i, w_pt = _opening_ints(curve, commitment, z, y, witness)
    lhs = g1_mul(p, w_pt, (srs.tau - z_i) % r)
    rhs = g1_add(p, c_pt, g1_neg(p, g1_mul(p, (curve.gen_x, curve.gen_y),
                                           y_i % r)))
    return lhs == rhs


def combine_ints(curve: CurveSpec, pts, ks):
    """sum_i ks[i]·pts[i] over host affine int pairs (None = identity;
    0 <= k < 2^256): the native interleaved multi-exponentiation
    (`pcs/lincomb.py`); raises if its library does not build."""
    return lincomb.lincomb(curve, pts, ks)


def combine_ints_plain(curve: CurveSpec, pts, ks):
    """The same sum by the python double-and-add fold."""
    p = curve.field.p
    acc = None
    for pt, k in zip(pts, ks):
        if pt is not None:
            acc = g1_add(p, acc, g1_mul(p, pt, k))
    return acc


def verify_many(srs: Srs, checks, rng=None) -> bool:
    """One multi-pairing for N KZG opening checks, each (c_pt, z, y, w_pt)
    with affine int pairs (None = identity) and int z, y.  A random r_i
    (from `rng`, default system entropy) weights each equation
        e(C_i - y_i·G + z_i·W_i, H) · e(-W_i, tau·H) == 1,
    and the weighted sums fold into two linear combinations."""
    if srs.h is None or srs.tau_h is None:
        raise ValueError("SRS lacks its G2 side")
    curve = srs.curve
    p = curve.field.p
    rng = rng if rng is not None else random.SystemRandom()
    g = (curve.gen_x, curve.gen_y)
    a_pts, a_ks, b_pts, b_ks = [], [], [], []
    gy_sum = 0
    for c_pt, z_i, y_i, w_pt in checks:
        r = rng.randrange(1, curve.order) if len(checks) > 1 else 1
        if c_pt is not None:
            a_pts.append(c_pt)
            a_ks.append(r)
        gy_sum = (gy_sum + r * y_i) % curve.order
        if w_pt is not None:
            a_pts.append(w_pt)
            a_ks.append(r * z_i % curve.order)
            b_pts.append(w_pt)
            b_ks.append(r)
    if gy_sum:
        a_pts.append(g)
        a_ks.append(curve.order - gy_sum)
    acc_a = combine_ints(curve, a_pts, a_ks)
    acc_b = combine_ints(curve, b_pts, b_ks) if b_pts else None
    hp = host_pairing(pairing_for_curve(curve))
    pairs = []
    if acc_a is not None:
        pairs.append((acc_a, hp.g2_gen))
    if acc_b is not None:
        pairs.append((g1_neg(p, acc_b), srs.tau_h))
    if not pairs:
        return True
    return hp.multi_pairing_is_one(pairs)
