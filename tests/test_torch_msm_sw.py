"""The port's short-Weierstrass MSM route (msm/pippenger.py: msm on a curve
with no twisted-Edwards form or with te=False, msm_jit_static,
msm_jit_batch; pcs/kzg.py: commit_batch and the SW test SRS) through its
entry points on the CPU, against the python-int oracle (tests/ec_ref.py,
utils/oracle.py) and the reference package's MSMs.

The reference's MSMs here cost 20-35 s each of JAX compile on a CPU, so
their results are pinned (affine ints); the `slow` tests re-derive each
pin from the reference package.  Every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ec_ref
from zprize_tpu.curve import sw as ref_sw
from zprize_tpu.curve.spec import BLS12_377_G1 as REF_377
from zprize_tpu.curve.spec import BLS12_381_G1 as REF_381
from zprize_tpu.field import fp as ref_fp
from zprize_tpu.msm import pippenger as ref_pippenger
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import api, pippenger
from zprize_tpu_torch.pcs import kzg
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

IDENT = 3

# the reference's pippenger.msm (its SW route) on `_chain_inputs(32, 31)`
PINNED_381 = (
    0x0FC495B0A2686C2EAA611BB389B711138EB4C1A1E5DBE90DD15998111A215D3F23597681906EFE06D70AFDF8DDA0C28D,
    0x0ADF51BECC4579E12F7F4DB3FE80CC90FFAF1F1A05AD59501C575EFF5EBCE287E30D27BF46111EB0DE73FC5E887D72A4)
# the reference's msm_jit_static(c = 6, cap_total = n) on
# `_reference_inputs(128, 45)` (tests/test_msm.py::test_msm_jit_static_matches)
PINNED_377_STATIC = (
    0x017FB10AB08740FAFF9F19ADC2C7EC14C1F47F7892BE1B32F5B2B88588C460EAB88576896E3AA7B74556F689DA19973F,
    0x014F7A3C7C4DBC9F9B4EC326D7AFF6920E8220070F959E1555917BBE23E05B219428D95EF6EF4624DD4A050B97416587)


def _limbs(curve, ints):
    """Python ints -> canonical base-2^15 limb planes (n, L) int32."""
    n_limbs = curve.scalar.n_limbs
    return torch.tensor([[(k >> (15 * j)) & 0x7FFF for j in range(n_limbs)]
                         for k in ints], dtype=torch.int32)


def _affine(curve, pts):
    f = curve.field
    return sw.Affine(fp.from_ints(f, [0 if p is None else p[0] for p in pts]),
                     fp.from_ints(f, [1 if p is None else p[1] for p in pts]),
                     torch.tensor([p is None for p in pts]))


def _ref_affine(curve, pts):
    f = curve.field
    return ref_sw.Affine(
        ref_fp.from_ints(f, [0 if p is None else p[0] for p in pts]),
        ref_fp.from_ints(f, [1 if p is None else p[1] for p in pts]),
        jnp.asarray(np.array([p is None for p in pts])))


def _ref_ints(curve, p):
    a = ref_sw.to_affine(curve, p)
    if bool(a.inf):
        return None
    return (int(ref_fp.to_ints(curve.field, a.x)[()]),
            int(ref_fp.to_ints(curve.field, a.y)[()]))


def _lane(p, i):
    return sw.Point(*(a[i] for a in p))


def _chain_inputs(curve, n, seed):
    """The chain (i+1)·G with an identity lane, seeded compact scalars,
    and the oracle's result."""
    pts = oracle.generator_chain(curve, n)
    pts[IDENT] = None
    scalars = oracle.scalar_batch_np(curve, np.random.default_rng(seed), n)
    ints = [sum(int(v) << (15 * k) for k, v in enumerate(row))
            for row in scalars]
    ints[IDENT] = 0                     # the identity lane adds nothing
    return pts, scalars, oracle.chain_msm(curve, ints)


def _reference_inputs(n, seed):
    """tests/test_msm.py::make_inputs on BLS12-377: 32 subgroup points
    tiled, seeded scalars, and its edge cases (zero, one and -1 scalars,
    an identity point, a repeated scalar and a repeated point)."""
    curve = BLS12_377_G1
    rng = random.Random(seed)
    pts = oracle.subgroup_points(curve, min(n, 32), seed)
    pts = [pts[i % len(pts)] for i in range(n)]
    scalars = [rng.randrange(curve.order) for _ in range(n)]
    scalars[0], scalars[1], scalars[2] = 0, 1, curve.order - 1
    pts[3] = None
    scalars[4] = scalars[5]
    pts[6] = pts[5]
    return pts, scalars


def test_msm_on_bls12_381_matches_oracle_and_reference():
    """BLS12-381 G1 has no TE form: the API takes the SW route, keeps the
    affine planes and c = default_window_bits(n), and a 32-point MSM with
    an identity lane equals the oracle and the reference's result."""
    curve = BLS12_381_G1
    pts, scalars, expect = _chain_inputs(curve, 32, 31)
    ctx = api.multi_scalar_mult_init(curve, pts, device="cpu")
    assert isinstance(ctx.prepared, pippenger.PreparedSw)
    assert ctx.prepared.c == pippenger.default_window_bits(32) == 4
    assert ctx.points.x.numel() == 0
    res = api.multi_scalar_mult(ctx, scalars)
    assert len(res) == 1 and res[0].x.device.type == "cpu"
    assert sw.to_affine_ints(curve, res[0]) == expect == PINNED_381
    with pytest.raises(ValueError, match="no twisted-Edwards form"):
        api.multi_scalar_mult_init(curve, pts, device="cpu", te=True)


@pytest.mark.slow
def test_pinned_bls12_381_msm_is_the_references():
    pts, scalars, _ = _chain_inputs(BLS12_381_G1, 32, 31)
    res = ref_pippenger.msm(REF_381, _ref_affine(REF_381, pts),
                            jnp.asarray(scalars))
    assert _ref_ints(REF_381, res) == PINNED_381


def test_te_false_matches_te_true_on_bls12_377():
    """The same BLS12-377 MSM on both routes: te=False (SW, as the
    reference's ZPRIZE_TE=0) and the default TE route, and the oracle."""
    curve = BLS12_377_G1
    pts, scalars, expect = _chain_inputs(curve, 16, 32)
    sw_ctx = api.multi_scalar_mult_init(curve, pts, device="cpu", te=False)
    te_ctx = api.multi_scalar_mult_init(curve, pts, device="cpu")
    assert isinstance(sw_ctx.prepared, pippenger.PreparedSw)
    assert isinstance(te_ctx.prepared, pippenger.PreparedTe)
    got_sw = api.multi_scalar_mult(sw_ctx, scalars)[0]
    got_te = api.multi_scalar_mult(te_ctx, scalars)[0]
    assert (sw.to_affine_ints(curve, got_sw)
            == sw.to_affine_ints(curve, got_te) == expect)


def test_msm_jit_batch_matches_singles():
    """msm_jit_batch with B = 3, an identity lane in the point set: the
    uniform row of test_msm_on_bls12_381_matches_oracle_and_reference
    gives that single MSM's result; a row of equal scalars (every point in
    one bucket of each window) and one half zero give the oracle's."""
    curve = BLS12_381_G1
    n, c = 32, 4
    pts, scalars, _ = _chain_inputs(curve, n, 31)
    k = sum(int(v) << (15 * j) for j, v in enumerate(scalars[0]))
    equal = np.tile(scalars[:1], (n, 1))
    half = equal.copy()
    half[::2] = 0
    batch = torch.from_numpy(np.stack([scalars, equal, half]).astype(
        np.int32))
    out = pippenger.msm_jit_batch(curve, _affine(curve, pts), batch, c, n)
    assert out.x.shape == (3, 12)
    g = oracle.generator(curve)
    lanes = [i for i in range(n) if i != IDENT]
    assert [sw.to_affine_ints(curve, _lane(out, b)) for b in range(3)] == [
        PINNED_381,
        oracle.ec_mul(g, k * sum(i + 1 for i in lanes) % curve.order,
                      curve.field.p),
        oracle.ec_mul(g, k * sum(i + 1 for i in lanes if i % 2)
                      % curve.order, curve.field.p)]


def test_msm_jit_static_matches_reference():
    """tests/test_msm.py::test_msm_jit_static_matches (BLS12-377, n = 128,
    c = 6, cap_total = n) on the port: the reference's pinned result,
    which the slow test below also holds against the python-int MSM
    (23 s here)."""
    pts, scalars = _reference_inputs(128, 45)
    res = pippenger.msm_jit_static(BLS12_377_G1, _affine(BLS12_377_G1, pts),
                                   _limbs(BLS12_377_G1, scalars), c=6,
                                   cap_total=128)
    assert sw.to_affine_ints(BLS12_377_G1, res) == PINNED_377_STATIC


@pytest.mark.slow
def test_pinned_msm_jit_static_is_the_references():
    pts, scalars = _reference_inputs(128, 45)
    assert oracle.subgroup_points(BLS12_377_G1, 32, 45) == (
        ec_ref.random_subgroup_points(BLS12_377_G1, 32, seed=45))
    res = ref_pippenger.msm_jit_static(
        REF_377, _ref_affine(REF_377, pts),
        ref_fp.from_ints(REF_377.scalar, scalars), c=6, cap_total=128)
    assert _ref_ints(REF_377, res) == PINNED_377_STATIC
    assert ec_ref.ec_msm(pts, scalars, REF_377.field.p) == PINNED_377_STATIC


@pytest.mark.parametrize("form", ["static", "batch"])
def test_occupancy_over_cap_total_raises(form):
    """Equal scalars put every point in one bucket of each window: over
    cap_total that raises, naming the occupancy (the reference's contract,
    tests/test_fp_kernel.py::test_msm_jit_static_occupancy_guard), though
    the port walks every run whole."""
    curve = BLS12_381_G1
    n = 32
    pts = oracle.subgroup_points(curve, 8, 3) * 4
    s = _limbs(curve, [12345] * n)
    with pytest.raises(RuntimeError, match="occupancy"):
        if form == "static":
            pippenger.msm_jit_static(curve, _affine(curve, pts), s, c=6,
                                     cap_total=4)
        else:
            pippenger.msm_jit_batch(curve, _affine(curve, pts),
                                    torch.stack([s, s]), c=6, cap_total=4)


def test_test_srs_and_commit_batch_on_bls12_381():
    """setup_test_srs on a curve with no TE form (the SW double-and-add
    on sw_full_add): tau^i·G as python ints; commit_batch of two rows
    equals (sum_i c_i tau^i)·G for each."""
    curve = BLS12_381_G1
    r, prime = curve.order, curve.field.p
    srs = kzg.setup_test_srs(curve, 4, seed=2, device="cpu")
    g = oracle.generator(curve)
    assert [sw.to_affine_ints(curve, sw.Point(
        srs.g1_powers.x[i], srs.g1_powers.y[i],
        fp.ones(curve.field))) for i in range(4)] == [
        oracle.ec_mul(g, pow(srs.tau, i, r), prime) for i in range(4)]
    assert not bool(srs.g1_powers.inf.any())
    rows = [[5, r - 1, 77], [0, 1, 2]]
    coms = kzg.commit_batch(srs, fp.from_ints(curve.scalar, rows))
    assert [kzg.point_ints(curve, _lane(coms, b)) for b in range(2)] == [
        oracle.ec_mul(g, sum(c * pow(srs.tau, i, r)
                             for i, c in enumerate(row)) % r, prime)
        for row in rows]


def test_crowded_window_is_cut_into_slices(monkeypatch):
    """window_sums_sw cuts a group whose longest run is far above a full
    window's mean into slices of the points, and the slices' window sums
    add up to the window's: one row with every point in bucket 3, one of
    seeded digits, against python ints sum_i d_i·P_i.  (_MIN_RUN lowered
    so that 32 points are a crowd.)"""
    curve = BLS12_381_G1
    n, c = 32, 4
    pts = oracle.generator_chain(curve, n)
    rng = np.random.default_rng(34)
    digits = np.stack([np.full(n, 3), rng.integers(-8, 8, n)])
    sorted_rows = []
    sort = pippenger.sort_windows

    def spy(d, nbe):
        sorted_rows.append(d.shape[0])
        return sort(d, nbe)

    monkeypatch.setattr(pippenger, "sort_windows", spy)
    monkeypatch.setattr(pippenger, "_MIN_RUN", 4)
    aff = _affine(curve, pts)
    sums = pippenger.window_sums_sw(
        curve, c, aff.x, aff.y, torch.from_numpy(digits.astype(np.int32)),
        {8: [0, 1]})
    assert sorted_rows == [2, 8]             # 4 slices of 8 points a row
    g = oracle.generator(curve)
    assert [sw.to_affine_ints(curve, sw.unpack(s)) for s in sums] == [
        oracle.ec_mul(g, sum(int(d) * (i + 1) for i, d in enumerate(row))
                      % curve.order, curve.field.p) for row in digits]
