"""The port's polynomial ops and KZG (zprize_tpu_torch/poly, pcs) against
python ints, on the CPU (plain versions of the kernels), and its trapdoor
check against the reference package's.  Exact: field values compare as
canonical ints, points as affine ints.

The reference's `verify_with_trapdoor` traces two scalar ladders of JAX
(5-15 s a call on a CPU), so the fast tier runs it once live, on the
identity-witness opening over BLS12-381, and holds the port's verdicts on
every opening against the python-int equation and `kzg.verify`; the slow
`test_trapdoor_verdicts_match_reference_on_its_srs` runs every opening on
both curves through the reference, on its own test SRS carried across."""

import random

import pytest
import torch

from zprize_tpu.curve import sw as ref_sw
from zprize_tpu.curve.spec import BLS12_377_G1 as REF_377
from zprize_tpu.curve.spec import BLS12_381_G1 as REF_381
from zprize_tpu.field import fp as ref_fp
from zprize_tpu.pcs import kzg as ref_kzg
from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import pippenger
from zprize_tpu_torch.pairing.host import host_pairing
from zprize_tpu_torch.pairing.params import pairing_for_curve
from zprize_tpu_torch.pcs import kzg
from zprize_tpu_torch.poly import ops
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

CURVE = BLS12_377_G1
FR = CURVE.scalar
R = FR.p
SRS_SIZE = 16


def _ints(a):
    return [int(v) for v in fp.to_ints(FR, a).reshape(-1)]


def _coeffs(n, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(R) for _ in range(n)]
    vals[:2] = [R - 1, 0][:n]
    return vals


def _horner(coeffs, z):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % R
    return acc


@pytest.mark.parametrize("count", [1, 2, 7, 64, 100])
def test_powers_match_python_ints(count):
    z = 123456789123456789 % R
    got = ops.powers(FR, fp.from_ints(FR, [z])[0], count)
    assert _ints(got) == [pow(z, i, R) for i in range(count)]


@pytest.mark.parametrize("n", [1, 5, 16, 33])
def test_evaluate_and_divide_linear_match_python_ints(n):
    coeffs = _coeffs(n, n)
    z = 987654321987654321 % R
    a, zt = fp.from_ints(FR, coeffs), fp.from_ints(FR, [z])[0]
    assert _ints(ops.evaluate(FR, a, zt)) == [_horner(coeffs, z)]
    q, rem = ops.divide_linear(FR, a, zt)
    # synthetic division: q_{n-2} = a_{n-1}, q_{i-1} = a_i + z q_i
    expect = [0] * max(1, n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (coeffs[i] + z * acc) % R
        expect[i - 1] = acc
    assert _ints(q) == expect
    assert _ints(rem) == [_horner(coeffs, z)]


def test_evaluate_batched_rows():
    rows = [_coeffs(9, 50 + k) for k in range(3)]
    z = 31337
    got = ops.evaluate(FR, fp.from_ints(FR, rows), fp.from_ints(FR, [z])[0])
    assert _ints(got) == [_horner(r, z) for r in rows]


@pytest.mark.parametrize("na,nb", [(1, 1), (3, 5), (8, 8), (13, 4)])
def test_mul_matches_python_ints(na, nb):
    a, b = _coeffs(na, na), _coeffs(nb, 100 + nb)
    expect = [0] * (na + nb - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            expect[i + j] = (expect[i + j] + x * y) % R
    got = ops.mul(FR, fp.from_ints(FR, a), fp.from_ints(FR, b))
    assert _ints(got) == expect
    assert _ints(ops.add(FR, fp.from_ints(FR, a), fp.from_ints(FR, b))) == [
        (x + y) % R for x, y in zip(a + [0] * nb, b + [0] * na)][:max(na, nb)]


def test_scalar_limbs_are_canonical_base_2_15():
    vals = _coeffs(6, 9)
    got = pippenger.scalar_limbs(CURVE, fp.from_ints(FR, vals))
    assert got.dtype == torch.int32 and got.shape == (6, FR.n_limbs)
    assert [sum(int(l) << (15 * k) for k, l in enumerate(row))
            for row in got.numpy()] == vals
    assert int(got.max()) < (1 << 15)


@pytest.fixture(scope="module")
def srs():
    return kzg.setup_test_srs(CURVE, SRS_SIZE, seed=3, device="cpu")


def test_setup_test_srs_matches_python_ints(srs):
    tau = random.Random(3 ^ 0x5EED).randrange(1, CURVE.order)
    assert srs.tau == tau and srs.size == SRS_SIZE
    g = oracle.generator(CURVE)
    q = CURVE.field.p
    expect = [oracle.ec_mul(g, pow(tau, i, R), q) for i in range(SRS_SIZE)]
    got = list(zip((int(v) for v in fp.to_ints(CURVE.field, srs.g1_powers.x)),
                   (int(v) for v in fp.to_ints(CURVE.field, srs.g1_powers.y))))
    assert got == expect
    assert not bool(srs.g1_powers.inf.any())


def test_table_length_rule(srs):
    assert [srs.table_length(n) for n in (1, 2, 5, 8, 9, 16)] == [
        1, 2, 8, 8, 16, 16]
    assert srs.table_length(3, shift=13) == 3
    assert srs.table_length(2, shift=13) == 2
    with pytest.raises(ValueError, match="larger than the SRS"):
        srs.table_length(17)


def test_commit_matches_python_ints(srs):
    coeffs = _coeffs(10, 3)
    got = kzg.point_ints(CURVE, kzg.commit(srs, fp.from_ints(FR, coeffs)))
    # MSM over tau^i·G = (sum_i c_i tau^i)·G
    k = sum(c * pow(srs.tau, i, R) for i, c in enumerate(coeffs)) % R
    assert got == oracle.ec_mul(oracle.generator(CURVE), k, CURVE.field.p)


def test_open_and_verify(srs):
    coeffs = fp.from_ints(FR, _coeffs(10, 4))
    com = kzg.commit(srs, coeffs)
    z = fp.from_ints(FR, [77777])[0]
    w, y = kzg.open_at(srs, coeffs, z)
    assert kzg.fr_int(CURVE, y) == _horner(_coeffs(10, 4), 77777)
    assert kzg.verify(srs, com, z, y, w)
    assert not kzg.verify(srs, com, z, (kzg.fr_int(CURVE, y) + 1) % R, w)
    assert kzg.verify_with_trapdoor(srs, com, z, y, w)
    assert not kzg.verify_with_trapdoor(srs, com, z,
                                        (kzg.fr_int(CURVE, y) + 1) % R, w)
    c_pt, w_pt = kzg.point_ints(CURVE, com), kzg.point_ints(CURVE, w)
    y_i = kzg.fr_int(CURVE, y)
    checks = [(c_pt, 77777, y_i, w_pt), (c_pt, 77777, y_i, w_pt)]
    rng = random.Random(5)
    assert kzg.verify_many(srs, checks, rng)
    assert not kzg.verify_many(srs, [checks[0], (c_pt, 77777, y_i + 1, w_pt)],
                               rng)


def test_commit_batch_names_its_queue_item(srs):
    """commit_batch, once refused naming its ROADMAP item, runs (through
    msm_jit_batch on the SW kernels): row 0 equals commit (the TE route),
    row 1 python ints, and too long a row is refused."""
    rows = [_coeffs(10, 5), _coeffs(10, 6)]
    coms = kzg.commit_batch(srs, fp.from_ints(FR, rows))
    assert coms.x.shape == (2, 12)
    got = [kzg.point_ints(CURVE, sw.Point(*(a[b] for a in coms)))
           for b in range(2)]
    assert got[0] == kzg.point_ints(CURVE, kzg.commit(
        srs, fp.from_ints(FR, rows[0])))
    k = sum(c * pow(srs.tau, i, R) for i, c in enumerate(rows[1])) % R
    assert got[1] == oracle.ec_mul(oracle.generator(CURVE), k, CURVE.field.p)
    with pytest.raises(ValueError, match="larger than the SRS"):
        kzg.commit_batch(srs, fp.from_ints(FR, [[1] * 15]), shift=2)


OPENINGS = ["honest", "y_plus_1", "wrong_witness", "identity_witness",
            "all_identity"]
COEFFS = _coeffs(10, 4)
Z = 77777


def _opening(curve, tau, case):
    """(C, z, y, W) of one opening as ints (points affine, None for the
    identity), made with the trapdoor: C = p(tau)·G, W = q(tau)·G where
    q = (p - p(z)) / (X - z); or a tampered or identity opening."""
    r, q = curve.order, curve.field.p
    g = oracle.generator(curve)
    p_tau, y = _horner(COEFFS, tau) % r, _horner(COEFFS, Z) % r
    w_k = (p_tau - y) * pow(tau - Z, -1, r) % r
    c, w = oracle.ec_mul(g, p_tau, q), oracle.ec_mul(g, w_k, q)
    if case == "y_plus_1":
        y += 1
    elif case == "wrong_witness":
        w = oracle.ec_mul(g, w_k + 1, q)
    elif case == "identity_witness":
        c, w = oracle.ec_mul(g, y, q), None
    elif case == "all_identity":
        c, y, w = None, 0, None
    return c, Z, y, w


def _equation(curve, tau, c, z, y, w) -> bool:
    """((tau - z) mod r)·W == C - (y mod r)·G on python ints."""
    r, q = curve.order, curve.field.p
    y_g = oracle.ec_mul(oracle.generator(curve), y % r, q)
    neg_y_g = None if y_g is None else (y_g[0], -y_g[1] % q)
    return (oracle.ec_mul(w, (tau - z) % r, q)
            == oracle.ec_add(c, neg_y_g, q))


def _trapdoor_srs(curve, seed):
    """What the two checks read of `setup_test_srs(curve, size, seed)`:
    its tau and G2 pair (its G1 powers take seconds on a CPU)."""
    tau = random.Random(seed ^ 0x5EED).randrange(1, curve.order)
    hp = host_pairing(pairing_for_curve(curve))
    return kzg.Srs(curve, None, hp.g2_gen, hp.g2_mul(hp.g2_gen, tau), tau)


def _ref_verdict(ref_srs, c, z, y, w) -> bool:
    """The reference's `verify_with_trapdoor` on the same opening."""
    curve = ref_srs.curve

    def pt(a):
        if a is None:
            return ref_sw.identity(curve)
        return ref_sw.Point(ref_fp.from_ints(curve.field, a[0]),
                            ref_fp.from_ints(curve.field, a[1]),
                            ref_fp.ones(curve.field))

    return ref_kzg.verify_with_trapdoor(
        ref_srs, pt(c), ref_fp.from_ints(curve.scalar, z),
        ref_fp.from_ints(curve.scalar, y % curve.order), pt(w))


@pytest.mark.parametrize("case", OPENINGS)
def test_trapdoor_verdicts_match_the_equation_and_verify(case):
    srs = _trapdoor_srs(CURVE, 3)
    c, z, y, w = _opening(CURVE, srs.tau, case)
    got = kzg.verify_with_trapdoor(srs, c, z, y, w)
    assert got == (case not in ("y_plus_1", "wrong_witness"))
    assert got == _equation(CURVE, srs.tau, c, z, y, w)
    # the honest and y + 1 openings are test_open_and_verify's (the same
    # polynomial, z and SRS), which holds both checks to each other there
    # (a pairing costs about a second)
    if case not in ("honest", "y_plus_1"):
        assert got == kzg.verify(srs, c, z, y, w)


def test_trapdoor_check_needs_tau():
    """A SRS without tau: the port raises ValueError, the reference
    asserts."""
    c, z, y, w = _opening(CURVE, 5, "honest")
    with pytest.raises(ValueError, match="tau"):
        kzg.verify_with_trapdoor(kzg.Srs(CURVE, None), c, z, y, w)
    with pytest.raises(AssertionError, match="test SRS"):
        _ref_verdict(ref_kzg.Srs(REF_377, None), c, z, y, w)


def test_identity_witness_verdict_matches_reference_live():
    """One live reference call, on BLS12-381: W = identity with C = y·G
    holds (the reference's projective equality of two identities).  The
    reference's check reads only its SRS's tau, which it gets alone."""
    srs = _trapdoor_srs(BLS12_381_G1, 9)
    c, z, y, w = _opening(BLS12_381_G1, srs.tau, "identity_witness")
    got = kzg.verify_with_trapdoor(srs, c, z, y, w)
    assert got == _ref_verdict(ref_kzg.Srs(REF_381, None, tau=srs.tau),
                               c, z, y, w)
    assert got and _equation(BLS12_381_G1, srs.tau, c, z, y, w)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["377", "381"])
def test_trapdoor_verdicts_match_reference_on_its_srs(name):
    """Every opening through the reference, on its `setup_test_srs(curve,
    8, seed)` carried across with `convert.srs_from_reference` (about a
    minute a curve)."""
    curve, ref_curve = {"377": (BLS12_377_G1, REF_377),
                        "381": (BLS12_381_G1, REF_381)}[name]
    ref_srs = ref_kzg.setup_test_srs(ref_curve, 8, seed=9)
    srs = convert.srs_from_reference(ref_srs, device="cpu")
    for case in OPENINGS:
        c, z, y, w = _opening(curve, srs.tau, case)
        assert (kzg.verify_with_trapdoor(srs, c, z, y, w)
                == _ref_verdict(ref_srs, c, z, y, w)), case
