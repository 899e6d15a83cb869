"""The port's polynomial ops and KZG (zprize_tpu_torch/poly, pcs) against
python ints, on the CPU (plain versions of the kernels).  Exact: field
values compare as canonical ints, points as affine ints."""

import random

import numpy as np
import pytest
import torch

from zprize_tpu_torch.curve.spec import BLS12_377_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import pippenger
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
    c_pt, w_pt = kzg.point_ints(CURVE, com), kzg.point_ints(CURVE, w)
    y_i = kzg.fr_int(CURVE, y)
    checks = [(c_pt, 77777, y_i, w_pt), (c_pt, 77777, y_i, w_pt)]
    rng = random.Random(5)
    assert kzg.verify_many(srs, checks, rng)
    assert not kzg.verify_many(srs, [checks[0], (c_pt, 77777, y_i + 1, w_pt)],
                               rng)


def test_commit_batch_names_its_queue_item(srs):
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        kzg.commit_batch(srs, np.zeros((2, 4, 8)))
