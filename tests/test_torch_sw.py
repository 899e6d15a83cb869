"""The port's short-Weierstrass group law (zprize_tpu_torch/curve/sw.py) and
the plain versions of its two SW kernels (msm/accum_kernel.py:
sw_gather_accumulate, sw_full_add) and of the route's merge
(msm/pippenger.py: merge_buckets_all), against the reference package's
`curve/sw.py` and `msm/pippenger.py` and the python-int oracle
(tests/ec_ref.py), on the CPU.  The hand-written kernels are held
against these plain versions on the card by chip_smoke.py, phase 3d.
Exact: points compare as affine ints (tolerance 0)."""

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
from zprize_tpu.field.spec import int_from_limbs
from zprize_tpu.msm import pippenger as ref_pippenger
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import accum_kernel as ak
from zprize_tpu_torch.msm import pippenger
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

CURVES = {"bls12_377": (BLS12_377_G1, REF_377),
          "bls12_381": (BLS12_381_G1, REF_381)}


def _affine(curve, pts):
    """[(x, y) | None] -> the port's Affine planes."""
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


def _ints(curve, p: sw.Point):
    """A lane-batched projective point -> [(x, y) | None]."""
    a = sw.to_affine(curve, sw.Point(*(t.reshape(-1, t.shape[-1])
                                       for t in p)))
    xs, ys = fp.to_ints(curve.field, a.x), fp.to_ints(curve.field, a.y)
    return [None if i else (int(x), int(y))
            for x, y, i in zip(xs, ys, a.inf.tolist())]


def _ref_ints(curve, p):
    """A lane-batched reference point -> [(x, y) | None]: its limb planes
    read with numpy (the redundant base-2^15 limbs summed exactly, mod
    p), then affine on python ints."""
    prime = curve.field.p
    xs, ys, zs = ([int_from_limbs(row) % prime
                   for row in np.asarray(t).reshape(-1, t.shape[-1])]
                  for t in p)
    out = []
    for x, y, z in zip(xs, ys, zs):
        zi = pow(z, -1, prime) if z else None
        out.append(None if zi is None else (x * zi % prime, y * zi % prime))
    return out


@pytest.mark.parametrize("name", sorted(CURVES))
def test_group_law_matches_reference_and_oracle(name):
    """add, add_mixed, dbl, neg, eq, to_affine and is_on_curve on the
    degenerate cases of tests/test_curve.py: doubling through add,
    P + (-P), identity on either side and both."""
    curve, ref = CURVES[name]
    prime = curve.field.p
    pts = oracle.subgroup_points(curve, 6, 3)
    g = (curve.gen_x, curve.gen_y)
    pairs = [(pts[0], pts[1]), (pts[2], pts[3]), (pts[4], pts[4]),
             (pts[5], ec_ref.ec_neg(pts[5], prime)), (None, pts[0]),
             (pts[1], None), (None, None), (g, g)]
    lhs = _affine(curve, [a for a, _ in pairs])
    rhs = _affine(curve, [b for _, b in pairs])
    expect = [ec_ref.ec_add(a, b, prime) for a, b in pairs]
    p = sw.from_affine(curve, lhs)
    got_add = sw.add(curve, p, sw.from_affine(curve, rhs))
    assert _ints(curve, got_add) == expect
    assert _ints(curve, sw.add_mixed(curve, p, rhs)) == expect
    r_lhs = _ref_affine(ref, [a for a, _ in pairs])
    r_rhs = _ref_affine(ref, [b for _, b in pairs])
    ref_add = ref_sw.add(ref, ref_sw.from_affine(ref, r_lhs),
                         ref_sw.from_affine(ref, r_rhs))
    assert _ref_ints(ref, ref_add) == expect
    # the same projective values as the reference's formulas, not only
    # the same affine points
    for mine, theirs in zip(got_add, ref_add):
        assert [int(v) for v in fp.to_ints(curve.field, mine)] == [
            int(v) for v in ref_fp.to_ints(ref.field, theirs)]

    dbl = sw.dbl(curve, p)
    assert _ints(curve, dbl) == [ec_ref.ec_add(a, a, prime)
                                 for a, _ in pairs]
    assert _ints(curve, sw.neg(curve, p)) == [ec_ref.ec_neg(a, prime)
                                              for a, _ in pairs]
    assert bool(sw.eq(curve, sw.add(curve, p, p), dbl).all())
    assert not bool((sw.eq(curve, p, dbl) & ~lhs.inf).any())
    assert bool(sw.is_on_curve(curve, lhs).all())
    off = sw.Affine(lhs.x, fp.add(curve.field, lhs.y, fp.ones(curve.field)),
                    lhs.inf)
    assert sw.is_on_curve(curve, off).tolist() == [a is None
                                                   for a, _ in pairs]
    back = sw.to_affine(curve, sw.from_affine(curve, lhs))
    assert back.inf.tolist() == lhs.inf.tolist()
    assert torch.equal(back.x[~back.inf], lhs.x[~lhs.inf])


def test_scalar_multiplication_and_sums_match_oracle():
    """mul_scalar (Montgomery scalar words, 32-bit scalars so the loop is
    short), mul_scalar_int, sum_points (odd length) and sum_points_scan
    (the scan over slabs of `group` rows, then the tree) on BLS12-381."""
    curve = BLS12_381_G1
    prime = curve.field.p
    rng = random.Random(17)
    pts = oracle.subgroup_points(curve, 5, 21)
    ks = [rng.randrange(1 << 32) for _ in pts]
    ks[0] = 0
    p = sw.from_affine(curve, _affine(curve, pts))
    got = sw.mul_scalar(curve, p, fp.from_ints(curve.scalar, ks), nbits=32)
    assert _ints(curve, got) == [ec_ref.ec_mul(q, k, prime)
                                 for q, k in zip(pts, ks)]
    k = 1000003
    assert _ints(curve, sw.mul_scalar_int(curve, p, k)) == [
        ec_ref.ec_mul(q, k, prime) for q in pts]
    assert _ints(curve, sw.mul_scalar_int(curve, p, 0)) == [None] * 5
    total = None
    for q in pts:
        total = ec_ref.ec_add(total, q, prime)
    assert _ints(curve, sw.sum_points(curve, p)) == [total]
    many = [pts[i % 5] for i in range(600)]
    many[7] = None
    p = sw.from_affine(curve, _affine(curve, many))
    expect = None
    for q in many:
        expect = ec_ref.ec_add(expect, q, prime)
    assert _ints(curve, sw.sum_points_scan(curve, p, group=256)) == [expect]


@pytest.fixture(scope="module")
def small_case():
    """The small case of tests/test_fp_kernel.py (`_small_msm_case`): 64
    points (8 subgroup points repeated, the points of
    ec_ref.random_subgroup_points) on BLS12-377, seeded scalars, c = 6;
    the reference's digits (`signed_digits`), grouping
    (`bucket_counts_all`) and bucket sums over every rank
    (`accumulate_pass_all`, cap 64), here on python ints and numpy
    (test_small_case_is_the_references holds the reference's own, about
    10 s of JAX, to them)."""
    curve = BLS12_377_G1
    prime = curve.field.p
    rng = random.Random(5)
    base = oracle.subgroup_points(curve, 8, 5)
    pts = base * 8
    scalars = [rng.randrange(curve.order) for _ in range(64)]
    c = 6
    half = 1 << (c - 1)
    n_win = pippenger.num_windows(curve, c)
    digits = []
    for k in scalars:                      # MSB-negated signed windows
        row, carry = [], 0
        for w in range(n_win):
            raw = ((k >> (w * c)) & ((1 << c) - 1)) + carry
            carry = int(raw >= half)
            row.append(raw - (carry << c))
        digits.append(row)
    digits = np.array(digits, dtype=np.int32).T                # (W, n)
    perm = np.argsort(np.abs(digits), axis=1, kind="stable")
    key = np.take_along_axis(np.abs(digits), perm, 1)
    ids = np.arange(half + 1)
    starts = np.stack([np.searchsorted(r, ids) for r in key])
    counts = np.stack([np.searchsorted(r, ids, side="right")
                       for r in key]) - starts
    sums = []
    for w in range(n_win):
        acc = [None] * half
        for i, d in enumerate(digits[w].tolist()):
            if d:
                q = pts[i] if d > 0 else ec_ref.ec_neg(pts[i], prime)
                acc[abs(d) - 1] = ec_ref.ec_add(acc[abs(d) - 1], q, prime)
        sums += acc
    return {"pts": pts, "c": c, "digits": digits,
            "perm": perm.astype(np.int32), "starts": starts.astype(np.int32),
            "counts": counts.astype(np.int32), "sums": sums}


@pytest.mark.slow
def test_small_case_is_the_references(small_case):
    """The reference's digits, grouping and bucket sums of the small case
    equal the python-int ones the fast tier holds the port against."""
    curve = REF_377
    aff = _ref_affine(curve, small_case["pts"])
    rng = random.Random(5)
    oracle.subgroup_points(BLS12_377_G1, 8, 5)
    s = ref_fp.from_ints(curve.scalar, [rng.randrange(curve.order)
                                        for _ in range(64)])
    c = small_case["c"]
    n_win = ref_pippenger.num_windows(curve, c)
    digits = ref_pippenger.signed_digits(curve, c, n_win, s)
    perm, starts, counts, _ = ref_pippenger.bucket_counts_all(c, digits)
    sums = ref_pippenger.accumulate_pass_all(
        curve, c, 64, aff.x, aff.y, digits, perm, starts, counts)
    for name, ref in (("digits", digits), ("perm", perm),
                      ("starts", starts), ("counts", counts)):
        assert np.array_equal(np.asarray(ref), small_case[name]), name
    assert _ref_ints(curve, sums) == small_case["sums"]


def test_gather_accumulate_plain_matches_reference(small_case):
    """The port's bucket grouping equals the reference's
    `bucket_counts_all`; sw_gather_accumulate_plain (on the sort of
    `sort_windows`) gives the reference's bucket sums, all 44 windows; the
    reference-form `accumulate_pass_all` too (8 windows), and split at a
    rank (rank0) its two passes add up to them."""
    curve, case = BLS12_377_G1, small_case
    c, nbe = case["c"], 1 << (case["c"] - 1)
    aff = _affine(curve, case["pts"])
    digits = torch.from_numpy(case["digits"].copy())
    perm, starts, counts, worst = pippenger.bucket_counts_all(c, digits)
    assert perm.tolist() == case["perm"].tolist()
    assert starts.tolist() == case["starts"].tolist()
    assert counts.tolist() == case["counts"].tolist()
    assert worst.tolist() == case["counts"][:, 1:].max(axis=1).tolist()
    runs = pippenger.sort_windows(digits.to(torch.int32), nbe)
    packed = ak.sw_gather_accumulate(curve, aff.x, aff.y, *runs)
    assert packed.shape == (digits.shape[0], nbe, 3, 12)
    assert _ints(curve, sw.unpack(packed)) == case["sums"]
    w8 = (digits[:8], perm[:8], starts[:8], counts[:8])
    depth = int(worst[:8].max())
    mine = pippenger.accumulate_pass_all(curve, c, depth, aff.x, aff.y, *w8)
    assert _ints(curve, mine) == case["sums"][:8 * nbe]
    head = pippenger.accumulate_pass_all(curve, c, 2, aff.x, aff.y, *w8)
    tail = pippenger.accumulate_pass_all(curve, c, depth - 2, aff.x, aff.y,
                                         *w8, rank0=2)
    assert _ints(curve, sw.add(curve, head, tail)) == case["sums"][:8 * nbe]


def _bucket_rows(case, n_win):
    nbe = 1 << (case["c"] - 1)
    return [case["sums"][w * nbe:(w + 1) * nbe] for w in range(n_win)]


def _merge_ints(rows, prime):
    """sum_b b·B_b of each row of affine bucket sums, on python ints."""
    out = []
    for row in rows:
        acc = None
        for b, p in enumerate(row, 1):
            acc = ec_ref.ec_add(acc, None if p is None else
                                ec_ref.ec_mul(p, b, prime), prime)
        out.append(acc)
    return out


def test_full_add_plain_and_merge_match_reference(small_case):
    """sw_full_add_plain (in place, skip lanes, the accumulator added to
    itself) against the reference's sw.add; merge_buckets_all against
    python ints sum_b b·B_b on 4 windows of the small case's bucket sums
    (the reference's merge_buckets_all: the slow test below)."""
    curve, case = BLS12_377_G1, small_case
    prime = curve.field.p
    pts = oracle.subgroup_points(curve, 6, 7)
    acc = sw.pack(sw.from_affine(curve, _affine(curve, pts + [None, None])))
    q = sw.pack(sw.from_affine(curve, _affine(
        curve, [pts[1], pts[1], ec_ref.ec_neg(pts[2], prime), None, pts[0],
                pts[5], pts[3], None])))
    skip = torch.tensor([0, 0, 0, 0, 1, 0, 0, 0], dtype=torch.int32)
    before = acc.clone()
    out = ak.sw_full_add(curve, acc, q, skip)
    assert out is acc
    refp = ref_sw.add(REF_377, ref_sw.from_affine(
        REF_377, _ref_affine(REF_377, pts + [None, None])),
        ref_sw.from_affine(REF_377, _ref_affine(REF_377, [
            pts[1], pts[1], ec_ref.ec_neg(pts[2], prime), None, pts[0],
            pts[5], pts[3], None])))
    expect = _ref_ints(REF_377, refp)
    expect[4] = pts[4]                                # skipped lane
    assert _ints(curve, sw.unpack(acc)) == expect
    assert torch.equal(acc[4], before[4])
    ak.sw_full_add(curve, before, before, torch.zeros(8, dtype=torch.int32))
    assert _ints(curve, sw.unpack(before)) == [
        ec_ref.ec_add(p, p, prime) for p in pts + [None, None]]

    rows = _bucket_rows(case, 4)
    sums = torch.stack([sw.pack(sw.from_affine(curve, _affine(curve, row)))
                        for row in rows])
    merged = pippenger.merge_buckets_all(curve, case["c"], sums)
    assert _ints(curve, sw.unpack(merged)) == _merge_ints(rows, prime)


@pytest.mark.slow
def test_merge_matches_reference_merge_buckets_all(small_case):
    """The merge against the reference's merge_buckets_all on all 44
    windows of the small case (about 17 s of JAX compile on a CPU, so the
    fast tier holds the merge against python ints instead)."""
    curve, case = BLS12_377_G1, small_case
    n_win = case["digits"].shape[0]
    rows = _bucket_rows(case, n_win)
    ref_sums = ref_sw.from_affine(REF_377, _ref_affine(
        REF_377, [p for row in rows for p in row]))
    ref_sums = ref_sw.Point(*(t.reshape(n_win, -1, t.shape[-1])
                              for t in ref_sums))
    ref = _ref_ints(REF_377, ref_pippenger.merge_buckets_all(
        REF_377, case["c"], ref_sums))
    sums = torch.stack([sw.pack(sw.from_affine(curve, _affine(curve, row)))
                        for row in rows])
    merged = pippenger.merge_buckets_all(curve, case["c"], sums)
    assert _ints(curve, sw.unpack(merged)) == ref


def test_combine_windows_matches_oracle():
    """combine_windows: sum_w 2^(c*w) W_w per lane, MSB first, the
    doublings as complete adds of the accumulator to itself."""
    curve = BLS12_381_G1
    prime = curve.field.p
    pts = oracle.subgroup_points(curve, 6, 11)
    ws = [[pts[0], pts[1]], [None, pts[2]], [pts[3], None], [pts[4], pts[5]]]
    planes = torch.stack([sw.pack(sw.from_affine(curve, _affine(curve, row)))
                          for row in ws])
    got = pippenger.combine_windows(curve, 3, planes)
    expect = []
    for lane in range(2):
        acc = None
        for w, row in enumerate(ws):
            acc = ec_ref.ec_add(acc, None if row[lane] is None else
                                ec_ref.ec_mul(row[lane], 1 << (3 * w), prime),
                                prime)
        expect.append(acc)
    assert _ints(curve, sw.unpack(got)) == expect


def test_sw_wrappers_check_their_inputs():
    curve = BLS12_381_G1
    x = torch.zeros((8, 12), dtype=torch.int32)
    perm = torch.zeros((2, 8), dtype=torch.int64)
    sign = torch.zeros((2, 8), dtype=torch.int32)
    runs = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="px"):
        ak.sw_gather_accumulate(curve, x[:, :8], x, perm, sign, runs, runs)
    with pytest.raises(TypeError):
        ak.sw_gather_accumulate(curve, x, x, perm.int(), sign, runs, runs)
    with pytest.raises(ValueError, match="perm"):
        ak.sw_gather_accumulate(curve, x, x, perm[:, :4].contiguous(), sign,
                                runs, runs)
    acc = torch.zeros((4, 3, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="skip"):
        ak.sw_full_add(curve, acc, acc, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ak.sw_full_add(curve, acc[::2], acc[::2],
                       torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        ak.sw_full_add(curve, acc.to("meta"), acc.to("meta"),
                       torch.zeros(4, dtype=torch.int32, device="meta"))
    # the SW kernels' constants: k = 3b in Montgomery form
    params = ak.sw_params(curve, torch.device("cpu"))
    assert torch.equal(params[36:48], fp.constant(curve.field, 12))
