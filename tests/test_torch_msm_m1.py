"""The port's m = 1 MSM route (no window collapse: the route the plan
takes from 2^24 points, and `collapse=False` at any size) against the
reference package's streamed m = 1 MSM and the python-int oracle, and
its accumulate `te_gather_accumulate` (plain version on the CPU) against
the reference's `te_path.accumulate_te`.

Points are the generator chain P_i = (i+1)·G, with one identity lane
where stated, so the oracle is one scalar multiplication:
(sum_i s_i·(i+1) mod r)·G.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_tpu.curve import sw as ref_sw
from zprize_tpu.curve import te as ref_te
from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
from zprize_tpu.field import fp as ref_fp
from zprize_tpu.msm import pippenger as ref_pippenger
from zprize_tpu.msm import te_path as ref_te_path
from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw, te
from zprize_tpu_torch.curve.spec import BLS12_377_G1 as CURVE
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import accum_kernel as ak
from zprize_tpu_torch.msm import api, pippenger, te_path
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

# small tensors: intra-op threads cost more than they give, and the suite
# runs several workers side by side
torch.set_num_threads(1)

P = CURVE.field.p
IDENT = 3


def _ints(scalars):
    return [sum(int(v) << (15 * k) for k, v in enumerate(row))
            for row in scalars]


def _inputs(n, seed, ident=True):
    pts = oracle.generator_chain(CURVE, n)
    scalars = oracle.scalar_batch_np(CURVE, np.random.default_rng(seed), n)
    ints = _ints(scalars)
    if ident:
        pts[IDENT] = None
        ints[IDENT] = 0                 # the identity lane adds nothing
    return pts, scalars, oracle.chain_msm(CURVE, ints)


def _affine(packed):
    pt = te.unpack(packed)
    xs, ys, zs = (fp.to_ints(CURVE.field, a).reshape(-1) for a in pt[:3])
    return [(int(x) * pow(int(z), P - 2, P) % P,
             int(y) * pow(int(z), P - 2, P) % P) for x, y, z in zip(xs, ys, zs)]


def _ref_affine(pt):
    xs, ys, zs = (ref_fp.to_ints(REF_CURVE.field, a).reshape(-1)
                  for a in pt[:3])
    return [(int(x) * pow(int(z), P - 2, P) % P,
             int(y) * pow(int(z), P - 2, P) % P) for x, y, z in zip(xs, ys, zs)]


# the reference's streamed m = 1 MSM, one window a chunk (about 20 s of
# JAX compile and run here), on `_inputs(64, 21)`;
# test_pinned_reference_streamed_msm re-derives it
REF_XY_STREAMED = (
    0x008D56A8B876A897BCCC2B5A22B2BD6E10AD110625571D47CB9C1BA74D4BAD229FE9CFBB0607EE2AE7F9B0BAAD5DE28A,
    0x003A58EBFCEE8548A63E071618F248531EF5BD6601F17CC57FC3AAE8A6F997CD4085C1B8163B0E519F8406A960F8FAB2)


def _ref_points(pts):
    f = REF_CURVE.field
    return ref_sw.Affine(
        ref_fp.from_ints(f, [0 if q is None else q[0] for q in pts]),
        ref_fp.from_ints(f, [1 if q is None else q[1] for q in pts]),
        jnp.asarray([q is None for q in pts]))


def test_slice_matches_reference_streamed_msm_and_oracle():
    """n = 2^6 with c = 4 (both packages' default window for an m = 1
    init of 64 points): the port's API in chunks of 16 windows, the
    reference's streamed route one window a chunk (pinned), and the
    oracle agree, and the reference's m = 1 table carried across equals
    the port's."""
    n = 64
    pts, scalars, expect = _inputs(n, 21)
    budget = 16 * pippenger.window_bytes(n, 8)
    ctx = api.multi_scalar_mult_init(CURVE, pts, device="cpu",
                                     collapse=False, window_budget=budget)
    p = ctx.prepared
    assert (p.c, p.g, p.m, tuple(p.table.shape)) == (4, 65, 1, (n, 3, 12))
    assert pippenger.windows_in_flight(n, 8, 63, p.table.device,
                                       budget) == 16
    assert ctx.points.x.numel() == 0          # only inf is kept
    ours = api.multi_scalar_mult(ctx, scalars)
    assert len(ours) == 1

    assert sw.to_affine_ints(CURVE, ours[0]) == REF_XY_STREAMED == expect
    ref_prep = ref_pippenger.prepare_points(REF_CURVE, _ref_points(pts),
                                            collapse=False)
    assert (ref_prep.c, ref_prep.g, ref_prep.m) == (4, 65, 1)

    # the reference's m = 1 table carried across is the port's, word for
    # word, so the port's MSM over it is the result above
    carried = convert.prepared_from_reference(
        CURVE, np.asarray(ref_prep.packed), 4, 65, 1, n, device="cpu")
    assert carried[1:] == p[1:]
    assert torch.equal(carried.table, p.table)


@pytest.mark.slow
def test_pinned_reference_streamed_msm(monkeypatch):
    pts, scalars, _ = _inputs(64, 21)
    # the reference's streamed route runs when its (n_win, n) digit
    # planes pass ZPRIZE_STREAM_GB; at this size, one window per chunk
    monkeypatch.setenv("ZPRIZE_STREAM_GB", "1e-9")
    ref_aff = _ref_points(pts)
    ref_prep = ref_pippenger.prepare_points(REF_CURVE, ref_aff,
                                            collapse=False)
    ref_res = ref_sw.to_affine(REF_CURVE, ref_pippenger.msm(
        REF_CURVE, ref_aff, jnp.asarray(scalars), prepared=ref_prep))
    f = REF_CURVE.field
    assert (int(ref_fp.to_ints(f, ref_res.x)[()]),
            int(ref_fp.to_ints(f, ref_res.y)[()])) == REF_XY_STREAMED


def test_gather_accumulate_plain_matches_reference():
    """te_gather_accumulate_plain == te_path.accumulate_te as affine
    bucket sums, at 64 points and c = 5 (16 buckets), over 4 windows of
    seeded digits, on the reference's packed m = 1 rows carried across
    with convert.prepared_from_reference.  The port's bucket sort finds
    the same runs as the reference's."""
    n, c, n_win = 64, 5, 4
    nbe = 1 << (c - 1)
    pts = oracle.generator_chain(CURVE, n)
    x = fp.from_ints(CURVE.field, [q[0] for q in pts])
    y = fp.from_ints(CURVE.field, [q[1] for q in pts])
    tx, ty, _ = te.sw_to_te(CURVE, x, y, torch.zeros(n, dtype=torch.bool))
    txi, tyi = fp.to_ints(CURVE.field, tx), fp.to_ints(CURVE.field, ty)
    ref_pre = ref_te.precompute(REF_CURVE,
                                ref_fp.from_ints(REF_CURVE.field, txi),
                                ref_fp.from_ints(REF_CURVE.field, tyi))
    packed = np.asarray(ref_te_path.precompute_packed(REF_CURVE, ref_pre).T)
    table = convert.prepared_from_reference(CURVE, packed, c, n_win, 1, n,
                                            device="cpu").table
    scalars = oracle.scalar_batch_np(CURVE, np.random.default_rng(5), n)
    scalars[:8] = scalars[8]                       # a crowded bucket
    # (signed_digits equals the reference's: test_torch_msm.py)
    digits = pippenger.signed_digits(
        CURVE, c, n_win, torch.from_numpy(scalars.astype(np.int32))).numpy()
    digits[np.abs(digits) == 5] -= np.sign(digits[np.abs(digits) == 5])
    # now bucket 5 is empty
    d_ref = jnp.asarray(digits)
    perm, starts, counts, cap = ref_pippenger.bucket_counts_all(c, d_ref)
    ref_sums = ref_te_path.accumulate_te(REF_CURVE, c, int(cap.max()),
                                         jnp.asarray(packed), d_ref,
                                         perm, starts, counts, nbe)
    perm = torch.from_numpy(np.asarray(perm).astype(np.int64))
    d = torch.from_numpy(digits.astype(np.int32))
    sign = (d.gather(1, perm) < 0).to(torch.int32)
    st = torch.from_numpy(np.asarray(starts)[:, 1:].astype(np.int64))
    ct = torch.from_numpy(np.asarray(counts)[:, 1:].astype(np.int64))
    assert int(ct[:, 4].max()) == 0 and int(ct.max()) >= 8
    ours = ak.te_gather_accumulate(CURVE, table, perm, sign, st, ct)
    assert tuple(ours.shape) == (n_win, nbe, 4, 12)
    assert _affine(ours) == _ref_affine(ref_sums)
    # the port's own sort (key 2|d| + sign) yields the same bucket runs
    _, _, st2, ct2 = pippenger.sort_windows(d, nbe)
    assert torch.equal(st2, st) and torch.equal(ct2, ct)


@pytest.mark.parametrize("c", [8, 13, 17])
def test_window_groups_match_reference(c):
    n_win = pippenger.num_windows(CURVE, c)
    full = 1 << (c - 1)
    ours = pippenger.window_groups(CURVE, c, n_win, full)
    assert ours == ref_pippenger._window_groups(REF_CURVE, c, n_win, full)
    assert sorted(w for ws in ours.values() for w in ws) == list(range(n_win))


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_digit_chunks_with_carry_match_signed_digits(chunk):
    """Windows taken `chunk` at a time, the carry riding between chunks,
    from the limb-major int16 view of the compact form, equal
    signed_digits of all windows at once (c = 17, the prize plan's)."""
    c = 17
    n_win = pippenger.num_windows(CURVE, c)
    scalars = oracle.scalar_batch_np(CURVE, np.random.default_rng(chunk), 40)
    r_minus_1 = CURVE.order - 1
    scalars[0] = 0
    scalars[1] = [(r_minus_1 >> (15 * k)) & 0x7FFF for k in range(17)]
    scalars[2] = [(1 << 15) - 1] * 16 + [0]         # every window overflows
    expect = pippenger.signed_digits(
        CURVE, c, n_win, torch.from_numpy(scalars.astype(np.int32)))
    limbs = torch.from_numpy(scalars.view(np.int16)).t().contiguous()
    carry = torch.zeros(40, dtype=torch.int32)
    parts = []
    for lo in range(0, n_win, chunk):
        part, carry = pippenger.signed_digits_range(
            CURVE, c, lo, min(n_win, lo + chunk), limbs, carry)
        assert part.dtype == torch.int32
        parts.append(part)
    assert torch.equal(torch.cat(parts).to(torch.int64), expect)
    assert not carry.any()                 # the top window took the carry


def test_window_chunk_does_not_change_the_window_sums():
    """Four windows in flight and all 65 in flight give the same
    projective window sums (the bit-decomposed merge is lane-wise, so
    they are equal word for word).  Each chunk pays its own merge, about
    0.17 s on the plain engine, so one window in flight would cost 11 s
    here; the slice test holds the port's chunks against the reference's
    one-window chunks."""
    n = 8
    pts, scalars, _ = _inputs(n, 22)
    ctx = api.multi_scalar_mult_init(CURVE, pts, device="cpu",
                                     collapse=False)
    s = torch.from_numpy(scalars.astype(np.int32))
    budget = 4 * pippenger.window_bytes(n, 8)
    assert pippenger.windows_in_flight(n, 8, 63, s.device, budget) == 4
    four = pippenger.window_sums_m1(CURVE, ctx.prepared, ctx.points.inf, s,
                                    budget)
    every = pippenger.window_sums_m1(CURVE, ctx.prepared, ctx.points.inf, s)
    assert tuple(every.shape) == (65, 4, 12)
    assert torch.equal(four, every)


@pytest.mark.parametrize("case", ["all_equal", "half_zero"])
def test_skewed_batch_matches_oracle(case):
    """Every scalar equal (one bucket per window holds every point), or
    half of them zero and the rest equal."""
    n = 8
    pts, scalars, _ = _inputs(n, 23, ident=False)
    scalars[:] = scalars[0]
    if case == "half_zero":
        scalars[::2] = 0
    expect = oracle.chain_msm(CURVE, _ints(scalars))
    ctx = api.multi_scalar_mult_init(CURVE, pts, device="cpu",
                                     collapse=False)
    res = api.multi_scalar_mult(ctx, scalars)
    assert sw.to_affine_ints(CURVE, res[0]) == expect


def test_m1_table_is_built_in_blocks(monkeypatch):
    """te_path.prepare_points gives the same table whatever its block,
    with an identity lane, and raises on a point with no TE image."""
    n = 12
    pts = oracle.generator_chain(CURVE, n)
    pts[5] = None
    f = CURVE.field
    x = fp.from_ints(f, [0 if q is None else q[0] for q in pts])
    y = fp.from_ints(f, [1 if q is None else q[1] for q in pts])
    inf = torch.tensor([q is None for q in pts])
    whole = te_path.prepare_points(CURVE, x, y, inf)
    monkeypatch.setattr(te_path, "_PREP_BLOCK", 5)
    assert torch.equal(te_path.prepare_points(CURVE, x, y, inf), whole)
    assert torch.equal(whole[5], te.pack(te.identity_pre(CURVE)))
    # (p - 1, 0): Montgomery v = 0, no TE image
    bad_x = x.clone()
    bad_x[7] = fp.from_ints(f, [P - 1])[0]
    bad_y = y.clone()
    bad_y[7] = fp.from_ints(f, [0])[0]
    with pytest.raises(ValueError, match="twisted-Edwards"):
        te_path.prepare_points(CURVE, bad_x, bad_y, inf)


def test_gather_wrapper_takes_plain_route_on_cpu_and_checks_inputs():
    n, nbe = 6, 4
    table = torch.zeros((n, 3, 12), dtype=torch.int32)
    table[:] = te.pack(te.identity_pre(CURVE))
    perm = torch.arange(n).repeat(2, 1)
    sign = torch.zeros((2, n), dtype=torch.int32)
    starts = torch.zeros((2, nbe), dtype=torch.int64)
    counts = torch.tensor([[0, 1, 2, 0], [6, 0, 0, 0]])
    ak.reset_launches()
    out = ak.te_gather_accumulate(CURVE, table, perm, sign, starts, counts)
    assert torch.equal(out, ak.te_gather_accumulate_plain(
        CURVE, table, perm, sign, starts, counts))
    assert _affine(out) == [(0, 1)] * (2 * nbe)         # identity rows
    assert torch.equal(out[0, 0], te.pack(te.identity(CURVE)))  # empty run
    assert set(ak.launches.values()) == {0}             # no kernel on CPU
    with pytest.raises(TypeError):
        ak.te_gather_accumulate(CURVE, table, perm.to(torch.int32), sign,
                                starts, counts)
    with pytest.raises(ValueError):
        ak.te_gather_accumulate(CURVE, table, perm[:, :5], sign[:, :5],
                                starts, counts)
    with pytest.raises(ValueError):
        ak.te_gather_accumulate(CURVE, table, perm, sign, starts,
                                counts[:, :3])


def test_device_scalar_batch_is_canonical_and_seeded():
    """oracle.scalar_batch_torch (chip_smoke's 2^26 batches): limbs below
    2^15, every value below the order, the same batch from the same seed,
    and the top limb's tie with the order drawn down to the lower limbs."""
    n = 1 << 14
    batch = oracle.scalar_batch_torch(
        CURVE, n, torch.Generator().manual_seed(7))
    again = oracle.scalar_batch_torch(
        CURVE, n, torch.Generator().manual_seed(7))
    assert batch.dtype == torch.int16 and tuple(batch.shape) == (n, 17)
    assert torch.equal(batch, again)
    u16 = batch.numpy().view(np.uint16)
    assert int(u16.max()) < 1 << 15
    top = CURVE.order >> (15 * 16)
    assert (u16[:, 16] == top).any()            # ties were resolved
    assert all(v < CURVE.order for v in _ints(u16))
