"""The TE routes' second accumulates (`accum`, the reference package's
ZPRIZE_ACCUM) against the reference package and the python-int oracle:
the m = 1 sorted route (`pippenger.window_sums_sorted`, the reference's
`_msm_te_sorted_streamed`: runs of rows sorted, copied and summed by
`te_bucket_accumulate` chained through its init lanes) and the collapsed
gather route (`pippenger.collapsed_gather_sums`, the reference's m > 1
gather `_msm_te`: one `te_gather_accumulate` over the collapsed table).

The inputs are the reference's own `tests/test_msm_sorted.py`: 48 seeded
subgroup points with point 5 the identity, scalars from
random.Random(21), c = 8; runs of 16 rows (three a window), and the
collapsed table at g = 2.  The reference's outputs are pinned in
`tests/fixtures/torch_msm_routes_reference.json`; the `slow` tests
re-derive them.  Every comparison is of affine points as ints."""

import json
import os
import random

import numpy as np
import pytest
import torch

from zprize_tpu_torch.curve import sw, te
from zprize_tpu_torch.curve.spec import BLS12_377_G1 as CURVE
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import accum_kernel as ak
from zprize_tpu_torch.msm import api, pippenger
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

# small tensors: intra-op threads cost more than they give, and the suite
# runs several workers side by side
torch.set_num_threads(1)

N, C, G, RUN = 48, 8, 2, 16
P = CURVE.field.p
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_msm_routes_reference.json")


def _pinned(route):
    with open(FIXTURE) as fh:
        xy = json.load(fh)[route]
    return int(xy["x"], 16), int(xy["y"], 16)


@pytest.fixture(scope="module")
def inputs():
    """(points, scalar ints, compact scalar planes, oracle MSM)."""
    pts = oracle.subgroup_points(CURVE, N, seed=9)
    pts[5] = None
    rng = random.Random(21)
    ints = [rng.randrange(CURVE.order) for _ in range(N)]
    planes = np.array([[(k >> (15 * j)) & 0x7FFF
                        for j in range(CURVE.scalar.n_limbs)] for k in ints],
                      np.uint16)
    expect = None
    for pt, k in zip(pts, ints):
        if pt is not None:
            expect = oracle.ec_add(expect, oracle.ec_mul(pt, k, P), P)
    return pts, ints, planes, expect


def _affine_planes(pts):
    f = CURVE.field
    return sw.Affine(fp.from_ints(f, [0 if q is None else q[0] for q in pts]),
                     fp.from_ints(f, [1 if q is None else q[1] for q in pts]),
                     torch.tensor([q is None for q in pts]))


@pytest.fixture(scope="module")
def collapsed(inputs):
    """The collapsed table at c = 8, g = 2 (m = 17): the plan
    `plan_collapse` picks when the budget holds 17 multiples."""
    aff = _affine_planes(inputs[0])
    row_bytes = 3 * ((CURVE.field.n_limbs + 1) // 2) * 4
    prep = pippenger.prepare_points(CURVE, aff, C,
                                    budget_bytes=17 * N * row_bytes)
    assert (prep.c, prep.g, prep.m) == (C, G, 17)
    return aff, prep


def _counting(monkeypatch):
    """Record every call of the two accumulates the routes may take, as
    (name, positional arguments, result)."""
    calls = []
    for name in ("te_bucket_accumulate", "te_gather_accumulate"):
        fn = getattr(pippenger, name)

        def wrapped(*args, _fn=fn, _name=name):
            out = _fn(*args)
            calls.append((_name, args, out))
            return out
        monkeypatch.setattr(pippenger, name, wrapped)
    return calls


def test_sorted_route_matches_reference_and_oracle(inputs, monkeypatch):
    """accum="sorted" on the m = 1 table through the API: 33 windows of
    three runs, each run a `te_bucket_accumulate` of 16 sorted rows over
    all 128 buckets, the first run of a window from the identity and the
    others from the sums before; == the pinned reference == the oracle."""
    pts, _, planes, expect = inputs
    ctx = api.multi_scalar_mult_init(CURVE, pts, window_bits=C,
                                     device="cpu", collapse=False,
                                     accum="sorted", sort_run=RUN)
    assert (ctx.prepared.c, ctx.prepared.m) == (C, 1)
    calls = _counting(monkeypatch)
    res = api.multi_scalar_mult(ctx, planes)
    assert sw.to_affine_ints(CURVE, res[0]) == _pinned("sorted_streamed")
    assert _pinned("sorted_streamed") == expect
    n_win = pippenger.num_windows(CURVE, C)
    assert [name for name, _, _ in calls] == (
        ["te_bucket_accumulate"] * n_win * 3)
    for k, (_, args, _) in enumerate(calls):
        rows, sign, starts, counts, init = args[1:]
        assert tuple(rows.shape) == (RUN, 3, 12)
        assert tuple(starts.shape) == (1 << (C - 1),)
        # a run's buckets hold its rows but for the zero digits
        assert int(counts.sum()) <= RUN
        # a window's first run starts from the identity, the others from
        # the sums of the run before
        assert init is (None if k % 3 == 0 else calls[k - 1][2])


def test_collapsed_gather_route_matches_reference_and_oracle(
        inputs, collapsed, monkeypatch):
    """accum="gather" on the collapsed table: one `te_gather_accumulate`
    over both bucket sets, reading the 17 x 48 rows through the
    permutation, no `te_bucket_accumulate`; == the pinned reference ==
    the oracle."""
    _, _, planes, expect = inputs
    aff, prep = collapsed
    calls = _counting(monkeypatch)
    res = pippenger.msm(CURVE, aff, torch.from_numpy(planes.view(np.int16)),
                        prepared=prep, accum="gather")
    assert sw.to_affine_ints(CURVE, res) == _pinned("collapsed_gather")
    assert _pinned("collapsed_gather") == expect
    assert [name for name, _, _ in calls] == ["te_gather_accumulate"]
    table, perm, sign, starts, counts = calls[0][1][1:]
    assert table is prep.table
    assert tuple(perm.shape) == (G, 17 * N)
    assert tuple(starts.shape) == (G, 1 << (C - 1))


@pytest.mark.parametrize("table,accum,kernel", [
    ("collapsed", None, "te_bucket_accumulate"),
    ("collapsed", "sorted", "te_bucket_accumulate"),
    ("m1", None, "te_gather_accumulate"),
    ("m1", "gather", "te_gather_accumulate")])
def test_accum_defaults_per_table(inputs, collapsed, monkeypatch, table,
                                  accum, kernel):
    """The reference's defaults: "sorted" for a collapsed table, "gather"
    at m = 1; each route equals the oracle and takes its one kernel."""
    pts, _, planes, expect = inputs
    aff, prep = collapsed
    if table == "m1":
        prep = pippenger.prepare_points(CURVE, aff, C, collapse=False)
    assert pippenger.accum_route(prep, accum) == (
        "sorted" if kernel == "te_bucket_accumulate" else "gather")
    calls = _counting(monkeypatch)
    res = pippenger.msm(CURVE, aff, torch.from_numpy(planes.view(np.int16)),
                        prepared=prep, accum=accum)
    assert sw.to_affine_ints(CURVE, res) == expect
    assert {name for name, _, _ in calls} == {kernel}


def test_accum_bad_values_raise(inputs, collapsed):
    pts = inputs[0]
    aff, prep = collapsed
    sw_prep = pippenger.PreparedSw(aff.x, aff.y, C, N)
    assert pippenger.accum_route(sw_prep, None) is None
    for bad in ("Sorted", "gathered", ""):
        with pytest.raises(ValueError, match="accum"):
            pippenger.accum_route(prep, bad)
    with pytest.raises(ValueError, match="SW route"):
        pippenger.accum_route(sw_prep, "sorted")
    s = torch.zeros((N, CURVE.scalar.n_limbs), dtype=torch.int32)
    with pytest.raises(ValueError, match="accum"):
        pippenger.msm(CURVE, aff, s, prepared=prep, accum="bucket")
    with pytest.raises(ValueError, match="accum"):
        api.multi_scalar_mult_init(CURVE, pts[:4], device="cpu",
                                   collapse=False, accum="bucket")
    with pytest.raises(ValueError, match="sort_run"):
        api.multi_scalar_mult_init(CURVE, pts[:4], device="cpu",
                                   collapse=False, accum="sorted",
                                   sort_run=0)


def _te_lanes(pts, scale):
    """Extended TE points (lanes, 4, nw) of SW affine points (None: the
    identity), each projectively scaled by its factor."""
    f = CURVE.field
    words = []
    for pt, lam in zip(pts, scale):
        x, y = oracle.te_affine_ints(CURVE, pt)
        words.append([lam * x % P, lam * y % P, lam % P, lam * x * y % P])
    return fp.from_ints(f, np.array(words, dtype=object))


def _sw_of_te(packed):
    """Packed extended TE points -> SW affine ints (None: identity)."""
    out = []
    for x, y, z, _ in fp.to_ints(CURVE.field, packed).tolist():
        sx, sy, sz = te.te_to_sw_host(CURVE, int(x), int(y), int(z))
        out.append(None if sz == 0 else (sx, sy))
    return out


def test_bucket_accumulate_plain_with_init_matches_ints():
    """te_bucket_accumulate_plain over 6 buckets of sorted rows, from
    init lanes (identity; random points at random projective scales)
    and from none: each bucket's SW image == init + sum of ±rows in
    python ints; an empty run returns its init lane word for word; an
    identity init equals no init word for word."""
    rng = random.Random(5)
    base = oracle.subgroup_points(CURVE, 14, seed=3)
    row_pts, init_pts = base[:10], [None] + base[10:] + [None]
    f = CURVE.field
    tx, ty = zip(*(oracle.te_affine_ints(CURVE, q) for q in row_pts))
    rows = te.pack(te.precompute(CURVE, fp.from_ints(f, list(tx)),
                                 fp.from_ints(f, list(ty))))
    sign = torch.tensor([rng.randrange(2) for _ in row_pts],
                        dtype=torch.int32)
    counts = torch.tensor([3, 0, 2, 4, 0, 1])
    starts = torch.tensor([0, 3, 3, 5, 9, 9])
    init = _te_lanes(init_pts, [1] + [rng.randrange(1, P) for _ in range(5)])
    out = ak.te_bucket_accumulate(CURVE, rows, sign, starts, counts, init)
    assert torch.equal(out, ak.te_bucket_accumulate_plain(
        CURVE, rows, sign, starts, counts, init))
    expect = []
    for b in range(6):
        acc = init_pts[b]
        for r in range(int(starts[b]), int(starts[b] + counts[b])):
            q = row_pts[r]
            if sign[r]:
                q = (q[0], -q[1] % P)
            acc = oracle.ec_add(acc, q, P)
        expect.append(acc)
    assert _sw_of_te(out) == expect
    for b in (1, 4):                                       # empty runs
        assert torch.equal(out[b], init[b])
    ident = te.pack(te.identity(CURVE, (6,)))
    assert torch.equal(
        ak.te_bucket_accumulate(CURVE, rows, sign, starts, counts, ident),
        ak.te_bucket_accumulate(CURVE, rows, sign, starts, counts))
    assert init.data_ptr() != out.data_ptr()


def test_bucket_accumulate_checks_init():
    rows = te.pack(te.identity_pre(CURVE, (4,)))
    sign = torch.zeros(4, dtype=torch.int32)
    starts = torch.zeros(3, dtype=torch.int64)
    counts = torch.tensor([4, 0, 1])
    init = te.pack(te.identity(CURVE, (3,)))
    with pytest.raises(TypeError, match="init"):
        ak.te_bucket_accumulate(CURVE, rows, sign, starts, counts,
                                init.to(torch.int64))
    with pytest.raises(ValueError, match="init"):
        ak.te_bucket_accumulate(CURVE, rows, sign, starts, counts, init[:2])
    with pytest.raises(ValueError, match="init"):
        ak.te_bucket_accumulate(CURVE, rows, sign, starts, counts,
                                init[None])
    with pytest.raises(ValueError, match="contiguous"):
        ak.te_bucket_accumulate(CURVE, rows, sign, starts, counts,
                                init.transpose(1, 2).contiguous()
                                .transpose(1, 2))


# --- the pins, re-derived from the reference package -----------------------


def _reference_inputs():
    import jax.numpy as jnp

    import ec_ref
    from zprize_tpu.curve import sw as ref_sw
    from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
    from zprize_tpu.field import fp as ref_fp
    pts = ec_ref.random_subgroup_points(REF_CURVE, N, seed=9)
    pts[5] = None
    aff = ref_sw.Affine(
        ref_fp.from_ints(REF_CURVE.field, [q[0] if q else 0 for q in pts]),
        ref_fp.from_ints(REF_CURVE.field, [q[1] if q else 1 for q in pts]),
        jnp.asarray([q is None for q in pts]))
    rng = random.Random(21)
    scal = [rng.randrange(REF_CURVE.order) for _ in range(N)]
    return REF_CURVE, aff, ref_fp.from_ints(REF_CURVE.scalar, scal)


def _reference_xy(ref_curve, res):
    from zprize_tpu.curve import sw as ref_sw
    from zprize_tpu.field import fp as ref_fp
    a = ref_sw.to_affine(ref_curve, res)
    return (int(ref_fp.to_ints(ref_curve.field, a.x)[()]),
            int(ref_fp.to_ints(ref_curve.field, a.y)[()]))


@pytest.mark.slow
def test_pinned_reference_sorted_streamed(monkeypatch):
    """The reference's `_msm_te_sorted_streamed` (its Pallas kernels in
    interpret mode) at runs of 2^4 rows."""
    from zprize_tpu.msm import pippenger as ref_pippenger
    from zprize_tpu.msm import te_path as ref_te_path
    ref_curve, aff, s = _reference_inputs()
    packed, bad = ref_te_path.prepare_points(ref_curve, aff.x, aff.y,
                                             aff.inf)
    assert not bool(bad)
    prep = ref_pippenger.PreparedTe(
        packed, C, ref_pippenger.num_windows(ref_curve, C), 1, N)
    monkeypatch.setenv("ZPRIZE_SORT_RUN_LOG", "4")
    res = ref_pippenger._msm_te_sorted_streamed(ref_curve, prep, aff.inf, s,
                                                C, interpret=True)
    assert _reference_xy(ref_curve, res) == _pinned("sorted_streamed")


@pytest.mark.slow
def test_pinned_reference_collapsed_gather():
    """The reference's m > 1 `_msm_te` on the CPU (no Pallas): its
    gather accumulate over the collapsed table at c = 8, g = 2."""
    from zprize_tpu.msm import pippenger as ref_pippenger
    from zprize_tpu.msm import te_path as ref_te_path
    ref_curve, aff, s = _reference_inputs()
    m = -(-ref_pippenger.num_windows(ref_curve, C) // G)
    packed, bad = ref_te_path.prepare_points_collapsed(
        ref_curve, aff.x, aff.y, aff.inf, C * G, m)
    assert not bool(bad)
    prep = ref_pippenger.PreparedTe(packed, C, G, m, N)
    res = ref_pippenger._msm_te(ref_curve, prep, aff.inf, s, C, False)
    assert _reference_xy(ref_curve, res) == _pinned("collapsed_gather")
