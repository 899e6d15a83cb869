"""Each kernel module of the port's MSM, through its plain version (the
CPU route of the wrappers), against the reference package's XLA forms in
`msm/te_path.py` on the same inputs (the triangle merge against the
python-int oracle).

Kernel-level projective results depend on the order of additions, so
points are compared as affine canonical ints; the window-collapse table
holds affine values and is compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_tpu.curve import te as ref_te
from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
from zprize_tpu.field import fp as ref_fp
from zprize_tpu.msm import pippenger as ref_pippenger
from zprize_tpu.msm import te_path as ref_te_path
from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import te
from zprize_tpu_torch.curve.spec import BLS12_377_G1 as CURVE
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import accum_kernel as ak
from zprize_tpu_torch.msm import te_path
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

# small tensors: intra-op threads cost more than they give, and the suite
# runs several workers side by side
torch.set_num_threads(1)

P = CURVE.field.p
N_BASE = 64


@pytest.fixture(scope="module")
def te_affine():
    """TE affine ints (x, y) of the G-chain points (i+1)·G, i < 64."""
    pts = oracle.generator_chain(CURVE, N_BASE)
    x = fp.from_ints(CURVE.field, [q[0] for q in pts])
    y = fp.from_ints(CURVE.field, [q[1] for q in pts])
    tx, ty, _ = te.sw_to_te(CURVE, x, y, torch.zeros(N_BASE, dtype=bool))
    return ([int(v) for v in fp.to_ints(CURVE.field, tx)],
            [int(v) for v in fp.to_ints(CURVE.field, ty)])


def _extended_ints(te_affine, idx, seed):
    """Extended coordinates (lists of ints) of the chain points idx, each
    at a random projective scale."""
    xs, ys = te_affine
    rng = np.random.default_rng(seed)
    lam = [int(v) + 1 for v in rng.integers(0, 1 << 62, size=len(idx))]
    return [[l * xs[i] % P for l, i in zip(lam, idx)],
            [l * ys[i] % P for l, i in zip(lam, idx)],
            [l % P for l in lam],
            [l * xs[i] * ys[i] % P for l, i in zip(lam, idx)]]


def _both(coords, shape):
    """Coordinate int lists -> (port packed (*shape, 4, nw), reference
    TePoint of (*shape, 26) planes)."""
    ours = te.pack(te.TePoint(*(fp.from_ints(CURVE.field, np.array(
        c, dtype=object).reshape(shape)) for c in coords)))
    ref = ref_te.TePoint(*(ref_fp.from_ints(REF_CURVE.field, np.array(
        c, dtype=object).reshape(shape)) for c in coords))
    return ours, ref


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


def test_dbl_chain_table_matches_reference():
    """The plain te_dbl_chain through prepare_points_collapsed builds the
    same table as the reference (carried over with prepared_from_reference),
    identity lane included."""
    n, shift, m = 8, 3, 3
    pts = oracle.generator_chain(CURVE, n)
    pts[2] = None
    xs = [0 if q is None else q[0] for q in pts]
    ys = [1 if q is None else q[1] for q in pts]
    inf = [q is None for q in pts]
    ref_packed, ref_bad = ref_te_path.prepare_points_collapsed(
        REF_CURVE, ref_fp.from_ints(REF_CURVE.field, xs),
        ref_fp.from_ints(REF_CURVE.field, ys), jnp.asarray(inf), shift, m)
    assert not bool(ref_bad)
    ref = convert.prepared_from_reference(CURVE, np.asarray(ref_packed), 1,
                                          1, m, n, device="cpu")
    ours = te_path.prepare_points_collapsed(
        CURVE, fp.from_ints(CURVE.field, xs), fp.from_ints(CURVE.field, ys),
        torch.tensor(inf), shift, m)
    assert ours.shape == (m * n, 3, fp.n_words(CURVE.field))
    # identity lane 2 at blocks j >= 1: the reference normalises
    # dbl(identity) = (0, -1, -1, 0) with z forced to 1 and stores the
    # operand of (0, -1); the port stores the identity operand (1, 1, 0).
    # Those rows are never read (identity lanes have zero digits).
    ident_rows = [j * n + 2 for j in range(1, m)]
    keep = [r for r in range(m * n) if r not in ident_rows]
    assert torch.equal(ours[keep], ref.table[keep])
    ident = te.pack(te.identity_pre(CURVE))
    assert all(torch.equal(ours[r], ident) for r in ident_rows + [2])


def test_bucket_sums_match_reference(te_affine):
    """te_bucket_accumulate over a bucket-sorted table (signed digits,
    empty buckets, repeated points) == te_path.accumulate_te."""
    c, rows_n = 4, 40
    nbe = 1 << (c - 1)
    xs, ys = te_affine
    idx = [i % 20 for i in range(rows_n)]               # repeats
    aff_x = [xs[i] for i in idx]
    aff_y = [ys[i] for i in idx]
    pre = te.precompute(CURVE, fp.from_ints(CURVE.field, aff_x),
                        fp.from_ints(CURVE.field, aff_y))
    ref_pre = ref_te.precompute(REF_CURVE,
                                ref_fp.from_ints(REF_CURVE.field, aff_x),
                                ref_fp.from_ints(REF_CURVE.field, aff_y))
    rng = np.random.default_rng(3)
    digits = rng.integers(-nbe, nbe, size=rows_n)
    digits[np.abs(digits) == 5] = 4                     # bucket 5 empty
    # reference: column-major packed table + key/index grouping
    ref_packed = ref_te_path.precompute_packed(REF_CURVE, ref_pre).T
    d_ref = jnp.asarray(digits[None], jnp.int32)
    perm, starts, counts, cap = ref_pippenger.bucket_counts_all(c, d_ref)
    ref_sums = ref_te_path.accumulate_te(REF_CURVE, c, int(cap.max()),
                                         ref_packed, d_ref, perm, starts,
                                         counts, nbe)
    # port: the same sort as pippenger.bucket_runs
    table = te.pack(pre)
    d = torch.from_numpy(digits)
    key, order = torch.sort(d.abs())
    buckets = torch.arange(1, nbe + 1)
    st = torch.searchsorted(key, buckets)
    ct = torch.searchsorted(key, buckets, right=True) - st
    sums = ak.te_bucket_accumulate(CURVE, table[order].contiguous(),
                                   (d[order] < 0).to(torch.int32), st, ct)
    assert ct[4] == 0
    assert _affine(sums) == _ref_affine(ref_te.TePoint(
        *(a[0] for a in ref_sums)))


def test_triangle_merge_matches_reference(te_affine):
    """merge_buckets_te_triangle at nbe = 1024 (C = 128, S = 8) against
    the python-int value: bucket b (weight b+1) holds ((b mod 64)+1)·G,
    so the merge is K·G with K = sum_b (b+1)·((b mod 64)+1).  (The
    reference package's triangle merge at this nbe is held through the
    whole slice in test_torch_msm.test_slice_matches_reference_at_256;
    tracing it here alone would cost half a minute.)"""
    nbe = 1024
    idx = [b % N_BASE for b in range(nbe)]
    ours, _ = _both(_extended_ints(te_affine, idx, 4), (1, nbe))
    got = te_path.merge_buckets_te_triangle(CURVE, 11, ours)
    x, y, z = (int(v) for v in fp.to_ints(CURVE.field, got[0, :3]))
    k = sum((b + 1) * (i + 1) for b, i in enumerate(idx)) % CURVE.order
    expect = oracle.ec_mul(oracle.generator(CURVE), k, P)
    assert te.te_to_sw_host(CURVE, x, y, z) == (*expect, 1)


def test_bit_decomposed_merge_matches_reference(te_affine):
    """merge_buckets_te (two windows of 16 buckets)."""
    coords = _extended_ints(te_affine, list(range(32)), 5)
    ours, ref = _both(coords, (2, 16))
    got = te_path.merge_buckets_te(CURVE, 5, ours)
    expect = ref_te_path.merge_buckets_te(REF_CURVE, 5, ref)
    assert _affine(got) == _ref_affine(expect)


def test_combine_matches_reference(te_affine):
    """combine_windows_te (te_combine) == te_path._combine_core_te."""
    coords = _extended_ints(te_affine, [7, 11, 13], 6)
    ours, ref = _both(coords, (3,))
    got = te_path.combine_windows_te(CURVE, 2, ours)
    expect = ref_te_path._combine_core_te(REF_CURVE, 2, ref)
    assert _affine(got) == _ref_affine(ref_te.TePoint(
        *(a[None] for a in expect)))


def test_wrappers_take_plain_route_on_cpu_and_check_inputs(te_affine):
    coords = _extended_ints(te_affine, list(range(4)), 7)
    pts, _ = _both(coords, (4,))
    skip = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    ak.reset_launches()
    out = ak.te_full_add(CURVE, pts, pts.flip(0).contiguous(), skip)
    assert torch.equal(out[1], pts[1])                  # skipped lane
    assert torch.equal(ak.te_dbl_chain(CURVE, pts, 2),
                       ak.te_dbl_chain_plain(CURVE, pts, 2))
    assert set(ak.launches.values()) == {0}             # no kernel on CPU
    with pytest.raises(TypeError):
        ak.te_dbl_chain(CURVE, pts.to(torch.int64), 1)
    with pytest.raises(ValueError):
        ak.te_dbl_chain(CURVE, pts[..., :11].contiguous(), 1)
    with pytest.raises(ValueError):
        ak.te_dbl_chain(CURVE, pts.transpose(0, 1), 1)
    with pytest.raises(ValueError):
        ak.te_full_add(CURVE, pts, pts, skip[:3])
    with pytest.raises(ValueError):
        ak.te_dbl_chain(CURVE, pts.to("meta"), 1)
