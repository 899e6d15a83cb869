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
from zprize_tpu_torch.msm import probe
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


DBL_N, DBL_SHIFT, DBL_M, DBL_IDENT = 8, 3, 3, 2


def _dbl_chain_inputs():
    pts = oracle.generator_chain(CURVE, DBL_N)
    pts[DBL_IDENT] = None
    return (pts, [0 if q is None else q[0] for q in pts],
            [1 if q is None else q[1] for q in pts], [q is None for q in pts])


def _collapse_table_ints(pts):
    """Rows j*n + i of the window-collapse table on python ints: the
    operand (Y+X, Y-X, 2d·X·Y) of the TE image of 2^(shift·j)·P_i; an
    identity lane the identity operand (1, 1, 0)."""
    k = te.te_params(CURVE).k
    rows = []
    for j in range(DBL_M):
        for q in pts:
            if q is None:
                rows.append((1, 1, 0))
                continue
            x, y = oracle.te_affine_ints(
                CURVE, oracle.ec_mul(q, 1 << (DBL_SHIFT * j), P))
            rows.append(((y + x) % P, (y - x) % P, k * x * y % P))
    return rows


def test_dbl_chain_table_matches_reference():
    """The plain te_dbl_chain through prepare_points_collapsed builds the
    table of python ints (identity lane included), which the reference's
    table equals (`test_reference_collapse_table_matches_ints`, slow:
    about 18 s of JAX on a CPU)."""
    pts, xs, ys, inf = _dbl_chain_inputs()
    ours = te_path.prepare_points_collapsed(
        CURVE, fp.from_ints(CURVE.field, xs), fp.from_ints(CURVE.field, ys),
        torch.tensor(inf), DBL_SHIFT, DBL_M)
    assert ours.shape == (DBL_M * DBL_N, 3, fp.n_words(CURVE.field))
    got = fp.to_ints(CURVE.field, ours).tolist()
    assert [tuple(int(v) for v in row) for row in got] == (
        _collapse_table_ints(pts))
    ident = te.pack(te.identity_pre(CURVE))
    assert all(torch.equal(ours[j * DBL_N + DBL_IDENT], ident)
               for j in range(DBL_M))


@pytest.mark.slow
def test_reference_collapse_table_matches_ints():
    """The reference's prepare_points_collapsed, carried over with
    prepared_from_reference, equals the python-int table but at the
    identity lane's rows of blocks j >= 1: the reference normalises
    dbl(identity) = (0, -1, -1, 0) with z forced to 1 and stores the
    operand of (0, -1); the port stores the identity operand (1, 1, 0).
    Those rows are never read (identity lanes have zero digits)."""
    pts, xs, ys, inf = _dbl_chain_inputs()
    ref_packed, ref_bad = ref_te_path.prepare_points_collapsed(
        REF_CURVE, ref_fp.from_ints(REF_CURVE.field, xs),
        ref_fp.from_ints(REF_CURVE.field, ys), jnp.asarray(inf), DBL_SHIFT,
        DBL_M)
    assert not bool(ref_bad)
    ref = convert.prepared_from_reference(CURVE, np.asarray(ref_packed), 1,
                                          1, DBL_M, DBL_N, device="cpu")
    got = [tuple(int(v) for v in row)
           for row in fp.to_ints(CURVE.field, ref.table).tolist()]
    expect = _collapse_table_ints(pts)
    keep = [r for r in range(DBL_M * DBL_N)
            if r % DBL_N != DBL_IDENT or r < DBL_N]
    assert [got[r] for r in keep] == [expect[r] for r in keep]


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


def test_running_sum_matches_full_add_loop_and_ints(te_affine):
    """te_running_sum_plain at the new split of W = 2 windows x 1024
    buckets (C = 128 chunks of S = 8): word for word the step-by-step
    te_full_add_plain walk (T = B_7, U = T; then T += B_j, U += T), and
    in value the python ints T = sum_j B_j, U = sum_j (j+1) B_j."""
    c_lanes, s = te_path.triangle_split(2, 1024)
    assert (c_lanes, s) == (128, 8)
    lanes = 2 * c_lanes
    idx = [(7 * l + 3 * j) % N_BASE for l in range(lanes) for j in range(s)]
    pts, _ = _both(_extended_ints(te_affine, idx, 8), (lanes, s))
    t, u = ak.te_running_sum(CURVE, pts)
    skip = torch.zeros(lanes, dtype=torch.int32)
    t_ref = pts[:, s - 1]
    u_ref = t_ref
    for j in range(s - 2, -1, -1):
        t_ref = ak.te_full_add_plain(CURVE, t_ref, pts[:, j].contiguous(),
                                     skip)
        u_ref = ak.te_full_add_plain(CURVE, u_ref, t_ref, skip)
    assert torch.equal(t, t_ref) and torch.equal(u, u_ref)
    g = oracle.generator(CURVE)
    for lane in (0, 1, lanes - 1):
        ks = [idx[lane * s + j] + 1 for j in range(s)]
        for got, k in ((t, sum(ks)), (u, sum((j + 1) * kj
                                             for j, kj in enumerate(ks)))):
            x, y, z = (int(v) for v in fp.to_ints(CURVE.field, got[lane, :3]))
            assert te.te_to_sw_host(CURVE, x, y, z) == (
                *oracle.ec_mul(g, k, P), 1)


def test_triangle_merge_several_windows_matches_ints(te_affine):
    """merge_buckets_te_triangle over 3 windows of 2048 buckets (new split:
    C = 256, S = 8; one te_running_sum walk, the trees and the combines)
    against the python-int value of each window."""
    n_win, nbe = 3, 2048
    assert te_path.triangle_split(n_win, nbe) == (256, 8)
    idx = [[(b * (w + 2) + w) % N_BASE for b in range(nbe)]
           for w in range(n_win)]
    ours, _ = _both(_extended_ints(te_affine, sum(idx, []), 9),
                    (n_win, nbe))
    got = te_path.merge_buckets_te_triangle(CURVE, 12, ours)
    g = oracle.generator(CURVE)
    for w in range(n_win):
        x, y, z = (int(v) for v in fp.to_ints(CURVE.field, got[w, :3]))
        k = sum((b + 1) * (i + 1) for b, i in enumerate(idx[w]))
        assert te.te_to_sw_host(CURVE, x, y, z) == (
            *oracle.ec_mul(g, k % CURVE.order, P), 1)


@pytest.mark.parametrize("n_win, n_buckets, split", [
    (15, 1 << 16, (2048, 32)),     # the 2^26 m = 1 route's full windows
    (1, 1 << 16, (8192, 8)),       # the 2^18 collapsed route (g = 1)
    (16, 1 << 16, (2048, 32)),
    (2, 1024, (128, 8)),
    (600, 1 << 12, (128, 32)),     # many windows: no fewer than 128 chunks
    (1, 512, None),                # below 1024 buckets: no triangle
    (4, 1000, None),
])
def test_triangle_split_fills_the_card(n_win, n_buckets, split):
    """C a power of two, the largest with W * C <= 2^15 lanes and S >= 8
    (at least 128 chunks); None below 1024 buckets."""
    got = te_path.triangle_split(n_win, n_buckets)
    assert got == split
    if got is not None:
        c_lanes, s = got
        assert c_lanes & (c_lanes - 1) == 0 and c_lanes * s == n_buckets
        assert s >= 8 and (n_win * c_lanes <= 1 << 15 or c_lanes == 128)


def test_running_sum_checks_its_input_and_runs_plain_on_cpu(te_affine):
    coords = _extended_ints(te_affine, list(range(12)), 10)
    pts, _ = _both(coords, (3, 4))
    ak.reset_launches()
    t, u = ak.te_running_sum(CURVE, pts)
    t_ref, u_ref = ak.te_running_sum_plain(CURVE, pts)
    assert torch.equal(t, t_ref) and torch.equal(u, u_ref)
    assert t.shape == (3, 4, fp.n_words(CURVE.field))
    assert set(ak.launches.values()) == {0}             # no kernel on CPU
    # S = 1: T = U = the lane's one point
    t1, u1 = ak.te_running_sum(CURVE, pts[:, :1].contiguous())
    assert torch.equal(t1, pts[:, 0]) and torch.equal(u1, pts[:, 0])
    with pytest.raises(TypeError):
        ak.te_running_sum(CURVE, pts.to(torch.int64))
    with pytest.raises(ValueError):                     # (L, 4, nw): no S
        ak.te_running_sum(CURVE, pts[:, 0].contiguous())
    with pytest.raises(ValueError):
        ak.te_running_sum(CURVE, pts[:, :0].contiguous())
    with pytest.raises(ValueError):
        ak.te_running_sum(CURVE, pts.transpose(0, 1))
    with pytest.raises(ValueError):
        ak.te_running_sum(CURVE, pts.to("meta"))


def _bit_merge_case(te_affine):
    """Two windows of 16 buckets: bucket b of window w holds the chain
    point (16w + b)·G at a random projective scale."""
    return _both(_extended_ints(te_affine, list(range(32)), 5), (2, 16))


def test_bit_decomposed_merge_matches_reference(te_affine):
    """merge_buckets_te (two windows of 16 buckets) against python ints:
    window w sums b·(16w + b)·G, mapped onto the TE form; the reference's
    merge gives the same points (`test_reference_bit_decomposed_merge`,
    slow: about 9 s of JAX on a CPU)."""
    ours, _ = _bit_merge_case(te_affine)
    got = te_path.merge_buckets_te(CURVE, 5, ours)
    g = oracle.generator(CURVE)
    assert _affine(got) == [oracle.te_affine_ints(CURVE, oracle.ec_mul(
        g, sum(b * (16 * w + b) for b in range(1, 17)), P))
        for w in range(2)]


@pytest.mark.slow
def test_reference_bit_decomposed_merge(te_affine):
    """The reference's merge_buckets_te on the same two windows equals the
    port's."""
    ours, ref = _bit_merge_case(te_affine)
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


def _port_points(te_affine, idx, seed, shape):
    """The chain points idx at random projective scales, packed (port
    only) in `shape`."""
    coords = _extended_ints(te_affine, idx, seed)
    return te.pack(te.TePoint(*(fp.from_ints(CURVE.field, np.array(
        c, dtype=object).reshape(shape)) for c in coords)))


def _affine_of(k):
    """The TE affine ints of k·G (the identity for k = 0 mod r)."""
    return oracle.te_affine_ints(CURVE, oracle.ec_mul(
        oracle.generator(CURVE), k % CURVE.order, P))


@pytest.mark.parametrize("rows, k, first", [
    (1, 1, None), (1, 1, 0), (1, 1, 1),   # one member (weight 0 has no bit)
    (2, 7, 1),                             # odd K, R > 1
    (1, 64, 0),                            # one whole segment
    (1, 63, 1),                            # weight 63 fills the segment
    (3, 100, 0),                           # two segments, the second ragged
    (2, 200, 1),                           # four segments: the finish's order
    (1, 300, None)],                       # roots only, five segments
    ids=["K1", "K1 first0", "K1 first1", "R2 K7 first1", "K64 first0",
         "K63 first1", "R3 K100 first0", "R2 K200 first1", "K300 root"])
def test_tree_sum_matches_ints(te_affine, rows, k, first):
    """te_tree_sum (plain on the CPU) against python ints: each row's sum
    and every bit sum S_j = sum of the members whose weight first + m has
    bit j, the identity where none has; at first = 0 (the same slots) the
    root words do not depend on whether the bits are asked for."""
    idx = [(5 * r + 3 * m + m * m) % N_BASE for r in range(rows)
           for m in range(k)]
    pts = _port_points(te_affine, idx, 12 + k, (rows, k))
    ak.reset_launches()
    sums, bits = ak.te_tree_sum(CURVE, pts, first)
    assert set(ak.launches.values()) == {0}             # no kernel on CPU
    scal = [[idx[r * k + m] + 1 for m in range(k)] for r in range(rows)]
    assert sums.shape == (rows, 4, fp.n_words(CURVE.field))
    assert _affine(sums) == [_affine_of(sum(row)) for row in scal]
    if first is None:
        assert bits is None
        return
    n_bits = ak.tree_bits(k, first)
    assert n_bits == max(1, (first + k - 1).bit_length())
    assert bits.shape == (n_bits, rows, 4, fp.n_words(CURVE.field))
    for j in range(n_bits):
        assert _affine(bits[j]) == [
            _affine_of(sum(v for m, v in enumerate(row)
                           if (first + m) >> j & 1)) for row in scal], j
    if first == 0:
        assert torch.equal(ak.te_tree_sum(CURVE, pts)[0], sums)


def test_tree_sum_checks_its_input(te_affine):
    pts = _port_points(te_affine, list(range(12)), 13, (3, 4))
    with pytest.raises(TypeError):
        ak.te_tree_sum(CURVE, pts.to(torch.int64))
    with pytest.raises(ValueError):                     # (L, 4, nw): no K
        ak.te_tree_sum(CURVE, pts[:, 0].contiguous())
    with pytest.raises(ValueError):                     # K = 0
        ak.te_tree_sum(CURVE, pts[:, :0].contiguous())
    with pytest.raises(ValueError):
        ak.te_tree_sum(CURVE, pts.transpose(0, 1))
    with pytest.raises(ValueError):
        ak.te_tree_sum(CURVE, pts, -1)
    with pytest.raises(ValueError):
        ak.te_tree_sum(CURVE, pts.to("meta"))


@pytest.mark.parametrize("fold, n_steps, c, depth", [
    (probe.te_combine_depth, 16, 17, 555),    # the 2^26 final combine
    (probe.te_combine_depth, 13, 1, 60),      # a merge tail's fold
    (probe.te_combine_depth, 1, 17, 0),
    (probe.sw_combine_depth, 21, 13, 560)],   # BLS12-381 2^18, c = 13
    ids=["te 16 x c17", "te 13 x c1", "te 1 step", "sw 21 x c13"])
def test_fold_depth_counts_the_critical_path(fold, n_steps, c, depth):
    assert fold(n_steps, c) == depth


def test_mul_chain_matches_ints_and_checks_input():
    """fq_mul_chain: x * y^k per lane (Montgomery words), plain on CPU."""
    f = CURVE.field
    rng = np.random.default_rng(3)
    xs = [int(rng.integers(1 << 62)) * 7919 % f.p for _ in range(3)] + [0]
    ys = [int(rng.integers(1 << 62)) ** 5 % f.p for _ in range(3)] + [1]
    x, y = fp.from_ints(f, xs), fp.from_ints(f, ys)
    probe.reset_launches()
    out = probe.fq_mul_chain(CURVE, x, y, 5)
    assert list(fp.to_ints(f, out)) == [a * pow(b, 5, f.p) % f.p
                                        for a, b in zip(xs, ys)]
    assert torch.equal(probe.fq_mul_chain(CURVE, x, y, 0), x)
    assert set(probe.launches.values()) == {0}          # no kernel on CPU
    with pytest.raises(ValueError):
        probe.fq_mul_chain(CURVE, x, y[:2], 1)
    with pytest.raises(ValueError):
        probe.fq_mul_chain(CURVE, x, y, -1)


def test_imad_chain_matches_ints_and_checks_input():
    """imad_chain: k times v = v a + b mod 2^32 per lane, plain on CPU."""
    rng = np.random.default_rng(4)
    words = [[int(w) for w in rng.integers(0, 1 << 32, 5)] for _ in range(3)]
    words[0][0], words[1][0], words[2][0] = (1 << 32) - 1, (1 << 32) - 1, 7
    x, a, b = (torch.tensor(w, dtype=torch.int64).to(torch.int32)
               for w in words)
    probe.reset_launches()
    out = probe.imad_chain(x, a, b, 70)
    want = []
    for v, m, d in zip(*words):
        for _ in range(70):
            v = (v * m + d) % (1 << 32)
        want.append(v)
    assert [w % (1 << 32) for w in out.tolist()] == want
    assert torch.equal(probe.imad_chain(x, a, b, 0), x)
    assert set(probe.launches.values()) == {0}          # no kernel on CPU
    with pytest.raises(ValueError):
        probe.imad_chain(x, a[:2], b, 1)
    with pytest.raises(ValueError):
        probe.imad_chain(x, a, b, -1)
    with pytest.raises(TypeError):
        probe.imad_chain(x.to(torch.int64), a, b, 1)
