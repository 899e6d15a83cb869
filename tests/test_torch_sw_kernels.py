"""The plain versions of the SW route's merge and combine kernels
(msm/accum_kernel.py: sw_running_sum, sw_tree_sum, sw_combine), the
dedicated a = 0 doubling they use (curve/sw.py: dbl_a0) and the merges
built on them (msm/pippenger.py: merge_buckets_all, the slice sums of
window_sums_sw), against step-by-step walks of `sw_full_add_plain` (word
for word) and python-int oracles, on the CPU.  The hand-written kernels
are held against these plain versions on the card by chip_smoke.py,
phases 3d and 3e.  Exact: tolerance 0."""

import pytest
import torch

from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1, TOY_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import accum_kernel as ak
from zprize_tpu_torch.msm import pippenger, te_path
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

CURVES = {"bls12_377": BLS12_377_G1, "bls12_381": BLS12_381_G1}
CHAIN = 64                       # points k·G, k = 1..CHAIN


def _multiples(curve, ks):
    """Python ints k (0 <= k <= CHAIN, 0 the identity) -> the packed
    projective points k·G, shape (*ks.shape, 3, nw), with a projective
    scale that differs from lane to lane (Z != 1)."""
    f = curve.field
    chain = [None] + oracle.generator_chain(curve, CHAIN)
    flat = [chain[k] for k in torch.as_tensor(ks).reshape(-1).tolist()]
    aff = sw.Affine(fp.from_ints(f, [0 if p is None else p[0] for p in flat]),
                    fp.from_ints(f, [1 if p is None else p[1] for p in flat]),
                    torch.tensor([p is None for p in flat]))
    lam = fp.from_ints(f, [3 + 2 * i for i in range(len(flat))])
    p = sw.from_affine(curve, aff)
    p = sw.Point(*(fp.mul(f, c, lam) for c in p))
    return sw.pack(p).reshape(*torch.as_tensor(ks).shape, 3, fp.n_words(f))


def _ints(curve, packed):
    """Packed points (..., 3, nw) -> [(x, y) | None], lane by lane."""
    flat = packed.reshape(-1, *packed.shape[-2:])
    return [sw.to_affine_ints(curve, sw.unpack(flat[i]))
            for i in range(flat.shape[0])]


def _times_g(curve, ks):
    """[k] -> [k·G | None] on python ints."""
    g = oracle.generator(curve)
    return [oracle.ec_mul(g, k % curve.order, curve.field.p) for k in ks]


@pytest.mark.parametrize("name", sorted(CURVES))
def test_dedicated_doubling_matches_complete_add_and_ints(name):
    """dbl_a0 (RCB Algorithm 9) gives the point of the complete add p + p
    (other projective words), the identity included."""
    curve = CURVES[name]
    ks = [1, 2, 5, 17, 64, 0]
    p = sw.unpack(_multiples(curve, ks))
    d = sw.dbl_a0(curve, p)
    assert bool(sw.eq(curve, d, sw.dbl(curve, p)).all())
    assert _ints(curve, sw.pack(d)) == _times_g(curve, [2 * k for k in ks])


@pytest.mark.parametrize("name", sorted(CURVES))
def test_combine_plain_matches_walk_and_ints(name):
    """sw_combine_plain over 2 lanes x 4 windows at c = 3: word for word
    the walk of c dbl_a0 and one sw_full_add_plain a window, and
    sum_w 2^(3w) W_w on python ints.  Lane 0 has an identity window; in
    lane 1 the window added after the first doublings equals the
    accumulator (2^3 W_3), so that add is a doubling."""
    curve = CURVES[name]
    c = 3
    ks = torch.tensor([[5, 7], [0, 11], [9, 8 * 3], [2, 3]])     # (S, L)
    ws = _multiples(curve, ks)
    ws[2, 1] = sw.pack(sw.dbl_a0(curve, sw.dbl_a0(curve, sw.dbl_a0(
        curve, sw.unpack(ws[3, 1])))))
    got = ak.sw_combine_plain(curve, ws, c)
    acc = ws[-1].clone()
    skip = torch.zeros(2, dtype=torch.int32)
    for w in range(2, -1, -1):
        for _ in range(c):
            acc = sw.pack(sw.dbl_a0(curve, sw.unpack(acc)))
        ak.sw_full_add_plain(curve, acc, ws[w].contiguous(), skip)
    assert torch.equal(got, acc)
    expect = [sum(int(ks[w, lane]) << (c * w) for w in range(4))
              for lane in range(2)]
    assert _ints(curve, got) == _times_g(curve, expect)
    assert torch.equal(ak.sw_combine(curve, ws, c), got)


def test_running_sum_plain_matches_walk_and_ints():
    """sw_running_sum_plain over 3 lanes x 8 steps: word for word the
    walk of sw_full_add_plain from the top (T += B_j, U += T), and
    T = sum_j B_j, U = sum_j (j+1) B_j on python ints.  Lane 1 holds
    identities, lane 2 one point repeated (T doubles through the add)."""
    curve = BLS12_381_G1
    ks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6],
                       [0, 7, 0, 0, 8, 0, 0, 0],
                       [13] * 8])
    pts = _multiples(curve, ks)
    pts[2] = pts[2, 0]                       # the same words at every step
    t_got, u_got = ak.sw_running_sum_plain(curve, pts)
    skip = torch.zeros(3, dtype=torch.int32)
    t = pts[:, -1].clone()
    u = t.clone()
    for j in range(6, -1, -1):
        ak.sw_full_add_plain(curve, t, pts[:, j].contiguous(), skip)
        ak.sw_full_add_plain(curve, u, t, skip)
    assert torch.equal(t_got, t) and torch.equal(u_got, u)
    assert _ints(curve, t_got) == _times_g(curve, ks.sum(1).tolist())
    assert _ints(curve, u_got) == _times_g(curve, [
        sum((j + 1) * k for j, k in enumerate(row)) for row in ks.tolist()])
    got = ak.sw_running_sum(curve, pts)
    assert torch.equal(got[0], t_got) and torch.equal(got[1], u_got)


def _count(monkeypatch, name):
    calls = []
    fn = getattr(pippenger, name)
    monkeypatch.setattr(pippenger, name,
                        lambda *a: calls.append(1) or fn(*a))
    return calls


@pytest.mark.parametrize("name", sorted(CURVES))
@pytest.mark.parametrize("rows, k, first", [
    (1, 1, None), (1, 1, 1),               # one member
    (2, 64, 0),                            # one whole segment
    (1, 63, 1),                            # weight 63 fills the segment
    (2, 200, 1),                           # four segments, the last ragged
    (1, 130, None)],                       # roots only, three segments
    ids=["K1", "K1 first1", "R2 K64 first0", "K63 first1", "R2 K200 first1",
         "K130 root"])
def test_tree_sum_plain_matches_ints(name, rows, k, first):
    """sw_tree_sum (plain on the CPU) against python ints: each row's sum
    and every bit sum S_j = sum of the members whose weight first + m has
    bit j, the identity where none has; members k·G with k in 0..64 (0 the
    identity) at lane-varying projective scales; at first = 0 the root
    words do not depend on whether the bits are asked for."""
    curve = CURVES[name]
    ks = (torch.arange(rows * k).reshape(rows, k) * 11 + 5 * rows) % (
        CHAIN + 1)
    pts = _multiples(curve, ks)
    ak.reset_launches()
    sums, bits = ak.sw_tree_sum(curve, pts, first)
    assert set(ak.launches.values()) == {0}             # no kernel on CPU
    assert _ints(curve, sums) == _times_g(curve, ks.sum(1).tolist())
    if first is None:
        assert bits is None
        return
    n_bits = ak.tree_bits(k, first)
    assert bits.shape == (n_bits, rows, 3, fp.n_words(curve.field))
    for j in range(n_bits):
        assert _ints(curve, bits[j]) == _times_g(curve, [
            sum(v for m, v in enumerate(row) if (first + m) >> j & 1)
            for row in ks.tolist()]), j
    if first == 0:
        assert torch.equal(ak.sw_tree_sum(curve, pts)[0], sums)


def _count(monkeypatch, name):
    calls = []
    fn = getattr(pippenger, name)
    monkeypatch.setattr(pippenger, name,
                        lambda *a: calls.append(1) or fn(*a))
    return calls


@pytest.mark.parametrize("n_win, nbe, running_sum", [(2, 1024, True),
                                                     (3, 64, False)])
def test_merge_matches_ints(monkeypatch, n_win, nbe, running_sum):
    """merge_buckets_all: sum_b b·B_b per window on python ints, through
    the chunked running sum at 2 windows x 1024 buckets (the split of
    te_path.triangle_split: 128 chunks of 8; two sw_tree_sum calls, the U
    root and the T_q's bit sums) and through the bit sums of one
    sw_tree_sum call at 3 x 64; either way one sw_combine fold."""
    curve = BLS12_381_G1
    ks = (torch.arange(n_win * nbe).reshape(n_win, nbe) * 7 + 3) % (CHAIN + 1)
    sums = _multiples(curve, ks)
    rs = _count(monkeypatch, "sw_running_sum")
    tree = _count(monkeypatch, "sw_tree_sum")
    cb = _count(monkeypatch, "sw_combine")
    merged = pippenger.merge_buckets_all(curve, 13, sums)
    assert (te_path.triangle_split(n_win, nbe) is not None) == running_sum
    assert (len(rs), len(tree), len(cb)) == (int(running_sum),
                                             1 + int(running_sum), 1)
    assert _ints(curve, merged) == _times_g(curve, [
        sum((b + 1) * k for b, k in enumerate(row)) for row in ks.tolist()])


def test_window_sums_sliced_match_ints(monkeypatch):
    """window_sums_sw on a group whose longest run exceeds its target
    (every point of row 0 in bucket 3, some negated): the points are cut
    into slices, each slice's window sum merged on its own, and the
    slices' sums added by one roots-only sw_tree_sum call; each row's sum
    is sum_i d_i·P_i on python ints, P_i = (i+1)·G."""
    curve = BLS12_381_G1
    n, c = 130, 4
    chain = oracle.generator_chain(curve, n)
    px = fp.from_ints(curve.field, [q[0] for q in chain])
    py = fp.from_ints(curve.field, [q[1] for q in chain])
    g = torch.Generator().manual_seed(3)
    digits = torch.stack([
        torch.where(torch.arange(n) % 5 == 1, -3, 3),
        torch.randint(-8, 8, (n,), generator=g)]).to(torch.int32)
    digits[0, 7] = 0
    tree = _count(monkeypatch, "sw_tree_sum")
    got = pippenger.window_sums_sw(curve, c, px, py, digits, {8: [0, 1]})
    assert len(tree) == 2                  # the narrow merge, the slice sum
    assert _ints(curve, got) == _times_g(curve, [
        sum(int(d) * (i + 1) for i, d in enumerate(row))
        for row in digits.tolist()])


def test_new_wrappers_check_their_inputs():
    curve = BLS12_381_G1
    pts = torch.zeros((4, 8, 3, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="pts"):
        ak.sw_running_sum(curve, pts[0])
    with pytest.raises(ValueError, match="pts"):
        ak.sw_running_sum(curve, pts[..., :8].contiguous())
    with pytest.raises(TypeError):
        ak.sw_running_sum(curve, pts.long())
    with pytest.raises(ValueError, match="contiguous"):
        ak.sw_running_sum(curve, pts[:, ::2])
    with pytest.raises(ValueError, match="window_sums"):
        ak.sw_combine(curve, pts[0], 2)
    with pytest.raises(ValueError, match="window_sums"):
        ak.sw_combine(curve, pts[:0], 2)
    with pytest.raises(ValueError, match="unsupported device"):
        ak.sw_combine(curve, pts.to("meta"), 2)
    with pytest.raises(ValueError, match="pts"):         # (L, 3, nw): no K
        ak.sw_tree_sum(curve, pts[0])
    with pytest.raises(ValueError, match="pts"):         # K = 0
        ak.sw_tree_sum(curve, pts[:, :0].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ak.sw_tree_sum(curve, pts.transpose(0, 1))
    with pytest.raises(ValueError, match="first"):
        ak.sw_tree_sum(curve, pts, -1)
    with pytest.raises(TypeError):
        ak.sw_tree_sum(curve, pts.long())
    # the kernels' instantiations: 3b = 3 (BLS12-377) and 12 (BLS12-381)
    assert [ak._sw_b3(c) for c in (BLS12_377_G1, BLS12_381_G1)] == [3, 12]
    with pytest.raises(ValueError, match="3b"):
        ak._sw_b3(TOY_G1)
