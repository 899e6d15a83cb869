"""The port's twisted-Edwards form (zprize_tpu_torch/curve/te.py) against
the reference package's `curve.te` on the same 64 lanes (G-chain points,
one identity lane).

Both sides run the same formulas with exact field arithmetic, so even the
projective coordinates agree; they are compared as canonical ints."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_tpu.curve import te as ref_te
from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
from zprize_tpu.field import fp as ref_fp
from zprize_tpu_torch.curve import sw, te
from zprize_tpu_torch.curve.spec import BLS12_377_G1 as CURVE
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import pippenger
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

# small tensors: intra-op threads cost more than they give, and the suite
# runs several workers side by side
torch.set_num_threads(1)

N = 64
IDENT = 5


def _ints(a):
    return [int(v) for v in fp.to_ints(CURVE.field, a).reshape(-1)]


def _ref_ints(a):
    return [int(v) for v in ref_fp.to_ints(REF_CURVE.field, a).reshape(-1)]


def _both(values):
    """Python ints -> (port Montgomery words, reference planes)."""
    return (fp.from_ints(CURVE.field, values),
            ref_fp.from_ints(REF_CURVE.field, values))


@pytest.fixture(scope="module")
def lanes():
    pts = oracle.generator_chain(CURVE, N)
    pts[IDENT] = None
    xs = [0 if p is None else p[0] for p in pts]
    ys = [1 if p is None else p[1] for p in pts]
    inf = [p is None for p in pts]
    (x, rx), (y, ry) = _both(xs), _both(ys)
    ours = te.sw_to_te(CURVE, x, y, torch.tensor(inf))
    ref = ref_te.sw_to_te(REF_CURVE, rx, ry, jnp.asarray(inf))
    return pts, ours, ref


def test_sw_to_te_and_precompute_match_reference(lanes):
    _, (tx, ty, bad), (rtx, rty, rbad) = lanes
    assert _ints(tx) == _ref_ints(rtx)
    assert _ints(ty) == _ref_ints(rty)
    assert bad.tolist() == np.asarray(rbad).tolist() == [False] * N
    ours = te.precompute(CURVE, tx, ty)
    ref = ref_te.precompute(REF_CURVE, rtx, rty)
    for a, b in zip(ours, ref):
        assert _ints(a) == _ref_ints(b)


def _extended(tx, ty, scale_seed):
    """Affine TE lanes -> extended points with a random projective scale
    (python ints), on both sides."""
    rng = np.random.default_rng(scale_seed)
    p = CURVE.field.p
    xs, ys = _ints(tx), _ints(ty)
    lam = [int(v) + 1 for v in rng.integers(0, 1 << 62, size=len(xs))]
    coords = [[l * x % p for l, x in zip(lam, xs)],
              [l * y % p for l, y in zip(lam, ys)],
              [l % p for l in lam],
              [l * x * y % p for l, x, y in zip(lam, xs, ys)]]
    pairs = [_both(c) for c in coords]
    return (te.TePoint(*(a for a, _ in pairs)),
            ref_te.TePoint(*(b for _, b in pairs)))


@pytest.mark.parametrize("op", ["add_mixed", "add", "dbl"])
def test_group_law_matches_reference(lanes, op):
    _, (tx, ty, _), (rtx, rty, _) = lanes
    p1, rp1 = _extended(tx, ty, 1)
    if op == "dbl":
        out, ref = te.dbl(CURVE, p1), ref_te.dbl(REF_CURVE, rp1)
    elif op == "add":
        # second operand: the lanes rolled by 3 (and lane 0 + itself)
        p2, rp2 = _extended(tx, ty, 2)
        roll = list(range(3, N)) + [0, 1, 2]
        roll[0] = 0
        p2 = te.TePoint(*(a[roll] for a in p2))
        rp2 = ref_te.TePoint(*(a[jnp.asarray(roll)] for a in rp2))
        out, ref = te.add(CURVE, p1, p2), ref_te.add(REF_CURVE, rp1, rp2)
    else:
        pre = te.precompute(CURVE, tx, ty)
        rpre = ref_te.precompute(REF_CURVE, rtx, rty)
        sign = torch.arange(N) % 3 == 1
        pre = te.select_neg_pre(CURVE, sign, pre)
        rpre = ref_te.select_neg_pre(REF_CURVE, jnp.asarray(sign.numpy()),
                                     rpre)
        out = te.add_mixed(CURVE, p1, pre)
        ref = ref_te.add_mixed(REF_CURVE, rp1, rpre)
    for a, b in zip(out, ref):
        assert _ints(a) == _ref_ints(b)


def test_te_to_sw_host_round_trip(lanes):
    pts, (tx, ty, _), _ = lanes
    p1, _ = _extended(tx, ty, 3)
    xs, ys, zs = _ints(p1.x), _ints(p1.y), _ints(p1.z)
    for i, pt in enumerate(pts):
        got = te.te_to_sw_host(CURVE, xs[i], ys[i], zs[i])
        assert got == ref_te.te_to_sw_host(REF_CURVE, xs[i], ys[i], zs[i])
        expect = (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
        assert got == expect
    # TE (0, -1) is the 2-torsion point (alpha, 0)
    p = CURVE.field.p
    assert te.te_to_sw_host(CURVE, 0, p - 1, 1) == (
        te.te_params(CURVE).alpha, 0, 1)


def test_te_params_match_reference():
    assert te.te_params(CURVE)[1:] == ref_te.te_params(REF_CURVE)[1:]


def test_exceptional_point_raises():
    """(alpha, 0) = (-1, 0) lies on y^2 = x^3 + 1 (outside G1) and has no
    TE image: it is flagged and the init refuses it."""
    p = CURVE.field.p
    xs = [p - 1, CURVE.gen_x]
    ys = [0, CURVE.gen_y]
    x, y = fp.from_ints(CURVE.field, xs), fp.from_ints(CURVE.field, ys)
    inf = torch.zeros(2, dtype=torch.bool)
    _, _, bad = te.sw_to_te(CURVE, x, y, inf)
    assert bad.tolist() == [True, False]
    with pytest.raises(ValueError, match="exceptional"):
        pippenger.prepare_points(CURVE, sw.Affine(x, y, inf), c=8)
