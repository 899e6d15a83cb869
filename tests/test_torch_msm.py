"""The port's whole MSM slice through its user entry points
(`msm/api.py`, CPU route) against the reference package's MSM and the
python-int oracle.

Points are the generator chain P_i = (i+1)·G with one identity lane, so
the oracle is one scalar multiplication: (sum_i s_i·(i+1) mod r)·G."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_tpu.curve import sw as ref_sw
from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
from zprize_tpu.field import fp as ref_fp
from zprize_tpu.msm import pippenger as ref_pippenger
from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1 as CURVE
from zprize_tpu_torch.curve.spec import BLS12_381_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.msm import api, pippenger
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

# small tensors: intra-op threads cost more than they give, and the suite
# runs several workers side by side
torch.set_num_threads(1)

IDENT = 3


def _inputs(n, seed):
    pts = oracle.generator_chain(CURVE, n)
    pts[IDENT] = None
    scalars = oracle.scalar_batch_np(CURVE, np.random.default_rng(seed), n)
    ints = [sum(int(v) << (15 * k) for k, v in enumerate(row))
            for row in scalars]
    ints[IDENT] = 0                     # the identity lane adds nothing
    return pts, scalars, oracle.chain_msm(CURVE, ints)


@pytest.fixture(scope="module")
def slice_256():
    """n = 2^8 (c = 11, g = 1, m = 24: the triangle merge): the port's
    context and result, and the reference package's collapsed MSM."""
    pts, scalars, expect = _inputs(256, 11)
    ctx = api.multi_scalar_mult_init(CURVE, pts, device="cpu")
    ours = api.multi_scalar_mult(ctx, scalars)[0]
    ref_aff = ref_sw.Affine(
        ref_fp.from_ints(REF_CURVE.field, [0 if p is None else p[0]
                                           for p in pts]),
        ref_fp.from_ints(REF_CURVE.field, [1 if p is None else p[1]
                                           for p in pts]),
        jnp.asarray([p is None for p in pts]))
    ref_prep = ref_pippenger.prepare_points(REF_CURVE, ref_aff,
                                            collapse=True)
    ref_res = ref_pippenger.msm(REF_CURVE, ref_aff, jnp.asarray(scalars),
                               prepared=ref_prep)
    ref_res = ref_sw.to_affine(REF_CURVE, ref_res)
    ref_xy = (int(ref_fp.to_ints(REF_CURVE.field, ref_res.x)[()]),
              int(ref_fp.to_ints(REF_CURVE.field, ref_res.y)[()]))
    return ctx, scalars, ours, ref_prep, ref_xy, expect


def test_slice_matches_reference_at_256(slice_256):
    ctx, _, ours, ref_prep, ref_xy, expect = slice_256
    p = ctx.prepared
    assert (p.c, p.g, p.m) == (ref_prep.c, ref_prep.g, ref_prep.m) == (
        11, 1, 24)
    assert sw.to_affine_ints(CURVE, ours) == ref_xy == expect


def test_table_carried_from_reference_gives_same_msm(slice_256):
    ctx, scalars, ours, ref_prep, _, _ = slice_256
    carried = convert.prepared_from_reference(
        CURVE, np.asarray(ref_prep.packed), ref_prep.c, ref_prep.g,
        ref_prep.m, ref_prep.n, device="cpu")
    p = ctx.prepared
    # equal but for the identity lane's unread rows at blocks j >= 1
    # (see test_torch_msm_kernels.test_dbl_chain_table_matches_reference)
    keep = [r for r in range(p.m * p.n) if r % p.n != IDENT or r < p.n]
    assert torch.equal(carried.table[keep], p.table[keep])
    res = pippenger.msm(CURVE, ctx.points,
                        convert.scalars_from_reference(CURVE, scalars, "cpu"),
                        prepared=carried)
    assert sw.to_affine_ints(CURVE, res) == sw.to_affine_ints(CURVE, ours)


def test_slice_matches_oracle_bit_decomposed_merge():
    """n = 2^6: c = 8, g = 1, m = 33, below the triangle's 1024 buckets."""
    pts, scalars, expect = _inputs(64, 12)
    ctx = api.multi_scalar_mult_init(CURVE, pts, device="cpu")
    assert (ctx.prepared.c, ctx.prepared.g, ctx.prepared.m) == (8, 1, 33)
    res = api.multi_scalar_mult(ctx, torch.from_numpy(
        scalars.astype(np.int32)))
    assert len(res) == 1
    assert sw.to_affine_ints(CURVE, res[0]) == expect


def test_slice_matches_oracle_with_two_bucket_sets():
    """n = 2^8 with c = 8 and a table budget of 17 multiples: g = 2, so
    windows j*g + gi fold onto two bucket sets over an m = 17 table."""
    n = 256
    pts, scalars, expect = _inputs(n, 13)
    aff = sw.Affine(
        fp.from_ints(CURVE.field, [0 if p is None else p[0] for p in pts]),
        fp.from_ints(CURVE.field, [1 if p is None else p[1] for p in pts]),
        torch.tensor([p is None for p in pts]))
    prep = pippenger.prepare_points(CURVE, aff, c=8,
                                    budget_bytes=17 * n * 3 * 13 * 4)
    assert (prep.c, prep.g, prep.m) == (8, 2, 17)
    res = pippenger.msm(CURVE, aff, torch.from_numpy(
        scalars.astype(np.int32)), prepared=prep)
    assert sw.to_affine_ints(CURVE, res) == expect


@pytest.mark.parametrize("log_n, plan", [(6, (8, 1, 33)), (8, (11, 1, 24)),
                                         (18, (17, 1, 16)), (22, (17, 3, 6)),
                                         (24, (17, 16, 1)), (26, (17, 16, 1))])
def test_plans_match_reference(log_n, plan):
    n = 1 << log_n
    assert pippenger.plan_collapse(CURVE, n) == plan
    assert ref_pippenger.plan_collapse(REF_CURVE, n) == plan


@pytest.mark.parametrize("c", [8, 11, 17])
def test_signed_digits_match_reference(c):
    scalars = oracle.scalar_batch_np(CURVE, np.random.default_rng(c), 32)
    scalars[0] = 0
    n_win = pippenger.num_windows(CURVE, c)
    ours = pippenger.signed_digits(CURVE, c, n_win,
                                   torch.from_numpy(scalars.astype(np.int32)))
    ref = ref_pippenger.signed_digits(REF_CURVE, c, n_win,
                                      jnp.asarray(scalars))
    assert ours.tolist() == np.asarray(ref).tolist()


def test_unported_routes_raise():
    """The m = 1 plans now build their table (the route is held in
    test_torch_msm_m1.py); the SW route and the jittable forms raise,
    naming their ROADMAP item."""
    pts = oracle.generator_chain(CURVE, 16)
    aff = sw.Affine(fp.from_ints(CURVE.field, [p[0] for p in pts]),
                    fp.from_ints(CURVE.field, [p[1] for p in pts]),
                    torch.zeros(16, dtype=torch.bool))
    prep = pippenger.prepare_points(CURVE, aff, collapse=False)
    assert (prep.c, prep.g, prep.m) == (4, 65, 1)
    prep = pippenger.prepare_points(CURVE, aff, c=8, budget_bytes=1)
    assert (prep.c, prep.g, prep.m) == (8, 33, 1)       # budget -> m = 1
    assert tuple(prep.table.shape) == (16, 3, 12)
    with pytest.raises(NotImplementedError, match="short-Weierstrass"):
        api.multi_scalar_mult_init(BLS12_381_G1, [], device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        pippenger.msm_jit_static(CURVE, aff, None)
    with pytest.raises(NotImplementedError, match="item 11"):
        pippenger.msm_jit_batch(CURVE, aff, None)
