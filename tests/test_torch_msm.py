"""The port's whole MSM slice through its user entry points
(`msm/api.py`, CPU route) against the reference package's MSM and the
python-int oracle.

Points are the generator chain P_i = (i+1)·G with one identity lane, so
the oracle is one scalar multiplication: (sum_i s_i·(i+1) mod r)·G."""

import hashlib

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

# the reference package's collapsed MSM (prepare_points(collapse=True),
# then msm: about 24 s of JAX compile and run here) on `_inputs(256, 11)`;
# test_pinned_reference_msm_at_256 re-derives it
REF_XY_256 = (
    0x002202FDCF91F6095FF930F66E91EA7E1310D7E03D28D4C11E616053F5A157FB3D1EF58CFD9A0031D1667333296B3743,
    0x00705566583A9B33D9247368DF71D5115F64CDE061F8482909182BF8B5D35E189EB2D8BDBA97403FCDEBA89FE7000D06)
# sha256 of that run's collapsed table (m*n = 6144 rows) as this port's
# Montgomery words, over the rows both packages read;
# test_pinned_reference_table_at_256 re-derives it
REF_TABLE_256_SHA256 = (
    "688a8293b2079887aa227a068c2044d9fe0020aedc42e52316a59ca7b53c3901")


def _inputs(n, seed):
    pts = oracle.generator_chain(CURVE, n)
    pts[IDENT] = None
    scalars = oracle.scalar_batch_np(CURVE, np.random.default_rng(seed), n)
    ints = [sum(int(v) << (15 * k) for k, v in enumerate(row))
            for row in scalars]
    ints[IDENT] = 0                     # the identity lane adds nothing
    return pts, scalars, oracle.chain_msm(CURVE, ints)


def _ref_affine(pts):
    return ref_sw.Affine(
        ref_fp.from_ints(REF_CURVE.field, [0 if p is None else p[0]
                                           for p in pts]),
        ref_fp.from_ints(REF_CURVE.field, [1 if p is None else p[1]
                                           for p in pts]),
        jnp.asarray([p is None for p in pts]))


@pytest.fixture(scope="module")
def slice_256():
    """n = 2^8 (c = 11, g = 1, m = 24: the triangle merge): the port's
    context and result."""
    pts, scalars, expect = _inputs(256, 11)
    ctx = api.multi_scalar_mult_init(CURVE, pts, device="cpu")
    ours = api.multi_scalar_mult(ctx, scalars)[0]
    return ctx, scalars, ours, expect


def test_slice_matches_reference_at_256(slice_256):
    ctx, _, ours, expect = slice_256
    p = ctx.prepared
    assert (p.c, p.g, p.m) == ref_pippenger.plan_collapse(REF_CURVE, 256) == (
        11, 1, 24)
    assert sw.to_affine_ints(CURVE, ours) == REF_XY_256 == expect


@pytest.mark.slow
def test_pinned_reference_msm_at_256():
    pts, scalars, _ = _inputs(256, 11)
    ref_aff = _ref_affine(pts)
    ref_prep = ref_pippenger.prepare_points(REF_CURVE, ref_aff,
                                            collapse=True)
    assert (ref_prep.c, ref_prep.g, ref_prep.m) == (11, 1, 24)
    ref_res = ref_sw.to_affine(REF_CURVE, ref_pippenger.msm(
        REF_CURVE, ref_aff, jnp.asarray(scalars), prepared=ref_prep))
    assert (int(ref_fp.to_ints(REF_CURVE.field, ref_res.x)[()]),
            int(ref_fp.to_ints(REF_CURVE.field, ref_res.y)[()])) == REF_XY_256


def _kept_rows(p):
    """The table rows the reference and the port agree on: all but the
    identity lane's unread rows at blocks j >= 1 (see
    test_torch_msm_kernels.test_dbl_chain_table_matches_reference)."""
    return [r for r in range(p.m * p.n) if r % p.n != IDENT or r < p.n]


def _table_digest(table):
    return hashlib.sha256(table.numpy().tobytes()).hexdigest()


def _packed_like_reference(table):
    """A (m*n, 3, nw) table -> the reference's `PreparedTe.packed` layout,
    (3h, m*n) with each plane's canonical limbs u16-packed in split-half
    order (limb j in the low half of word j, limb j + h in the high)."""
    h = (CURVE.field.n_limbs + 1) // 2
    limbs = convert.elements_to_reference(CURVE.field, table)
    limbs = np.pad(limbs, ((0, 0), (0, 0), (0, 2 * h - limbs.shape[-1])))
    words = limbs[..., :h] | (limbs[..., h:] << 16)
    return words.reshape(table.shape[0], 3 * h).T.astype(np.uint32)


def test_table_carried_from_reference_gives_same_msm(slice_256):
    """The port's table equals the reference's on the rows both read (its
    pinned digest; test_pinned_reference_table_at_256 carries the
    reference's own table and re-derives it), comes back through
    `convert.prepared_from_reference` from the reference's layout, and the
    carried table gives the same MSM."""
    ctx, scalars, ours, _ = slice_256
    p = ctx.prepared
    assert _table_digest(p.table[_kept_rows(p)]) == REF_TABLE_256_SHA256
    carried = convert.prepared_from_reference(
        CURVE, _packed_like_reference(p.table), p.c, p.g, p.m, p.n,
        device="cpu")
    assert torch.equal(carried.table, p.table)
    res = pippenger.msm(CURVE, ctx.points,
                        convert.scalars_from_reference(CURVE, scalars, "cpu"),
                        prepared=carried)
    assert sw.to_affine_ints(CURVE, res) == sw.to_affine_ints(CURVE, ours)


@pytest.mark.slow
def test_pinned_reference_table_at_256(slice_256):
    """The reference's collapsed table (prepare_points(collapse=True), about
    27 s here) carried into the port: its digest on the rows both read is
    the pinned one, and the MSM over it (the reference's identity rows
    included) equals the port's."""
    ctx, scalars, ours, _ = slice_256
    pts, _, _ = _inputs(256, 11)
    ref_prep = ref_pippenger.prepare_points(REF_CURVE, _ref_affine(pts),
                                            collapse=True)
    carried = convert.prepared_from_reference(
        CURVE, np.asarray(ref_prep.packed), ref_prep.c, ref_prep.g,
        ref_prep.m, ref_prep.n, device="cpu")
    p = ctx.prepared
    assert _table_digest(carried.table[_kept_rows(p)]) == REF_TABLE_256_SHA256
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
    """Every MSM route of the reference now runs in the port: the m = 1
    plans build their table (held in test_torch_msm_m1.py), a curve with
    no TE form (BLS12-381) takes the SW route, and the jittable forms run
    on the SW kernels (held in test_torch_msm_sw.py), here as far as their
    occupancy guard.  What still raises: te=True on a curve with no TE
    form."""
    pts = oracle.generator_chain(CURVE, 16)
    aff = sw.Affine(fp.from_ints(CURVE.field, [p[0] for p in pts]),
                    fp.from_ints(CURVE.field, [p[1] for p in pts]),
                    torch.zeros(16, dtype=torch.bool))
    prep = pippenger.prepare_points(CURVE, aff, collapse=False)
    assert (prep.c, prep.g, prep.m) == (4, 65, 1)
    prep = pippenger.prepare_points(CURVE, aff, c=8, budget_bytes=1)
    assert (prep.c, prep.g, prep.m) == (8, 33, 1)       # budget -> m = 1
    assert tuple(prep.table.shape) == (16, 3, 12)
    pts381 = oracle.generator_chain(BLS12_381_G1, 16)
    ctx = api.multi_scalar_mult_init(BLS12_381_G1, pts381, device="cpu")
    assert isinstance(ctx.prepared, pippenger.PreparedSw)
    assert ctx.prepared.c == 4 and ctx.prepared.x.shape == (16, 12)
    with pytest.raises(ValueError, match="no twisted-Edwards form"):
        api.multi_scalar_mult_init(BLS12_381_G1, pts381, device="cpu",
                                   te=True)
    equal = torch.ones((16, CURVE.scalar.n_limbs), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="occupancy"):
        pippenger.msm_jit_static(CURVE, aff, equal, 4, 2)
    with pytest.raises(RuntimeError, match="occupancy"):
        pippenger.msm_jit_batch(CURVE, aff, equal[None], 4, 2)
