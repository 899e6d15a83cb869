"""The port's plain field engine (zprize_tpu_torch/field/fp.py) against
python ints and the reference package's `field.fp`, on Fq377 and Fr377.

Values are compared as canonical ints, never as limbs: the port keeps
12-word Montgomery rows, the reference redundant base-2^15 planes."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_tpu.field import fp as ref_fp
from zprize_tpu.field import spec as ref_spec
from zprize_tpu_torch import convert
from zprize_tpu_torch.curve.spec import BLS12_377_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.field import spec
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

# small tensors: intra-op threads cost more than they give, and the suite
# runs several workers side by side
torch.set_num_threads(1)


FIELDS = {"fq377": (spec.BLS12_377_FQ, ref_spec.BLS12_377_FQ),
          "fr377": (spec.BLS12_377_FR, ref_spec.BLS12_377_FR)}
N = 48


def _values(f, n, seed):
    """Edge values first (0, 1, p-1, p-2, 2^(bits-1)), then uniform."""
    rng = random.Random(seed)
    p = f.p
    edge = [0, 1, p - 1, p - 2, 1 << (p.bit_length() - 1)]
    return edge + [rng.randrange(p) for _ in range(n - len(edge))]


def _ints(f, a):
    return [int(v) for v in fp.to_ints(f, a).reshape(-1)]


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_op_matches_python_ints(name, op):
    f = FIELDS[name][0]
    a, b = _values(f, N, 1), _values(f, N, 2)[::-1]
    b[:3] = [f.p - 1, 0, f.p - 1]          # pair edges with edges
    got = _ints(f, getattr(fp, op)(f, fp.from_ints(f, a), fp.from_ints(f, b)))
    py = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    assert got == [py(x, y) % f.p for x, y in zip(a, b)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_neg_sqr_pow_match_python_ints(name):
    f = FIELDS[name][0]
    a = _values(f, N, 3)
    ta = fp.from_ints(f, a)
    assert _ints(f, fp.neg(f, ta)) == [(-x) % f.p for x in a]
    assert _ints(f, fp.sqr(f, ta)) == [x * x % f.p for x in a]
    assert _ints(f, fp.pow_const(f, ta, 12345)) == [pow(x, 12345, f.p)
                                                    for x in a]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_inv_and_batch_inv_match_python_ints(name):
    f = FIELDS[name][0]
    a = _values(f, 37, 4)                  # not a power of two; holds 0
    expect = [pow(x, f.p - 2, f.p) for x in a]
    assert _ints(f, fp.batch_inv(f, fp.from_ints(f, a))) == expect
    assert _ints(f, fp.batch_inv(f, fp.from_ints(f, [a[:7]] * 3))) == (
        expect[:7] * 3)
    assert _ints(f, fp.inv(f, fp.from_ints(f, a[:4]))) == expect[:4]


def _redundant_planes(ref_f, n, seed):
    """Reference-form planes with limbs anywhere in [0, 2^16): rows of all
    zeros and all 0xFFFF, then uniform limbs (values may exceed p)."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 1 << 16, size=(n, ref_f.n_limbs),
                          dtype=np.uint32)
    planes[0] = 0
    planes[1] = 0xFFFF
    planes[2] = ref_fp.from_ints_np(ref_f, [ref_f.p - 1])[0]
    return planes


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_op_matches_reference_on_redundant_planes(name, op):
    f, ref_f = FIELDS[name]
    pa, pb = _redundant_planes(ref_f, 16, 5), _redundant_planes(ref_f, 16, 6)
    ref = getattr(ref_fp, op)(ref_f, jnp.asarray(pa), jnp.asarray(pb))
    got = getattr(fp, op)(f, convert.elements_from_reference(f, pa, "cpu"),
                          convert.elements_from_reference(f, pb, "cpu"))
    assert _ints(f, got) == [int(v) for v in ref_fp.to_ints(ref_f, ref)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_converters(name):
    f, ref_f = FIELDS[name]
    a = _values(f, N, 7)
    ta = fp.from_ints(f, a)
    assert ta.dtype == torch.int32 and ta.shape == (N, fp.n_words(f))
    assert _ints(f, ta) == a
    # Montgomery form: the words of x are those of x*R mod p
    big_r = 1 << (32 * fp.n_words(f))
    raw = [int.from_bytes(row.astype(np.uint32).tobytes(), "little")
           for row in ta.numpy()]
    assert raw == [x * big_r % f.p for x in a]
    canon = fp.from_mont(f, ta)
    assert torch.equal(fp.to_mont(f, canon), ta)
    planes = _redundant_planes(ref_f, 8, 8)
    assert _ints(f, convert.elements_from_reference(f, planes, "cpu")) == [
        int(v) for v in ref_fp.to_ints(ref_f, jnp.asarray(planes))]


def test_scalars_from_reference():
    f, ref_f = FIELDS["fr377"]
    planes = _redundant_planes(ref_f, 8, 9)
    got = convert.scalars_from_reference(BLS12_377_G1, planes, "cpu")
    expect = [int(v) for v in ref_fp.to_ints(ref_f, jnp.asarray(planes))]
    assert [sum(int(l) << (15 * k) for k, l in enumerate(row))
            for row in got.numpy()] == expect
    # the benchmark's compact form is canonical: carried over as it is
    compact = oracle.scalar_batch_np(BLS12_377_G1, np.random.default_rng(9), 8)
    assert torch.equal(convert.scalars_from_reference(BLS12_377_G1, compact,
                                                      "cpu"),
                       torch.from_numpy(compact.astype(np.int32)))


def test_points_from_reference():
    f, ref_f = FIELDS["fq377"]
    pts = oracle.generator_chain(BLS12_377_G1, 4)
    xs, ys = [q[0] for q in pts], [q[1] for q in pts]
    inf = [False, True, False, False]
    got = convert.points_from_reference(
        BLS12_377_G1, ref_fp.from_ints_np(ref_f, xs),
        ref_fp.from_ints_np(ref_f, ys), inf, device="cpu")
    assert _ints(f, got.x) == xs and _ints(f, got.y) == ys
    assert got.inf.tolist() == inf


def test_field_specs_are_copies():
    for ours, theirs in zip(spec.ALL_SPECS, ref_spec.ALL_SPECS):
        assert (ours.name, ours.p, ours.generator, ours.n_limbs) == (
            theirs.name, theirs.p, theirs.generator, theirs.n_limbs)


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_small_cpu_batches_on_ints_equal_the_digit_engine(name, op):
    """Inside `fp.python_ints` a CPU op runs on python ints and gives the
    digit engine's words, broadcasting included; outside it the digit
    engine runs."""
    f = FIELDS[name][0]
    a = fp.from_ints(f, _values(f, N, 5)).reshape(6, 8, -1)
    b = fp.from_ints(f, _values(f, 8, 6))
    assert fp._host_op(f, a, b, lambda x, y: 0) is None
    want = getattr(fp, op)(f, a, b)
    with fp.python_ints():
        assert fp._host_op(f, a, b, lambda x, y: 0) is not None
        got = getattr(fp, op)(f, a, b)
    assert torch.equal(got, want)
    assert fp._host_op(f, a, b, lambda x, y: 0) is None
