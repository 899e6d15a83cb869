"""The port's NTT (zprize_tpu_torch/ntt) against python ints and the
reference package's `ntt`, on the CPU, where `fr_ntt` runs its plain
version (the hand-written kernel is held against that plain version on the
card by chip_smoke.py, phase 3b).  Exact: values compare as canonical
ints."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zprize_tpu.field import fp as ref_fp
from zprize_tpu.field import spec as ref_spec
from zprize_tpu.ntt import domain as ref_domain
from zprize_tpu.ntt import radix2 as ref_radix2
from zprize_tpu_torch.field import fp, spec
from zprize_tpu_torch.ntt import fr_kernel, radix2
from zprize_tpu_torch.ntt.domain import Domain, primitive_root
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

FR = spec.BLS12_377_FR
FIELDS = {"fr377": (spec.BLS12_377_FR, ref_spec.BLS12_377_FR),
          "fr381": (spec.BLS12_381_FR, ref_spec.BLS12_381_FR),
          "goldilocks": (spec.GOLDILOCKS, ref_spec.GOLDILOCKS)}


def _ints(f, a):
    return [int(v) for v in fp.to_ints(f, a).reshape(-1)]


def _values(f, count, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(f.p) for _ in range(count)]
    vals[:3] = [0, 1, f.p - 1][:count]
    return vals


def _dft(p, w, row):
    n = len(row)
    return [sum(a * pow(w, j * k, p) for j, a in enumerate(row)) % p
            for k in range(n)]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_primitive_root_and_tables_match_reference(name):
    f, ref_f = FIELDS[name]
    for log_n in (0, 1, 5, 12, f.two_adicity):
        assert primitive_root(f, log_n) == ref_domain.primitive_root(
            ref_f, log_n)
    for log_n in (1, 4, 7):
        dom, ref = Domain(f, log_n, "cpu"), ref_domain.Domain(ref_f, log_n)
        assert (dom.w, dom.w_inv, dom.n_inv) == (ref.w, ref.w_inv, ref.n_inv)
        assert _ints(f, dom.pows) == [int(v) for v in
                                      ref_fp.to_ints(ref_f, ref.pows)]
        assert _ints(f, dom.pows_inv) == [
            int(v) for v in ref_fp.to_ints(ref_f, ref.pows_inv)]
        assert dom.bitrev.tolist() == np.asarray(ref.bitrev).tolist()
    with pytest.raises(ValueError, match="supports only"):
        primitive_root(f, f.two_adicity + 1)


def test_domain_is_cached_per_device():
    assert Domain(FR, 3, "cpu") is Domain(FR, 3, torch.device("cpu"))
    assert Domain(FR, 3, "cpu") is not Domain(FR, 4, "cpu")


@pytest.mark.parametrize("log_n", range(1, 7))
@pytest.mark.parametrize("rows", [1, 3])
def test_ntt_matches_python_dft(log_n, rows):
    n = 1 << log_n
    dom = Domain(FR, log_n, "cpu")
    vals = [_values(FR, n, 100 * log_n + r) for r in range(rows)]
    a = fp.from_ints(FR, vals)
    fwd = radix2.ntt(dom, a)
    assert _ints(FR, fwd) == [v for row in vals
                              for v in _dft(FR.p, dom.w, row)]
    back = radix2.intt(dom, fwd)
    assert torch.equal(back, a)
    inv = radix2.intt(dom, a)
    n_inv = pow(n, -1, FR.p)
    assert _ints(FR, inv) == [v * n_inv % FR.p for row in vals
                              for v in _dft(FR.p, dom.w_inv, row)]


def test_ntt_along_another_axis_and_n_of_one():
    dom = Domain(FR, 3, "cpu")
    vals = [_values(FR, 3, 7 + j) for j in range(8)]          # (n=8, 3)
    a = fp.from_ints(FR, vals)
    got = radix2.ntt(dom, a, axis=0)
    cols = [_dft(FR.p, dom.w, [vals[j][c] for j in range(8)])
            for c in range(3)]
    assert _ints(FR, got) == [cols[c][k] for k in range(8) for c in range(3)]
    one = fp.from_ints(FR, [[5]])
    assert torch.equal(radix2.intt(Domain(FR, 0, "cpu"), one), one)


@pytest.mark.parametrize("log_n", [3, 5])
def test_ntt_matches_reference(log_n):
    """Against the reference's `radix2.ntt` / `intt` (its XLA forms, the
    reference's CPU path) on (3, n) planes along the coefficient axis."""
    f, ref_f = FIELDS["fr377"]
    n = 1 << log_n
    vals = [_values(f, n, 40 + log_n + r) for r in range(3)]
    dom, ref_dom = Domain(f, log_n, "cpu"), ref_domain.Domain(ref_f, log_n)
    ref_a = jnp.asarray(ref_fp.from_ints_np(ref_f, vals))
    a = fp.from_ints(f, vals)
    for ours, theirs in ((radix2.ntt, ref_radix2.ntt),
                         (radix2.intt, ref_radix2.intt)):
        expect = [int(v) for v in
                  ref_fp.to_ints(ref_f, theirs(ref_dom, ref_a)).reshape(-1)]
        assert _ints(f, ours(dom, a)) == expect


def test_wrapper_checks_its_input():
    dom = Domain(FR, 3, "cpu")
    with pytest.raises(ValueError, match="expected"):
        fr_kernel.fr_ntt(dom, fp.zeros(FR, (1, 4)))
    with pytest.raises(TypeError):
        fr_kernel.fr_ntt(dom, torch.zeros((1, 8, 8), dtype=torch.int64))
    meta = torch.empty((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="domain tables"):
        fr_kernel.fr_ntt(dom, meta)
