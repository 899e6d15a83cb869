"""The count functions and the generator against small hand-worked cases
and Python ints."""

import random

import numpy as np
import pytest
import torch

from zkbench import digits, generator, peaks, registry
from zkbench.reference import curve


def test_gather_counts_by_hand():
    te = registry.counts("te_gather_accumulate")
    # 2 rows, 1 bucket: 2 * 7 mulmods * 588 IMADs; 2 * (144 + 12) bytes of
    # rows, 16 + 192 of the lane
    assert te.work(2, 1) == (2 * 7 * 588, 2 * 156 + 208)
    assert te.work(0, 0) == (0, 0)


def test_bucket_and_sw_counts_by_hand():
    tb = registry.counts("te_bucket_accumulate")
    assert tb.work(3, 2) == (3 * 7 * 588, 3 * 148 + 2 * 208)
    sw = registry.counts("sw_gather_accumulate")
    assert sw.work(1, 1) == (11 * 588, 96 + 12 + 16 + 144)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(16.75e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(16.75e12, 2 * 3.35e12) == pytest.approx(2.0)


def _digits_int(k, c):
    """The signed digits of k by Python ints, window by window."""
    out, carry = [], 0
    for w in range(digits.n_windows(c)):
        raw = (k >> (c * w)) % (1 << c) + carry
        carry = int(raw >= 1 << (c - 1))
        out.append(raw - (carry << c))
    return out


def _limbs(values):
    return torch.tensor([[(v >> (15 * i)) & 0x7FFF for i in range(17)]
                         for v in values], dtype=torch.int16)


@pytest.mark.parametrize("c", [4, 13, 16, 17])
def test_nonzero_digits_against_ints(c):
    rng = random.Random(c)
    vals = ([0, 1, curve.R - 1, (1 << (c - 1)), (1 << c) - 1, (1 << 64) - 1]
            + [rng.randrange(curve.R) for _ in range(200)])
    for v in vals:
        d = _digits_int(v, c)
        assert sum(x * (1 << (c * w)) for w, x in enumerate(d)) == v
    want = sum(sum(x != 0 for x in _digits_int(v, c)) for v in vals)
    assert digits.nonzero_digits(_limbs(vals), c) == want


def test_nonzero_digits_by_hand():
    # c = 4: 8 = 0b1000 -> digit -8 carrying 1 into window 1: two digits
    assert digits.nonzero_digits(_limbs([8]), 4) == 2
    assert digits.nonzero_digits(_limbs([7]), 4) == 1
    assert digits.nonzero_digits(_limbs([0]), 4) == 0


def test_window_buckets():
    # c = 17 (the 2^26 plan): 15 windows of 2^16 buckets, the carry window 4
    assert digits.window_buckets(17) == [1 << 16] * 15 + [4]
    # c = 13 (the SW batch): 19 full windows, a 6-bit window, the carry one
    assert digits.window_buckets(13) == [4096] * 19 + [128, 4]


def _ints(words):
    w = words.numpy().astype(np.uint32)
    return [sum(int(x) << (32 * j) for j, x in enumerate(row)) for row in w]


def test_generator_uniform_below_r_and_seeded():
    spec = {"kind": "uniform"}
    a = next(generator.vectors(spec, 4096, 1, 2**33 + 5, "cpu"))
    b = next(generator.vectors(spec, 4096, 1, 2**33 + 5, "cpu"))
    c = next(generator.vectors(spec, 4096, 1, 2**33 + 6, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    vals = _ints(a)
    assert max(vals) < curve.R
    assert max(vals) > curve.R // 2 and len(set(vals)) == len(vals)


def test_generator_bits_and_limbs():
    w = next(generator.vectors({"kind": "bits", "bits": 64}, 1000, 1, 7,
                               "cpu"))
    vals = _ints(w)
    assert max(vals) < 1 << 64 and max(vals) > 1 << 62
    limbs = generator.compact_limbs(w).numpy().astype(np.int64)
    assert limbs.max() < 1 << 15 and limbs.min() >= 0
    back = [sum(int(x) << (15 * i) for i, x in enumerate(row))
            for row in limbs]
    assert back == vals
    with pytest.raises(ValueError):
        next(generator.vectors({"kind": "bits", "bits": 253}, 1, 1, 0, "cpu"))
