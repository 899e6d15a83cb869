"""The expected KZG commitment: with the SRS's powers tau^i·G, the
commitment to p(X) = sum_i c_i X^i is p(tau)·G.  Coefficients are Fr
Montgomery words w_i (value w_i·R^-1 mod r, R = 2^256), so
p(tau) = R^-1·sum_i w_i tau^i, one Horner pass over Python ints."""

from __future__ import annotations

import random

import numpy as np

from . import curve


def srs_tau(seed: int) -> int:
    """The trapdoor of the test SRS of `seed`: random.Random(seed ^ 0x5EED)
    .randrange(1, r), the rule the deterministic test SRS is defined by."""
    return random.Random(seed ^ 0x5EED).randrange(1, curve.R)


def raw_ints(words: np.ndarray) -> list[int]:
    """(n, 8) int32 words -> the n raw 256-bit ints they spell."""
    raw = np.ascontiguousarray(words).view(np.uint32).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def evaluate(words: np.ndarray, tau: int, low_bits: int = 0) -> int:
    """p(tau) mod r for one polynomial's coefficient words (n, 8); with
    `low_bits`, of the coefficient values with that many low bits cleared
    (the control)."""
    r = curve.R
    r_inv = pow(1 << 256, -1, r)
    acc = 0
    if low_bits:
        mask = ~((1 << low_bits) - 1)
        for w in reversed(raw_ints(words)):
            acc = (acc * tau + (w * r_inv % r & mask)) % r
        return acc
    for w in reversed(raw_ints(words)):
        acc = (acc * tau + w) % r
    return acc * r_inv % r


def expected(words: np.ndarray, tau: int, low_bits: int = 0):
    """The commitment p(tau)·G as affine ints."""
    return curve.mul(curve.G, evaluate(words, tau, low_bits))
