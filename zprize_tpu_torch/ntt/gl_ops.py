"""Goldilocks arithmetic on the plain engine, q = 2^64 - 2^32 + 1.

An element is its canonical value below q, stored as the bit pattern of a
u64 in a ``torch.int64`` tensor (values at or above 2^63 read as negative).
This is the form the Goldilocks NTT kernel (``csrc/ntt_gl.cu``) reads and
writes.

torch has no add, shift or compare on uint64, so every function here splits
its operands into 32-bit pieces (16-bit pieces for the product) held in
int64, where carries and borrows are exact, and reduces with the identities
2^64 = 2^32 - 1 and 2^96 = -1 (mod q), as the reference's packed ops do
(zprize_tpu/ntt/gl_ops.py).  Every function returns canonical values, so
the kernel and this engine agree bit for bit.

Conversions: to and from the reference's packed ``(lo, hi)`` u32 planes
(which may hold any value below 2^64: they are canonicalised on the way in),
and to and from the Montgomery words of ``field/fp.py`` for GOLDILOCKS
(2 words, R = 2^64).
"""

from __future__ import annotations

import numpy as np
import torch

Q = (1 << 64) - (1 << 32) + 1
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_EPS = (1 << 32) - 1                # 2^64 mod q; also q's high word
_R = (1 << 64) % Q                  # Montgomery R = 2^64 of field/fp.py
_R_INV = pow(_R, -1, Q)


def _as_int64(v: int) -> int:
    """The int64 that holds the bit pattern of the u64 `v`."""
    return v - (1 << 64) if v >= 1 << 63 else v


def from_ints(values, device="cpu") -> torch.Tensor:
    """Python ints (any nesting) -> canonical elements (reduced mod q)."""
    arr = np.asarray(values, dtype=object)
    flat = [_as_int64(int(v) % Q) for v in arr.reshape(-1)]
    return torch.tensor(flat, dtype=torch.int64).reshape(arr.shape).to(device)


def to_ints(x: torch.Tensor) -> list:
    """Elements -> a flat list of python ints (the u64 each holds)."""
    return [v & ((1 << 64) - 1) for v in x.reshape(-1).tolist()]


def _split(x: torch.Tensor):
    """u64 bit patterns -> (lo, hi) 32-bit pieces, each in [0, 2^32)."""
    return x & _M32, (x >> 32) & _M32


def _join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) pieces in [0, 2^32) -> the u64 bit pattern in int64."""
    return (hi << 32) | lo


def _normalize(lo: torch.Tensor, hi: torch.Tensor):
    """Carry a signed low piece into the high piece: lo lands in
    [0, 2^32), and the value lo + hi * 2^32 is unchanged."""
    return lo & _M32, hi + (lo >> 32)


def _add_q_if_negative(lo, hi):
    """(lo, hi) normalized, value above -q -> the same mod q, >= 0."""
    neg = hi < 0
    lo, hi = _normalize(lo + neg, hi + neg * _EPS)
    return lo, hi


def _sub_q_if_at_least_q(lo, hi):
    """(lo, hi) normalized, value >= 0 -> value - q where that is >= 0."""
    dlo, dhi = _normalize(lo - 1, hi - _EPS)
    keep = dhi >= 0
    return torch.where(keep, dlo, lo), torch.where(keep, dhi, hi)


def gl_canon(x: torch.Tensor) -> torch.Tensor:
    """Any u64 (below 2^64 < 2q) -> its canonical value below q."""
    return _join(*_sub_q_if_at_least_q(*_split(x)))


def gl_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (mod q) of canonical elements."""
    alo, ahi = _split(a)
    blo, bhi = _split(b)
    lo, hi = _normalize(alo + blo, ahi + bhi)
    return _join(*_sub_q_if_at_least_q(lo, hi))


def gl_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod q) of canonical elements."""
    alo, ahi = _split(a)
    blo, bhi = _split(b)
    lo, hi = _normalize(alo - blo, ahi - bhi)
    return _join(*_add_q_if_negative(lo, hi))


def gl_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b (mod q) of elements below 2^64: the 16-bit-piece schoolbook
    product to 128 bits as four 32-bit words w0..w3, then the fold
    n = (w0 + w1 2^32) + w2 2^64 + w3 2^96 = (w0 + w1 2^32) + w2 (2^32 - 1)
    - w3 (mod q), then at most one addition and two subtractions of q."""
    a, b = torch.broadcast_tensors(a, b)
    ad = [(a >> (16 * i)) & _M16 for i in range(4)]
    bd = [(b >> (16 * i)) & _M16 for i in range(4)]
    cols = [None] * 7
    for i in range(4):
        for j in range(4):
            p = ad[i] * bd[j]                    # < 2^32
            k = i + j
            cols[k] = p if cols[k] is None else cols[k] + p
    cols.append(torch.zeros_like(a))
    words, carry = [], 0
    for k in range(0, 8, 2):                     # each column < 2^34
        w = cols[k] + (cols[k + 1] << 16) + carry
        words.append(w & _M32)
        carry = w >> 32
    w0, w1, w2, w3 = words                       # carry is 0: n < 2^128
    lo, hi = _normalize(w0 - w2 - w3, w1 + w2)   # value in (-2^33, 2^65)
    lo, hi = _add_q_if_negative(lo, hi)
    lo, hi = _sub_q_if_at_least_q(lo, hi)        # 2^65 < 3q
    return _join(*_sub_q_if_at_least_q(lo, hi))


def const(value: int, device="cpu") -> torch.Tensor:
    """A scalar element tensor of `value` (reduced mod q)."""
    return torch.tensor(_as_int64(value % Q), dtype=torch.int64,
                        device=device)


# ---- conversions -----------------------------------------------------------


def from_planes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The reference's packed (lo, hi) u32 planes, as tensors of any
    integer type holding the u32 values (value lo + hi 2^32, any value
    below 2^64) -> canonical elements."""
    lo = lo.to(torch.int64) & _M32
    hi = hi.to(torch.int64) & _M32
    return gl_canon(_join(lo, hi))


def to_planes(x: torch.Tensor):
    """Elements -> (lo, hi) 32-bit pieces as int64 tensors."""
    return _split(x)


def from_words(words: torch.Tensor) -> torch.Tensor:
    """Montgomery words of field/fp.py for GOLDILOCKS, (..., 2) int32 ->
    canonical elements (...): the u64 the words hold, times R^-1."""
    w = words.to(torch.int64)
    return gl_mul(_join(w[..., 0] & _M32, w[..., 1] & _M32),
                  const(_R_INV, words.device))


def to_words(x: torch.Tensor) -> torch.Tensor:
    """Canonical elements (...) -> Montgomery words (..., 2) int32."""
    m = gl_mul(x, const(_R, x.device))
    lo, hi = _split(m)
    words = torch.stack([lo, hi], dim=-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)
