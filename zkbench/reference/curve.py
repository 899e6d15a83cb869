"""BLS12-377 G1 (y^2 = x^3 + 1 over Fq, prime-order subgroup r) on Python
ints, and the word layout the program's inputs and outputs use: an element
is little-endian 32-bit words of x·R mod m, R = 2^(32·words)."""

from __future__ import annotations

import numpy as np

P = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
GX = 0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF
GY = 0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6
B = 1
G = (GX, GY)
FQ_WORDS = 12
FR_WORDS = 8
SCALAR_BITS = R.bit_length()          # 253


def on_curve(pt) -> bool:
    return pt is None or (pt[1] * pt[1] - pt[0] ** 3 - B) % P == 0


def add(p1, p2):
    """Affine addition (None is the identity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def mul(pt, k: int):
    """k·pt (k taken mod r) by MSB-first double-and-add in affine
    coordinates: a few milliseconds for one 253-bit scalar."""
    k %= R
    acc = None
    for bit in bin(k)[2:]:
        acc = add(acc, acc)
        if bit == "1":
            acc = add(acc, pt)
    return acc


def words_to_ints(words: np.ndarray, modulus: int) -> list[int]:
    """Montgomery words (..., nw) int32/uint32 -> canonical Python ints
    x·R^-1 mod m, flattened."""
    words = np.ascontiguousarray(words).view(np.uint32)
    nw = words.shape[-1]
    r_inv = pow(1 << (32 * nw), -1, modulus)
    raw = words.reshape(-1, nw).tobytes()
    step = 4 * nw
    return [int.from_bytes(raw[i:i + step], "little") * r_inv % modulus
            for i in range(0, len(raw), step)]


def ints_to_words(values, modulus: int, nw: int) -> np.ndarray:
    """Python ints -> Montgomery words (len, nw) int32."""
    big_r = 1 << (32 * nw)
    raw = b"".join((v % modulus * big_r % modulus).to_bytes(4 * nw, "little")
                   for v in values)
    return np.frombuffer(raw, np.uint32).reshape(-1, nw).view(np.int32).copy()


def projective_ints(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """One homogeneous projective point (X : Y : Z) of Fq Montgomery
    words -> affine ints (None for the identity, Z = 0)."""
    xi, yi, zi = (words_to_ints(a, P)[0] for a in (x, y, z))
    if zi == 0:
        return None
    zinv = pow(zi, -1, P)
    return (xi * zinv % P, yi * zinv % P)
