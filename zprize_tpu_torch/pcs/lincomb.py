"""The verifier's G1 linear combination on the host, in C++.

`lincomb(curve, pts, ks)` = sum_i ks[i]·pts[i] over host affine int pairs
(None = identity, 0 <= k < 2^256): one interleaved multi-exponentiation
of ``csrc/lincomb.cc`` (256 shared doublings and one add a set bit, on the
complete projective formulas), built with the host C++ compiler by
``utils/build.py`` at first use.  It serves `kzg.combine_ints`, which the
KZG batch check and the Marlin verifier call with 2 to 40 terms: the
python double-and-add fold (`kzg.combine_ints_plain`) takes a few hundred
ms there, this a few ms.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..curve.spec import CurveSpec

_WORDS = 6          # u64 words of a base-field element (up to 384 bits)


def _lib() -> ctypes.CDLL:
    from ..utils import build
    lib = build.load("lincomb")
    vp = ctypes.c_void_p
    lib.lincomb.argtypes = [vp, vp, vp, vp, ctypes.c_uint64, vp]
    lib.lincomb.restype = None
    return lib


def _words(values, count: int) -> np.ndarray:
    """Non-negative ints -> (len, count) little-endian u64 words."""
    buf = b"".join(v.to_bytes(8 * count, "little") for v in values)
    return np.frombuffer(buf, np.uint64).reshape(len(values), count).copy()


def lincomb(curve: CurveSpec, pts, ks):
    """sum_i ks[i]·pts[i]: an affine int pair, or None for the identity."""
    if len(pts) != len(ks):
        raise ValueError(f"{len(pts)} points, {len(ks)} scalars")
    if any(not 0 <= k < 1 << 256 for k in ks):
        raise ValueError("scalars must lie in [0, 2^256)")
    n = len(pts)
    xy = _words([c for pt in pts for c in ((0, 0) if pt is None else pt)],
                _WORDS)
    k4 = _words(list(ks), 4)
    p_w = _words([curve.field.p], _WORDS)
    b3_w = _words([3 * curve.b % curve.field.p], _WORDS)
    out = np.zeros(2 * _WORDS, np.uint64)
    _lib().lincomb(p_w.ctypes.data, b3_w.ctypes.data, xy.ctypes.data,
                   k4.ctypes.data, n, out.ctypes.data)
    x = int.from_bytes(out[:_WORDS].tobytes(), "little")
    y = int.from_bytes(out[_WORDS:].tobytes(), "little")
    return None if x == 0 and y == 0 else (x, y)
