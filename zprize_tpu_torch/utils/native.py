"""Affine points in the arkworks-style uncompressed byte form, on the host.

`serialize_points` writes, and `deserialize_points` reads, the records of
the reference's host library (`native/zk_host.cc:310-345`) byte for byte:
a point is x‖y, each coordinate `nbytes` little-endian bytes of which the
first min(nbytes, 48) hold the value (zeros above 48 bytes; below 48 the
value is cut to its low bytes), and the identity (None, or both
coordinates zero) is a record of zeros with bit 6 (0x40) of its last byte
set.  A record is two `int.to_bytes`: python and numpy, nothing to build.

The rest of the reference's `utils/native.py` lives elsewhere here:
- `lincomb` is `pcs/lincomb.py` (host C++, `csrc/lincomb.cc`);
- `point_chain` and `scalar_mul` are `utils/oracle.py`'s `generator_chain`
  and `ec_mul`;
- `host_combine_windows` has no counterpart: the port combines the windows
  on the card (`te_combine`, `sw_combine`);
- `available` and `CURVE_ID` belong to the ctypes interface of the
  reference's shared library, which the port does not load.
"""

from __future__ import annotations

import numpy as np

from ..curve.spec import CurveSpec

_COORD = 48                     # bytes of a coordinate a record can carry
_MASK = (1 << (8 * _COORD)) - 1
_INFINITY = 0x40                # the identity's flag in a record's last byte


def _width(nbytes: int) -> int:
    if nbytes < 1:
        raise ValueError(f"a coordinate needs at least one byte, not "
                         f"{nbytes}")
    return min(nbytes, _COORD)


def serialize_points(curve: CurveSpec, points, nbytes: int = 48) -> bytes:
    """Affine int pairs (None = identity) -> 2·nbytes bytes a point.  The
    form is the same on every curve; `curve` keeps the reference's
    signature."""
    width = _width(nbytes)
    pts = [(0, 0) if pt is None else pt for pt in points]
    raw = np.frombuffer(b"".join((v & _MASK).to_bytes(_COORD, "little")
                                 for pt in pts for v in pt), np.uint8
                        ).reshape(len(pts), 2, _COORD)
    out = np.zeros((len(pts), 2, nbytes), np.uint8)
    out[:, :, :width] = raw[:, :, :width]
    out[~raw.any(axis=(1, 2)), 1, -1] |= _INFINITY
    return out.tobytes()


def deserialize_points(curve: CurveSpec, data: bytes, nbytes: int = 48
                       ) -> list:
    """Records of `serialize_points` -> affine int pairs, None for a flagged
    record; bytes after the last whole record are ignored."""
    width = _width(nbytes)
    n = len(data) // (2 * nbytes)
    recs = np.frombuffer(data, np.uint8, count=n * 2 * nbytes
                         ).reshape(n, 2, nbytes)
    return [None if rec[1, -1] & _INFINITY else
            tuple(int.from_bytes(c[:width].tobytes(), "little") for c in rec)
            for rec in recs]
