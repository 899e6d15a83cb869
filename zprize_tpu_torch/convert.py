"""Carry the reference package's state across into this port's form.

The reference keeps field elements as (n, 26) redundant base-2^15 limb
planes (limbs < 2^16, value reduced mod p only lazily), scalars as (n, 17)
limb planes or the uint16 compact form of the benchmark, and its prepared
window-collapse table u16-packed and column-major.  Everything here takes
numpy arrays and returns this port's tensors, reducing values mod p
exactly through python ints (fine at test sizes; the main path never
converts a large table).  Like the other entry points, they return
tensors on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve import sw
from .curve.spec import ALL_CURVES, CurveSpec
from .field import fp
from .field.spec import BASE_BITS, FieldSpec
from .msm.pippenger import PreparedTe
from .pcs.kzg import Srs
from .utils.device import resolve_device


def _ints(planes: np.ndarray) -> np.ndarray:
    """(..., L) base-2^15 limbs (any per-limb value) -> object ints."""
    planes = np.asarray(planes)
    weights = np.array([1 << (BASE_BITS * j) for j in range(planes.shape[-1])],
                       dtype=object)
    return planes.astype(object) @ weights


def elements_from_reference(spec: FieldSpec, planes, device=None
                            ) -> torch.Tensor:
    """Reference field planes (..., n_limbs), limbs < 2^16 -> Montgomery
    words (..., n_words)."""
    return fp.from_ints(spec, _ints(planes), resolve_device(device))


def points_from_reference(curve: CurveSpec, x_planes, y_planes, inf,
                          device=None) -> sw.Affine:
    """Reference affine planes (n, 26) + inf mask -> `sw.Affine`."""
    f = curve.field
    device = resolve_device(device)
    return sw.Affine(elements_from_reference(f, x_planes, device),
                     elements_from_reference(f, y_planes, device),
                     torch.as_tensor(np.asarray(inf, bool), device=device))


def scalars_from_reference(curve: CurveSpec, planes, device=None
                           ) -> torch.Tensor:
    """Reference scalar planes -> canonical (n, L) int32 base-2^15 limbs.
    uint16 planes are the compact form, canonical by contract; other
    planes may be redundant and are reduced mod r."""
    device = resolve_device(device)
    planes = np.asarray(planes)
    if planes.dtype == np.uint16:
        return torch.from_numpy(planes.astype(np.int32)).to(device)
    r = curve.order
    n_limbs = curve.scalar.n_limbs
    vals = [int(v) % r for v in _ints(planes).reshape(-1)]
    limbs = [[(v >> (BASE_BITS * j)) & ((1 << BASE_BITS) - 1)
              for j in range(n_limbs)] for v in vals]
    out = np.asarray(limbs, np.int32).reshape(*planes.shape[:-1], n_limbs)
    return torch.from_numpy(out).to(device)


def prepared_from_reference(curve: CurveSpec, packed, c: int, g: int, m: int,
                            n: int, device=None) -> PreparedTe:
    """The reference `PreparedTe.packed` table, (3h, m*n) column-major with
    each plane's 26 limbs u16-packed in split-half order (limb j in the
    low half of word j, limb j+h in the high half), -> this port's
    `PreparedTe` with a (m*n, 3, nw) table."""
    device = resolve_device(device)
    packed = np.asarray(packed, dtype=np.uint32)
    n_limbs = curve.field.n_limbs
    h = (n_limbs + 1) // 2
    if packed.shape != (3 * h, m * n):
        raise ValueError(f"expected a ({3 * h}, {m * n}) table, got "
                         f"{packed.shape}")
    rows = packed.T
    planes = []
    for q in range(3):
        words = rows[:, q * h:(q + 1) * h]
        limbs = np.concatenate([words & 0xFFFF, words >> 16], axis=1)
        planes.append(elements_from_reference(curve.field,
                                              limbs[:, :n_limbs], device))
    return PreparedTe(torch.stack(planes, dim=1).contiguous(), c, g, m, n)


def fr_from_reference(curve: CurveSpec, planes, device=None) -> torch.Tensor:
    """Reference scalar-field planes (..., 17), e.g. PLONK wire planes or
    coefficients -> Montgomery words (..., 8) of the curve's Fr."""
    return elements_from_reference(curve.scalar, planes, device)


def srs_from_reference(ref_srs, device=None):
    """A reference `kzg.Srs` -> this port's `pcs.kzg.Srs`: the G1 powers as
    SW affine words on `device`, the G2 pair and tau as they are (ints)."""
    curve = _port_curve(ref_srs.curve)
    aff = ref_srs.g1_powers
    return Srs(curve, points_from_reference(curve, aff.x, aff.y, aff.inf,
                                            device),
               ref_srs.h, ref_srs.tau_h, ref_srs.tau)


def _port_curve(curve) -> CurveSpec:
    """The port's CurveSpec of the same name as `curve` (either package's)."""
    for c in ALL_CURVES:
        if c.name == curve.name:
            return c
    raise ValueError(f"no curve named {curve.name} in the port")


def point_ints(curve, pt):
    """A projective point of either package -> affine ints or None."""
    curve = _port_curve(curve)
    if isinstance(pt.x, torch.Tensor):
        return sw.to_affine_ints(curve, pt)
    q = curve.field.p
    x, y, z = (int(_ints(np.asarray(c))) % q for c in pt)
    if z == 0:
        return None
    zinv = pow(z, -1, q)
    return (x * zinv % q, y * zinv % q)


def proof_ints(curve: CurveSpec, proof) -> dict:
    """A PLONK proof of either package as canonical python ints:
    {"comms": the 9 commitments (a, b, c, z, t_lo, t_mid, t_hi, w_zeta,
    w_zeta_omega) as affine (x, y) or None, "evals": {name: int}}."""
    curve = _port_curve(curve)
    pts = [*proof.wire_comms, proof.z_comm, *proof.t_comms, proof.w_zeta,
           proof.w_zeta_omega]
    r = curve.order
    evals = {}
    for name, v in proof.evals.items():
        if isinstance(v, torch.Tensor):
            evals[name] = int(fp.to_ints(curve.scalar, v)[()])
        else:
            evals[name] = int(_ints(np.asarray(v))) % r
    return {"comms": [point_ints(curve, q) for q in pts], "evals": evals}
