"""Measurement probes beside the MSM kernels, on no path of the port, and
the critical paths of the serial folds that they time.

The probes are kernels of ``csrc/msm_te.cu`` that replace no TPU kernel:

* `imad_chain`: per lane, k dependent 32-bit multiply-adds on one thread,
  so the launch's time over k is the latency of one dependent IMAD;
* `fq_mul_chain`: per lane, k dependent 12-word Montgomery products on one
  thread, so its time over k is the latency of one mulmod as
  ``csrc/fq.cuh`` runs it on one thread.

`te_combine_depth` and `sw_combine_depth` count a fold's critical path in
dependent mulmods.  ``chip_smoke.py`` bounds the folds by that depth times
the least a mulmod can take on the card (two dependent IMADs), and
reports beside it the depth times `fq_mul_chain`'s latency, the floor of a
design that runs each mulmod on one thread.

Each wrapper runs its kernel on CUDA tensors (adding one to
``launches[name]``) and its plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..curve.spec import CurveSpec
from ..field import fp
from ..utils import device as _device
from . import accum_kernel as ak

KERNELS = ("imad_chain", "fq_mul_chain")
MASK32 = 0xFFFFFFFF

# launches of each probe since the last reset_launches()
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ak._lib()
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.imad_chain.argtypes = [vp, vp, vp, vp, ll, ci, vp]
    lib.fq_mul_chain.argtypes = [vp, vp, vp, vp, ll, ci, vp]
    for name in KERNELS:
        getattr(lib, name).restype = ci
    return lib


def _launch(name: str, rc: int) -> None:
    launches[name] += 1
    if rc != 0:
        err = _lib().msm_te_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cuda error {rc} ({err})")


def _check_chain(x: torch.Tensor, y: torch.Tensor, k: int) -> None:
    if x.shape != y.shape:
        raise ValueError(f"expected tensors of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if k < 0:
        raise ValueError(f"k: expected k >= 0, got {k}")


def imad_chain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, k: int
               ) -> torch.Tensor:
    """Per lane, v = x, then k times v = v a + b mod 2^32: x, a, b (L,)
    int32 (32-bit words) -> (L,) int32."""
    for name, t in (("x", x), ("a", a), ("b", b)):
        ak._check(name, t, ())
    if x.dim() != 1:
        raise ValueError(f"x: expected (L,), got {tuple(x.shape)}")
    _check_chain(x, a, k)
    _check_chain(x, b, k)
    if not _device.on_card(x, a, b):
        return imad_chain_plain(x, a, b, k)
    out = torch.empty_like(x)
    rc = _lib().imad_chain(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                           out.data_ptr(), x.shape[0], k, _device.stream(out))
    _launch("imad_chain", rc)
    return out


def imad_chain_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     k: int) -> torch.Tensor:
    # in int64 without overflow: v a = v a_lo + ((v a_hi) mod 2^16) 2^16
    # mod 2^32, a_lo and a_hi the 16-bit halves of a
    v, a, b = (t.to(torch.int64) & MASK32 for t in (x, a, b))
    a_lo, a_hi = a & 0xFFFF, a >> 16
    for _ in range(k):
        v = (v * a_lo + ((v * a_hi & 0xFFFF) << 16) + b) & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def fq_mul_chain(curve: CurveSpec, x: torch.Tensor, y: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """Per lane, x times y k times in a row (Montgomery products of the
    curve's base field): x, y (L, nw) -> (L, nw)."""
    tail = (fp.n_words(curve.field),)
    ak._check("x", x, tail)
    ak._check("y", y, tail)
    if x.dim() != 2:
        raise ValueError(f"x: expected (L, nw), got {tuple(x.shape)}")
    _check_chain(x, y, k)
    if not _device.on_card(x, y):
        return fq_mul_chain_plain(curve, x, y, k)
    out = torch.empty_like(x)
    rc = _lib().fq_mul_chain(ak.device_params(curve, out.device).data_ptr(),
                             x.data_ptr(), y.data_ptr(), out.data_ptr(),
                             x.shape[0], k, _device.stream(out))
    _launch("fq_mul_chain", rc)
    return out


def fq_mul_chain_plain(curve: CurveSpec, x: torch.Tensor, y: torch.Tensor,
                       k: int) -> torch.Tensor:
    for _ in range(k):
        x = fp.mul(curve.field, x, y)
    return x.clone()


def te_combine_depth(n_steps: int, c: int) -> int:
    """The critical path of one te_combine lane in dependent mulmods:
    n_steps - 1 steps of c doublings (4 independent squarings, then 4
    independent products: 2 deep) and one full add (a, b, Z1 Z2 and
    T1 T2 independent, then c = T1 T2 k, then 4 products: 3 deep)."""
    return (n_steps - 1) * (2 * c + 3)


def sw_combine_depth(n_steps: int, c: int) -> int:
    """The critical path of one sw_combine lane in dependent mulmods:
    n_steps - 1 steps of c a = 0 doublings (Y^2, Z^2, X Y and Y Z
    independent, then the products by them: 2 deep) and one complete add
    (the 6 products of the coordinates independent, then the 6 of the
    tail: 2 deep); the products by 3b are additions."""
    return (n_steps - 1) * (2 * c + 2)
