"""The Fr NTT kernel: wrapper, launch count and plain version.

`fr_ntt(dom, a, inverse)` transforms every row of `a` (B, n, n_words), int32
Montgomery words of an 8-word scalar field (BLS12-377/381 Fr), in natural
order: A[k] = sum_j a_j w^(jk), the inverse scaled by n^-1.

* On CUDA tensors it launches `fr_ntt` of ``csrc/ntt_fr.cu`` (one tile pass
  in shared memory, then one pass per stage above 2^10) on the current
  stream, adds one to ``launches["fr_ntt"]`` per transform, and raises if a
  launch failed.
* On CPU tensors it runs `fr_ntt_plain`: the radix-2 stage loop of the
  reference's `_ntt_core` (zprize_tpu/ntt/radix2.py) on the plain engine
  ``field/fp.py``.

Both return fully reduced words, so they agree bit for bit.  Replaces the
TPU kernel `_make_ntt_fn` of zprize_tpu/ntt/fr_kernel.py; no size cap and
no batch-shape rule (the TPU kernel took 2^7..2^12 and composed larger
sizes four-step).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..field import fp
from ..field.spec import FieldSpec
from .domain import Domain

KERNELS = ("fr_ntt",)

# transforms launched since the last reset_launches()
launches = dict.fromkeys(KERNELS, 0)

N_WORDS = 8


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built from the checkout at first use."""
    from ..utils import build
    lib = build.load("ntt_fr")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fr_ntt.argtypes = [vp, vp, vp, vp, vp, ll, ci, vp]
    lib.fr_ntt.restype = ci
    lib.ntt_fr_error_string.argtypes = [ci]
    lib.ntt_fr_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def device_params(spec: FieldSpec, device: torch.device) -> torch.Tensor:
    """The constants tensor of ``csrc/fq.cuh`` for a scalar field: p,
    R mod p, R^2 mod p, zero words in place of the curve constant, and
    -p^-1 mod 2^32, as int32 words."""
    mp = fp.montgomery_params(spec)
    words = [fp.raw_words(spec, mp["p"]), fp.raw_words(spec, mp["one"]),
             fp.raw_words(spec, mp["r2"]), fp.zeros(spec),
             torch.tensor([mp["n0"] - (1 << 32) * (mp["n0"] >> 31)],
                          dtype=torch.int32)]
    return torch.cat(words).to(device)


def _check(dom: Domain, a: torch.Tensor) -> None:
    nw = fp.n_words(dom.spec)
    if a.dtype != torch.int32:
        raise TypeError(f"a: expected torch.int32, got {a.dtype}")
    if a.dim() != 3 or tuple(a.shape[1:]) != (dom.n, nw):
        raise ValueError(f"a: expected (B, {dom.n}, {nw}), got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("a: tensor must be contiguous")
    if a.device != dom.device:
        raise ValueError(f"a on {a.device}, domain tables on {dom.device}")


def fr_ntt(dom: Domain, a: torch.Tensor, inverse: bool = False
           ) -> torch.Tensor:
    """Forward (or inverse, scaled by n^-1) NTT of every row of
    a (B, n, n_words)."""
    _check(dom, a)
    if a.device.type == "cpu":
        return fr_ntt_plain(dom, a, inverse)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if fp.n_words(dom.spec) != N_WORDS:
        raise NotImplementedError(
            f"{dom.spec.name}: the device NTT takes 8-word scalar fields; "
            "the Goldilocks NTT is not ported yet: ROADMAP.md Queue 1, "
            "item 6")
    if dom.n == 1:
        return a.clone()
    out = torch.empty_like(a)
    scale = fp.constant(dom.spec, dom.n_inv, (), a.device).contiguous()
    pows = dom.pows_inv if inverse else dom.pows
    rc = _lib().fr_ntt(device_params(dom.spec, a.device).data_ptr(),
                       pows.data_ptr(), scale.data_ptr() if inverse else None,
                       a.data_ptr(), out.data_ptr(),
                       a.shape[0], dom.log_n,
                       torch.cuda.current_stream(a.device).cuda_stream)
    launches["fr_ntt"] += 1
    if rc != 0:
        msg = _lib().ntt_fr_error_string(rc).decode()
        raise RuntimeError(f"fr_ntt launch failed: cuda error {rc} ({msg})")
    return out


def fr_ntt_plain(dom: Domain, a: torch.Tensor, inverse: bool = False
                 ) -> torch.Tensor:
    """The radix-2 DIT stage loop on the plain engine: bit-reverse, then
    per stage s (m = 2^s) the butterflies (lo + w^j hi, lo - w^j hi) with
    w^j = pows[j * n/m], and the inverse's n^-1 scale."""
    spec, n = dom.spec, dom.n
    pows = dom.pows_inv if inverse else dom.pows
    b, nw = a.shape[0], a.shape[-1]
    x = a.index_select(1, dom.bitrev)
    for s in range(1, dom.log_n + 1):
        m = 1 << s
        tw = pows[::n // m][:m // 2]                       # (m/2, nw)
        v = x.reshape(b, n // m, m, nw)
        lo, hi = v[:, :, :m // 2], v[:, :, m // 2:]
        t = fp.mul(spec, hi, tw)
        x = torch.cat([fp.add(spec, lo, t), fp.sub(spec, lo, t)],
                      dim=2).reshape(b, n, nw)
    if inverse:
        x = fp.mul(spec, x, fp.constant(spec, dom.n_inv, (), x.device))
    return x
