"""The Goldilocks NTT: kernel wrapper, launch count, plain version, and the
four-step composition of large transforms (bench.py's 2^24 = 2^12 x 2^12).

Elements are canonical values below q = 2^64 - 2^32 + 1 held as u64 bit
patterns in ``torch.int64`` (``gl_ops``).  Transforms run over axis 0 of
(n, B) arrays, B contiguous (the reference's packed-plane convention), in
natural order: A[k] = sum_j a_j w^(jk), the inverse scaled by n^-1.

* `gl_ntt(x, log_n, ...)`, n <= 2^12 (`TILE_LOG`): on CUDA tensors it
  launches `gl_ntt` of ``csrc/ntt_gl.cu`` on the current stream, adds one
  to ``launches["gl_ntt"]`` per launch, and raises if the launch failed; on
  CPU tensors it runs `gl_ntt_plain`, the radix-2 DIT stage loop on
  ``gl_ops``.  Options that the four-step composition fuses into the
  store: the step twiddle of a column pass and a final scale.
* `ntt_packed(log_n, x, inverse)`: any size, splitting four-step above the
  tile (`_ntt_axis0`, output index k1 + n1 k2 as in the reference).
* `ntt_fourstep_packed(log_n1, log_n2, x)`: bench.py's entry point, the
  forward transform of an (n,) vector, natural order.

Replaces the TPU kernels `_make_ntt_call` (2^k <= 2^9, all stages in one
grid step) and `_make_ntt_grid_call` (2^10..2^12, one stage per grid step)
of zprize_tpu/ntt/gl_kernel.py with one kernel: a 2^12-point column fits in
a block's shared memory, so the TPU's split at 2^9 is not needed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..field.spec import GOLDILOCKS
from ..utils.device import resolve_device
from . import gl_ops as G
from .domain import bitrev_perm, gl_powers, power_ints, primitive_root

KERNELS = ("gl_ntt",)

# launches since the last reset_launches()
launches = dict.fromkeys(KERNELS, 0)

# the largest transform one launch takes: 2^12 u64 values are 32 KB of
# shared memory a column
TILE_LOG = 12
# split point of the two-level step-twiddle tables
_TW_SPLIT_LOG = 8


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built from the checkout at first use."""
    from ..utils import build
    lib = build.load("ntt_gl")
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gl_ntt.argtypes = [vp, vp, vp, vp, vp, ci, ci, ll,
                           ctypes.c_ulonglong, ll, ci, vp]
    lib.gl_ntt.restype = ci
    lib.ntt_gl_error_string.argtypes = [ci]
    lib.ntt_gl_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _step_tables_host(log_n1: int, log_n2: int, inverse: bool):
    """Two-level step-twiddle tables, w the 2^(log_n1 + log_n2)-th root
    (w^-1 for the inverse): w^(k1 j2) = A[k1, j2 >> s] * B[k1, j2 & (2^s -
    1)], s = min(log_n2, 8), A (n1, 2^(log_n2 - s)) or None when that is 1
    column, B (n1, 2^s); running products of python ints (the reference's
    `_twiddle_tables_two_level`)."""
    q = G.Q
    n1 = 1 << log_n1
    s = min(log_n2, _TW_SPLIT_LOG)
    nlo, nhi = 1 << s, 1 << (log_n2 - s)
    w = primitive_root(GOLDILOCKS, log_n1 + log_n2)
    if inverse:
        w = pow(w, q - 2, q)

    def build(base, count):
        rows, step = [], 1                  # step = base^k1
        for _ in range(n1):
            rows.append(power_ints(GOLDILOCKS, count, step))
            step = step * base % q
        return G.from_ints(rows)

    a = build(pow(w, nlo, q), nhi) if nhi > 1 else None
    return a, build(w, nlo), s


_step_cache: dict = {}


def _step_tables(log_n1: int, log_n2: int, inverse: bool,
                device: torch.device):
    """(A or None, B, split) of `_step_tables_host` on `device`, cached."""
    key = (log_n1, log_n2, inverse, device)
    if key not in _step_cache:
        a, b, s = _step_tables_host(log_n1, log_n2, inverse)
        _step_cache[key] = (None if a is None else a.to(device), b.to(device),
                            s)
    return _step_cache[key]


def _check(x: torch.Tensor, log_n: int, step_log: int, inner: int) -> None:
    if x.dtype != torch.int64:
        raise TypeError(f"x: expected torch.int64, got {x.dtype}")
    if not 0 <= log_n <= TILE_LOG:
        raise ValueError(f"gl_ntt takes 2^0..2^{TILE_LOG} points, not "
                         f"2^{log_n}")
    if x.dim() != 2 or x.shape[0] != 1 << log_n:
        raise ValueError(f"x: expected ({1 << log_n}, B), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x: tensor must be contiguous")
    if step_log and (inner < 1 or x.shape[1] != inner << step_log):
        raise ValueError(f"x: {x.shape[1]} columns are not {inner} x "
                         f"2^{step_log}")


def gl_ntt(x: torch.Tensor, log_n: int, inverse: bool = False,
           step_log: int = 0, inner: int = 1, scale: int | None = None
           ) -> torch.Tensor:
    """The NTT of every column of x (2^log_n, B), log_n <= TILE_LOG, then,
    if step_log > 0, element (k1, col) times w^(k1 j2), w the
    2^(log_n + step_log)-th root (w^-1 for the inverse), j2 = col // inner
    (the column pass of a four-step transform), then times `scale`."""
    _check(x, log_n, step_log, inner)
    if x.device.type == "cpu":
        return gl_ntt_plain(x, log_n, inverse, step_log, inner, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    pows = gl_powers(log_n, inverse, x.device)
    tw_a = tw_b = None
    split = 0
    if step_log:
        tw_a, tw_b, split = _step_tables(log_n, step_log, inverse, x.device)
    rc = _lib().gl_ntt(x.data_ptr(), out.data_ptr(), pows.data_ptr(),
                       None if tw_a is None else tw_a.data_ptr(),
                       None if tw_b is None else tw_b.data_ptr(),
                       step_log, split, inner, 0 if scale is None else scale,
                       x.shape[1], log_n,
                       torch.cuda.current_stream(x.device).cuda_stream)
    launches["gl_ntt"] += 1
    if rc != 0:
        msg = _lib().ntt_gl_error_string(rc).decode()
        raise RuntimeError(f"gl_ntt launch failed: cuda error {rc} ({msg})")
    return out


def gl_ntt_plain(x: torch.Tensor, log_n: int, inverse: bool = False,
                 step_log: int = 0, inner: int = 1, scale: int | None = None
                 ) -> torch.Tensor:
    """`gl_ntt` on ``gl_ops``, at any log_n: bit-reverse, then per stage s
    (m = 2^s) the butterflies (lo + w^j hi, lo - w^j hi) with
    w^j = pows[j * n/m] (stage 1 multiplies by nothing), then the step
    twiddle and the scale."""
    n, b = x.shape
    pows = gl_powers(log_n, inverse, x.device)
    y = x.index_select(0, bitrev_perm(log_n, x.device))
    for s in range(1, log_n + 1):
        m = 1 << s
        v = y.reshape(n // m, m, b)
        lo, hi = v[:, :m // 2], v[:, m // 2:]
        t = hi if s == 1 else G.gl_mul(hi, pows[::n // m][:m // 2, None])
        y = torch.cat([G.gl_add(lo, t), G.gl_sub(lo, t)], dim=1).reshape(n, b)
    if step_log:
        y = _step_twiddle(y, log_n, step_log, inverse, inner)
    if scale is not None:
        y = G.gl_mul(y, G.const(scale, x.device))
    return y


def _step_twiddle(y: torch.Tensor, log_n: int, step_log: int,
                  inverse: bool, inner: int) -> torch.Tensor:
    """Element (k1, col) of y (2^log_n, B) times w^(k1 j2), w the
    2^(log_n + step_log)-th root (w^-1 for the inverse), j2 = col // inner,
    from the two-level tables, on ``gl_ops``."""
    n, b = y.shape
    a, tb, split = _step_tables(log_n, step_log, inverse, y.device)
    nlo, nhi = 1 << split, 1 << (step_log - split)
    y = G.gl_mul(y.reshape(n, nhi, nlo, inner), tb[:, None, :, None])
    if a is not None:
        y = G.gl_mul(y, a[:, :, None, None])
    return y.reshape(n, b)


def _fourstep(log_n1: int, log_n2: int, x: torch.Tensor, inverse: bool,
              tile_log: int, scale: int | None) -> torch.Tensor:
    """NTT over axis 0 of x (n1 n2, B): the column pass with the step
    twiddle (fused into the store up to the tile; above it the recursive
    `_ntt_axis0`, then `_step_twiddle`), a transpose (a torch copy), then
    the row pass, which takes the scale; the output index is k1 + n1 k2."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    b = x.shape[1]
    cols = x.reshape(n1, n2 * b)
    if log_n1 <= tile_log:
        c = gl_ntt(cols, log_n1, inverse, step_log=log_n2, inner=b)
    else:
        c = _step_twiddle(_ntt_axis0(log_n1, cols, inverse, tile_log, None),
                          log_n1, log_n2, inverse, b)
    r = c.reshape(n1, n2, b).transpose(0, 1).contiguous().reshape(n2, n1 * b)
    return _ntt_axis0(log_n2, r, inverse, tile_log, scale).reshape(n1 * n2, b)


def _ntt_axis0(log_n: int, x: torch.Tensor, inverse: bool, tile_log: int,
               scale: int | None) -> torch.Tensor:
    """One launch up to the tile, else the four-step split (the
    reference's `_ntt_axis0`, split at the tile instead of 2^9)."""
    if log_n <= tile_log:
        return gl_ntt(x, log_n, inverse, scale=scale)
    l1 = (min(tile_log, log_n - tile_log) if log_n > 2 * tile_log
          else log_n // 2)
    return _fourstep(l1, log_n - l1, x, inverse, tile_log, scale)


def _prepare(x: torch.Tensor, n: int, dims: int, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError("x: expected a torch.int64 tensor of canonical "
                        "Goldilocks elements")
    if x.dim() != dims or x.shape[0] != n:
        raise ValueError(f"x: expected {dims} dims with {n} rows, got "
                         f"{tuple(x.shape)}")
    return x.to(resolve_device(device)).contiguous()


def ntt_packed(log_n: int, x: torch.Tensor, inverse: bool = False,
               device=None, *, _tile_log: int = TILE_LOG) -> torch.Tensor:
    """Forward (or inverse, scaled by n^-1) NTT over axis 0 of x (n, B),
    on `device` (the card unless the caller asks for the CPU)."""
    n = 1 << log_n
    x = _prepare(x, n, 2, device)
    scale = pow(n, -1, G.Q) if inverse and n > 1 else None
    return _ntt_axis0(log_n, x, inverse, _tile_log, scale)


def ntt_fourstep_packed(log_n1: int, log_n2: int, x: torch.Tensor,
                        device=None) -> torch.Tensor:
    """Forward NTT of x (2^(log_n1 + log_n2),) by the four-step split:
    2^log_n1-point column transforms with the step twiddle (split again
    above TILE_LOG), then 2^log_n2-point row transforms; natural order, on
    `device` (the card unless the caller asks for the CPU)."""
    n = 1 << (log_n1 + log_n2)
    x = _prepare(x, n, 1, device)
    return _fourstep(log_n1, log_n2, x.reshape(n, 1), False, TILE_LOG,
                     None).reshape(n)
