"""Plain PyTorch prime-field engine: Montgomery arithmetic on word planes.

Representation (shared with the CUDA header ``csrc/fq.cuh``):

* an element is ``n_words(spec)`` little-endian 32-bit words in Montgomery
  form, R = 2**(32 * n_words), fully reduced to [0, p);
* it is stored as ``torch.int32`` with shape ``(..., n_words)``, contiguous,
  one row per element (12 words and R = 2**384 for Fq377).

Every function returns fully reduced values, so this engine and the device
engine agree bit for bit: a kernel is checked against its plain version by
exact equality.

torch has no add, shift or compare on uint32, so the arithmetic runs in
int64 on 16-bit digits, digit-major ``(n_digits, batch)``.  The product is a
separated-operand-scanning Montgomery multiply: each of the ``n_digits``
steps adds one row of partial products and one multiple of p, with lazy
column sums (below 2**38) and only the lowest column's carry passed on.
Carries are resolved by parallel carry passes and a carry-lookahead, never
by a digit-serial ripple, and a conditional subtraction finishes.  The engine
runs on any device.  On the card it serves the glue between kernels
(conversion, batch inversion) as XLA ops did for the reference package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .spec import FieldSpec

_D = 16                      # digit bits
_DMASK = (1 << _D) - 1


def n_words(spec: FieldSpec) -> int:
    """32-bit words per element (12 for the 377/381-bit fields)."""
    return (spec.p.bit_length() + 31) // 32


@dataclasses.dataclass(frozen=True)
class _Consts:
    nw: int                  # words per element
    nd: int                  # 16-bit digits per element
    r: int                   # R mod p (Montgomery one)
    r2: int                  # R^2 mod p
    n0: int                  # -p^-1 mod 2^16


@functools.lru_cache(maxsize=None)
def _consts(spec: FieldSpec) -> _Consts:
    nw = n_words(spec)
    p = spec.p
    big_r = 1 << (32 * nw)
    return _Consts(nw, 2 * nw, big_r % p, big_r * big_r % p,
                   (-pow(p, -1, 1 << _D)) % (1 << _D))


def montgomery_params(spec: FieldSpec) -> dict:
    """Host ints the device engine needs: p, R mod p, R^2 mod p and
    -p^-1 mod 2^32."""
    c = _consts(spec)
    return {"p": spec.p, "one": c.r, "r2": c.r2,
            "n0": (-pow(spec.p, -1, 1 << 32)) % (1 << 32)}


@functools.lru_cache(maxsize=None)
def _p_col(spec: FieldSpec, device: torch.device) -> torch.Tensor:
    """p as a (n_digits + 1, 1) int64 digit column (top digit 0)."""
    nd = _consts(spec).nd
    digs = [(spec.p >> (_D * j)) & _DMASK for j in range(nd + 1)]
    return torch.tensor(digs, dtype=torch.int64, device=device)[:, None]


# ---------------------------------------------------------------------------
# words <-> digits
# ---------------------------------------------------------------------------


def _to_digits(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """(..., nw) int32 words -> (nd, B) int64 digits, B = batch size."""
    c = _consts(spec)
    if a.dtype != torch.int32 or a.shape[-1] != c.nw:
        raise ValueError(f"expected (..., {c.nw}) int32 words, got "
                         f"{tuple(a.shape)} {a.dtype}")
    w = a.reshape(-1, c.nw).to(torch.int64) & 0xFFFFFFFF
    d = torch.stack([w & _DMASK, w >> _D], dim=-1).reshape(-1, c.nd)
    return d.t().contiguous()


def _from_digits(spec: FieldSpec, d: torch.Tensor, shape) -> torch.Tensor:
    """(nd, B) normalized digits (< 2^16) -> (*shape, nw) int32 words."""
    c = _consts(spec)
    d = d[:c.nd].t().reshape(-1, c.nw, 2)
    w = d[..., 0] | (d[..., 1] << _D)
    w = w - ((w >> 31) << 32)               # into int32 range, same bits
    return w.to(torch.int32).reshape(*shape, c.nw)


def _norm(t: torch.Tensor, passes: int) -> torch.Tensor:
    """Exact carry normalization of (k, B) int64 columns: rows 0..k-2 end
    in [0, 2^16) and the top row absorbs the excess.

    The lower rows must be non-negative.  `passes` parallel carry passes
    bring every lower digit to at most 2^16 + 2^15 (one pass from below
    2^31, two from below 2^47), so the remaining carries are 0 or 1 and a
    carry-lookahead (the last non-propagating digit decides each carry)
    resolves them without a sequential ripple."""
    for _ in range(passes):
        hi = t[:-1] >> _D
        t[:-1] &= _DMASK
        t[1:] += hi
    lo = t[:-1] & _DMASK
    gen = (t[:-1] >> _D) != 0              # carries out (lo <= 2^15 then)
    stop = lo != _DMASK                    # every digit but a full one
    rows = torch.arange(lo.shape[0], device=t.device)[:, None]
    last = torch.where(stop, rows, -1).cummax(dim=0).values
    cout = (last >= 0) & gen.gather(0, last.clamp(min=0))
    cout = cout.to(torch.int64)
    t[0] = lo[0]
    t[1:-1] = (lo[1:] + cout[:-1]) & _DMASK
    t[-1] += cout[-1]
    return t


@functools.lru_cache(maxsize=None)
def _reduce_consts(spec: FieldSpec, device: torch.device):
    """Digit columns (nd+1 rows) for the conditional subtraction and sub:
    powers of 3 for the lexicographic compare, the two's complement of p,
    and p in a borrowed form whose lower digits are all >= 2^16 - 1."""
    nd = _consts(spec).nd
    p = [(spec.p >> (_D * j)) & _DMASK for j in range(nd + 1)]
    comp = [_DMASK - d for d in p]
    comp[0] += 1
    borrowed = [p[0] + (1 << _D)] + [d + _DMASK for d in p[1:nd]] + [-1]
    col = lambda v: torch.tensor(v, dtype=torch.int64, device=device)[:, None]
    return col([3 ** j for j in range(nd + 1)]), col(comp), col(borrowed)


def _cond_sub(spec: FieldSpec, r: torch.Tensor) -> torch.Tensor:
    """(nd+1, B) normalized digits of a value in [0, 2p) -> [0, p) in the
    lower nd rows: subtract p (add its complement) where r >= p."""
    pow3, comp, _ = _reduce_consts(spec, r.device)
    ge = (torch.sign(r - _p_col(spec, r.device)) * pow3).sum(0) >= 0
    return _norm(r + ge * comp, 1)


def _mont_mul(spec: FieldSpec, ad: torch.Tensor, bd: torch.Tensor
              ) -> torch.Tensor:
    """Digit-major Montgomery product a*b/R, fully reduced (nd rows)."""
    c = _consts(spec)
    nd, batch = ad.shape
    pd = _p_col(spec, ad.device)[:nd]
    t = torch.zeros((2 * nd + 1, batch), dtype=torch.int64, device=ad.device)
    for i in range(nd):
        t[i:i + nd].addcmul_(bd, ad[i])
        m = (t[i] * c.n0) & _DMASK
        t[i:i + nd].addcmul_(pd, m)
        t[i + 1] += t[i] >> _D              # low 16 bits of t[i] are 0
    # columns stay below 2nd * 2^32 + 2^22 < 2^47: two carry passes
    return _cond_sub(spec, _norm(t[nd:], 2))


def _binary(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    a, b = torch.broadcast_tensors(a, b)
    return _to_digits(spec, a), _to_digits(spec, b), a.shape[:-1]


# ---------------------------------------------------------------------------
# public ops: (..., nw) int32 Montgomery words in, fully reduced words out
# ---------------------------------------------------------------------------


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ad, bd, shape = _binary(spec, a, b)
    return _from_digits(spec, _mont_mul(spec, ad, bd), shape)


def sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mul(spec, a, a)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ad, bd, shape = _binary(spec, a, b)
    s = torch.nn.functional.pad(ad + bd, (0, 0, 0, 1))
    return _from_digits(spec, _cond_sub(spec, _norm(s, 1)), shape)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + p lies in (0, 2p), so one conditional subtraction reduces;
    p in borrowed form keeps every lower digit of a - b + p non-negative."""
    ad, bd, shape = _binary(spec, a, b)
    s = torch.nn.functional.pad(ad - bd, (0, 0, 0, 1))
    s += _reduce_consts(spec, s.device)[2]
    return _from_digits(spec, _cond_sub(spec, _norm(s, 1)), shape)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """cond ? a : b per element; `cond` has the batch shape."""
    return torch.where(cond[..., None], a, b)


def eq(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=-1)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e for a fixed non-negative python-int exponent (MSB first)."""
    if e == 0:
        return ones(spec, a.shape[:-1], a.device)
    acc = a
    for bit in bin(e)[3:]:
        acc = sqr(spec, acc)
        if bit == "1":
            acc = mul(spec, acc, a)
    return acc


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2); the inverse of 0 is 0."""
    return pow_const(spec, a, spec.p - 2)


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Inverse of every element (any batch shape) with Montgomery's trick
    over a log-depth product tree: one Fermat inversion in all.  Zeros map
    to zero."""
    shape = a.shape
    flat = a.reshape(-1, shape[-1])
    m = flat.shape[0]
    if m == 0:
        return a.clone()
    zero = is_zero(spec, flat)
    one = ones(spec, (1,), a.device)
    cur = torch.where(zero[:, None], one, flat)
    m_pad = 1 << (m - 1).bit_length()
    if m_pad != m:
        cur = torch.cat([cur, one.expand(m_pad - m, -1)])
    levels = [cur]
    while cur.shape[0] > 1:
        cur = mul(spec, cur[0::2], cur[1::2])
        levels.append(cur)
    inv_cur = inv(spec, cur)
    for lvl in reversed(levels[:-1]):
        inv_left = mul(spec, inv_cur, lvl[1::2])
        inv_right = mul(spec, inv_cur, lvl[0::2])
        inv_cur = torch.stack([inv_left, inv_right], dim=1).reshape(lvl.shape)
    out = torch.where(zero[:, None], 0, inv_cur[:m])
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# constants and host conversion
# ---------------------------------------------------------------------------


def _ints_to_words(spec: FieldSpec, values, shape) -> torch.Tensor:
    """Flat python ints in [0, 2^(32 nw)) -> (*shape, nw) int32 words."""
    nw = _consts(spec).nw
    buf = b"".join(v.to_bytes(4 * nw, "little") for v in values)
    arr = np.frombuffer(buf, np.uint32).view(np.int32).reshape(*shape, nw)
    return torch.from_numpy(arr.copy())


def from_ints(spec: FieldSpec, values, device="cpu") -> torch.Tensor:
    """Python ints (any nesting; reduced mod p) -> Montgomery words."""
    arr = np.asarray(values, dtype=object)
    c = _consts(spec)
    flat = [int(v) % spec.p * c.r % spec.p for v in arr.reshape(-1)]
    return _ints_to_words(spec, flat, arr.shape).to(device)


def to_ints(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """Montgomery words -> numpy object array of canonical python ints
    (the words leave Montgomery form on the host: x*R^-1 mod p)."""
    c = _consts(spec)
    r_inv = pow(c.r, -1, spec.p)
    data = a.cpu().contiguous().numpy().view(np.uint32).reshape(-1, c.nw)
    out = np.empty((data.shape[0],), dtype=object)
    for i, row in enumerate(data):
        out[i] = int.from_bytes(row.tobytes(), "little") * r_inv % spec.p
    return out.reshape(tuple(a.shape[:-1]))


@functools.lru_cache(maxsize=None)
def _const_row(spec: FieldSpec, value: int, device: torch.device
               ) -> torch.Tensor:
    return from_ints(spec, [value], device)[0]


def constant(spec: FieldSpec, value: int, shape=(), device="cpu"
             ) -> torch.Tensor:
    """Montgomery words of `value`, broadcast (a view) to `shape`."""
    row = _const_row(spec, value % spec.p, torch.device(device))
    return row.expand(*shape, row.shape[-1])


def ones(spec: FieldSpec, shape=(), device="cpu") -> torch.Tensor:
    return constant(spec, 1, shape, device)


def zeros(spec: FieldSpec, shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((*shape, n_words(spec)), dtype=torch.int32,
                       device=device)


def raw_words(spec: FieldSpec, value: int, device="cpu") -> torch.Tensor:
    """The words of `value` itself (no Montgomery scaling)."""
    return _ints_to_words(spec, [value], (1,))[0].to(device)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical words (value < p) -> Montgomery words."""
    return mul(spec, a, raw_words(spec, _consts(spec).r2, a.device))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery words -> canonical words."""
    return mul(spec, a, raw_words(spec, 1, a.device))
