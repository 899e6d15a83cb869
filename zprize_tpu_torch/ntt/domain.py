"""NTT evaluation domains: roots of unity and twiddle tables.

For Goldilocks the primitive 2^32-th root of unity is pinned to the value
of the prize2-ntt reference vectors
(`open-division/prize2-ntt/cosic/testvectors/testvectors.py:5`), so
transforms match the competition's golden files.  For other fields the
root is derived from the field's multiplicative generator (the arkworks
Radix2 convention, cf. snarkVM `algorithms/src/fft/domain.rs`).

Power tables are built on the host from python ints (a running product,
exact by construction) and held on the domain's device as Montgomery word
rows of ``field/fp.py``; for Goldilocks also as canonical u64 values in
int64 (``gl_powers``), the form the Goldilocks NTT kernel reads.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import fp
from ..field.spec import GOLDILOCKS, FieldSpec
from ..utils.device import resolve_device

# Reference 2^32-th root for Goldilocks (cosic testvectors.py, N=2**32).
_GOLDILOCKS_W32 = 11724716146725638212


def primitive_root(spec: FieldSpec, log_n: int) -> int:
    """A primitive 2^log_n-th root of unity as a python int."""
    if not 0 <= log_n <= spec.two_adicity:
        raise ValueError(f"{spec.name} supports only 2^0..2^"
                         f"{spec.two_adicity} domains, not 2^{log_n}")
    if spec.name == GOLDILOCKS.name:
        w = _GOLDILOCKS_W32
        for _ in range(32 - log_n):
            w = w * w % spec.p
        return w
    w = spec.root_of_unity
    for _ in range(spec.two_adicity - log_n):
        w = w * w % spec.p
    return w


def power_ints(spec: FieldSpec, count: int, w: int) -> list[int]:
    """[1, w, w^2, ..., w^(count-1)] as python ints."""
    vals = [1] * count
    for k in range(1, count):
        vals[k] = vals[k - 1] * w % spec.p
    return vals


@functools.lru_cache(maxsize=None)
def _power_table(spec: FieldSpec, count: int, w: int) -> torch.Tensor:
    """power_ints as (count, n_words) Montgomery words on the CPU."""
    return fp.from_ints(spec, power_ints(spec, count, w))


def power_table(spec: FieldSpec, count: int, w: int, device="cpu"
                ) -> torch.Tensor:
    return _power_table(spec, count, w).to(device)


def _indexed(device: torch.device) -> torch.device:
    """The card as cuda:<current index>, so that cache keys agree."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _gl_power_table(log_n: int, inverse: bool) -> torch.Tensor:
    q = GOLDILOCKS.p
    w = primitive_root(GOLDILOCKS, log_n)
    vals = power_ints(GOLDILOCKS, max(1, (1 << log_n) // 2),
                      pow(w, q - 2, q) if inverse else w)
    return torch.from_numpy(np.array(vals, dtype=np.uint64).view(np.int64))


_gl_tables: dict = {}


def gl_powers(log_n: int, inverse: bool = False, device=None
              ) -> torch.Tensor:
    """Goldilocks w^0 .. w^(n/2 - 1) (of w^-1 for the inverse; one entry
    for n = 1) as canonical u64 values in int64, on `device` (the card
    unless the caller asks for the CPU); cached per device."""
    device = _indexed(resolve_device(device))
    key = (log_n, inverse, device)
    if key not in _gl_tables:
        _gl_tables[key] = _gl_power_table(log_n, inverse).to(device)
    return _gl_tables[key]


def bitrev_perm(log_n: int, device="cpu") -> torch.Tensor:
    """The bit-reversal permutation of 0..2^log_n - 1 (int64)."""
    idx = torch.arange(1 << log_n, device=device)
    out = torch.zeros_like(idx)
    for b in range(log_n):
        out |= ((idx >> b) & 1) << (log_n - 1 - b)
    return out


class Domain:
    """Radix-2 evaluation domain of size 2^log_n over `spec`, with its
    twiddle tables on `device` (the card unless the caller asks for the
    CPU): `pows` = w^0 .. w^(n/2 - 1) and `pows_inv` the same for w^-1 (one
    entry for n = 1).  Built once per
    (field, size, device) and reused: the analog of the reference's cached
    twiddles (`ntt-cuda/ntt_parameters/ntt_twiddles.cu`)."""

    _cache: dict = {}

    def __new__(cls, spec: FieldSpec, log_n: int, device=None):
        device = _indexed(resolve_device(device))
        key = (spec.name, log_n, device)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        self.spec = spec
        self.log_n = log_n
        self.n = 1 << log_n
        self.device = device
        self.w = primitive_root(spec, log_n)
        self.w_inv = pow(self.w, -1, spec.p)
        self.n_inv = pow(self.n, -1, spec.p)
        half = max(1, self.n // 2)
        self.pows = power_table(spec, half, self.w, device)
        self.pows_inv = power_table(spec, half, self.w_inv, device)
        self.bitrev = bitrev_perm(log_n, device)
        cls._cache[key] = self
        return self
