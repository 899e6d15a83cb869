"""Polynomial operations over a prime field: coefficient planes
(..., n, n_words) of Montgomery words, lowest degree first.

Each operation is an NTT, a wide elementwise op or a log-depth scan; none
is a sequential Horner or synthetic-division loop (the reference's op set,
`snarkvm-cuda/cuda/snarkvm.cu:1126-1338`, and jf-plonk's prover helpers).
"""

from __future__ import annotations

import functools

import torch

from ..field import fp
from ..field.spec import FieldSpec
from ..ntt.domain import Domain, power_table
from ..ntt.radix2 import intt, ntt


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def pad_to(spec: FieldSpec, a: torch.Tensor, n: int) -> torch.Tensor:
    """Zero coefficients appended up to length n (or cut to n)."""
    k = a.shape[-2]
    if k >= n:
        return a[..., :n, :]
    return torch.nn.functional.pad(a, (0, 0, 0, n - k))


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = max(a.shape[-2], b.shape[-2])
    return fp.add(spec, pad_to(spec, a, n), pad_to(spec, b, n))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = max(a.shape[-2], b.shape[-2])
    return fp.sub(spec, pad_to(spec, a, n), pad_to(spec, b, n))


def scale(spec: FieldSpec, a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Multiply every coefficient by the scalar row k (n_words,)."""
    return fp.mul(spec, a, k)


@functools.lru_cache(maxsize=None)
def gpow(spec: FieldSpec, g: int, count: int, inverse: bool = False,
         device=torch.device("cpu")) -> torch.Tensor:
    """[g^0 .. g^(count-1)] (or of g^-1) as (count, n_words) words on
    `device`, built once per (field, g, count, direction, device): the coset
    scalings of the prover reuse it on every call."""
    gg = pow(g, -1, spec.p) if inverse else g
    return power_table(spec, count, gg, device)


def powers(spec: FieldSpec, z: torch.Tensor, count: int) -> torch.Tensor:
    """[1, z, ..., z^(count-1)] for scalar rows z (..., n_words) on their
    device, as (..., count, n_words): a log-doubling ladder (each step
    appends the known prefix times z^k and squares z^k), log2(count)
    multiplications."""
    pows = fp.ones(spec, (*z.shape[:-1], 1), z.device)
    zk = z[..., None, :]
    while pows.shape[-2] < count:
        take = min(pows.shape[-2], count - pows.shape[-2])
        pows = torch.cat([pows, fp.mul(spec, pows[..., :take, :], zk)], -2)
        zk = fp.sqr(spec, zk)
    return pows[..., :count, :]


def sum_axis(spec: FieldSpec, a: torch.Tensor, axis: int) -> torch.Tensor:
    """Field sum along `axis` by a log-depth tree of adds."""
    x = torch.movedim(a, axis, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        merged = fp.add(spec, x[:half], x[half:2 * half])
        if x.shape[0] % 2:
            merged = torch.cat([merged, x[2 * half:]])
        x = merged
    return x[0]


def evaluate(spec: FieldSpec, a: torch.Tensor, z: torch.Tensor
             ) -> torch.Tensor:
    """p(z) for every polynomial of a (..., n, n_words) at the scalar row
    z (n_words,), or at one row a polynomial (z of a's batch shape): the
    power ladder and a log-depth sum (replaces Horner).  Returns
    (..., n_words)."""
    return sum_axis(spec, fp.mul(spec, a, powers(spec, z, a.shape[-2])), -2)


def mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial product via NTT (length len(a) + len(b) - 1)."""
    na, nb = a.shape[-2], b.shape[-2]
    n = _next_pow2(na + nb - 1)
    dom = Domain(spec, n.bit_length() - 1, a.device)
    fa = ntt(dom, pad_to(spec, a, n))
    fb = ntt(dom, pad_to(spec, b, n))
    return intt(dom, fp.mul(spec, fa, fb))[..., :na + nb - 1, :]


def divide_linear(spec: FieldSpec, a: torch.Tensor, z: torch.Tensor):
    """(quotient, remainder) of a(X) / (X - z) for a (..., n, n_words) and
    z (..., n_words) (one z for every polynomial, or one a polynomial).

    The quotient is q_i = sum_{k > i} a_k z^(k-1-i): with c_j = a_{n-1-j},
    q_i = P_{n-2-i} for the prefix sums P_k = sum_{j <= k} c_j z^(k-j).  All
    the recurrence's multipliers equal z, so a Hillis-Steele scan computes
    them in log2(n) steps, P_k += z^d P_{k-d} for d = 1, 2, 4, ...: the
    log-depth form of the reference's associative scan over affine maps
    (its replacement of the sequential KZG witness loop,
    `snarkVM polycommit/kzg10/mod.rs:402`)."""
    n = a.shape[-2]
    if n == 1:
        return (fp.zeros(spec, (*a.shape[:-2], 1), a.device),
                a[..., 0, :])
    pre = a[..., 1:, :].flip(-2)                  # c_0 .. c_{n-2}
    zd = z[..., None, :]
    d = 1
    while d < n - 1:
        pre = torch.cat([pre[..., :d, :],
                         fp.add(spec, pre[..., d:, :],
                                fp.mul(spec, pre[..., :-d, :], zd))], -2)
        zd = fp.sqr(spec, zd)
        d *= 2
    quotient = pre.flip(-2)                       # q_0 .. q_{n-2}
    remainder = fp.add(spec, fp.mul(spec, z, quotient[..., 0, :]),
                       a[..., 0, :])
    return quotient, remainder
