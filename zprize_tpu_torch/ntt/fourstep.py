"""Four-step NTT over any field's Montgomery words: 2^(l1+l2) = 2^l1 x 2^l2.

Column transforms, the step-twiddle correction W[k1, j2] = w^(k1 j2), row
transforms, and the output read as A[k1 + n1 k2] = M[k1, k2] (the
decomposition every prize2-ntt entry uses for 2^24, cf.
`prize2-ntt/hardcaml/zprize/ntt/docs/zprize_ntt_top.mld:53-75`).  Every
sub-transform goes through `radix2.ntt/intt`, so on the card through the
field's NTT kernel.  Bit-exact with the direct transform; bench.py's
Goldilocks metric uses it as its correctness reference.
"""

from __future__ import annotations

import torch

from ..field import fp
from ..field.spec import FieldSpec
from ..utils.device import resolve_device
from .domain import Domain
from .radix2 import intt, ntt

_tw_cache: dict = {}


def twiddle_matrix(spec: FieldSpec, log_n1: int, log_n2: int,
                   inverse: bool = False, device=None) -> torch.Tensor:
    """W[k1, j2] = w_n^(±k1 j2), n = 2^(l1+l2), as (n1, n2, n_words)
    Montgomery words on `device` (the card unless the caller asks for the
    CPU); cached per domain and device."""
    dom = Domain(spec, log_n1 + log_n2, device)
    key = (spec.name, log_n1, log_n2, inverse, dom.device)
    if key not in _tw_cache:
        half = dom.pows_inv if inverse else dom.pows          # (n/2, L)
        # w^(n/2) = -1, so the top half is the negation
        full = torch.cat([half, fp.neg(spec, half)], dim=0)
        k1 = torch.arange(1 << log_n1, device=dom.device)[:, None]
        j2 = torch.arange(1 << log_n2, device=dom.device)[None, :]
        _tw_cache[key] = full[(k1 * j2) % dom.n]
    return _tw_cache[key]


def ntt_fourstep(spec: FieldSpec, a: torch.Tensor, log_n1: int, log_n2: int,
                 device=None) -> torch.Tensor:
    """Forward NTT of a natural-order (n, L) array via the four-step
    decomposition, on `device` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    tw = twiddle_matrix(spec, log_n1, log_n2, False, device)
    n1, n2 = 1 << log_n1, 1 << log_n2
    m = a.to(tw.device).reshape(n1, n2, -1)
    m = ntt(Domain(spec, log_n1, device), m, axis=0)       # column NTTs
    m = fp.mul(spec, m, tw)
    m = ntt(Domain(spec, log_n2, device), m, axis=1)       # row NTTs
    return m.transpose(0, 1).reshape(n1 * n2, -1)


def intt_fourstep(spec: FieldSpec, a: torch.Tensor, log_n1: int, log_n2: int,
                  device=None) -> torch.Tensor:
    """Inverse of `ntt_fourstep` (includes the 1/n scale)."""
    device = resolve_device(device)
    tw_inv = twiddle_matrix(spec, log_n1, log_n2, True, device)
    n1, n2 = 1 << log_n1, 1 << log_n2
    # invert the output permutation: M[k1, k2] = A[k1 + n1 k2]
    m = a.to(tw_inv.device).reshape(n2, n1, -1).transpose(0, 1)
    m = intt(Domain(spec, log_n2, device), m, axis=1)
    m = fp.mul(spec, m, tw_inv)
    m = intt(Domain(spec, log_n1, device), m, axis=0)
    return m.reshape(n1 * n2, -1)
