"""The rows a bucket accumulate walks: the nonzero signed digits of the
cell's scalars under the plan the run reports.

Window w of a scalar holds its bits [c·w, c·w + c) plus the carry from
window w - 1; a value of 2^(c-1) or more becomes value - 2^c and carries
one (the MSB-negated signed digits of the Pippenger method).  A zero digit
adds nothing and is not walked."""

from __future__ import annotations

import torch

from .generator import LIMB_BITS
from .reference import curve


def n_windows(c: int) -> int:
    """Windows of c bits over the scalar, plus one for the last carry."""
    return -(-curve.SCALAR_BITS // c) + 1


def nonzero_digits(limbs: torch.Tensor, c: int) -> int:
    """The nonzero signed digits of (n, L) base-2^15 limbs over
    `n_windows(c)` windows (c <= 18: a window spans at most three limbs)."""
    n, n_limbs = limbs.shape
    zero = torch.zeros(n, dtype=torch.int64, device=limbs.device)

    def limb(i):
        return limbs[:, i].to(torch.int64) & 0x7FFF if i < n_limbs else zero

    carry = torch.zeros(n, dtype=torch.int64, device=limbs.device)
    count = 0
    for w in range(n_windows(c)):
        i, sh = divmod(w * c, LIMB_BITS)
        word = limb(i) | (limb(i + 1) << LIMB_BITS) | (limb(i + 2) << 30)
        raw = ((word >> sh) & ((1 << c) - 1)) + carry
        over = raw >= 1 << (c - 1)
        count += int(((raw != 0) & (raw != 1 << c)).sum())
        carry = over.to(torch.int64)
    return count


def window_buckets(c: int) -> list[int]:
    """Buckets of each window: 2^(c-1), or fewer for a top window whose
    digits are bounded lower (its few raw bits plus the carry), as the
    program's grouping sizes them (at least 4, a power of two)."""
    full = 1 << (c - 1)
    out = []
    for w in range(n_windows(c)):
        raw_bits = min(c, max(0, curve.SCALAR_BITS - w * c))
        dmax = min(full, (1 << raw_bits) + 1)
        out.append(min(full, max(4, 1 << (dmax - 1).bit_length())))
    return out
