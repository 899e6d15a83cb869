"""Field specifications: primes, limb layout, and derived reduction tables.

TPU-first design notes
----------------------
The reference entries implement large-prime arithmetic with carry-chained
Montgomery multiplication over 32/64-bit machine words (e.g. the CUDA
Montgomery multiplier in the yrrid entry, ``yrrid-msm/MP.cu:141-239``, and the
generic template ``sppark/ff/mont_t.cuh``).  TPUs have no scalar 64-bit
integer datapath and no carry flag, so we do NOT port that design.  Instead:

* A field element is a little-endian vector of ``n_limbs`` base ``2**15``
  digits stored in a ``uint32`` plane: shape ``(..., n_limbs)``.
* The representation is *redundant*: limb values may be as large as
  ``2**16 - 1`` (one bit of headroom over the base) and the integer value is
  only kept reduced modulo ``p`` lazily.  This mirrors the insight of the
  winning WASM entries (30-bit limbs in 32-bit words / ``[0, 2q)`` redundant
  form — see ``open-division/prize4-msm-wasm/mitschabaude/README.md:51-60``
  and ``snarkify``'s README) but is chosen here so that *every* carry
  propagation is a fixed, data-independent number of vectorized passes —
  there are no sequential carry ripples anywhere on the hot path.
* Modular reduction is Montgomery-free: the high limbs of a wide product are
  folded back with a precomputed table of ``2**(15*k) mod p`` limb vectors
  (a small constant matrix product).  This keeps elements in the *standard*
  representation (no to/from-Montgomery conversions at API boundaries, unlike
  ``mont_t.cuh``) and maps onto dense vector/matrix ops.

The base of 2**15 (rather than 2**16) buys the single redundancy bit that
makes a fixed two/three-pass carry normalization sound: products of two
limbs < 2**16 are exact in uint32, and all column accumulations stay below
2**32 by static bounds analysis (see ``reduction plan`` in ``fp.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

BASE_BITS = 15
BASE = 1 << BASE_BITS
LIMB_MASK = BASE - 1
# Invariant bound on limb values in the redundant representation.
REDUNDANT_LIMB_BOUND = 1 << 16


def limbs_from_int(value: int, n_limbs: int, base_bits: int = BASE_BITS) -> np.ndarray:
    """Decompose a non-negative python int into little-endian limbs."""
    if value < 0:
        raise ValueError("limbs_from_int requires a non-negative value")
    out = np.zeros((n_limbs,), dtype=np.uint32)
    mask = (1 << base_bits) - 1
    for i in range(n_limbs):
        out[i] = value & mask
        value >>= base_bits
    if value != 0:
        raise ValueError(f"value does not fit in {n_limbs} limbs of {base_bits} bits")
    return out


def int_from_limbs(limbs, base_bits: int = BASE_BITS) -> int:
    """Recompose a python int from little-endian limbs (any per-limb values)."""
    value = 0
    for i, limb in enumerate(reversed(list(limbs))):
        value = (value << base_bits) + int(limb)
    return value


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field and its limb layout.

    Hashable and comparable by (name, p) so it can be used as a static
    argument to jitted functions.
    """

    name: str
    p: int
    # Multiplicative generator of F_p^* (smallest is fine); used to derive
    # roots of unity for NTT domains.
    generator: int
    n_limbs: int = 0  # 0 = derive from p

    def __post_init__(self):
        if self.n_limbs == 0:
            n = (self.p.bit_length() + BASE_BITS - 1) // BASE_BITS
            object.__setattr__(self, "n_limbs", n)
        if self.p.bit_length() > self.n_limbs * BASE_BITS:
            raise ValueError("n_limbs too small for p")

    # ---- derived, cached tables (host-side numpy; become jnp constants) ----

    @functools.cached_property
    def two_adicity(self) -> int:
        s, m = 0, self.p - 1
        while m % 2 == 0:
            s, m = s + 1, m // 2
        return s

    @functools.cached_property
    def root_of_unity(self) -> int:
        """A primitive 2**two_adicity-th root of unity."""
        return pow(self.generator, (self.p - 1) >> self.two_adicity, self.p)

    @functools.cached_property
    def fold_table(self) -> np.ndarray:
        """Row j = canonical limbs of 2**(15*(n_limbs + j)) mod p.

        Rows j = 0..n_limbs inclusive (the extra row absorbs the base-2**15
        spill of split high columns during folding).
        """
        n = self.n_limbs
        rows = [limbs_from_int(pow(2, BASE_BITS * (n + j), self.p), n) for j in range(n + 2)]
        return np.stack(rows).astype(np.uint32)

    @functools.cached_property
    def neg_helper(self) -> np.ndarray:
        """Limbs of M = D - (D mod p) where D = all limbs 0xFFFF.

        M is a multiple of p whose limbs are each >= 2**15 and <= 0xFFFF, so
        ``M - b`` can be computed limbwise without borrows for any element
        ``b`` respecting the redundant limb bound minus... (b limbs <= 0xFFFF).
        Used for branch-free negation/subtraction.
        """
        n = self.n_limbs
        d_val = int_from_limbs([0xFFFF] * n)
        # M = D - (D mod p); limbwise: 0xFFFF - canonical(<2**15) per limb.
        mm = (np.full((n,), 0xFFFF, np.int64)
              - limbs_from_int(d_val % self.p, n).astype(np.int64))
        assert np.all(mm >= BASE), "neg helper limb below 2**15"
        assert int_from_limbs(mm) % self.p == 0
        return mm.astype(np.uint32)

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return limbs_from_int(self.p, self.n_limbs)

    @functools.cached_property
    def p_multiples(self) -> np.ndarray:
        """Canonicalization constants: rows k = limbs of 2**k * p while they
        still fit in n_limbs+1 limbs, descending order (largest first)."""
        n = self.n_limbs
        max_val = (1 << (BASE_BITS * n + 1))  # value bound of redundant rep
        rows = []
        k = 0
        while (self.p << k) < max_val:
            k += 1
        for j in range(k - 1, -1, -1):
            rows.append(limbs_from_int(self.p << j, n + 1))
        return np.stack(rows).astype(np.uint32)

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    def __hash__(self):
        return hash((self.name, self.p, self.n_limbs))

    def __eq__(self, other):
        return (
            isinstance(other, FieldSpec)
            and (self.name, self.p, self.n_limbs) == (other.name, other.p, other.n_limbs)
        )


# ---------------------------------------------------------------------------
# Standard field instances for the ZPrize workloads.
#
# Primes/generators are standard public parameters of BLS12-377 / BLS12-381 /
# Goldilocks (cf. the constants embedded in the reference's
# ``sppark/ff/bls12-377.hpp:10-31``, arkworks ``ark-bls12-377``/``ark-bls12-381``
# and the Goldilocks modulus in
# ``open-division/prize2-ntt/cosic/testvectors/testvectors.py:3``).
# ---------------------------------------------------------------------------

# BLS12-377 base field (G1 coordinates), 377 bits.
BLS12_377_FQ = FieldSpec(
    name="bls12_377_fq",
    p=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    generator=15,  # smallest multiplicative generator of Fq377
)

# BLS12-377 scalar field Fr (= base field of the Edwards inner curve),
# 253 bits, 2-adicity 47.
BLS12_377_FR = FieldSpec(
    name="bls12_377_fr",
    p=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    generator=22,
)

# BLS12-381 base field, 381 bits.
BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    p=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
)

# BLS12-381 scalar field Fr, 255 bits, 2-adicity 32.
BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    p=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
)

# Goldilocks: q = 2**64 - 2**32 + 1 (prize2-ntt field), 2-adicity 32.
GOLDILOCKS = FieldSpec(
    name="goldilocks",
    p=(1 << 64) - (1 << 32) + 1,
    generator=7,
)

ALL_SPECS = [BLS12_377_FQ, BLS12_377_FR, BLS12_381_FQ, BLS12_381_FR, GOLDILOCKS]
