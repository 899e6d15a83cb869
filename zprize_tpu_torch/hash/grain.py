"""Grain-LFSR Poseidon parameter generation (host side, python ints).

This is the standard parameter-derivation procedure from the Poseidon
reference implementation (Grassi et al., "Poseidon: A New Hash Function for
Zero-Knowledge Proof Systems", USENIX'21), as instantiated by snarkVM
(`fields/src/traits/poseidon_grain_lfsr.rs`, `poseidon_default.rs`) and
arkworks.  Our outputs are validated bit-exactly against the reference's
checked-in snapshot fixtures (see `tests/fixtures/poseidon_fr377_rate2.json`).
"""

from __future__ import annotations

import dataclasses
import functools

from ..field.spec import FieldSpec


class GrainLFSR:
    def __init__(self, is_sbox_inverse: bool, field_bits: int, state_len: int,
                 full_rounds: int, partial_rounds: int):
        bits = [False] * 80
        bits[1] = True  # field descriptor
        bits[5] = is_sbox_inverse

        def put(value, lo, hi):
            for i in range(hi, lo - 1, -1):
                bits[i] = (value & 1) == 1
                value >>= 1

        put(field_bits, 6, 17)
        put(state_len, 18, 29)
        put(full_rounds, 30, 39)
        put(partial_rounds, 40, 49)
        for i in range(50, 80):
            bits[i] = True
        self.state = bits
        self.head = 0
        self.field_bits = field_bits
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> bool:
        s, h = self.state, self.head
        nb = (s[(h + 62) % 80] ^ s[(h + 51) % 80] ^ s[(h + 38) % 80]
              ^ s[(h + 23) % 80] ^ s[(h + 13) % 80] ^ s[h])
        s[h] = nb
        self.head = (h + 1) % 80
        return nb

    def get_bits(self, n: int) -> int:
        """n sampled bits, MSB first, as an integer (von-Neumann pair
        sampling: leading-zero pairs are discarded)."""
        v = 0
        for _ in range(n):
            first = self._next_bit()
            while not first:
                self._next_bit()          # discard second bit
                first = self._next_bit()
            v = (v << 1) | int(self._next_bit())
        return v

    def field_elements_rejection(self, p: int, count: int) -> list[int]:
        out = []
        while len(out) < count:
            v = self.get_bits(self.field_bits)
            if v < p:
                out.append(v)
        return out

    def field_elements_mod_p(self, p: int, count: int) -> list[int]:
        return [self.get_bits(self.field_bits) % p for _ in range(count)]


@dataclasses.dataclass(frozen=True)
class PoseidonConfig:
    """Static Poseidon configuration (python ints; device tables built in
    `poseidon.py`)."""
    spec: FieldSpec
    rate: int
    capacity: int
    alpha: int
    full_rounds: int
    partial_rounds: int
    ark: tuple            # (rounds, t) ints
    mds: tuple            # (t, t) ints

    @property
    def t(self):
        return self.rate + self.capacity


# snarkVM's default table (curves/src/bls12_377/fr.rs:147-156 and fq.rs):
# every rate 2..8 uses alpha=17, 8 full rounds, 31 partial rounds, skip 0.
_SNARKVM_DEFAULTS = {r: (17, 8, 31, 0) for r in range(2, 9)}


@functools.lru_cache(maxsize=None)
def snarkvm_config(spec: FieldSpec, rate: int) -> PoseidonConfig:
    """Parameters matching snarkVM's `default_poseidon_parameters::<RATE>()`."""
    alpha, rf, rp, skip = _SNARKVM_DEFAULTS[rate]
    return generate_config(spec, rate, 1, alpha, rf, rp, skip)


@functools.lru_cache(maxsize=None)
def generate_config(spec: FieldSpec, rate: int, capacity: int, alpha: int,
                    full_rounds: int, partial_rounds: int,
                    skip_matrices: int = 0) -> PoseidonConfig:
    p = spec.p
    t = rate + capacity
    bits = p.bit_length()
    lfsr = GrainLFSR(False, bits, t, full_rounds, partial_rounds)
    rounds = full_rounds + partial_rounds
    ark = tuple(tuple(lfsr.field_elements_rejection(p, t)) for _ in range(rounds))
    for _ in range(skip_matrices):
        lfsr.field_elements_mod_p(p, 2 * t)
    xs = lfsr.field_elements_mod_p(p, t)
    ys = lfsr.field_elements_mod_p(p, t)
    mds = tuple(tuple(pow((x + y) % p, p - 2, p) for y in ys) for x in xs)
    return PoseidonConfig(spec, rate, capacity, alpha, full_rounds,
                          partial_rounds, ark, mds)
