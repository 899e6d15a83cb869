"""In-circuit Poseidon + Merkle-membership gadgets and the partial-circuit
merge workload generator.

Mirrors the reference's circuit workload
(`prize3-plonk-dizk/winderica/distributed/src/circuit.rs`):
`generate_circuit` (:676-703) builds one partial circuit per membership
proof and merges them with index offsets (`PlonkCircuit::{new_partial,
merge}` :356-384).  The hash is the same Poseidon the proving stack uses
(snarkVM Grain parameters, rate 2, alpha 17) so the circuit is validated
bit-for-bit against `hash/poseidon.py`.

Gate budget (standard PLONK, one mul per gate):
  x^17 S-box      = 5 gates ((s+a)^2 folds the ark constant; 3 more
                    squarings; final (x^16)*(s+a) folds it again)
  MDS row (t=3)   = 2 gates (two fused linear-combination gates; partial
                    rounds fold the ark constants of the un-S-boxed lanes
                    into the MDS gates' q_C)
  full round      = 3*5 + 3*2 = 21 gates; partial round = 5 + 6 = 11
  permutation     = 8*21 + 31*11 = 509 gates
  membership step = one 2-to-1 compression = one permutation
"""

from __future__ import annotations

from ..hash.grain import PoseidonConfig
from .circuit import CircuitBuilder


def sbox17_gadget(cb: CircuitBuilder, s: int, ark: int) -> int:
    """(s + ark)^17 with the additive constant folded into the first and
    last gates; 5 mul gates."""
    p = cb.spec.p
    # u1 = (s + a)^2 = s^2 + 2a s + a^2
    u1 = cb.new_var()
    cb.add_gate(2 * ark, 0, -1, 1, ark * ark, s, s, u1)
    u4 = cb.mul(u1, u1)                   # (s+a)^4
    u8 = cb.mul(u4, u4)                   # (s+a)^8
    u16 = cb.mul(u8, u8)                  # (s+a)^16
    y = cb.new_var()
    # u16 * (s + a) = u16*s + a*u16
    cb.add_gate(ark, 0, -1, 1, 0, u16, s, y)
    return y


def _mds_row_gadget(cb: CircuitBuilder, row, ys, const: int) -> int:
    """out = sum_j row[j] * ys[j] + const, t=3: two fused gates."""
    t1 = cb.new_var()
    cb.add_gate(row[0], row[1], -1, 0, 0, ys[0], ys[1], t1)
    out = cb.new_var()
    cb.add_gate(1, row[2], -1, 0, const, t1, ys[2], out)
    return out


def poseidon_permutation_gadget(cb: CircuitBuilder, cfg: PoseidonConfig,
                                state: list[int]) -> list[int]:
    """One Poseidon permutation over t variable ids; same round structure as
    `hash/poseidon.py _permute_core` (ark -> sbox -> mds; partial rounds
    S-box lane 0 only, folding the other lanes' ark into the MDS gates)."""
    assert cfg.alpha == 17, "gadget chain is specialized to alpha=17"
    t = cfg.t
    assert len(state) == t == 3
    p = cfg.spec.p
    rf, rp = cfg.full_rounds, cfg.partial_rounds
    half = rf // 2

    def full_round(r, st):
        ys = [sbox17_gadget(cb, st[i], cfg.ark[r][i] % p) for i in range(t)]
        return [_mds_row_gadget(cb, cfg.mds[i], ys, 0) for i in range(t)]

    def partial_round(r, st):
        y0 = sbox17_gadget(cb, st[0], cfg.ark[r][0] % p)
        ys = [y0, st[1], st[2]]
        out = []
        for i in range(t):
            # fold m_i1*a1 + m_i2*a2 into the row constant
            const = (cfg.mds[i][1] * cfg.ark[r][1]
                     + cfg.mds[i][2] * cfg.ark[r][2]) % p
            out.append(_mds_row_gadget(cb, cfg.mds[i], ys, const))
        return out

    for r in range(half):
        state = full_round(r, state)
    for r in range(half, half + rp):
        state = partial_round(r, state)
    for r in range(half + rp, rf + rp):
        state = full_round(r, state)
    return state


def hash2_gadget(cb: CircuitBuilder, cfg: PoseidonConfig, zero: int,
                 left: int, right: int) -> int:
    """2-to-1 compression: permute([0, l, r])[1] (rate-2 duplex sponge with
    a fresh state, as in `hash/merkle.py hash_pairs`)."""
    return poseidon_permutation_gadget(cb, cfg, [zero, left, right])[1]


def membership_gadget(cb: CircuitBuilder, cfg: PoseidonConfig, height: int,
                      index: int):
    """Merkle-membership partial circuit for a leaf at `index` (direction
    bits baked statically, as the reference bakes one partial circuit per
    proof).  Returns (leaf_var, sibling_vars, root_row): the caller assigns
    leaf + siblings; the computed root is exposed as a public input."""
    zero = cb.zero_var()
    leaf = cb.new_var()
    sibs = [cb.new_var() for _ in range(height)]
    cur = leaf
    idx = index
    for sib in sibs:
        if idx & 1:
            cur = hash2_gadget(cb, cfg, zero, sib, cur)
        else:
            cur = hash2_gadget(cb, cfg, zero, cur, sib)
        idx >>= 1
    cb.public_input(cur)
    return leaf, sibs, cur


def generate_membership_circuit(cfg: PoseidonConfig, n_proofs: int,
                                height: int, indices=None):
    """The reference workload (`circuit.rs:676-703`): n_proofs membership
    partial circuits, built independently and merged with id offsets.
    Returns (builder, handles) where handles[i] = (leaf_var, sibling_vars)
    with ids valid in the merged builder."""
    spec = cfg.spec
    if indices is None:
        indices = [i % (1 << height) for i in range(n_proofs)]
    merged = CircuitBuilder(spec)
    handles = []
    for i in range(n_proofs):
        part = CircuitBuilder(spec)
        leaf, sibs, _ = membership_gadget(part, cfg, height, indices[i])
        off = merged.merge(part)
        handles.append((leaf + off, [s + off for s in sibs]))
    return merged, handles, indices
