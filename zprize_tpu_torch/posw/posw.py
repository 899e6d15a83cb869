"""Proof-of-Succinct-Work: the Marlin mining loop of team prize 2.

As snarkVM's PoSW (`dpc/src/posw/posw.rs`):

* `prove_once_unchecked` (:156-168): one unconditional Marlin proof of
  the PoSW circuit for a candidate nonce;
* the difficulty check (:170-200): hash the proof, compare with the
  target;
* the cooperative `terminator` cancellation (:159, `marlin.rs:264-275`):
  a `threading.Event` polled between proving iterations;
* `mine` and `mine_batch`: the miners' retry loop; `mine_batch` proves B
  nonces in one `ahp.prove_batch` on the card.

The circuit proves knowledge of (header, nonce) with the public
digest = Poseidon2(header, nonce) (rate 2, snarkVM's parameters), its
permutation written as rank-1 constraints.  The difficulty hash is a
Poseidon sponge over the proof's commitment coordinates (snarkVM hashes
the serialized proof bytes; the same role).  The witness and the hashes
run on host ints (`hash/poseidon.py`'s host sponge and permutation).
"""

from __future__ import annotations

import dataclasses

from ..curve.spec import BLS12_377_G1
from ..field.spec import BLS12_377_FR
from ..hash import poseidon
from ..hash.grain import snarkvm_config
from ..marlin import ahp, indexer
from ..marlin.r1cs import R1CSBuilder
from ..pcs import kzg
from ..utils.device import resolve_device

FR = BLS12_377_FR
CURVE = BLS12_377_G1


# ----------------------------------------------------------- R1CS Poseidon

def _lc_add_const(lc, k, p):
    return lc + [(0, k % p)]


def _lc_scale(lc, k, p):
    return [(v, c * k % p) for v, c in lc]


def _lc_sum(lcs, p):
    acc: dict = {}
    for lc in lcs:
        for v, c in lc:
            acc[v] = (acc.get(v, 0) + c) % p
    return [(v, c) for v, c in acc.items() if c]


def _sbox17_r1cs(rb: R1CSBuilder, lc):
    """x^17 as 5 rank-1 constraints (4 squarings and a product); the MDS
    and round constants fold into the linear combinations."""
    u1 = rb.new_witness()
    rb.constrain(lc, lc, [(u1, 1)])
    u2 = rb.new_witness()
    rb.constrain([(u1, 1)], [(u1, 1)], [(u2, 1)])
    u4 = rb.new_witness()
    rb.constrain([(u2, 1)], [(u2, 1)], [(u4, 1)])
    u16 = rb.new_witness()
    rb.constrain([(u4, 1)], [(u4, 1)], [(u16, 1)])
    y = rb.new_witness()
    rb.constrain([(u16, 1)], lc, [(y, 1)])
    return [(y, 1)]


def poseidon_permutation_r1cs(rb: R1CSBuilder, cfg, state_lcs):
    """The Poseidon permutation as constraints (the round structure of
    `hash/poseidon.py`): the S-boxes, and t rebinding constraints a round
    that keep every state linear combination at O(t) terms (without them
    the folded linear layers grow the combinations round over round, and
    the AHP's entry domain K about 50-fold)."""
    p = cfg.spec.p
    t = cfg.t
    rf, rp = cfg.full_rounds, cfg.partial_rounds
    half = rf // 2

    def rebind(lcs):
        out = []
        for lc in lcs:
            if len(lc) <= 1:
                out.append(lc)
                continue
            w = rb.new_witness()
            rb.constrain(lc, [(0, 1)], [(w, 1)])
            out.append([(w, 1)])
        return out

    def mds(ys):
        return rebind([_lc_sum([_lc_scale(ys[j], cfg.mds[i][j], p)
                                for j in range(t)], p) for i in range(t)])

    def full_round(r, st):
        ys = [_sbox17_r1cs(rb, _lc_add_const(st[i], cfg.ark[r][i], p))
              for i in range(t)]
        return mds(ys)

    def partial_round(r, st):
        ys = [_sbox17_r1cs(rb, _lc_add_const(st[0], cfg.ark[r][0], p))]
        ys += [_lc_add_const(st[i], cfg.ark[r][i], p) for i in range(1, t)]
        return mds(ys)

    for r in range(half):
        state_lcs = full_round(r, state_lcs)
    for r in range(half, half + rp):
        state_lcs = partial_round(r, state_lcs)
    for r in range(half + rp, rf + rp):
        state_lcs = full_round(r, state_lcs)
    return state_lcs


# ----------------------------------------------------------- PoSW circuit

@dataclasses.dataclass
class PoswCircuit:
    """The circuit without its index (the tests and keygen-once flows
    build it without an SRS)."""
    r1cs: object
    header_var: int
    nonce_var: int
    cfg: object


@dataclasses.dataclass
class PoswKeys:
    pk: indexer.IndexProverKey
    circuit: PoswCircuit

    @property
    def cfg(self):
        return self.circuit.cfg


def build_circuit() -> PoswCircuit:
    """The PoSW R1CS: digest (public) = Poseidon2(header, nonce)."""
    cfg = snarkvm_config(FR, 2)
    rb = R1CSBuilder(FR, num_public=1)     # public: the digest
    header = rb.new_witness()
    nonce = rb.new_witness()
    state = [[], [(header, 1)], [(nonce, 1)]]   # absorbed into the rate
    out = poseidon_permutation_r1cs(rb, cfg, state)
    rb.constrain(out[1], [(0, 1)], [(rb.public(0), 1)])
    return PoswCircuit(rb.build(), header, nonce, cfg)


def sizes(circuit: PoswCircuit) -> tuple[int, int]:
    """(n, k) of the circuit as `setup` sizes its SRS."""
    r1 = circuit.r1cs
    n = 1 << max(r1.num_constraints, r1.num_vars, 2).bit_length()
    k = 1 << max(len(r1.a), len(r1.b), len(r1.c), 2).bit_length()
    return n, k


def setup(srs: kzg.Srs | None = None, srs_seed: int = 9,
          circuit: PoswCircuit | None = None, device=None) -> PoswKeys:
    """Index the PoSW circuit once (proving reuses the keys), on `device`:
    the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    circ = circuit if circuit is not None else build_circuit()
    if srs is None:
        n, k = sizes(circ)
        srs = kzg.setup_test_srs(CURVE, max(3 * k, 2 * n) + 8, seed=srs_seed,
                                 device=dev)
    return PoswKeys(indexer.index(CURVE, circ.r1cs, srs, device=dev), circ)


def _witness(circ: PoswCircuit, header: int, nonce: int) -> list[int]:
    """The full assignment by forward propagation, with the digest."""
    digest = poseidon.permute_ints(circ.cfg, [0, header % FR.p,
                                              nonce % FR.p])[1]
    r1 = circ.r1cs
    partial = {0: 1, 1: digest, circ.header_var: header % FR.p,
               circ.nonce_var: nonce % FR.p}
    z = _solve(r1, partial)
    if not r1.is_satisfied(z):
        raise AssertionError("the PoSW witness does not satisfy its R1CS")
    return z


def _solve(r1, partial: dict) -> list[int]:
    """Forward propagation over rank-1 constraints whose C side is one
    fresh variable (all of this module's are)."""
    p = r1.spec.p
    vals = dict(partial)
    by_row: dict = {}
    for side, entries in (("a", r1.a), ("b", r1.b), ("c", r1.c)):
        for r, c, v in entries:
            by_row.setdefault(r, {"a": [], "b": [], "c": []})[side].append(
                (c, v))
    for r in range(r1.num_constraints):
        lcs = by_row.get(r)
        if lcs is None:
            continue
        cs = lcs["c"]
        if len(cs) == 1 and cs[0][1] == 1 and cs[0][0] not in vals:
            a = sum(vals.get(v, 0) * c for v, c in lcs["a"]) % p
            b = sum(vals.get(v, 0) * c for v, c in lcs["b"]) % p
            vals[cs[0][0]] = a * b % p
    return [vals.get(i, 0) for i in range(r1.num_vars)]


# ----------------------------------------------------------- mining loop

def prove_once_unchecked(keys: PoswKeys, header: int, nonce: int):
    """One unconditional proof (`posw.rs:156-168`).  Returns
    (proof, digest)."""
    z = _witness(keys.circuit, header, nonce)
    return ahp.prove(keys.pk, z, device=keys.pk.device), z[1]


def _proof_coords(proof) -> list[int]:
    coords = []
    for name in sorted(proof.comms):
        c = proof.comms[name]
        coords.extend([0, 0] if c is None else [c[0] % FR.p, c[1] % FR.p])
    return coords


def proof_difficulty(keys: PoswKeys, proof) -> int:
    """The Poseidon-sponge hash of the proof's commitment coordinates, an
    int (the difficulty hash of `posw.rs:170-200`)."""
    return proof_difficulty_batch(keys, [proof])[0]


def proof_difficulty_batch(keys: PoswKeys, proofs) -> list[int]:
    """The difficulty hashes of B proofs, one host sponge each."""
    out = []
    for pf in proofs:
        sponge = poseidon.Sponge(keys.cfg, host=True)
        sponge.absorb(_proof_coords(pf))
        out.append(sponge.squeeze(1)[0])
    return out


def mine(keys: PoswKeys, header: int, target: int, start_nonce: int = 0,
         max_nonces: int = 64, terminator=None):
    """Prove nonces until a proof's hash meets `target`; None when the
    nonces run out or the terminator fires."""
    for nonce in range(start_nonce, start_nonce + max_nonces):
        if terminator is not None and terminator.is_set():
            return None
        proof, digest = prove_once_unchecked(keys, header, nonce)
        if proof_difficulty(keys, proof) < target:
            return {"nonce": nonce, "digest": digest, "proof": proof}
    return None


def mine_batch(keys: PoswKeys, header: int, target: int,
               start_nonce: int = 0, max_nonces: int = 64, batch: int = 8,
               terminator=None):
    """The batched miner: B nonces a `ahp.prove_batch`, the difficulty
    checked for the batch.  Returns the first qualifying solution in nonce
    order."""
    nonce, end = start_nonce, start_nonce + max_nonces
    while nonce < end:
        if terminator is not None and terminator.is_set():
            return None
        bs = min(batch, end - nonce)
        zs = [_witness(keys.circuit, header, nonce + i) for i in range(bs)]
        proofs = ahp.prove_batch(keys.pk, zs, device=keys.pk.device)
        for i, d in enumerate(proof_difficulty_batch(keys, proofs)):
            if d < target:
                return {"nonce": nonce + i, "digest": zs[i][1],
                        "proof": proofs[i]}
        nonce += bs
    return None


def verify_work(keys: PoswKeys, srs: kzg.Srs, solution: dict,
                target: int) -> bool:
    """The full block check: the difficulty and the Marlin proof."""
    if proof_difficulty(keys, solution["proof"]) >= target:
        return False
    public = [1, solution["digest"]]
    return ahp.verify(keys.pk.vk, srs, public, solution["proof"])
