"""PLONK verifier, on the host: validate the proof's points, replay the
Fiat-Shamir transcript, check the gate + permutation + L1 identity at
zeta, and check both KZG openings with the ate pairing (`kzg.verify`, the
`multi_pairing == one` check of jf-plonk
`plonk/src/proof_system/verifier.rs:174-229`).

Everything here is a handful of group elements and single field elements,
so it runs on python ints: the point checks and the combination of the 15
commitments use `pairing/host.py`'s g1_add / g1_mul, the identity at zeta
plain modular arithmetic.  The verdicts are the reference's, whose
verifier does the same arithmetic on device planes.
"""

from __future__ import annotations

from ..curve import sw
from ..field import fp
from ..ntt.domain import primitive_root
from ..pairing.host import g1_mul
from ..pcs import kzg
from .prover import OPEN_ORDER, Proof, VerifyingKey
from .transcript import vk_transcript


def _inv(x: int, p: int) -> int:
    """Modular inverse, with inv(0) = 0 as the field engines define it."""
    return pow(x, -1, p) if x % p else 0


def _affine(curve, pt):
    return sw.to_affine_ints(curve, pt) if isinstance(pt, sw.Point) else pt


def _points_valid(vk: VerifyingKey, pts: list) -> bool:
    """On-curve and prime-subgroup (r·P = O) checks of every proof point
    (affine int pairs, None = identity): the invalid-point attack surface."""
    curve = vk.curve
    q = curve.field.p
    for pt in pts:
        if pt is None:
            continue
        x, y = pt
        if (y * y - x * x * x - curve.b) % q != 0:
            return False
        if g1_mul(q, pt, curve.order) is not None:
            return False
    return True


def verify(vk: VerifyingKey, srs: kzg.Srs, proof: Proof,
           public: list[int]) -> bool:
    curve = vk.curve
    fr = curve.scalar
    p = fr.p
    n = vk.n
    w = primitive_root(fr, n.bit_length() - 1)

    wires = [_affine(curve, c) for c in proof.wire_comms]
    z_comm = _affine(curve, proof.z_comm)
    t_comms = [_affine(curve, c) for c in proof.t_comms]
    w_zeta = _affine(curve, proof.w_zeta)
    w_zeta_omega = _affine(curve, proof.w_zeta_omega)
    if not _points_valid(vk, [*wires, z_comm, *t_comms, w_zeta,
                              w_zeta_omega]):
        return False
    e = {k: int(fp.to_ints(fr, v)[()]) % p for k, v in proof.evals.items()}

    # --- replay the transcript -------------------------------------------
    tr = vk_transcript(curve, vk)
    for v in public:
        tr.absorb_fr(v)
    for cm in wires:
        tr.absorb_point_ints(cm)
    beta = tr.challenge()
    gamma = tr.challenge()
    tr.absorb_point_ints(z_comm)
    alpha = tr.challenge()
    for cm in t_comms:
        tr.absorb_point_ints(cm)
    zeta = tr.challenge()
    for name in OPEN_ORDER:
        tr.absorb_fr(e[name])
    tr.absorb_fr(e["z_omega"])
    v_ch = tr.challenge()

    # --- the identity at zeta --------------------------------------------
    zeta_n = pow(zeta, n, p)
    zh = (zeta_n - 1) % p
    zh_n = zh * pow(n, -1, p) % p
    l1 = zh_n * _inv(zeta - 1, p) % p
    pi = 0
    for idx, row in enumerate(vk.public_rows):
        w_row = pow(w, row, p)
        pi -= public[idx] % p * (zh_n * w_row * _inv(zeta - w_row, p))
    gate = (e["qm"] * e["a"] * e["b"] + e["ql"] * e["a"] + e["qr"] * e["b"]
            + e["qo"] * e["c"] + e["qc"] + pi)

    def lin(x, base):
        return x + beta * base + gamma

    perm_a = (lin(e["a"], zeta) * lin(e["b"], vk.k1 * zeta)
              * lin(e["c"], vk.k2 * zeta) * e["z"])
    perm_b = (lin(e["a"], e["s1"]) * lin(e["b"], e["s2"])
              * lin(e["c"], e["s3"]) * e["z_omega"])
    l1term = alpha * alpha * l1 * (e["z"] - 1)
    lhs = gate + alpha * (perm_a - perm_b) + l1term
    rhs = zh * (e["t_lo"] + zeta_n * e["t_mid"]
                + zeta_n * zeta_n * e["t_hi"])
    if (lhs - rhs) % p:
        return False

    # --- KZG opening checks ----------------------------------------------
    comms = {"a": wires[0], "b": wires[1], "c": wires[2], "z": z_comm,
             "t_lo": t_comms[0], "t_mid": t_comms[1], "t_hi": t_comms[2],
             **{k: _affine(curve, c) for k, c in vk.commitments.items()}}
    v_pows = [pow(v_ch, i, p) for i in range(len(OPEN_ORDER))]
    combined_comm = kzg.combine_ints(curve, [comms[k] for k in OPEN_ORDER],
                                     v_pows)
    combined_eval = sum(e[k] * vp for k, vp in zip(OPEN_ORDER, v_pows)) % p
    if not kzg.verify(srs, combined_comm, zeta, combined_eval, w_zeta):
        return False
    return kzg.verify(srs, z_comm, zeta * w % p, e["z_omega"], w_zeta_omega)
