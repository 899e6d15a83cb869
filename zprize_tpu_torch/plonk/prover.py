"""PLONK prover: the five rounds of the reference's TurboPLONK
(`prize3-plonk-dizk/winderica/distributed/src/dispatcher.rs:569-640`,
`worker/round{1..5}.rs`) on the device:
  R1 wire commitments, R2 permutation product Z, R3 quotient t (split in
  three), R4 evaluations at zeta, R5 batched KZG openings.

Polynomials are (n, n_words) Montgomery word planes of Fr on the SRS's
device.  Every NTT is the Fr NTT kernel (`ntt/radix2.py`), every
commitment the TE MSM (`pcs/kzg.py`); the running product of Z and the
opening quotients are log-depth scans; the quotient is evaluated on a 4n
coset with elementwise ops on the plain engine; the transcript runs on
the host (`plonk/transcript.py`).

Zero knowledge: hiding randomizers as in standard PLONK (jf-plonk
`plonk/src/proof_system/prover.rs` rounds 1-2): p(X) += r(X)·Z_H(X) with 2
coefficients per wire polynomial and 3 for Z, drawn from `blinding_rng` in
the reference's order (a, b, c, then z), so a seeded rng gives the
reference's proof.  The SRS needs >= n + 6 powers.
"""

from __future__ import annotations

import dataclasses
import functools
import random

import torch

from ..curve import sw
from ..curve.spec import CurveSpec
from ..field import fp
from ..ntt.domain import Domain, power_ints
from ..ntt.radix2 import intt, ntt
from ..pcs import kzg
from ..poly import ops as poly_ops
from .circuit import CompiledCircuit
from .transcript import vk_transcript

SELECTORS = ("ql", "qr", "qo", "qm", "qc")
OPEN_ORDER = ["a", "b", "c", "z", "t_lo", "t_mid", "t_hi",
              "ql", "qr", "qo", "qm", "qc", "s1", "s2", "s3"]


@dataclasses.dataclass
class VerifyingKey:
    curve: CurveSpec
    n: int
    k1: int
    k2: int
    public_rows: list
    commitments: dict        # selector/sigma name -> sw.Point


@dataclasses.dataclass
class ProvingKey:
    curve: CurveSpec
    circuit: CompiledCircuit
    srs: kzg.Srs
    dom: Domain
    dom4: Domain
    coset_g: int
    selectors: dict          # name -> coefficients (n, nw)
    sigma_coeffs: torch.Tensor  # (3, n, nw)
    sigma_evals: torch.Tensor   # (3, n, nw)
    id_evals: torch.Tensor      # (3, n, nw)
    coset_evals: dict        # selectors, s1..s3, l1 on the 4n coset
    commitments: dict
    vk: VerifyingKey


@dataclasses.dataclass
class Proof:
    wire_comms: list         # [a, b, c] sw.Point
    z_comm: sw.Point
    t_comms: list            # [lo, mid, hi]
    evals: dict              # OPEN_ORDER names and z_omega -> (nw,) row
    w_zeta: sw.Point
    w_zeta_omega: sw.Point


def _row(fr, value: int, device) -> torch.Tensor:
    """A (nw,) Montgomery row of a python int (no constant cache: the
    prover's challenges are fresh per proof)."""
    return fp.from_ints(fr, [value % fr.p], device)[0]


def _sum(fr, terms):
    return functools.reduce(lambda a, b: fp.add(fr, a, b), terms)


def _coset_scale(fr, coeffs, g: int, n_out: int, inverse=False):
    """coeff_i·g^i (or g^-i), padded to n_out along the coefficient axis."""
    pows = poly_ops.gpow(fr, g, n_out, inverse, coeffs.device)
    return fp.mul(fr, poly_ops.pad_to(fr, coeffs, n_out), pows)


def _coset_eval(dom4: Domain, g: int, coeffs):
    """Evaluations on the coset g·H_4n of (..., k, nw) coefficients."""
    return ntt(dom4, _coset_scale(dom4.spec, coeffs, g, dom4.n))


def _cumprod_exclusive(fr, ratio):
    """Exclusive running product along axis 0: a Hillis-Steele scan,
    log2(n) steps (replaces the sequential Z loop of
    `worker/round2.rs:14-51`)."""
    inc = ratio
    d = 1
    while d < inc.shape[0]:
        inc = torch.cat([inc[:d], fp.mul(fr, inc[d:], inc[:-d])])
        d *= 2
    return torch.cat([fp.ones(fr, (1,), ratio.device), inc[:-1]])


def _blind(fr, coeffs, randomizers):
    """coeffs(X) + (sum_i r_i X^i)·(X^n - 1): hiding that vanishes on H.
    (n, nw) -> (n + k, nw)."""
    k = len(randomizers)
    n = coeffs.shape[-2]
    r = fp.from_ints(fr, randomizers, coeffs.device)
    ext = poly_ops.pad_to(fr, coeffs, n + k)
    return torch.cat([fp.sub(fr, ext[:k], r), ext[k:n],
                      fp.add(fr, ext[n:n + k], r)])


def setup(curve: CurveSpec, circuit: CompiledCircuit, srs: kzg.Srs):
    """Preprocess the circuit on the SRS's device: selector and sigma
    polynomials, their commitments, their evaluations on the 4n coset (the
    jf-plonk trick of precomputed coset forms) and the verifying key."""
    fr = curve.scalar
    p = fr.p
    n = circuit.n
    dev = srs.device
    if srs.size < n + 6:
        raise ValueError(f"SRS of {srs.size} < n + 6 = {n + 6} powers: the "
                         "blinded polynomials need them")
    if n < 8:
        raise ValueError("the blinded quotient (degree 3n+5) needs 4n > "
                         "3n+5, i.e. n >= 8")
    log_n = n.bit_length() - 1
    dom = Domain(fr, log_n, dev)
    dom4 = Domain(fr, log_n + 2, dev)
    g = fr.generator
    if pow(g, 4 * n, p) == 1:
        raise ValueError("coset generator lies in H_4n")

    sel_evals = fp.from_ints(
        fr, [[int(v) % p for v in getattr(circuit, k)] for k in SELECTORS],
        dev)
    sel_coeffs = intt(dom, sel_evals)                     # (5, n, nw)
    selectors = dict(zip(SELECTORS, sel_coeffs))

    # identity / sigma encodings: slot col*n + j -> k_col · w^j
    wp = power_ints(fr, n, dom.w)
    ks = [1, circuit.k1, circuit.k2]
    id_evals = fp.from_ints(fr, [[ks[c] * wp[j] % p for j in range(n)]
                                 for c in range(3)], dev)
    sigma_evals = fp.from_ints(
        fr, [[ks[int(s) // n] * wp[int(s) % n] % p for s in circuit.sigma[c]]
             for c in range(3)], dev)
    sigma_coeffs = intt(dom, sigma_evals)

    polys = dict(selectors, s1=sigma_coeffs[0], s2=sigma_coeffs[1],
                 s3=sigma_coeffs[2])
    comms = {name: kzg.commit(srs, coeffs) for name, coeffs in polys.items()}
    vk = VerifyingKey(curve, n, circuit.k1, circuit.k2,
                      list(circuit.public_rows), dict(comms))
    pk = ProvingKey(curve, circuit, srs, dom, dom4, g, selectors,
                    sigma_coeffs, sigma_evals, id_evals,
                    coset_forms(dom4, g, selectors, sigma_coeffs), comms, vk)
    return pk, vk


def coset_forms(dom4: Domain, g: int, selectors: dict,
                sigma_coeffs: torch.Tensor) -> dict:
    """The selectors', the sigmas' and L1's evaluations on the 4n coset
    g·H_4n (L1 has every coefficient 1/n)."""
    fr = dom4.spec
    n = sigma_coeffs.shape[-2]
    polys = dict(selectors, s1=sigma_coeffs[0], s2=sigma_coeffs[1],
                 s3=sigma_coeffs[2],
                 l1=fp.constant(fr, pow(n, -1, fr.p), (n,),
                                sigma_coeffs.device))
    names = list(polys)
    cos = _coset_eval(dom4, g, torch.stack([polys[k] for k in names]))
    return dict(zip(names, cos))


def prove(pk: ProvingKey, assignment: dict, public: list[int],
          blinding_rng=None) -> Proof:
    """Dict-assignment form: the (3, n) wire values on the host, then
    `prove_planes`."""
    w_ints = pk.circuit.wire_values(assignment)
    wires = fp.from_ints(pk.curve.scalar, w_ints.tolist(), pk.srs.device)
    return prove_planes(pk, wires, public, blinding_rng)


def prove_planes(pk: ProvingKey, wires: torch.Tensor, public: list[int],
                 blinding_rng=None) -> Proof:
    """Prove from wire evaluation planes (3, n, nw) on the SRS's device."""
    curve, fr = pk.curve, pk.curve.scalar
    p = fr.p
    cc = pk.circuit
    n = cc.n
    dom, dom4, g = pk.dom, pk.dom4, pk.coset_g
    dev = pk.srs.device
    brng = blinding_rng if blinding_rng is not None else random.SystemRandom()
    row = functools.partial(_row, fr, device=dev)

    tr = vk_transcript(curve, pk.vk)
    for v in public:
        tr.absorb_fr(v)

    # public-input polynomial: PI = -public at the public rows
    pi_evals = fp.zeros(fr, (n,), dev)
    if cc.public_rows:
        pi_evals[torch.tensor(cc.public_rows, device=dev)] = fp.from_ints(
            fr, [(-v) % p for v in public], dev)

    # --- round 1: wire polynomials ---------------------------------------
    wire_coeffs0 = intt(dom, wires)                      # (3, n, nw)
    wire_coeffs = [_blind(fr, wire_coeffs0[i],
                          [brng.randrange(p), brng.randrange(p)])
                   for i in range(3)]                    # each (n+2, nw)
    wire_comms = [kzg.commit(pk.srs, c) for c in wire_coeffs]
    for cm in wire_comms:
        tr.absorb_point(cm)
    beta, gamma = row(tr.challenge()), row(tr.challenge())

    def lin(w, base):
        return fp.add(fr, fp.add(fr, w, fp.mul(fr, beta, base)), gamma)

    # --- round 2: permutation product Z ----------------------------------
    num = lin(wires, pk.id_evals)
    den = lin(wires, pk.sigma_evals)
    num = fp.mul(fr, fp.mul(fr, num[0], num[1]), num[2])
    den = fp.mul(fr, fp.mul(fr, den[0], den[1]), den[2])
    z_evals = _cumprod_exclusive(fr, fp.mul(fr, num, fp.batch_inv(fr, den)))
    z_coeffs = _blind(fr, intt(dom, z_evals),
                      [brng.randrange(p) for _ in range(3)])  # (n+3, nw)
    z_comm = kzg.commit(pk.srs, z_coeffs)
    tr.absorb_point(z_comm)
    alpha = row(tr.challenge())

    # --- round 3: quotient on the 4n coset -------------------------------
    ca, cb, cc_, cz, cpi = _coset_eval(dom4, g, torch.stack(
        [poly_ops.pad_to(fr, q, n + 3)
         for q in (*wire_coeffs, z_coeffs, intt(dom, pi_evals))]))
    cz_w = torch.roll(cz, -4, dims=0)                    # z(w x) on the coset
    ce = pk.coset_evals
    half = dom4.pows                                      # x = g·w4^i
    xs = fp.mul(fr, torch.cat([half, fp.neg(fr, half)]),
                fp.constant(fr, g, (), dev))

    gate = _sum(fr, [fp.mul(fr, ce["qm"], fp.mul(fr, ca, cb)),
                     fp.mul(fr, ce["ql"], ca), fp.mul(fr, ce["qr"], cb),
                     fp.mul(fr, ce["qo"], cc_), ce["qc"], cpi])
    k1x = fp.mul(fr, xs, row(cc.k1))
    k2x = fp.mul(fr, xs, row(cc.k2))
    perm_a = fp.mul(fr, fp.mul(fr, lin(ca, xs), lin(cb, k1x)),
                    fp.mul(fr, lin(cc_, k2x), cz))
    perm_b = fp.mul(fr, fp.mul(fr, lin(ca, ce["s1"]), lin(cb, ce["s2"])),
                    fp.mul(fr, lin(cc_, ce["s3"]), cz_w))
    perm = fp.mul(fr, fp.sub(fr, perm_a, perm_b), alpha)
    z_minus_1 = fp.sub(fr, cz, fp.ones(fr, (), dev))
    l1term = fp.mul(fr, fp.mul(fr, alpha, alpha),
                    fp.mul(fr, ce["l1"], z_minus_1))
    numerator = _sum(fr, [gate, perm, l1term])

    # 1/Z_H on the coset: x^n - 1 cycles with period 4
    gn = pow(g, n, p)
    w4n = pow(dom4.w, n, p)                              # primitive 4th root
    zh_inv = fp.from_ints(fr, [pow((gn * pow(w4n, i, p) - 1) % p, -1, p)
                               for i in range(4)], dev)
    t_evals = fp.mul(fr, numerator, zh_inv.repeat(dom4.n // 4, 1))
    t_coeffs = _coset_scale(fr, intt(dom4, t_evals), g, dom4.n, inverse=True)
    # degree <= 3n+5 with blinding: two n-chunks and an (n+6)-chunk
    t_lo, t_mid, t_hi = (t_coeffs[:n], t_coeffs[n:2 * n],
                         t_coeffs[2 * n:3 * n + 6])
    t_comms = [kzg.commit(pk.srs, t) for t in (t_lo, t_mid, t_hi)]
    for cm in t_comms:
        tr.absorb_point(cm)
    zeta_i = tr.challenge()
    zeta = row(zeta_i)

    # --- round 4: evaluations at zeta ------------------------------------
    zeta_omega = row(zeta_i * dom.w)
    polys = {"a": wire_coeffs[0], "b": wire_coeffs[1], "c": wire_coeffs[2],
             "z": z_coeffs, "t_lo": t_lo, "t_mid": t_mid, "t_hi": t_hi,
             **pk.selectors, "s1": pk.sigma_coeffs[0],
             "s2": pk.sigma_coeffs[1], "s3": pk.sigma_coeffs[2]}
    max_len = max(polys[k].shape[-2] for k in OPEN_ORDER)
    stacked = torch.stack([poly_ops.pad_to(fr, polys[k], max_len)
                           for k in OPEN_ORDER])          # (15, len, nw)
    at_zeta = poly_ops.evaluate(fr, stacked, zeta)        # (15, nw)
    z_omega = poly_ops.evaluate(fr, z_coeffs, zeta_omega)
    evals = dict(zip(OPEN_ORDER, at_zeta))
    evals["z_omega"] = z_omega
    for v in fp.to_ints(fr, torch.cat([at_zeta, z_omega[None]])):
        tr.absorb_fr(int(v))
    v_ch = row(tr.challenge())

    # --- round 5: batched openings ---------------------------------------
    v_pows = poly_ops.powers(fr, v_ch, len(OPEN_ORDER))
    combined = poly_ops.sum_axis(fr, fp.mul(fr, stacked, v_pows[:, None]), 0)
    q_zeta, _ = poly_ops.divide_linear(fr, combined, zeta)
    w_zeta = kzg.commit(pk.srs, q_zeta)
    q_zw, _ = poly_ops.divide_linear(fr, z_coeffs, zeta_omega)
    w_zeta_omega = kzg.commit(pk.srs, q_zw)
    return Proof(wire_comms, z_comm, t_comms, evals, w_zeta, w_zeta_omega)
