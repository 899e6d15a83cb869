"""Marlin AHP prover and verifier over the KZG commitment scheme.

The protocol of the reference's Marlin (`snarkVM algorithms/src/snark/
marlin/marlin.rs:303-450`; AHP rounds in `ahp/prover/round_functions/`):

  round 1  witness oracles  w-hat, z_A, z_B
  round 2  outer sumcheck   g_1, h_1 over H (summed_z_m = eta_A z_A +
           eta_B z_B + eta_C z_A z_B, the t polynomial, and
           q_1 = h_1 v_H + X g_1)
  round 3  inner sumcheck   g_M, h_M, sigma_M over K per matrix
  round 4  evaluations at beta (H oracles) and delta (K oracles), two
           batched KZG openings.

The prover runs B instances at once (`prove_batch`) on the key's device:
every polynomial step is an Fr NTT kernel launch (`ntt/radix2.py`), a wide
elementwise op or a batched inversion on the plain engine (`field/fp.py`);
the sparse matvecs are a gather and an `index_add_` of int64 words with
one reduction (`_seg_sum`); every commitment is a `kzg.commit_batch` (the
short-Weierstrass MSM kernels), one call for all the polynomials of a
round that share a length.  The Fiat-Shamir transcript runs on host ints,
one lane an instance (`Transcript.broadcast`), so each round's
commitments and scalars come to the host once for the next challenge.

The verifier runs on host ints: O(1) field checks a proof, the
challenges of a group of proofs from one B-lane transcript, and the
batched KZG openings of the whole group in one multi-pairing
(`kzg.verify_many`, its linear combinations native: `kzg.combine_ints`).

Soundness as the reference's sonic_pc
(`snarkVM algorithms/src/polycommit/sonic_pc/mod.rs`):

* degree-bound commitments: g_1 (deg <= |H|-2) and each g_M
  (deg <= |K|-2) also commit X^s * g through the shifted SRS slice
  (s = srs.size-1-bound); the verifier derives the shifted evaluation as
  z^s * g(z) itself, so a g over its bound has no consistent shifted
  commitment;
* zero knowledge (opt-in, `zk_rng`): the round-1 oracles are blinded with
  multiples of v_H (one fresh scalar each) and a random mask polynomial s
  with sum_H s = 0 joins the outer sumcheck.  The draws follow the
  reference's order, so a seeded rng gives the reference's proof.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..field import fp
from ..ntt.domain import Domain, primitive_root
from ..ntt.radix2 import intt, ntt
from ..pcs import kzg
from ..plonk.transcript import Transcript, lane_points_ints, vk_transcript
from ..poly import ops as poly_ops
from ..utils.device import resolve_device
from .indexer import (M_NAMES, IndexedMatrix, IndexProverKey,
                      IndexVerifierKey)

LABEL = 0x4D41524C494E       # "MARLIN"


# ------------------------------------------------------------------ helpers

def _seg_sum(fr, terms: torch.Tensor, seg: torch.Tensor, num: int
             ) -> torch.Tensor:
    """sum of terms (B, K, nw) by segment seg (K,) into (B, num, nw).

    Montgomery words are linear: the word-wise integer sum of the terms is
    the Montgomery form of their field sum, only unreduced.  The words
    accumulate as int64 with `index_add_` (each column below K * 2^32),
    one carry pass splits the sum into lo (nw words) + hi * 2^(32 nw), and
    two products reduce it: lo * (R mod p) / R = lo mod p, and
    hi * (R^2 mod p) / R = hi * R mod p."""
    nw = terms.shape[-1]
    acc = torch.zeros(terms.shape[0], num, nw, dtype=torch.int64,
                      device=terms.device)
    acc.index_add_(1, seg, terms.to(torch.int64) & 0xFFFFFFFF)
    for j in range(nw - 1):
        acc[..., j + 1] += acc[..., j] >> 32
        acc[..., j] &= 0xFFFFFFFF
    hi = acc[..., nw - 1] >> 32
    acc[..., nw - 1] &= 0xFFFFFFFF
    hi_words = torch.zeros_like(acc)
    hi_words[..., 0] = hi & 0xFFFFFFFF
    hi_words[..., 1] = hi >> 32

    def words(t):                      # u32 bit patterns in int32
        return (t - ((t >> 31) << 32)).to(torch.int32)

    consts = fp.montgomery_params(fr)
    lo = fp.mul(fr, words(acc), fp.raw_words(fr, consts["one"], acc.device))
    return fp.add(fr, lo, fp.mul(fr, words(hi_words),
                                 fp.raw_words(fr, consts["r2"], acc.device)))


def _h_pows(dom: Domain) -> torch.Tensor:
    """omega^j for j < n, (n, nw) (the domain's table holds the first half;
    the second half is its negation)."""
    return torch.cat([dom.pows, fp.neg(dom.spec, dom.pows)])


def _coset_ntt(fr, coeffs, dom_big: Domain, g: int):
    pows = poly_ops.gpow(fr, g, dom_big.n, False, coeffs.device)
    return ntt(dom_big, fp.mul(fr, poly_ops.pad_to(fr, coeffs, dom_big.n),
                               pows))


def _coset_intt(fr, evals, dom_big: Domain, g: int):
    pows = poly_ops.gpow(fr, g, dom_big.n, True, evals.device)
    return fp.mul(fr, intt(dom_big, evals), pows)


def _vanishing_inv_on_coset(fr, m: int, dom_big: Domain, g: int):
    """1 / (X^m - 1) on the coset g*W_big: it cycles with period big/m."""
    p = fr.p
    period = dom_big.n // m
    gm = pow(g, m, p)
    wm = pow(dom_big.w, m, p)
    vals = [pow((gm * pow(wm, i, p) - 1) % p, -1, p) for i in range(period)]
    return fp.from_ints(fr, vals, dom_big.device).repeat(m, 1)


def _suffix_sum(fr, c: torch.Tensor, axis: int) -> torch.Tensor:
    """Inclusive suffix sums along `axis`: a Hillis-Steele scan, log2 of
    its length steps."""
    x = c.flip(axis)
    d = 1
    while d < x.shape[axis]:
        head = x.narrow(axis, 0, d)
        x = torch.cat([head, fp.add(fr, x.narrow(axis, d, x.shape[axis] - d),
                                    x.narrow(axis, 0, x.shape[axis] - d))],
                      axis)
        d *= 2
    return x.flip(axis)


def _div_vanishing(fr, coeffs: torch.Tensor, m: int):
    """(q, r) with coeffs = q * (X^m - 1) + r, deg r < m, for (..., n, nw):
    the strided suffix sums q_i = sum_{j>=1} c_{i+jm}."""
    nc, nw = coeffs.shape[-2:]
    lead = coeffs.shape[:-2]
    if nc <= m:
        return (fp.zeros(fr, (*lead, 1), coeffs.device),
                poly_ops.pad_to(fr, coeffs, m))
    rows = -(-nc // m)
    c = poly_ops.pad_to(fr, coeffs, rows * m).reshape(*lead, rows, m, nw)
    inc = _suffix_sum(fr, c, c.dim() - 3)
    exc = fp.sub(fr, inc, c)                         # exclusive suffix
    q = exc.reshape(*lead, rows * m, nw)[..., :nc - m, :]
    rem = fp.add(fr, c[..., 0, :, :], exc[..., 0, :, :])
    return q, rem


def _index_coset(fr, im: IndexedMatrix, dom_big: Domain, g: int):
    """The row and col polynomials on the coset g*W_big, kept on the
    matrix: they do not depend on the witness (the analog of the
    reference's GPU-resident arithmetization caches)."""
    key = (dom_big.n, g)
    if key not in im.coset:
        both = _coset_ntt(fr, torch.stack([im.row_coeffs, im.col_coeffs]),
                          dom_big, g)
        im.coset[key] = (both[0], both[1])
    return im.coset[key]


def _matvec(fr, im: IndexedMatrix, z_evals, n: int):
    """(M z) evaluations over H for every row of z_evals (B, n, nw)."""
    terms = fp.mul(fr, im.val_raw, z_evals[:, im.cols_idx])
    return _seg_sum(fr, terms, im.rows_idx, n)


def _matvec_t(fr, im: IndexedMatrix, r_vec, n: int):
    """(M^T r) evaluations over H (the t polynomial's mass per column)."""
    terms = fp.mul(fr, im.val_raw, r_vec[:, im.rows_idx])
    return _seg_sum(fr, terms, im.cols_idx, n)


def _add_at(fr, coeffs, terms, min_len: int):
    """coeffs + sum (sign * r * X^pos) for terms ((pos, r, sign), ...),
    r a (B, nw) row a lane: the v_H-multiple blinders (adding
    r*(X^n - 1) touches two coefficients)."""
    ln = max(min_len, coeffs.shape[-2], max(pos for pos, _, _ in terms) + 1)
    c = poly_ops.pad_to(fr, coeffs, ln).clone()
    for pos, r, sign in terms:
        op = fp.add if sign > 0 else fp.sub
        c[..., pos, :] = op(fr, c[..., pos, :], r)
    return c


def _shift_bounds(srs_size: int, n: int, ksz: int) -> tuple[int, int]:
    """Shifted-powers offsets enforcing deg(g_1) <= n-2 and
    deg(g_M) <= ksz-2 against the whole SRS degree (srs.size-1), as
    sonic_pc's shifted_powers_of_beta_g slices."""
    return srs_size - 1 - (n - 2), srs_size - 1 - (ksz - 2)


# ------------------------------------------------------------------ proof

@dataclasses.dataclass
class MarlinProof:
    comms: dict              # name -> host affine int pair (or None)
    sigmas: dict             # matrix -> int
    evals: dict              # name -> int
    open_beta: tuple | None  # witness commitment for the beta batch
    open_delta: tuple | None


H_OPEN = ("w", "z_a", "z_b", "g_1", "h_1")
K_OPEN = tuple(f"{m}_{part}" for m in M_NAMES
               for part in ("row", "col", "val", "g", "h"))


def _absorb_vk(tr: Transcript, vk: IndexVerifierKey):
    for v in (vk.num_public, vk.log_n, vk.log_k, vk.log_x):
        tr.absorb_fr(v)
    for name in sorted(vk.commitments):
        tr.absorb_point_ints(vk.commitments[name])


# ------------------------------------------------------------------ prover

def prove(pk: IndexProverKey, assignment: list[int], zk_rng=None,
          device=None) -> MarlinProof:
    """One proof: `prove_batch` of one instance.  `assignment` is the full
    variable assignment (the public prefix with its leading 1)."""
    return prove_batch(pk, [assignment], zk_rng=zk_rng, device=device)[0]


def prove_batch(pk: IndexProverKey, assignments, zk_rng=None,
                device=None) -> list[MarlinProof]:
    """B proofs in one pass on `device` (the card unless the caller asks
    for the CPU), which must be the key's: every round's polynomials and
    commitments carry the instance axis, and lane b of every step, the
    transcript's included, is what a single proof of instance b computes.
    `zk_rng` (a random.Random) turns on the hiding blinders and the mask
    polynomial."""
    dev = resolve_device(device)
    if pk.device.type != dev.type:
        raise ValueError(f"key on {pk.device}, proof asked on {dev}")
    dev = pk.device
    curve, fr = pk.curve, pk.curve.scalar
    p = fr.p
    r1 = pk.r1cs
    bsz = len(assignments)
    n, ksz, xsz = 1 << pk.log_n, 1 << pk.log_k, 1 << pk.log_x
    dom_h, dom_k = Domain(fr, pk.log_n, dev), Domain(fr, pk.log_k, dev)
    dom_h4, dom_k4 = Domain(fr, pk.log_n + 2, dev), Domain(fr, pk.log_k + 2,
                                                           dev)
    dom_x = Domain(fr, pk.log_x, dev)
    g = fr.generator
    if pow(g, 4 * max(n, ksz), p) == 1:
        raise ValueError("coset generator lies in the 4x domain")
    srs = pk.srs
    cl = pk.commit_len
    sh1, shm = _shift_bounds(srs.size, n, ksz)

    def commit(*entries):
        """Commit (B, len, nw) polynomials, each at its shift (X^shift * p
        for a degree-bound commitment), in one commit_batch: each row sits
        at its shift in a plane of the longest entry's extent, and the
        zeros around it add nothing.  Returns the host affine ints, one
        list of B lanes an entry."""
        width = max(sh + c.shape[-2] for c, sh in entries)
        flat = torch.stack([torch.nn.functional.pad(
            c, (0, 0, sh, width - sh - c.shape[-2])) for c, sh in entries])
        pts = lane_points_ints(curve, kzg.commit_batch(
            srs, flat.reshape(-1, width, flat.shape[-1])))
        return [pts[i * bsz:(i + 1) * bsz] for i in range(len(entries))]

    def cut(coeffs):              # the commitment length of the scheme
        return poly_ops.pad_to(fr, coeffs, cl)

    publics = [[v % p for v in a[:r1.num_public]] for a in assignments]
    slots = np.zeros((bsz, n), dtype=object)
    for b, a in enumerate(assignments):
        slots[b, pk.slot_of_var] = [v % p for v in a]
    z_evals = fp.from_ints(fr, slots, dev)             # (B, n, nw)

    tr = vk_transcript(curve, pk.vk, label=LABEL,
                       absorb=_absorb_vk).broadcast(bsz)
    for i in range(r1.num_public):
        tr.absorb_fr([pub[i] for pub in publics])

    # ---- round 1: witness oracles ---------------------------------------
    z_a = _matvec(fr, pk.matrices["a"], z_evals, n)
    z_b = _matvec(fr, pk.matrices["b"], z_evals, n)
    z_coeffs, za_coeffs, zb_coeffs = intt(dom_h, torch.stack(
        [z_evals, z_a, z_b])).unbind(0)
    x_evals = fp.from_ints(fr, [pub + [0] * (xsz - len(pub))
                                for pub in publics], dev)
    x_coeffs = intt(dom_x, x_evals)
    diff = fp.sub(fr, z_coeffs, poly_ops.pad_to(fr, x_coeffs, n))
    w_coeffs, _ = _div_vanishing(fr, diff, xsz)      # exact by construction

    s_coeffs = None
    if zk_rng is not None:
        # p + r*v_H keeps the evaluations over H (and every sumcheck sum)
        # and randomizes the committed polynomial: one scalar an oracle
        # covers the single beta query
        r_w, r_a, r_b = (fp.from_ints(fr, [zk_rng.randrange(p)
                                    for _ in range(bsz)], dev)
                         for _ in range(3))
        w_coeffs = _add_at(fr, w_coeffs, ((0, r_w, -1), (n, r_w, +1)), n + 1)
        za_coeffs = _add_at(fr, za_coeffs, ((0, r_a, -1), (n, r_a, +1)),
                            n + 1)
        zb_coeffs = _add_at(fr, zb_coeffs, ((0, r_b, -1), (n, r_b, +1)),
                            n + 1)
        # z' = w'*v_X + x = z + r_w*(X^n - 1)(X^xsz - 1): the round-2
        # identity stays exact against the blinded w
        z_coeffs = _add_at(fr, z_coeffs,
                           ((0, r_w, +1), (xsz, r_w, -1), (n, r_w, -1),
                            (n + xsz, r_w, +1)), n + xsz + 1)
        # the mask s with sum_H s = 0 (its coefficients at X^{jn} cancel)
        deg_s = min(3 * n - 3, cl - 1)
        s_rows = []
        for _ in range(bsz):
            cs = [zk_rng.randrange(p) for _ in range(deg_s + 1)]
            cs[0] = -(sum(cs[j] for j in range(n, deg_s + 1, n))) % p
            s_rows.append(cs)
        s_coeffs = fp.from_ints(fr, s_rows, dev)

    r1_names = ("w", "z_a", "z_b") + (("s",) if s_coeffs is not None
                                      else ())
    r1_polys = [w_coeffs, za_coeffs, zb_coeffs] + (
        [s_coeffs] if s_coeffs is not None else [])
    comms = dict(zip(r1_names, commit(*((cut(c), 0) for c in r1_polys))))
    for name in r1_names:
        tr.absorb_points_ints(comms[name])
    alpha = tr.challenge()
    etas = {m: tr.challenge() for m in M_NAMES}

    # ---- round 2: outer sumcheck over H ---------------------------------
    alpha_t = fp.from_ints(fr, alpha, dev)                    # (B, nw)
    eta_t = {m: fp.from_ints(fr, etas[m], dev)[:, None] for m in M_NAMES}
    vh_alpha = [(pow(a, n, p) - 1) % p for a in alpha]
    denom = fp.sub(fr, alpha_t[:, None], _h_pows(dom_h)[None])   # (B, n)
    r_vec = fp.mul(fr, fp.from_ints(fr, vh_alpha, dev)[:, None],
                   fp.batch_inv(fr, denom))            # u_H(alpha, .) on H
    t_evals = None
    for m in M_NAMES:
        tm = fp.mul(fr, eta_t[m], _matvec_t(fr, pk.matrices[m], r_vec, n))
        t_evals = tm if t_evals is None else fp.add(fr, t_evals, tm)
    r_coeffs, t_coeffs = intt(dom_h, torch.stack([r_vec, t_evals])).unbind(0)

    four_n = dom_h4.n
    cr, ct, cz, cza, czb = _coset_ntt(fr, torch.stack(
        [poly_ops.pad_to(fr, c, four_n) for c in
         (r_coeffs, t_coeffs, z_coeffs, za_coeffs, zb_coeffs)]),
        dom_h4, g).unbind(0)
    summed = fp.add(fr, fp.add(fr, fp.mul(fr, eta_t["a"], cza),
                               fp.mul(fr, eta_t["b"], czb)),
                    fp.mul(fr, eta_t["c"], fp.mul(fr, cza, czb)))
    q1_evals = fp.sub(fr, fp.mul(fr, cr, summed), fp.mul(fr, ct, cz))
    if s_coeffs is not None:
        q1_evals = fp.add(fr, q1_evals, _coset_ntt(fr, s_coeffs, dom_h4, g))
    q1_coeffs = _coset_intt(fr, q1_evals, dom_h4, g)
    h1_coeffs, rem = _div_vanishing(fr, q1_coeffs, n)
    g1_coeffs = rem[..., 1:, :]                      # rem = X g_1 (sum = 0)
    # with the degree-bound commitment X^sh1 * g_1
    comms["g_1"], comms["h_1"], comms["g_1_shift"] = commit(
        (cut(g1_coeffs), 0), (cut(h1_coeffs), 0), (g1_coeffs, sh1))
    for name in ("g_1", "h_1", "g_1_shift"):
        tr.absorb_points_ints(comms[name])
    beta = tr.challenge()

    # ---- round 3: inner sumcheck over K, the three matrices at once -----
    beta_t = fp.from_ints(fr, beta, dev)
    c_ab = fp.from_ints(fr, [(pow(a, n, p) - 1) * (pow(b, n, p) - 1)
                             for a, b in zip(alpha, beta)], dev)[:, None]
    mats = [pk.matrices[m] for m in M_NAMES]

    def stack(attr):                                  # (3, 1, K, nw)
        return torch.stack([getattr(im, attr) for im in mats])[:, None]

    den = fp.mul(fr, fp.sub(fr, alpha_t[:, None], stack("row_e")),
                 fp.sub(fr, beta_t[:, None], stack("col_e")))  # (3, B, K)
    f = fp.mul(fr, fp.mul(fr, c_ab, stack("val")), fp.batch_inv(fr, den))
    sig = poly_ops.sum_axis(fr, f, -2)               # (3, B, nw)
    f_coeffs = intt(dom_k, f)
    g_m = f_coeffs[..., 1:, :]                       # f = sigma/|K| + X g
    # h_M = (a - b (X g + sigma/|K|)) / v_K on the 4K coset
    ca = _coset_ntt(fr, fp.mul(fr, c_ab, stack("val_coeffs")), dom_k4, g)
    crow, ccol = (torch.stack(c)[:, None] for c in zip(
        *(_index_coset(fr, im, dom_k4, g) for im in mats)))
    cb = fp.mul(fr, fp.sub(fr, alpha_t[:, None], crow),
                fp.sub(fr, beta_t[:, None], ccol))
    cf = _coset_ntt(fr, f_coeffs, dom_k4, g)
    ch = fp.mul(fr, fp.sub(fr, ca, fp.mul(fr, cb, cf)),
                _vanishing_inv_on_coset(fr, ksz, dom_k4, g))
    h_m = _coset_intt(fr, ch, dom_k4, g)[..., :3 * ksz, :]
    pts = commit(*((cut(g_m[i]), 0) for i in range(3)),
                 *((cut(h_m[i]), 0) for i in range(3)),
                 *((g_m[i], shm) for i in range(3)))
    sigmas = [[int(v) for v in row] for row in fp.to_ints(fr, sig)]
    for i, m in enumerate(M_NAMES):
        comms[f"{m}_g"], comms[f"{m}_h"] = pts[i], pts[3 + i]
        comms[f"{m}_g_shift"] = pts[6 + i]
        for name in (f"{m}_g", f"{m}_h", f"{m}_g_shift"):
            tr.absorb_points_ints(comms[name])
        tr.absorb_fr(sigmas[i])
    delta = tr.challenge()

    # ---- round 4: evaluations and the two batched openings --------------
    h_order = H_OPEN + (("s",) if s_coeffs is not None else ())
    h_polys = {"w": w_coeffs, "z_a": za_coeffs, "z_b": zb_coeffs,
               "g_1": g1_coeffs, "h_1": h1_coeffs, "s": s_coeffs}
    k_polys = {}
    for i, (m, im) in enumerate(zip(M_NAMES, mats)):
        k_polys[f"{m}_row"] = im.row_coeffs
        k_polys[f"{m}_col"] = im.col_coeffs
        k_polys[f"{m}_val"] = im.val_coeffs
        k_polys[f"{m}_g"] = g_m[i]
        k_polys[f"{m}_h"] = h_m[i]

    def bstack(polys, names):                        # (B, len(names), cl)
        return torch.stack([poly_ops.pad_to(fr, polys[nm], cl).expand(
            bsz, cl, -1) for nm in names], dim=1)

    delta_t = fp.from_ints(fr, delta, dev)
    h_stack = bstack(h_polys, h_order)
    k_stack = bstack(k_polys, K_OPEN)
    ev_b = poly_ops.evaluate(fr, h_stack, beta_t[:, None])      # (B, |h|)
    ev_d = poly_ops.evaluate(fr, k_stack, delta_t[:, None])
    evb_i = fp.to_ints(fr, ev_b).tolist()
    evd_i = fp.to_ints(fr, ev_d).tolist()
    for i in range(len(h_order)):
        tr.absorb_fr([row[i] for row in evb_i])
    for i in range(len(K_OPEN)):
        tr.absorb_fr([row[i] for row in evd_i])
    u_beta = fp.from_ints(fr, tr.challenge(), dev)
    u_delta = fp.from_ints(fr, tr.challenge(), dev)

    def opening(stacked, point, u, shifted):
        """The witness polynomial of the u-combination of the stacked base
        polynomials plus the shifted degree-bound ones X^sh * g (whose
        evaluations z^sh * g(z) the verifier derives)."""
        n_base = stacked.shape[1]
        upows = poly_ops.powers(fr, u, n_base + len(shifted))   # (B, cnt)
        combined = poly_ops.sum_axis(
            fr, fp.mul(fr, stacked, upows[:, :n_base, None, :]), 1)
        combined = poly_ops.pad_to(fr, combined, srs.size)
        for j, (coeffs, sh) in enumerate(shifted):
            plane = torch.nn.functional.pad(
                coeffs, (0, 0, sh, srs.size - sh - coeffs.shape[-2]))
            combined = fp.add(fr, combined,
                              fp.mul(fr, plane, upows[:, n_base + j, None]))
        return poly_ops.divide_linear(fr, combined, point)[0]

    q_beta = opening(h_stack, beta_t, u_beta, [(g1_coeffs, sh1)])
    q_delta = opening(k_stack, delta_t, u_delta,
                      [(g_m[i], shm) for i in range(len(M_NAMES))])
    open_beta, open_delta = commit((q_beta, 0), (q_delta, 0))

    proofs = []
    for b in range(bsz):
        evals = {nm: evb_i[b][i] for i, nm in enumerate(h_order)}
        evals.update({nm: evd_i[b][i] for i, nm in enumerate(K_OPEN)})
        proofs.append(MarlinProof(
            {nm: lanes[b] for nm, lanes in comms.items()},
            {m: sigmas[i][b] for i, m in enumerate(M_NAMES)},
            {nm: int(v) for nm, v in evals.items()},
            open_beta[b], open_delta[b]))
    return proofs


# ---------------------------------------------------------------- verifier

def verify(vk: IndexVerifierKey, srs: kzg.Srs, public: list[int],
           proof: MarlinProof) -> bool:
    """Host-int verifier: O(1) field checks and the two batched KZG
    openings in one pairing check.  `public` includes the leading 1."""
    checks = _verify_checks(vk, srs, public, proof)
    return checks is not None and kzg.verify_many(srs, checks)


def batch_verify(vk: IndexVerifierKey, srs: kzg.Srs, instances,
                 rng=None) -> bool:
    """Many (public, proof) instances with one multi-pairing: the field
    and sumcheck checks per instance, the 2N pairing equations in one
    random linear combination.  False if any instance fails."""
    checks = _group_checks(vk, srs, instances)
    if any(c is None for c in checks):
        return False
    return kzg.verify_many(srs, [t for c in checks for t in c], rng=rng)


def _group_checks(vk: IndexVerifierKey, srs: kzg.Srs, instances) -> list:
    """Per-instance opening-check tuples (None where a host check fails),
    the Fiat-Shamir challenges of the well-formed instances derived in one
    B-lane transcript per (zk, public length) bucket."""
    checks = [None] * len(instances)
    buckets: dict = {}
    for i, (public, proof) in enumerate(instances):
        if _proof_well_formed(vk, public, proof):
            key = ("s" in proof.comms, len(public))
            buckets.setdefault(key, []).append(i)
    for idxs in buckets.values():
        chs = _derive_challenges_batch(vk, [instances[i] for i in idxs])
        for i, ch in zip(idxs, chs):
            public, proof = instances[i]
            checks[i] = _checks_host(vk, srs, public, proof, ch)
    return checks


def verify_group(vk: IndexVerifierKey, srs: kzg.Srs, instances,
                 rng=None) -> list:
    """A verdict for every (public, proof) instance of a group, faulty ones
    among them (the contract of `prize-marlin-verifier/src/main.rs:37-62`:
    a wrong verdict either way fails).

    The host checks run per instance (a tampered proof usually dies there,
    its commitments reseeding the challenges); the survivors share one
    multi-pairing, and only if it fails are they bisected on their cached
    opening tuples: f faulty pairings cost O(f log N) multi-pairings."""
    checks = _group_checks(vk, srs, instances)
    verdicts = [c is not None for c in checks]
    live = [i for i, c in enumerate(checks) if c is not None]

    def combined_ok(sub) -> bool:
        return kzg.verify_many(srs, [t for i in sub for t in checks[i]],
                               rng=rng)

    def isolate(sub):
        if not sub or combined_ok(sub):
            return
        if len(sub) == 1:
            verdicts[sub[0]] = False
            return
        mid = len(sub) // 2
        isolate(sub[:mid])
        isolate(sub[mid:])

    isolate(live)
    return verdicts


def _proof_well_formed(vk: IndexVerifierKey, public, proof) -> bool:
    """Shape and key validation: a malformed proof fails here, before it
    could take a lane of a batched transcript."""
    if len(public) > (1 << vk.log_x) or (public and public[0] != 1):
        return False
    zk = "s" in proof.comms
    comms_needed = (("w", "z_a", "z_b") + (("s",) if zk else ())
                    + ("g_1", "h_1", "g_1_shift")
                    + tuple(f"{m}_{sfx}" for m in M_NAMES
                            for sfx in ("g", "h", "g_shift")))
    ev_needed = H_OPEN + (("s",) if zk else ()) + K_OPEN
    return (all(k in proof.comms for k in comms_needed)
            and all(m in proof.sigmas for m in M_NAMES)
            and all(k in proof.evals for k in ev_needed))


def _derive_challenges_batch(vk: IndexVerifierKey, instances) -> list:
    """The Fiat-Shamir challenges of B same-shape well-formed instances
    from one B-lane transcript (the prover's absorbs replayed); lane b is
    instance b's own derivation.  The instances share the zk flag and the
    public length (`_group_checks` buckets by them)."""
    zk = "s" in instances[0][1].comms
    tr = vk_transcript(vk.curve, vk, label=LABEL, absorb=_absorb_vk
                       ).broadcast(len(instances))

    def apts(key):
        tr.absorb_points_ints([pf.comms[key] for _, pf in instances])

    for j in range(len(instances[0][0])):
        tr.absorb_fr([pub[j] for pub, _ in instances])
    for name in ("w", "z_a", "z_b") + (("s",) if zk else ()):
        apts(name)
    alpha = tr.challenge()
    etas = {m: tr.challenge() for m in M_NAMES}
    for name in ("g_1", "h_1", "g_1_shift"):
        apts(name)
    beta = tr.challenge()
    for m in M_NAMES:
        for sfx in ("g", "h", "g_shift"):
            apts(f"{m}_{sfx}")
        tr.absorb_fr([pf.sigmas[m] for _, pf in instances])
    delta = tr.challenge()
    for name in H_OPEN + (("s",) if zk else ()) + K_OPEN:
        tr.absorb_fr([pf.evals[name] for _, pf in instances])
    u_beta = tr.challenge()
    u_delta = tr.challenge()
    return [
        {"alpha": alpha[b], "etas": {m: etas[m][b] for m in M_NAMES},
         "beta": beta[b], "delta": delta[b], "u_beta": u_beta[b],
         "u_delta": u_delta[b]}
        for b in range(len(instances))]


def _verify_checks(vk: IndexVerifierKey, srs: kzg.Srs, public: list[int],
                   proof: MarlinProof):
    """Every transcript and sumcheck check of one proof; the two KZG
    opening check tuples (host ints), or None on a failure."""
    if not _proof_well_formed(vk, public, proof):
        return None
    chall = _derive_challenges_batch(vk, [(public, proof)])[0]
    return _checks_host(vk, srs, public, proof, chall)


def _checks_host(vk: IndexVerifierKey, srs: kzg.Srs, public: list[int],
                 proof: MarlinProof, chall: dict):
    """The sumcheck checks and the opening tuples, given the challenges."""
    curve = vk.curve
    fr = curve.scalar
    p = fr.p
    n, ksz, xsz = 1 << vk.log_n, 1 << vk.log_k, 1 << vk.log_x
    zk = "s" in proof.comms
    h_order = H_OPEN + (("s",) if zk else ())
    alpha, etas, beta = chall["alpha"], chall["etas"], chall["beta"]
    delta, u_beta, u_delta = chall["delta"], chall["u_beta"], chall["u_delta"]

    ev = proof.evals
    v_h_alpha = (pow(alpha, n, p) - 1) % p
    v_h_beta = (pow(beta, n, p) - 1) % p
    v_x_beta = (pow(beta, xsz, p) - 1) % p
    if beta == alpha or v_h_beta == 0 or v_x_beta == 0:
        return None

    # x-hat(beta) by Lagrange over the X subgroup (|X| is tiny)
    wx = primitive_root(fr, vk.log_x)
    x_inv = pow(xsz, -1, p)
    xhat = 0
    elem = 1
    for i in range(xsz):
        xi = public[i] if i < len(public) else 0
        li = v_x_beta * elem % p * x_inv % p * pow((beta - elem) % p,
                                                  -1, p) % p
        xhat = (xhat + xi * li) % p
        elem = elem * wx % p
    z_beta = (ev["w"] * v_x_beta + xhat) % p

    # outer sumcheck at beta (the zk mask s joins q_1 additively)
    r_ab = (v_h_alpha - v_h_beta) % p * pow((alpha - beta) % p, -1, p) % p
    summed = (etas["a"] * ev["z_a"] + etas["b"] * ev["z_b"]
              + etas["c"] * ev["z_a"] % p * ev["z_b"]) % p
    sigma3 = sum(etas[m] * proof.sigmas[m] for m in M_NAMES) % p
    s_beta = ev["s"] if zk else 0
    lhs = (s_beta + r_ab * summed - sigma3 * z_beta) % p
    rhs = (ev["h_1"] * v_h_beta + beta * ev["g_1"]) % p
    if lhs != rhs:
        return None

    # inner sumchecks at delta
    v_k_delta = (pow(delta, ksz, p) - 1) % p
    c_ab = v_h_alpha * v_h_beta % p
    k_inv = pow(ksz, -1, p)
    for m in M_NAMES:
        a_d = c_ab * ev[f"{m}_val"] % p
        b_d = (alpha - ev[f"{m}_row"]) % p * ((beta - ev[f"{m}_col"]) % p) % p
        f_d = (delta * ev[f"{m}_g"] + proof.sigmas[m] * k_inv) % p
        if ev[f"{m}_h"] * v_k_delta % p != (a_d - b_d * f_d) % p:
            return None

    # the two batched openings as (C, z, y, W) host tuples for one
    # multi-pairing (`kzg.verify_many`); the shifted degree-bound
    # commitments' evaluations are derived, z^sh * y_base, never read from
    # the proof
    sh1, shm = _shift_bounds(srs.size, n, ksz)

    def batch_tuple(order, comm_src, point, u, witness, shifted):
        pts, ks, y, upow = [], [], 0, 1
        for nm in order:
            c = comm_src(nm)
            if c is not None:
                pts.append(c)
                ks.append(upow)
            y = (y + upow * ev[nm]) % p
            upow = upow * u % p
        for shift_nm, base_nm, sh in shifted:
            c = proof.comms.get(shift_nm)
            if c is not None:
                pts.append(c)
                ks.append(upow)
            y = (y + upow * pow(point, sh, p) * ev[base_nm]) % p
            upow = upow * u % p
        return (kzg.combine_ints(curve, pts, ks), point, y, witness)

    index_comms = vk.commitments
    return [
        batch_tuple(h_order, lambda nm: proof.comms[nm], beta, u_beta,
                    proof.open_beta, [("g_1_shift", "g_1", sh1)]),
        batch_tuple(
            K_OPEN,
            lambda nm: (index_comms[nm] if nm in index_comms
                        else proof.comms[nm]),
            delta, u_delta, proof.open_delta,
            [(f"{m}_g_shift", f"{m}_g", shm) for m in M_NAMES]),
    ]

