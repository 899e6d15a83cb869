"""Sharded PLONK prover: the five rounds of `plonk/prover.py` over a world
of ranks, the counterpart of the reference's mesh-sharded prover
(`zprize_tpu/parallel/plonk_sharded.py`, itself the SPMD form of
winderica's distributed TurboPLONK, `prize3-plonk-dizk/winderica/
distributed/`).

Every polynomial is row-sharded (`parallel/mesh.py`): rank r holds its
block of rows of the wire, selector and sigma polynomials, of the n + 8
coefficients of each committed polynomial, and of the 4n coset
evaluations.  The collective forms:

* the NTTs: four-step n1 x n2 with three all_to_alls (`dist_ntt`),
  natural order in and out, each rank's passes on the Fr NTT kernel;
* the permutation product Z: a local scan, an all-gather of the block
  totals and a shift of one row across the rank boundary
  (`dist_cumprod_exclusive`; winderica's worker-to-worker chain,
  `worker/mod.rs:766-831`);
* z(wx) on the coset: a roll of four rows across the rank boundary;
* the commitments: the points-sharded MSM (`msm_sharded`), each rank
  against its rows of the SRS;
* evaluations and opening quotients: local dots and scans with
  all-gathered partials (`dist_eval_stack`, `dist_divide_linear`).

The Fiat-Shamir transcript runs on the host of every rank, replicated and
deterministic: no rank sends a challenge to another.  `prove` mirrors
`prover.prove_planes` (transcript order, blinding draws and layout), so a
seeded `blinding_rng` gives the single-device proof, which the standard
verifier accepts.

Keygen is not sharded: `key_shard` cuts a single-device `ProvingKey` into
the rows one rank reads, as CPU tensors that can travel to a rank
process.
"""

from __future__ import annotations

import dataclasses
import functools
import random

import torch

from ..curve import sw
from ..curve.spec import CurveSpec
from ..field import fp
from ..field.spec import FieldSpec
from ..msm import pippenger
from ..ntt.domain import Domain, primitive_root
from ..ntt.radix2 import intt, ntt
from ..plonk.prover import OPEN_ORDER, SELECTORS, Proof, ProvingKey, \
    VerifyingKey
from ..plonk.transcript import vk_transcript
from ..poly import ops as poly_ops
from .mesh import World, all_gather_rows, all_to_all_tiled, shift_rows, \
    take_rows
from .msm_sharded import msm_sharded
from .ntt_sharded import column_twiddles

EXTRA = 8                 # the commit length is n + EXTRA
KEY_POLYS = (*SELECTORS, "s1", "s2", "s3")
BLINDING_DRAWS = 9        # 2 for each wire polynomial, 3 for Z


# --------------------------------------------------------------------------
# collective building blocks
# --------------------------------------------------------------------------

def _tree_fold(spec: FieldSpec, x: torch.Tensor, op) -> torch.Tensor:
    """Log-depth fold of op over axis 0 (any length >= 1)."""
    m = x.shape[0]
    while m > 1:
        half = m // 2
        merged = op(spec, x[:half], x[half:2 * half])
        if m % 2:
            merged = torch.cat([merged, x[m - 1:m]])
        x, m = merged, half + m % 2
    return x[0]


def _scan(spec: FieldSpec, x: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of op along axis 0 (Hillis-Steele, log2 n steps)."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], op(spec, x[d:], x[:-d])])
        d *= 2
    return x


def dist_ntt(spec: FieldSpec, a: torch.Tensor, world: World,
             inverse: bool = False) -> torch.Tensor:
    """NTT (or the inverse, scaled by 1/n) of natural-order row-sharded
    coefficients: a is this rank's (..., n/D, L) block, the result its
    block of the natural-order transform.  Four-step n1 x n2 (n1 =
    2^floor(log n / 2)) with three tiled all_to_alls: to column-sharded
    for the column NTTs and the step twiddle of the rank's columns, back
    to row-sharded for the row NTTs, and to natural order."""
    d = world.size
    n = a.shape[-2] * d
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"n = {n} is not a power of two")
    l1, l2 = log_n // 2, log_n - log_n // 2
    n1, n2 = 1 << l1, 1 << l2
    if n1 % d or n2 % d:
        raise ValueError(f"{n1} x {n2} does not split over {d} ranks")
    dev, tfm = a.device, intt if inverse else ntt
    ax = a.dim() - 2                              # the j1 axis
    x = a.reshape(*a.shape[:-2], n1 // d, n2, a.shape[-1])
    x = all_to_all_tiled(x, ax + 1, ax, world)   # (.., n1, n2/D, L)
    x = tfm(Domain(spec, l1, dev), x, axis=ax)    # column NTTs
    x = fp.mul(spec, x, column_twiddles(spec, l1, l2, world.rank * n2 // d,
                                        n2 // d, inverse, dev))
    x = all_to_all_tiled(x, ax, ax + 1, world)   # (.., n1/D, n2, L)
    x = tfm(Domain(spec, l2, dev), x, axis=ax + 1)   # row NTTs
    x = all_to_all_tiled(x, ax + 1, ax, world)   # (.., n1, n2/D, L)
    # C[k1, k2] -> A[k1 + n1 k2]: the rank's k2 block, k2-major
    return x.transpose(ax, ax + 1).reshape(*a.shape)


def dist_powers(spec: FieldSpec, z: int, n: int, world: World
                ) -> torch.Tensor:
    """This rank's block of [1, z, .., z^(n-1)] as (n/D, L) words: the
    local power ladder times z^(r n/D).  z is a host int, the same on
    every rank (a transcript challenge), so the offset needs no
    collective."""
    m = n // world.size
    base = fp.from_ints(spec, [z, pow(z, world.rank * m, spec.p)],
                        world.device)
    return fp.mul(spec, poly_ops.powers(spec, base[0], m), base[1])


def dist_cumprod_exclusive(spec: FieldSpec, ratio: torch.Tensor,
                           world: World) -> torch.Tensor:
    """Exclusive running product of a row-sharded (n/D, L) block: a local
    scan, the product of the earlier ranks' block totals (all-gathered),
    and a shift of one row across the rank boundary."""
    inc = _scan(spec, ratio, fp.mul)
    totals = all_gather_rows(inc[-1:], world)                 # (D, L)
    if world.rank:
        inc = fp.mul(spec, inc, _tree_fold(spec, totals[:world.rank],
                                           fp.mul))
    out = shift_rows(inc, 1, world)
    if world.rank == 0:
        out[0] = fp.ones(spec, (), ratio.device)
    return out


def dist_batch_inv(spec: FieldSpec, a: torch.Tensor, world: World
                   ) -> torch.Tensor:
    """Inverse of every element of a row-sharded block: each rank's own
    batch inversion (one host inversion a rank), no collective."""
    return fp.batch_inv(spec, a)


def dist_eval_stack(spec: FieldSpec, polys: torch.Tensor,
                    pows: torch.Tensor, world: World) -> torch.Tensor:
    """K stacked polynomials (K, n/D, L) (row-sharded) at the point whose
    power block is `pows` (n/D, L): the local dot products, all-gathered
    and summed.  Returns (K, L) on every rank."""
    part = poly_ops.sum_axis(spec, fp.mul(spec, polys, pows), -2)   # (K, L)
    return poly_ops.sum_axis(spec, all_gather_rows(part[None], world), 0)


def dist_suffix_sum(spec: FieldSpec, t: torch.Tensor, world: World
                    ) -> torch.Tensor:
    """Exclusive suffix sum sum_{k > j} t_k of a row-sharded (n/D, L)
    block: a local reversed scan plus the later ranks' block totals."""
    inc = _scan(spec, t.flip(0), fp.add).flip(0)
    totals = all_gather_rows(inc[:1], world)                  # (D, L)
    if world.rank < world.size - 1:
        inc = fp.add(spec, inc, _tree_fold(spec, totals[world.rank + 1:],
                                           fp.add))
    return fp.sub(spec, inc, t)


def dist_divide_linear(spec: FieldSpec, a: torch.Tensor, z: int,
                       zpows: torch.Tensor, world: World) -> torch.Tensor:
    """The quotient of a(X) / (X - z) for row-sharded coefficients (n/D, L),
    `zpows` the block of z's powers (`dist_powers`), by the suffix-sum
    identity q_j = z^(-j-1) sum_{k > j} a_k z^k (z != 0): the same
    collective pattern as the Z product, reversed."""
    s = dist_suffix_sum(spec, fp.mul(spec, a, zpows), world)
    zinv = pow(z, -1, spec.p)
    zinv_pows = dist_powers(spec, zinv, a.shape[-2] * world.size, world)
    return fp.mul(spec, fp.mul(spec, s, zinv_pows),
                  fp.constant(spec, zinv, (), a.device))


# --------------------------------------------------------------------------
# the sharded prover
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KeyShard:
    """The rows of a `ProvingKey` that rank `rank` of a world of `size`
    reads, on the CPU: its block of the first n + 8 SRS points, of the
    selector and sigma coefficients (padded to n + 8; rows of KEY_POLYS),
    of the sigma and identity evaluations (n rows), and of the selectors',
    sigmas' and L1's 4n coset evaluations; and the verifying key (which
    seeds the transcript) with its commitments on the CPU."""
    curve: CurveSpec
    vk: VerifyingKey
    coset_g: int
    rank: int
    size: int
    srs: sw.Affine
    coeffs: torch.Tensor          # (8, (n+8)/D, nw)
    sigma_evals: torch.Tensor     # (3, n/D, nw)
    id_evals: torch.Tensor        # (3, n/D, nw)
    coset: dict                   # name -> (4n/D, nw)


def key_shard(pk: ProvingKey, size: int, rank: int) -> KeyShard:
    """Cut rank `rank`'s rows for a world of `size` out of a single-device
    proving key (copies on the CPU, so that a rank process receives only
    its own rows)."""
    n = pk.circuit.n
    nc = n + EXTRA
    if n % size or nc % size:
        raise ValueError(f"n = {n} and n + {EXTRA} do not split over "
                         f"{size} ranks")
    if pk.srs.size < nc:
        raise ValueError(f"SRS of {pk.srs.size} < n + {EXTRA} powers")

    def block(t, total):
        m = total // size
        return t[..., rank * m:(rank + 1) * m, :].cpu().clone()

    fr = pk.curve.scalar
    polys = dict(pk.selectors, s1=pk.sigma_coeffs[0],
                 s2=pk.sigma_coeffs[1], s3=pk.sigma_coeffs[2])
    coeffs = torch.stack([poly_ops.pad_to(fr, polys[k], nc)
                          for k in KEY_POLYS])
    mc = nc // size
    srs = sw.Affine(*(a[rank * mc:(rank + 1) * mc].cpu().clone()
                      for a in pk.srs.g1_powers))
    vk = pk.vk
    vk = VerifyingKey(vk.curve, vk.n, vk.k1, vk.k2, list(vk.public_rows),
                      {k: sw.Point(*(a.cpu() for a in v))
                       for k, v in vk.commitments.items()})
    return KeyShard(pk.curve, vk, pk.coset_g, rank, size, srs,
                    block(coeffs, nc), block(pk.sigma_evals, n),
                    block(pk.id_evals, n),
                    {k: block(v, 4 * n) for k, v in pk.coset_evals.items()})


def _row(fr: FieldSpec, value: int, device) -> torch.Tensor:
    return fp.from_ints(fr, [value % fr.p], device)[0]


class ShardedProver:
    """This rank's part of a sharded PLONK prover: `pk` a single-device
    `ProvingKey` (whose rows this rank takes) or this rank's `KeyShard`,
    on `world.device`.  Every rank of the world calls `prove` with its
    own wire rows; each gets the whole proof."""

    def __init__(self, pk: ProvingKey | KeyShard, world: World):
        key = pk if isinstance(pk, KeyShard) else key_shard(
            pk, world.size, world.rank)
        if (key.rank, key.size) != (world.rank, world.size):
            raise ValueError(f"key of rank {key.rank}/{key.size} on rank "
                             f"{world.rank}/{world.size}")
        self.world = world
        self.curve, self.vk = key.curve, key.vk
        dev = world.device
        fr = self.curve.scalar
        p = fr.p
        n = self.vk.n
        self.n, self.nc = n, n + EXTRA
        self.m, self.mc, self.m4 = (n // world.size,
                                    self.nc // world.size,
                                    4 * n // world.size)
        self.srs = sw.Affine(*(a.to(dev) for a in key.srs))
        self.coeffs = key.coeffs.to(dev)
        self.sigma_evals = key.sigma_evals.to(dev)
        self.id_evals = key.id_evals.to(dev)
        self.coset = {k: v.to(dev) for k, v in key.coset.items()}
        # no wider than log2 of the rank's points: wider windows would
        # leave most of their buckets empty
        self.c_commit = max(2, min(pippenger.default_window_bits(self.mc),
                                   self.mc.bit_length() - 1))
        g = key.coset_g
        self.g = g
        self.w = primitive_root(fr, n.bit_length() - 1)
        w4 = primitive_root(fr, n.bit_length() + 1)
        start = world.rank * self.m4
        # this rank's rows of g^i, g^-i and x = g w4^i on the 4n coset
        self.gpow = self._block_powers(g, start, self.m4)
        self.ginv = self._block_powers(pow(g, -1, p), start, self.m4)
        self.xs = fp.mul(fr, self._block_powers(w4, start, self.m4),
                         _row(fr, g, dev))
        gn, w4n = pow(g, n, p), pow(w4, n, p)
        zh_inv = fp.from_ints(fr, [pow((gn * pow(w4n, i, p) - 1) % p, -1, p)
                                   for i in range(4)], dev)
        self.zh_inv = zh_inv.repeat(self.m4 // 4, 1)   # x^n - 1: period 4

    def _block_powers(self, base: int, start: int, count: int
                      ) -> torch.Tensor:
        fr = self.curve.scalar
        rows = fp.from_ints(fr, [base, pow(base, start, fr.p)],
                            self.world.device)
        return fp.mul(fr, poly_ops.powers(fr, rows[0], count), rows[1])

    def _commit(self, coeffs: torch.Tensor) -> sw.Point:
        """Commitment to row-sharded (n+8)/D coefficient blocks."""
        return msm_sharded(self.curve, self.srs,
                           pippenger.scalar_limbs(self.curve, coeffs),
                           self.world, c=self.c_commit)

    def _blind(self, coeffs: torch.Tensor, rands: list[int]
               ) -> torch.Tensor:
        """prover._blind on row-sharded n-coefficient blocks: the n + 8
        layout, minus r_i at rows i and plus r_i at rows n + i, on the
        ranks that hold those rows."""
        fr, n, mc = self.curve.scalar, self.n, self.mc
        ext = take_rows(coeffs, 0, n, self.nc, self.world)
        r = fp.from_ints(fr, rands, ext.device)
        lo = self.world.rank * mc
        for i in range(len(rands)):
            for row, op in ((i, fp.sub), (n + i, fp.add)):
                if lo <= row < lo + mc:
                    ext[row - lo] = op(fr, ext[row - lo], r[i])
        return ext

    def _coset4(self, coeffs: torch.Tensor, rows: int) -> torch.Tensor:
        """Evaluations on this rank's rows of the coset g·H_4n of (K, b, nw)
        row-sharded blocks of polynomials of `rows` rows."""
        fr, world = self.curve.scalar, self.world
        padded = torch.movedim(take_rows(torch.movedim(coeffs, -2, 0), 0,
                                         rows, 4 * self.n, world), 0, -2)
        return dist_ntt(fr, fp.mul(fr, padded, self.gpow), world)

    def _drawn_on_rank0(self) -> list[int]:
        """BLINDING_DRAWS values of the host's entropy drawn on rank 0 and
        given to every rank (each rank must blind with the same ones)."""
        fr = self.curve.scalar
        rng = random.SystemRandom()
        mine = fp.from_ints(fr, [rng.randrange(fr.p)
                                 for _ in range(BLINDING_DRAWS)],
                            self.world.device)
        rows = all_gather_rows(mine, self.world)[:BLINDING_DRAWS]
        return [int(v) for v in fp.to_ints(fr, rows)]

    def prove(self, wires_local: torch.Tensor, public: list[int],
              blinding_rng=None) -> Proof:
        """wires_local: this rank's (3, n/D, nw) rows of the wire
        evaluations.  Every rank passes the same public inputs, and the
        same `blinding_rng` in the same state or None (then rank 0 draws
        the blinding from the host's entropy for every rank)."""
        curve, world = self.curve, self.world
        fr = curve.scalar
        p = fr.p
        n, nc, vk = self.n, self.nc, self.vk
        dev = world.device
        rank = world.rank
        if blinding_rng is None:
            draws = iter(self._drawn_on_rank0())
            blind = functools.partial(next, draws)
        else:
            blind = functools.partial(blinding_rng.randrange, p)

        def row(v):
            return _row(fr, v, dev)

        tr = vk_transcript(curve, vk)
        for v in public:
            tr.absorb_fr(v)

        # public-input polynomial: PI = -public at the public rows
        pi_evals = fp.zeros(fr, (self.m,), dev)
        for v, prow in zip(public, vk.public_rows):
            if prow // self.m == rank:
                pi_evals[prow - rank * self.m] = row(-v)

        # --- round 1: wire polynomials -----------------------------------
        wc0 = dist_ntt(fr, wires_local, world, inverse=True)
        wire_coeffs = [self._blind(wc0[i], [blind(), blind()])
                       for i in range(3)]
        wire_comms = [self._commit(c) for c in wire_coeffs]
        for cm in wire_comms:
            tr.absorb_point(cm)
        beta, gamma = row(tr.challenge()), row(tr.challenge())

        def lin(w, base):
            return fp.add(fr, fp.add(fr, w, fp.mul(fr, beta, base)), gamma)

        # --- round 2: permutation product Z ------------------------------
        num = lin(wires_local, self.id_evals)
        den = lin(wires_local, self.sigma_evals)
        num = fp.mul(fr, fp.mul(fr, num[0], num[1]), num[2])
        den = fp.mul(fr, fp.mul(fr, den[0], den[1]), den[2])
        z_evals = dist_cumprod_exclusive(
            fr, fp.mul(fr, num, dist_batch_inv(fr, den, world)), world)
        z_coeffs = self._blind(dist_ntt(fr, z_evals, world, inverse=True),
                               [blind() for _ in range(3)])
        z_comm = self._commit(z_coeffs)
        tr.absorb_point(z_comm)
        alpha = row(tr.challenge())

        # --- round 3: quotient on the 4n coset ---------------------------
        ca, cb, cc_, cz = self._coset4(torch.stack([*wire_coeffs, z_coeffs]),
                                       nc)
        cpi = self._coset4(dist_ntt(fr, pi_evals, world, inverse=True)[None],
                           n)[0]
        cz_w = shift_rows(cz, -4, world)              # z(w x) on the coset
        ce, xs = self.coset, self.xs
        gate = poly_ops.sum_axis(fr, torch.stack([
            fp.mul(fr, ce["qm"], fp.mul(fr, ca, cb)),
            fp.mul(fr, ce["ql"], ca), fp.mul(fr, ce["qr"], cb),
            fp.mul(fr, ce["qo"], cc_), ce["qc"], cpi]), 0)
        k1x = fp.mul(fr, xs, row(vk.k1))
        k2x = fp.mul(fr, xs, row(vk.k2))
        perm_a = fp.mul(fr, fp.mul(fr, lin(ca, xs), lin(cb, k1x)),
                        fp.mul(fr, lin(cc_, k2x), cz))
        perm_b = fp.mul(fr, fp.mul(fr, lin(ca, ce["s1"]), lin(cb, ce["s2"])),
                        fp.mul(fr, lin(cc_, ce["s3"]), cz_w))
        perm = fp.mul(fr, fp.sub(fr, perm_a, perm_b), alpha)
        z_minus_1 = fp.sub(fr, cz, fp.ones(fr, (), dev))
        l1term = fp.mul(fr, fp.mul(fr, alpha, alpha),
                        fp.mul(fr, ce["l1"], z_minus_1))
        numerator = fp.add(fr, fp.add(fr, gate, perm), l1term)
        t_coeffs = fp.mul(fr, dist_ntt(fr, fp.mul(fr, numerator,
                                                  self.zh_inv),
                                       world, inverse=True), self.ginv)
        # degree <= 3n+5 with blinding: two n-chunks and an (n+6)-chunk
        t_chunks = [take_rows(t_coeffs, lo, hi, nc, world)
                    for lo, hi in ((0, n), (n, 2 * n), (2 * n, 3 * n + 6))]
        t_comms = [self._commit(t) for t in t_chunks]
        for cm in t_comms:
            tr.absorb_point(cm)
        zeta = tr.challenge()

        # --- round 4: evaluations at zeta --------------------------------
        zeta_omega = zeta * self.w % p
        stacked = torch.cat([torch.stack([*wire_coeffs, z_coeffs,
                                          *t_chunks]), self.coeffs])
        zp = dist_powers(fr, zeta, nc, world)
        zwp = dist_powers(fr, zeta_omega, nc, world)
        at_zeta = dist_eval_stack(fr, stacked, zp, world)       # (15, nw)
        z_omega = dist_eval_stack(fr, z_coeffs[None], zwp, world)[0]
        evals = dict(zip(OPEN_ORDER, at_zeta))
        evals["z_omega"] = z_omega
        for v in fp.to_ints(fr, torch.cat([at_zeta, z_omega[None]])):
            tr.absorb_fr(int(v))
        v_ch = row(tr.challenge())

        # --- round 5: batched openings -----------------------------------
        v_pows = poly_ops.powers(fr, v_ch, len(OPEN_ORDER))
        combined = poly_ops.sum_axis(fr, fp.mul(fr, stacked,
                                                v_pows[:, None]), 0)
        w_zeta = self._commit(dist_divide_linear(fr, combined, zeta, zp,
                                                 world))
        w_zeta_omega = self._commit(dist_divide_linear(
            fr, z_coeffs, zeta_omega, zwp, world))
        return Proof(wire_comms, z_comm, t_comms, evals, w_zeta,
                     w_zeta_omega)
