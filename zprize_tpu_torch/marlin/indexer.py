"""Marlin AHP indexer: the arithmetization of an R1CS's matrices.

The role of snarkVM's `algorithms/src/snark/marlin/ahp/indexer/`: for each
matrix M the indexer makes the three polynomials (row_M, col_M, val_M)
over the domain K of the non-zero entries, whose rational combination is
the low-degree extension

    M-hat(X, Y) = sum_k  v_H(X) v_H(Y) val'_k / ((X - row_k)(Y - col_k)),

with the Lagrange-derivative normalization val'_k = val_k * col_k / n
folded into the indexed val polynomial, so the prover and the verifier
only touch val'.

Variable -> H-slot map: public variable i sits at the point
omega^(i * n/|X|) of the subgroup X of H, and the witness variables fill
the remaining slots in order (the standard Marlin input-domain embedding).

The planes are (K, n_words) Montgomery words of Fr on the SRS's device;
the nine polynomials come out of one batched inverse Fr NTT and are
committed through `kzg.commit` (the collapsed twisted-Edwards MSM route);
the verifying key holds the commitments as host affine int pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..curve import sw
from ..curve.spec import CurveSpec
from ..field import fp
from ..ntt.domain import Domain, power_ints, primitive_root
from ..ntt.radix2 import intt
from ..pcs import kzg
from ..plonk.transcript import lane_points_ints
from ..poly import ops as poly_ops
from ..utils.device import resolve_device
from .r1cs import R1CS

M_NAMES = ("a", "b", "c")


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


@dataclasses.dataclass
class IndexedMatrix:
    rows_idx: torch.Tensor   # (K,) int64 H slot of each entry's row
    cols_idx: torch.Tensor   # (K,) int64 H slot of each entry's column
    row_e: torch.Tensor      # (K, nw) omega^row
    col_e: torch.Tensor      # (K, nw) omega^col
    val: torch.Tensor        # (K, nw) normalized val'
    val_raw: torch.Tensor    # (K, nw) the matrix coefficients (matvec form)
    row_coeffs: torch.Tensor  # intt_K of row_e
    col_coeffs: torch.Tensor
    val_coeffs: torch.Tensor
    # the row and col polynomials on a coset, by (size, generator): they
    # are the same for every proof (`ahp._index_coset`)
    coset: dict = dataclasses.field(default_factory=dict, repr=False)


@dataclasses.dataclass
class IndexVerifierKey:
    curve: CurveSpec
    num_public: int
    log_n: int
    log_k: int
    log_x: int
    commitments: dict        # "{m}_{row|col|val}" -> affine (x, y) ints


@dataclasses.dataclass
class IndexProverKey:
    curve: CurveSpec
    r1cs: R1CS
    log_n: int
    log_k: int
    log_x: int
    slot_of_var: np.ndarray  # (num_vars,) int64
    matrices: dict           # name -> IndexedMatrix
    srs: kzg.Srs
    vk: IndexVerifierKey
    commit_len: int

    @property
    def device(self) -> torch.device:
        return self.srs.device


def index(curve: CurveSpec, r1cs: R1CS, srs: kzg.Srs,
          device=None) -> IndexProverKey:
    """Index `r1cs` over `srs`, on `device` (the card unless the caller
    asks for the CPU), which must be the SRS's."""
    dev = resolve_device(device)
    if srs.device.type != dev.type:
        raise ValueError(f"SRS on {srs.device}, index asked on {dev}")
    dev = srs.device
    fr = curve.scalar
    p = fr.p
    n = _pow2(max(r1cs.num_constraints, r1cs.num_vars, 2))
    log_n = n.bit_length() - 1
    x_size = _pow2(r1cs.num_public)
    log_x = x_size.bit_length() - 1
    stride = n // x_size

    # public var i -> slot i*stride (the X subgroup); witnesses fill the rest
    slot_of_var = np.full(r1cs.num_vars, -1, dtype=np.int64)
    taken = np.zeros(n, dtype=bool)
    for i in range(r1cs.num_public):
        slot_of_var[i] = i * stride
        taken[i * stride] = True
    free = np.flatnonzero(~taken)
    nw = r1cs.num_vars - r1cs.num_public
    slot_of_var[r1cs.num_public:] = free[:nw]

    k_size = _pow2(max(len(r1cs.a), len(r1cs.b), len(r1cs.c), 2))
    log_k = k_size.bit_length() - 1
    n_inv = pow(n, -1, p)
    # one commitment length for every polynomial of the scheme: one MSM
    # shape (and one prepared SRS table) serves the whole protocol
    commit_len = max(2 * n, 3 * k_size)
    if srs.size < commit_len:
        raise ValueError(f"SRS of {srs.size} < {commit_len} powers")

    w_pows = power_ints(fr, n, primitive_root(fr, log_n))
    entries = {}
    for name, ents in zip(M_NAMES, (r1cs.a, r1cs.b, r1cs.c)):
        rows = [r for r, _, _ in ents]
        cols = [int(slot_of_var[c]) for _, c, _ in ents]
        # val' = val * col_elem / n  (Lagrange-derivative normalization)
        vals = [v * w_pows[c] % p * n_inv % p
                for (_, _, v), c in zip(ents, cols)]
        raw = [v % p for _, _, v in ents]
        pad = k_size - len(rows)
        entries[name] = (rows + [0] * pad, cols + [0] * pad,
                         vals + [0] * pad, raw + [0] * pad)

    # (3 matrices, row_e / col_e / val, K) -> one batched inverse NTT
    evals = fp.from_ints(fr, [[[w_pows[r] for r in e[0]],
                               [w_pows[c] for c in e[1]], e[2]]
                              for e in entries.values()], dev)
    coeffs = intt(Domain(fr, log_k, dev), evals)
    raw = fp.from_ints(fr, [e[3] for e in entries.values()], dev)
    matrices, polys = {}, {}
    for i, (name, e) in enumerate(entries.items()):
        matrices[name] = IndexedMatrix(
            torch.tensor(e[0], dtype=torch.int64, device=dev),
            torch.tensor(e[1], dtype=torch.int64, device=dev),
            evals[i, 0], evals[i, 1], evals[i, 2], raw[i],
            coeffs[i, 0], coeffs[i, 1], coeffs[i, 2])
        for j, part in enumerate(("row", "col", "val")):
            polys[f"{name}_{part}"] = coeffs[i, j]
    comms = [kzg.commit(srs, poly_ops.pad_to(fr, c, commit_len))
             for c in polys.values()]
    pts = lane_points_ints(curve, sw.Point(
        *(torch.stack(cs) for cs in zip(*comms))))
    vk = IndexVerifierKey(curve, r1cs.num_public, log_n, log_k, log_x,
                          dict(zip(polys, pts)))
    return IndexProverKey(curve, r1cs, log_n, log_k, log_x, slot_of_var,
                          matrices, srs, vk, commit_len)
