"""Persistence of proving artifacts: the SRS and the PLONK proving key.

The role of the reference's disk-backed `SliceStorage` (keygen once, prove
from disk: `winderica/distributed/src/storage.rs:10-50`).  Files have the
reference package's format, so a file written by either package loads in
the other: compressed npz of canonical base-2^15 limb planes (uint32,
through `convert.py`'s `*_to_reference` and `*_from_reference`), big ints
as fixed-width u64 words, loaded with ``allow_pickle=False``.

A test SRS carries its own trapdoor tau, which forges any opening:
`load_srs` refuses such a file unless the caller passes
``allow_trapdoor=True``.  Loading puts the arrays on the card unless the
caller asks for the CPU (`device`, or the SRS's device for a key).
"""

from __future__ import annotations

import numpy as np

from .. import convert
from ..curve.spec import ALL_CURVES
from ..ntt.domain import Domain
from ..utils.device import resolve_device
from . import kzg

_U64_WORDS = 8      # fits any <= 512-bit field element or scalar


def _int_to_u64(v: int, words: int = _U64_WORDS) -> np.ndarray:
    if not 0 <= v < 1 << (64 * words):
        raise ValueError("int too large for the u64 word encoding")
    return np.frombuffer(v.to_bytes(8 * words, "little"), np.uint64).copy()


def _u64_to_int(a) -> int:
    return int.from_bytes(np.asarray(a, np.uint64).tobytes(), "little")


def _g2_to_u64(q) -> np.ndarray:
    """Affine twist point ((x0, x1), (y0, y1)) -> (4, words) u64."""
    (x0, x1), (y0, y1) = q
    return np.stack([_int_to_u64(v) for v in (x0, x1, y0, y1)])


def _g2_from_u64(a):
    x0, x1, y0, y1 = (_u64_to_int(row) for row in a)
    return ((x0, x1), (y0, y1))


def _curve(name: str):
    for c in ALL_CURVES:
        if c.name == name:
            return c
    raise ValueError(f"no curve named {name}")


def save_srs(path: str, srs: kzg.Srs) -> None:
    extra = {}
    if srs.h is not None:
        extra["h"] = _g2_to_u64(srs.h)
        extra["tau_h"] = _g2_to_u64(srs.tau_h)
    if srs.tau is not None:
        extra["tau"] = _int_to_u64(srs.tau)
    x, y, inf = convert.points_to_reference(srs.curve, srs.g1_powers)
    np.savez_compressed(path, curve=srs.curve.name, g1_x=x, g1_y=y,
                        g1_inf=inf, **extra)


def load_srs(path: str, allow_trapdoor: bool = False,
             device=None) -> kzg.Srs:
    data = np.load(path, allow_pickle=False)
    curve = _curve(str(data["curve"]))
    tau = None
    if "tau" in data:
        if not allow_trapdoor:
            raise ValueError(
                f"{path} is a trapdoor-bearing test SRS (it holds tau, its "
                "own forgery key); pass allow_trapdoor=True only in test "
                "code")
        tau = _u64_to_int(data["tau"])
    aff = convert.points_from_reference(curve, data["g1_x"], data["g1_y"],
                                        data["g1_inf"],
                                        resolve_device(device))
    h = _g2_from_u64(data["h"]) if "h" in data else None
    tau_h = _g2_from_u64(data["tau_h"]) if "tau_h" in data else None
    return kzg.Srs(curve, aff, h, tau_h, tau)


class StoredCircuit:
    """What the prover reads of a compiled circuit after keygen (the wire
    slot map and the metadata), as a reloaded key carries it."""

    def __init__(self, spec, n, k1, k2, public_rows, wires):
        self.spec = spec
        self.n = n
        self.k1, self.k2 = k1, k2
        self.public_rows = list(public_rows)
        self.wires = wires

    def wire_values(self, assignment: dict[int, int]) -> np.ndarray:
        p = self.spec.p
        out = np.zeros((3, self.n), dtype=object)
        for col in range(3):
            for j in range(self.n):
                out[col, j] = assignment.get(int(self.wires[col, j]), 0) % p
        return out


def save_pk(path: str, pk) -> None:
    """Write a PLONK `ProvingKey`: everything `prove` needs but the SRS,
    which `save_srs` stores and `load_pk` takes."""
    fr = pk.curve.scalar
    sel_names = sorted(pk.selectors)
    com_names = sorted(pk.commitments)
    arrays = {
        "curve": pk.curve.name,
        "n": np.int64(pk.circuit.n),
        "coset_g": _int_to_u64(pk.coset_g),
        "k1": _int_to_u64(pk.circuit.k1),
        "k2": _int_to_u64(pk.circuit.k2),
        "public_rows": np.asarray(pk.circuit.public_rows, np.int64),
        "wires": np.asarray(pk.circuit.wires, np.int64),
        "sel_names": np.array(sel_names),
        "com_names": np.array(com_names),
        "sigma_coeffs": convert.elements_to_reference(fr, pk.sigma_coeffs),
        "sigma_evals": convert.elements_to_reference(fr, pk.sigma_evals),
        "id_evals": convert.elements_to_reference(fr, pk.id_evals),
    }
    for name in sel_names:
        arrays[f"sel_{name}"] = convert.elements_to_reference(
            fr, pk.selectors[name])
    for name in com_names:
        arrays[f"com_{name}"] = convert.point_to_reference(
            pk.curve, pk.commitments[name])
    np.savez_compressed(path, **arrays)


def load_pk(path: str, srs: kzg.Srs):
    """A `ProvingKey` on the SRS's device from a file of `save_pk` (or of
    the reference's): no keygen again but the coset forms, one NTT."""
    from ..plonk import prover

    data = np.load(path, allow_pickle=False)
    curve = _curve(str(data["curve"]))
    if curve.name != srs.curve.name:
        raise ValueError(f"key for {curve.name}, SRS for {srs.curve.name}")
    fr = curve.scalar
    dev = srs.device
    n = int(data["n"])
    circuit = StoredCircuit(fr, n, _u64_to_int(data["k1"]),
                            _u64_to_int(data["k2"]),
                            [int(v) for v in data["public_rows"]],
                            np.asarray(data["wires"], np.int64))

    def planes(key):
        return convert.elements_from_reference(fr, data[key], dev)

    selectors = {str(nm): planes(f"sel_{nm}") for nm in data["sel_names"]}
    commitments = {str(nm): convert.point_from_reference(
        curve, data[f"com_{nm}"], dev) for nm in data["com_names"]}
    sigma_coeffs = planes("sigma_coeffs")
    log_n = n.bit_length() - 1
    dom4 = Domain(fr, log_n + 2, dev)
    coset_g = _u64_to_int(data["coset_g"])
    vk = prover.VerifyingKey(curve, n, circuit.k1, circuit.k2,
                             list(circuit.public_rows), dict(commitments))
    return prover.ProvingKey(
        curve, circuit, srs, Domain(fr, log_n, dev), dom4, coset_g,
        selectors, sigma_coeffs, planes("sigma_evals"), planes("id_evals"),
        prover.coset_forms(dom4, coset_g, selectors, sigma_coeffs),
        commitments, vk)

