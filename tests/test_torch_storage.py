"""The port's storage (zprize_tpu_torch/pcs/storage.py) against the
reference package's file format, on the CPU: SRS and PLONK proving-key
round trips in the port, files written by the port loaded by the
reference and files written by the reference loaded by the port, a proof
from a reloaded key, and the refusal of a trapdoor-bearing SRS."""

import os
import random
import types

import numpy as np
import pytest
import torch

from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.field.spec import BLS12_377_FR
from zprize_tpu_torch.pairing.host import host_pairing
from zprize_tpu_torch.pairing.params import pairing_for_curve
from zprize_tpu_torch.pcs import kzg, storage
from zprize_tpu_torch.plonk import prover, verifier
from zprize_tpu_torch.plonk.circuit import CircuitBuilder
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

CURVE = BLS12_377_G1


def srs_from_ints(size, seed):
    """`setup_test_srs(CURVE, size, seed)` from python ints, on the CPU."""
    tau = random.Random(seed ^ 0x5EED).randrange(1, CURVE.order)
    g, q = oracle.generator(CURVE), CURVE.field.p
    pts = [oracle.ec_mul(g, pow(tau, i, CURVE.order), q) for i in range(size)]
    hp = host_pairing(pairing_for_curve(CURVE))
    aff = sw.Affine(fp.from_ints(CURVE.field, [p[0] for p in pts]),
                    fp.from_ints(CURVE.field, [p[1] for p in pts]),
                    torch.zeros(size, dtype=torch.bool))
    return kzg.Srs(CURVE, aff, hp.g2_gen, hp.g2_mul(hp.g2_gen, tau), tau)


def _same_srs(a: kzg.Srs, b: kzg.Srs):
    assert a.curve.name == b.curve.name
    assert (a.tau, a.h, a.tau_h) == (b.tau, b.h, b.tau_h)
    for x, y in zip(a.g1_powers, b.g1_powers):
        assert torch.equal(x, y)


def _reference_srs(srs: kzg.Srs):
    """The port's SRS as a reference `kzg.Srs` over numpy limb planes."""
    from zprize_tpu.curve import sw as ref_sw
    from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
    from zprize_tpu.pcs import kzg as ref_kzg
    x, y, inf = convert.points_to_reference(srs.curve, srs.g1_powers)
    return ref_kzg.Srs(REF_CURVE, ref_sw.Affine(x, y, inf), srs.h,
                       srs.tau_h, srs.tau)


@pytest.fixture(scope="module")
def plonk_key():
    """x^2 + 1 = out, out public (tests/test_api_storage.py:66), its SRS
    and the port's keygen."""
    cb = CircuitBuilder(BLS12_377_FR)
    x = cb.new_var()
    x2 = cb.mul(x, x)
    out = cb.add_const(x2, 1)
    cb.public_input(out)
    cc = cb.compile()
    srs = srs_from_ints(cc.n + 8, 7)
    pk, vk = prover.setup(CURVE, cc, srs)
    return srs, pk, vk, {x: 4, x2: 16, out: 17}


def test_srs_round_trip_and_trapdoor_refusal(tmp_path):
    srs = srs_from_ints(8, 5)
    path = os.path.join(tmp_path, "srs.npz")
    storage.save_srs(path, srs)
    with pytest.raises(ValueError, match="trapdoor"):
        storage.load_srs(path, device="cpu")
    _same_srs(storage.load_srs(path, allow_trapdoor=True, device="cpu"), srs)
    public = kzg.Srs(srs.curve, srs.g1_powers, srs.h, srs.tau_h)
    storage.save_srs(path, public)
    _same_srs(storage.load_srs(path, device="cpu"), public)


def test_srs_cross_loads_with_reference(tmp_path):
    """A file of the port loads in the reference and one of the reference
    in the port; the reference refuses the trapdoor too."""
    from zprize_tpu.pcs import storage as ref_storage
    srs = srs_from_ints(8, 5)
    ours = os.path.join(tmp_path, "ours.npz")
    storage.save_srs(ours, srs)
    with pytest.raises(ValueError, match="trapdoor"):
        ref_storage.load_srs(ours)
    ref = ref_storage.load_srs(ours, allow_trapdoor=True)
    assert (ref.tau, ref.h, ref.tau_h) == (srs.tau, srs.h, srs.tau_h)
    f = CURVE.field
    for ours_c, ref_c in ((srs.g1_powers.x, ref.g1_powers.x),
                          (srs.g1_powers.y, ref.g1_powers.y)):
        assert [int(v) for v in fp.to_ints(f, ours_c)] == \
            [int(v) for v in convert._ints(np.asarray(ref_c))]
    assert not np.asarray(ref.g1_powers.inf).any()
    theirs = os.path.join(tmp_path, "theirs.npz")
    ref_storage.save_srs(theirs, _reference_srs(srs))
    _same_srs(storage.load_srs(theirs, allow_trapdoor=True, device="cpu"),
              srs)


def _same_key(a, b):
    assert (a.circuit.n, a.circuit.k1, a.circuit.k2, a.coset_g) == (
        b.circuit.n, b.circuit.k1, b.circuit.k2, b.coset_g)
    assert list(a.circuit.public_rows) == list(b.circuit.public_rows)
    assert np.array_equal(np.asarray(a.circuit.wires),
                          np.asarray(b.circuit.wires))
    for name in ("sigma_coeffs", "sigma_evals", "id_evals"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert sorted(a.selectors) == sorted(b.selectors)
    for name in a.selectors:
        assert torch.equal(a.selectors[name], b.selectors[name]), name
    for name in a.coset_evals:
        assert torch.equal(a.coset_evals[name], b.coset_evals[name]), name
    assert {k: kzg.point_ints(a.curve, c) for k, c in a.commitments.items()} \
        == {k: kzg.point_ints(b.curve, c) for k, c in b.commitments.items()}


def test_pk_round_trip_proves(tmp_path, plonk_key):
    """Keygen once, save, load, prove from the reloaded key: the proof
    verifies under the original verifying key."""
    srs, pk, vk, assignment = plonk_key
    path = os.path.join(tmp_path, "pk.npz")
    storage.save_pk(path, pk)
    pk2 = storage.load_pk(path, srs)
    _same_key(pk2, pk)
    proof = prover.prove(pk2, assignment, [17],
                         blinding_rng=random.Random(9))
    assert verifier.verify(vk, srs, proof, [17])


def test_pk_cross_loads_with_reference(tmp_path, plonk_key):
    """The reference loads the port's key file, writes it again, and the
    port loads the reference's file back to the same key."""
    from zprize_tpu.pcs import storage as ref_storage
    srs, pk, _, _ = plonk_key
    ours = os.path.join(tmp_path, "ours.npz")
    storage.save_pk(ours, pk)
    ref_pk = ref_storage.load_pk(ours, _reference_srs(srs))
    assert (ref_pk.circuit.n, ref_pk.circuit.k1, ref_pk.coset_g) == (
        pk.circuit.n, pk.circuit.k1, pk.coset_g)
    assert {k: convert.point_ints(ref_pk.curve, c)
            for k, c in ref_pk.commitments.items()} == {
        k: kzg.point_ints(CURVE, c) for k, c in pk.commitments.items()}
    theirs = os.path.join(tmp_path, "theirs.npz")
    ref_storage.save_pk(theirs, ref_pk)
    _same_key(storage.load_pk(theirs, srs), pk)


def test_load_pk_refuses_another_curve(tmp_path, plonk_key):
    from zprize_tpu_torch.curve.spec import BLS12_381_G1
    srs, pk, _, _ = plonk_key
    path = os.path.join(tmp_path, "pk.npz")
    storage.save_pk(path, pk)
    other = types.SimpleNamespace(curve=BLS12_381_G1, device=srs.device)
    with pytest.raises(ValueError, match="SRS for"):
        storage.load_pk(path, other)
