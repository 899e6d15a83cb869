"""The port's PoSW (zprize_tpu_torch/posw) against the reference package,
on the CPU: the R1CS Poseidon digest against the port's sponge and the
reference's permutation, the witness against the reference's (pinned in
tests/fixtures/torch_marlin_reference.json, re-derived by
tests/test_torch_marlin.py's slow test), the difficulty hash of the
pinned Marlin proofs, the terminator, and (slow, as the reference's) a
mined and verified block at the PoSW circuit's size."""

import hashlib
import json
import pathlib
import threading
import types

import pytest
import torch

from zprize_tpu_torch.field import fp
from zprize_tpu_torch.field.spec import BLS12_377_FR as FR
from zprize_tpu_torch.hash import poseidon
from zprize_tpu_torch.marlin import ahp
from zprize_tpu_torch.posw import posw
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

PIN = json.loads((pathlib.Path(__file__).parent / "fixtures" /
                  "torch_marlin_reference.json").read_text())


@pytest.fixture(scope="module")
def circuit():
    return posw.build_circuit()


def test_r1cs_digest_equals_sponges_and_reference(circuit):
    from zprize_tpu.field import fp as ref_fp
    from zprize_tpu.field.spec import BLS12_377_FR as REF_FR
    from zprize_tpu.hash import poseidon as ref_poseidon
    from zprize_tpu.hash.grain import snarkvm_config as ref_config
    header, nonce = 1234, 7
    z = posw._witness(circuit, header, nonce)
    host = poseidon.Sponge(circuit.cfg, host=True)
    host.absorb([header, nonce])
    planes = poseidon.Sponge(circuit.cfg, device="cpu")
    planes.absorb([fp.from_ints(FR, [header])[0],
                   fp.from_ints(FR, [nonce])[0]])
    ref = ref_poseidon.permute(ref_config(REF_FR, 2),
                               ref_fp.from_ints(REF_FR, [0, header, nonce]))
    assert z[1] == host.squeeze(1)[0] == int(
        fp.to_ints(FR, planes.squeeze(1)[0])[()]) == int(
            ref_fp.to_ints(REF_FR, ref[1])[()])


def test_witness_equals_reference(circuit):
    w = PIN["posw_witness"]
    z = posw._witness(circuit, w["header"], w["nonce"])
    assert circuit.r1cs.is_satisfied(z)
    assert (len(z), hex(z[1]), hashlib.sha256(
        ",".join(map(str, z)).encode()).hexdigest()) == (
            w["length"], w["digest"], w["sha256"])


def test_difficulty_equals_reference(circuit):
    keys = types.SimpleNamespace(cfg=circuit.cfg)

    def pair(v):
        return None if v is None else (int(v[0], 16), int(v[1], 16))

    proofs = {name: ahp.MarlinProof(
        {k: pair(v) for k, v in d["comms"].items()},
        {k: int(v, 16) for k, v in d["sigmas"].items()},
        {k: int(v, 16) for k, v in d["evals"].items()},
        pair(d["open_beta"]), pair(d["open_delta"]))
        for name, d in PIN["proofs"].items()}
    names = sorted(proofs)
    got = posw.proof_difficulty_batch(keys, [proofs[n] for n in names])
    assert {n: hex(v) for n, v in zip(names, got)} == PIN["difficulty"]
    assert posw.proof_difficulty(keys, proofs["x3"]) == int(
        PIN["difficulty"]["x3"], 16)


def test_circuit_sizes(circuit):
    """The PoSW circuit's n and k, as bench.py's posw run reports them."""
    assert posw.sizes(circuit) == (512, 1024)


class _CircuitOnlyKeys:
    """mine() reaches the prover only after the terminator check."""

    def __init__(self, circ):
        self.circuit = circ
        self.pk = None


@pytest.mark.parametrize("miner", ["mine", "mine_batch"])
def test_terminator_cancels_immediately(circuit, miner):
    ev = threading.Event()
    ev.set()
    assert getattr(posw, miner)(_CircuitOnlyKeys(circuit), header=1,
                                target=FR.p, terminator=ev) is None


@pytest.mark.slow
def test_mine_and_verify_work():
    keys = posw.setup(device="cpu")
    srs = keys.pk.srs
    sol = posw.mine_batch(keys, header=42, target=FR.p, max_nonces=2,
                          batch=2)
    assert sol is not None and sol["nonce"] == 0
    assert posw.verify_work(keys, srs, sol, FR.p)
    d = posw.proof_difficulty(keys, sol["proof"])
    assert not posw.verify_work(keys, srs, sol, d)
