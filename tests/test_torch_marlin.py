"""The port's Marlin (zprize_tpu_torch/marlin) and its native linear
combination against the reference package, on the CPU.

The reference's Marlin run of the cubic circuit of tests/test_marlin.py
takes minutes here, so its outputs are pinned in
tests/fixtures/torch_marlin_reference.json: on `setup_test_srs(curve, 32,
seed=7)`, the index commitments, the single proofs of x = 3, x = 4 and of
an unsatisfied witness, the zk proof of x = 3 with zk_rng=Random(11), the
challenges of one batched derivation, the verdicts of a mixed
`verify_group`, the PoSW difficulty hashes of those proofs and a PoSW
witness.  `test_pin_matches_reference` (marked slow: `python -m pytest
tests/test_torch_marlin.py -m slow`) re-derives the file from the
reference package, and proves on the reference's SRS and key carried
across.  Every comparison is exact.

The port proves here on its plain versions: two prover runs (a batch of
two plain instances, one zk proof), each in a module fixture of its own;
the verifier's tests take the pinned proofs."""

import contextlib
import copy
import json
import pathlib
import random
import types

import pytest
import torch

from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.marlin import ahp, indexer
from zprize_tpu_torch.marlin.r1cs import R1CSBuilder
from zprize_tpu_torch.pairing.host import host_pairing
from zprize_tpu_torch.pairing.params import pairing_for_curve
from zprize_tpu_torch.pcs import kzg
from zprize_tpu_torch.utils import build, oracle
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

CURVE = BLS12_377_G1
FR = CURVE.scalar
PIN_PATH = pathlib.Path(__file__).parent / "fixtures" / \
    "torch_marlin_reference.json"
PIN = json.loads(PIN_PATH.read_text())
SRS_SEED = 7
ZK_SEED = 11
GROUP_SEED = 9
PROVER_THREADS = 2


def build_cubic(builder=R1CSBuilder, spec=FR):
    """x^3 + x + 5 = out, out public (tests/test_marlin.py:21), with
    either package's builder."""
    rb = builder(spec, num_public=1)
    x = rb.new_witness()
    x2 = rb.mul(x, x)
    x3 = rb.mul(x2, x)
    s = rb.add(x3, x)
    out = rb.add_const(s, 5)
    rb.enforce_equal(out, rb.public(0))
    return rb.build()


def build_verify_circuit(builder=R1CSBuilder, spec=FR, n_constraints=100):
    """bench.py's verify circuit: c = a·b public, filler constraints."""
    rb = builder(spec, num_public=1)
    a_v = rb.new_witness()
    b_v = rb.new_witness()
    c_v = rb.mul(a_v, b_v)
    for _ in range(n_constraints - 2):
        rb.mul(a_v, b_v)
    rb.enforce_equal(c_v, rb.public(0))
    return rb.build()


def witness_for(x_val):
    p = FR.p
    x = x_val % p
    x2 = x * x % p
    x3 = x2 * x % p
    s = (x3 + x) % p
    out = (s + 5) % p
    return [1, out, x, x2, x3, s, out]


def unsatisfied():
    z = witness_for(3)
    z[3] = (z[3] + 1) % FR.p             # x2 inconsistent with x*x
    return z


def srs_from_ints(size=PIN["sizes"]["srs"], seed=SRS_SEED):
    """`setup_test_srs(CURVE, size, seed)` from python ints, on the CPU."""
    tau = random.Random(seed ^ 0x5EED).randrange(1, CURVE.order)
    g, q = oracle.generator(CURVE), CURVE.field.p
    pts = [oracle.ec_mul(g, pow(tau, i, CURVE.order), q) for i in range(size)]
    hp = host_pairing(pairing_for_curve(CURVE))
    aff = sw.Affine(fp.from_ints(CURVE.field, [p[0] for p in pts]),
                    fp.from_ints(CURVE.field, [p[1] for p in pts]),
                    torch.zeros(size, dtype=torch.bool))
    return kzg.Srs(CURVE, aff, hp.g2_gen, hp.g2_mul(hp.g2_gen, tau), tau)


def _pair(v):
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def pinned_proof(name) -> ahp.MarlinProof:
    d = PIN["proofs"][name]
    return ahp.MarlinProof({k: _pair(v) for k, v in d["comms"].items()},
                           {k: int(v, 16) for k, v in d["sigmas"].items()},
                           {k: int(v, 16) for k, v in d["evals"].items()},
                           _pair(d["open_beta"]), _pair(d["open_delta"]))


def pinned_vk() -> indexer.IndexVerifierKey:
    s = PIN["sizes"]
    return indexer.IndexVerifierKey(
        CURVE, s["num_public"], s["log_n"], s["log_k"], s["log_x"],
        {k: _pair(v) for k, v in PIN["vk"].items()})


def proof_json(pf: ahp.MarlinProof) -> dict:
    """A proof of either package in the pin's form."""
    def h(v):
        return None if v is None else [hex(v[0]), hex(v[1])]
    return {"comms": {k: h(v) for k, v in pf.comms.items()},
            "sigmas": {k: hex(v) for k, v in pf.sigmas.items()},
            "evals": {k: hex(v) for k, v in pf.evals.items()},
            "open_beta": h(pf.open_beta), "open_delta": h(pf.open_delta)}


def tampered_group(proofs: dict):
    """The mixed group of the pin's verdicts: good proofs, g_1's y negated
    (`main.rs:182`), a bumped evaluation, a broken opening witness, a
    bumped sigma, both degree-bound commitments replaced, a wrong public
    input, an unsatisfied witness and a zk proof."""
    q = CURVE.field.p
    pub3, pub4 = witness_for(3)[:2], witness_for(4)[:2]
    p3 = proofs["x3"]

    def tamper(fn):
        bad = copy.deepcopy(p3)
        fn(bad)
        return bad

    def neg_g1(b):
        b.comms["g_1"] = (b.comms["g_1"][0], (-b.comms["g_1"][1]) % q)

    def bump_eval(b):
        b.evals["h_1"] = (b.evals["h_1"] + 1) % FR.p

    def neg_open(b):
        b.open_beta = (b.open_beta[0], (-b.open_beta[1]) % q)

    def bump_sigma(b):
        b.sigmas["a"] = (b.sigmas["a"] + 1) % FR.p

    def shift_1(b):
        b.comms["g_1_shift"] = b.comms["g_1"]

    def shift_a(b):
        b.comms["a_g_shift"] = b.comms["a_g"]

    wrong_pub = [1, (pub3[1] + 1) % FR.p]
    return [(pub3, p3), (pub3, tamper(neg_g1)), (pub4, proofs["x4"]),
            (pub3, tamper(bump_eval)), (pub3, tamper(neg_open)),
            (pub3, tamper(bump_sigma)), (pub3, tamper(shift_1)),
            (pub3, tamper(shift_a)), (wrong_pub, p3),
            (pub3, proofs["unsat"]), (pub3, proofs["zk_x3"])]


def challenge_json(ch: dict) -> dict:
    return {"alpha": hex(ch["alpha"]),
            "etas": {m: hex(v) for m, v in ch["etas"].items()},
            "beta": hex(ch["beta"]), "delta": hex(ch["delta"]),
            "u_beta": hex(ch["u_beta"]), "u_delta": hex(ch["u_delta"])}


@pytest.fixture(scope="module")
def key():
    """The test SRS from ints and the port's index of the cubic circuit."""
    srs = srs_from_ints()
    return srs, indexer.index(CURVE, build_cubic(), srs, device="cpu")


@contextlib.contextmanager
def prover_threads():
    """Two intra-op threads for a prover run: its MSMs' bucket work runs
    on thousands of lanes, where a second thread nearly halves the time
    (the other tests of the suite keep one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(PROVER_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def batch(key):
    """One prove_batch of x = 3 and x = 4."""
    _, pk = key
    with prover_threads():
        return ahp.prove_batch(pk, [witness_for(3), witness_for(4)],
                               device="cpu")


@pytest.fixture(scope="module")
def zk_proof(key):
    _, pk = key
    with prover_threads():
        return ahp.prove(pk, witness_for(3), zk_rng=random.Random(ZK_SEED),
                         device="cpu")


@pytest.mark.parametrize("circuit", ["cubic", "verify", "posw"])
def test_r1cs_equals_reference(circuit):
    from zprize_tpu.field.spec import BLS12_377_FR as REF_FR
    from zprize_tpu.marlin.r1cs import R1CSBuilder as RefBuilder
    if circuit == "posw":
        from zprize_tpu.posw import posw as ref_posw
        from zprize_tpu_torch.posw import posw
        ours, ref = posw.build_circuit().r1cs, ref_posw.build_circuit().r1cs
    else:
        build_fn = build_cubic if circuit == "cubic" else build_verify_circuit
        ours, ref = build_fn(), build_fn(RefBuilder, REF_FR)
    fields = ("num_public", "num_vars", "a", "b", "c", "num_constraints")
    assert ([getattr(ours, f) for f in fields]
            == [getattr(ref, f) for f in fields])


def test_index_commitments_equal_reference(key):
    _, pk = key
    assert pk.vk.commitments == pinned_vk().commitments
    s = PIN["sizes"]
    assert (pk.log_n, pk.log_k, pk.log_x) == (s["log_n"], s["log_k"],
                                              s["log_x"])


def test_batch_lanes_equal_reference_single_proofs(batch):
    """Lane b of the batch is the reference's single proof of instance b
    (whose own lanes equal its single proofs, tests/test_marlin.py)."""
    assert [proof_json(pf) for pf in batch] == [PIN["proofs"]["x3"],
                                                PIN["proofs"]["x4"]]


def test_zk_proof_equals_reference_and_verifies(key, zk_proof):
    srs, pk = key
    assert proof_json(zk_proof) == PIN["proofs"]["zk_x3"]
    assert ahp.verify(pk.vk, srs, witness_for(3)[:2], zk_proof)


def test_batch_challenges_equal_reference():
    """The B-lane derivation gives the reference's challenges lane by
    lane, and the same tuples as the sequential derivation."""
    srs = srs_from_ints()
    vk = pinned_vk()
    insts = [(witness_for(3)[:2], pinned_proof("x3")),
             (witness_for(4)[:2], pinned_proof("x4")),
             (witness_for(3)[:2], pinned_proof("unsat"))]
    got = ahp._derive_challenges_batch(vk, insts)
    assert [challenge_json(c) for c in got] == PIN["challenges"]
    grouped = ahp._group_checks(vk, srs, insts)
    assert grouped == [ahp._verify_checks(vk, srs, pub, pf)
                       for pub, pf in insts]
    assert grouped[0] is not None and grouped[2] is None


def test_verify_group_verdicts_equal_reference():
    """Every tamper verdict of the reference, in one mixed group (the
    bisected pairing isolates the broken opening), and batch_verify."""
    srs = srs_from_ints()
    vk = pinned_vk()
    proofs = {name: pinned_proof(name) for name in PIN["proofs"]}
    group = tampered_group(proofs)
    assert ahp.verify_group(vk, srs, group, rng=random.Random(GROUP_SEED)
                            ) == PIN["verdicts"]
    good = [group[0], group[2], group[-1]]
    assert ahp.batch_verify(vk, srs, good, rng=random.Random(5))
    assert not ahp.batch_verify(vk, srs, good + [group[4]],
                                rng=random.Random(6))


def test_index_from_reference(key):
    """A key in the reference's form (its dataclasses, numpy limb planes,
    projective commitments) comes back as the port's key."""
    from zprize_tpu.marlin import indexer as ref_indexer
    srs, pk = key
    ref_pk = _reference_form(pk, ref_indexer)
    got = convert.index_from_reference(ref_pk, device="cpu")
    assert got.vk.commitments == pk.vk.commitments
    assert (got.log_n, got.log_k, got.log_x, got.commit_len) == (
        pk.log_n, pk.log_k, pk.log_x, pk.commit_len)
    assert (got.slot_of_var == pk.slot_of_var).all()
    assert got.r1cs.a == pk.r1cs.a and got.r1cs.num_vars == pk.r1cs.num_vars
    for name, m in pk.matrices.items():
        g = got.matrices[name]
        for f in ("rows_idx", "cols_idx", "row_e", "col_e", "val", "val_raw",
                  "row_coeffs", "col_coeffs", "val_coeffs"):
            assert torch.equal(getattr(g, f), getattr(m, f)), (name, f)
    for a, b in zip(got.srs.g1_powers, srs.g1_powers):
        assert torch.equal(a, b)


def _reference_form(pk, ref_indexer):
    """The port's key as the reference's dataclasses hold it."""
    from zprize_tpu.curve import sw as ref_sw
    from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
    fr = pk.curve.scalar
    mats = {}
    for name, m in pk.matrices.items():
        planes = {f: convert.elements_to_reference(fr, getattr(m, f))
                  for f in ("row_e", "col_e", "val", "val_raw", "row_coeffs",
                            "col_coeffs", "val_coeffs")}
        mats[name] = ref_indexer.IndexedMatrix(
            m.rows_idx.numpy().astype("int32"),
            m.cols_idx.numpy().astype("int32"), **planes,
            max_row_count=1, max_col_count=1)
    comms = {}
    for name, xy in pk.vk.commitments.items():
        planes = convert.limbs_of_ints([xy[0], xy[1], 1],
                                       REF_CURVE.field.n_limbs)
        comms[name] = ref_sw.Point(*planes)
    x, y, inf = convert.points_to_reference(pk.curve, pk.srs.g1_powers)
    ref_srs = types.SimpleNamespace(
        curve=REF_CURVE, g1_powers=types.SimpleNamespace(x=x, y=y, inf=inf),
        h=pk.srs.h, tau_h=pk.srs.tau_h, tau=pk.srs.tau)
    vk = ref_indexer.IndexVerifierKey(REF_CURVE, pk.vk.num_public,
                                      pk.log_n, pk.log_k, pk.log_x, comms)
    return ref_indexer.IndexProverKey(
        REF_CURVE, pk.r1cs, pk.log_n, pk.log_k, pk.log_x, pk.slot_of_var,
        mats, ref_srs, vk, pk.commit_len)


@pytest.mark.parametrize("curve", [BLS12_377_G1, BLS12_381_G1],
                         ids=lambda c: c.name)
def test_native_combine_equals_python_fold(curve):
    rng = random.Random(21)
    g, q = oracle.generator(curve), curve.field.p
    pts = [oracle.ec_mul(g, rng.randrange(1, curve.order), q)
           for _ in range(6)]
    ks = [rng.randrange(curve.order) for _ in pts]
    pts[2] = None                              # the identity
    ks[4] = 0                                  # a zero scalar
    pts.append(pts[0])                         # P twice: a doubling
    ks.append(ks[0])
    pts.append((pts[1][0], (-pts[1][1]) % q))  # -P beside P
    ks.append(ks[1])
    assert kzg.combine_ints(curve, pts, ks) == \
        kzg.combine_ints_plain(curve, pts, ks)
    assert kzg.combine_ints(curve, [], []) is None
    assert kzg.combine_ints(curve, pts[:1], [0]) is None
    assert kzg.combine_ints(curve, pts[:2], [1, 1]) == \
        kzg.combine_ints_plain(curve, pts[:2], [1, 1])


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler"])
def test_native_combine_build_failure_raises(monkeypatch, tmp_path,
                                             compiler):
    """A host compiler that fails or is missing raises from combine_ints;
    nothing falls back to the python fold."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "CXX", compiler)
    g = oracle.generator(CURVE)
    with pytest.raises(RuntimeError):
        kzg.combine_ints(CURVE, [g], [3])


@pytest.mark.slow
def test_pin_matches_reference():
    """Re-derive the pin from the reference package (minutes), and prove
    with the port on the reference's SRS and key carried across."""
    import hashlib

    from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
    from zprize_tpu.field.spec import BLS12_377_FR as REF_FR
    from zprize_tpu.marlin import ahp as ref_ahp
    from zprize_tpu.marlin import indexer as ref_indexer
    from zprize_tpu.marlin.r1cs import R1CSBuilder as RefBuilder
    from zprize_tpu.pcs import kzg as ref_kzg
    from zprize_tpu.posw import posw as ref_posw
    r1 = build_cubic(RefBuilder, REF_FR)
    ref_srs = ref_kzg.setup_test_srs(REF_CURVE, PIN["sizes"]["srs"],
                                     seed=SRS_SEED)
    ref_pk = ref_indexer.index(REF_CURVE, r1, ref_srs)
    assert {k: list(map(hex, v)) for k, v in
            ref_ahp._vk_comm_ints(ref_pk.vk).items()} == PIN["vk"]
    proofs = {"x3": ref_ahp.prove(ref_pk, witness_for(3)),
              "x4": ref_ahp.prove(ref_pk, witness_for(4)),
              "unsat": ref_ahp.prove(ref_pk, unsatisfied()),
              "zk_x3": ref_ahp.prove(ref_pk, witness_for(3),
                                     zk_rng=random.Random(ZK_SEED))}
    assert {k: proof_json(v) for k, v in proofs.items()} == PIN["proofs"]
    insts = [(witness_for(3)[:2], proofs["x3"]),
             (witness_for(4)[:2], proofs["x4"]),
             (witness_for(3)[:2], proofs["unsat"])]
    assert [challenge_json(c) for c in ref_ahp._derive_challenges_batch(
        ref_pk.vk, insts)] == PIN["challenges"]
    assert ref_ahp.verify_group(ref_pk.vk, ref_srs, tampered_group(proofs),
                                rng=random.Random(GROUP_SEED)) == \
        PIN["verdicts"]
    circ = ref_posw.build_circuit()
    keys = types.SimpleNamespace(cfg=circ.cfg)
    assert {n: hex(ref_posw.proof_difficulty_batch(keys, [pf])[0])
            for n, pf in proofs.items()} == PIN["difficulty"]
    w = PIN["posw_witness"]
    z = ref_posw._witness(circ, w["header"], w["nonce"])
    assert (len(z), hex(z[1]), hashlib.sha256(
        ",".join(map(str, z)).encode()).hexdigest()) == (
            w["length"], w["digest"], w["sha256"])
    # the port on the reference's SRS and key, carried across
    srs = convert.srs_from_reference(ref_srs, device="cpu")
    ours = srs_from_ints()
    for a, b in zip(srs.g1_powers, ours.g1_powers):
        assert torch.equal(a, b)
    pk = convert.index_from_reference(ref_pk, device="cpu")
    assert pk.vk.commitments == pinned_vk().commitments
    got = ahp.prove_batch(pk, [witness_for(3), unsatisfied()], device="cpu")
    assert [proof_json(pf) for pf in got] == [PIN["proofs"]["x3"],
                                              PIN["proofs"]["unsat"]]
