"""The port's PLONK prover, verifier and transcript
(zprize_tpu_torch/plonk) against the reference package, on the CPU.

The reference prover takes minutes on this CPU, so its proof of the
cubic circuit of tests/test_plonk.py (x = 3, public output 35) on
`setup_test_srs(curve, 16, seed=3)` with `blinding_rng=random.Random(1)` is
pinned below as canonical ints: commitments as affine (x, y), evaluations
as ints, and the verifying key's commitments.  `test_pin_matches_reference`
(marked slow: `python -m pytest tests/test_torch_plonk.py -m slow`)
re-derives the pin from the reference package.  Every comparison is exact."""

import random

import jax.numpy as jnp
import pytest
import torch

from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.pairing.host import host_pairing
from zprize_tpu_torch.pairing.params import pairing_for_curve
from zprize_tpu_torch.pcs import kzg
from zprize_tpu_torch.plonk import prover, verifier
from zprize_tpu_torch.plonk.circuit import CircuitBuilder
from zprize_tpu_torch.plonk.transcript import Transcript
from zprize_tpu_torch.utils import oracle
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

CURVE = BLS12_377_G1
FR = CURVE.scalar
SEED = 3
SRS_SIZE = 16
PUBLIC = [35]

PIN_COMMS = [
    (0x15eb8a81b952ecb181d5a0ef46abf5c47261b2c4458aa53a41b9f049992647d6cbbb8decfa0d5f85bd582db3876c93f,
     0x4ff1c4351f17985f3bf526ffb742a2741acfb7273cb8e920d8b204761192e724b71458f800c74c62431ab2494a3a38),
    (0x7fec78de7a860ebf6df23dbbe96db27041cbdf20441a4e9441bf315adac7bbcb3d992b478174bbff3c8347be09be86,
     0x5ce49bb18a0305f9b19e6b3f67b8b293e89d59407b83dd19ceccd5ff0b919a440c87b08aa9e30531fa39490365b39f),
    (0x109f5aa00134268bbcefa1d82430b6bb09efd1bfc7f8d9262ba2c4cdbad3fdc22b6b8e67f337a0c79e00dceb21701f6,
     0x12fbd2b9509c98df8f30b925f201637769c1ea3c7971414c7572d3aa092ce17c60ab5c38bcbeb2916f174d0705aa915),
    (0xf172559dbf643b713a798760346c85a40ed292b8adcd416550ace428997bd7d0d45a941fff4e0b9c518be0b8651f66,
     0x1340d3ac9cf8c7fc267583d8a347c2a6f67f41f80b33c925d8b359975de8d9567e4caa5c981dcda243b486862c65344),
    (0xcde928a8cc8a636ec6477656d611d7f2fb2671c65feca6c53ccc93341ac7a8138252eac80b448a5ac3172e9d6cdc5e,
     0x16b0b890ab2f713575bf5e3e86f82f3f5ee7fcf9855b53504f7818f18f704377af184e9123e62ef103724524c4dcc8),
    (0x158eaa43fe86165227d515bc90f9bc3aa42948247af6027afa71a30509cf8e2af4e01c385f217de4465f64eec6be588,
     0x131994d82a5215e072cbbe495d78b7d7eedd47bbc6f738c8c5307a0765d5b2f484cc6f4dcacd9b7424481efee6aa12b),
    (0x1748c882e702832cb4da21731a77b18486ff15882d6294ff8748357477708c9b79e6c58c5f49cf01a8a6f264b6958e6,
     0x17e4c252e0e7051f6cbac4e5d1eaf0614d96dfcd4c0353520dec498acc5340b5a7b512f36c25a8db369299046c4163f),
    (0x69197c3301990a9aaefa3adf1f54b2c07afb987c56b1901f32e8e452d20acba64786b14e822c1ff9737f75b0807cb3,
     0x32dfa7ad271cf5922bf9f8f2db38ea059e87546a59fa293e264619364dc37f31d40bf0976226419852a8f229352abf),
    (0x1080abc6a9bd5762b636d7676cf055d5252d1c6020fa6c163168fc189f010dba830ccc0834f0dd38e47ff5e632eb848,
     0x17c5c91ed8faafc33c2704dd46f78840ba4e397cd4379dfec1fd61823bfa66cfdd76f152cfcee4891daf511097cf19c),
]
PIN_EVALS = {
    "a": 0x11b7df4d2a2e83056222fe622d8b49f4c677402932e1900bde7c366fbd98f51b,
    "b": 0x42ade60204a3832a5035d1399ed323c68a772d3e2b142612695433f923e9ece,
    "c": 0x14f98209dced19826a486553067538e0818fb46ce2563636ed26ad8f9b060e6,
    "z": 0x4a517adeb4448450e4b97a56e2c6c4e376534f3c39e4e4a45f2d06df244364f,
    "t_lo": 0xa5afee1b756613905d27fb763a54af4f720f86763cff8bff8713924a9b17a4,
    "t_mid": 0x125c1af20e93264303fd9bda4dcdda89142b70a0a322386c5426fe249a8d7e17,
    "t_hi": 0x942176e3824f5c4052318c5d2f64aeb97c7c20eef8ff8028a4ea0fdc837aed8,
    "ql": 0x7c7ae527c847951b487841065465c6a99aa8baf5f4cc5564be17c072a54bb8d,
    "qr": 0x6bee2348611fe806cdb910952db5809459480723000caa8fcc77d8b04fc85da,
    "qo": 0xae80e39d6ab04f8860f0c34086a24be8411f42ed6ebc8070f211ad7628182bf,
    "qm": 0x7ac2742646fda2bdc4b7863aa0bf23bfd8750ba6bb49fcd0df6812a0b7cb2bc,
    "qc": 0x4104f227158312498dfafaf6aeea4f68fc4662e72da0395c51f0041c11a575e,
    "s1": 0x102dc1a11a3089f4d5675b12565f8d31895f9ee82b894a29cdfacb5e586b42a,
    "s2": 0x979a527aa2346f2f0ba9c4502376459fa754bf001848efe2623c167277d3307,
    "s3": 0xd0fd1cd8738d2d57b11ad75dc11a3032c79ca36868ac004184cadf70209ce84,
    "z_omega": 0x2f52a03248a34a7269f1a40ede373cceb03981a67206c3183a8f799c67e3ebe,
}
PIN_VK = {
    "ql": (0x98092ac533fb153287638f415d7f0041215f789d59fec57f229e80cdc9d8036783ceb2606989eff5f0f7b8fcd7dcc9,
     0x13c8aaafd452bd47b4283a7f37df8f99be44857e364674b07b864c5afa27959b751685f13b1daa5e8d2d03fab35d091),
    "qr": (0x708f3f2def0eda73b5fb8226b45159f2fdbc0725765813c096e1ce1d28588eb3e9418f65e0efe61bf259beefb0fdd4,
     0xaa8e97339f3a8d71b66ea8bfb0cb7bc2b38eb4ad45e4992483bb35c91ee50aa628ea2fad76a8735342760287fce7cc),
    "qo": (0x110d6b06c3e5e014e2fc0c1edfa5f1c49fd9cd2dd742278568dc1b729cfc97d12b1fda0cf2219e79faed0b6ff765c92,
     0x140fb7af85d1d8f3c437375dfe8dcae14fec46472fa04627bc0c33ac77ba737ad49bd2c347d719bd02e9a5723ee7e4a),
    "qm": (0xcd8c962b7d2ca37645417faafc35fa4e746c773885a50a7c91f5e6638e0672e5f1c41e655f9b0cce6c3f8eff6e924b,
     0x14100c5bf0c1c3f16635fbd8a5eaafe596a2be989a70e62f01b5651478d0ca8da968ceff2143a252d896b4a9004748),
    "qc": (0x16423a513acd72aba50de8e2302b417afa56412d81dd0de57a25f4806b9d76df9be654b90d85a35d0d477a4c2afb077,
     0x1a6ce12aef88c9589c9183ecb39b024abdf06e5ebe18991a1b188e71732470a335bc15e7cd628ee050605e9230add34),
    "s1": (0xd0b8b8de6771725f6f78583aa9eb4089878332d955b6684b82ede512cce601346ff0694515f40a23d94908e3f62fb2,
     0x18aab189673c319ff9a2a8dba11c832abec4539425b9a270be3ad1b32e6ad76fae624a1bfdedc03be2ffee7e94ca7be),
    "s2": (0xbd4742bf7e1b064f282f45d4ba862c0e07a22f901b15f08a69866e9df305ffd2efcad0d29966d4e186825a39f22ac5,
     0xf171d0382053fe05fdd3c95fef99897ef531be886f2402c3b69e9d9f6e9f96990abc195b5f8f12d5a2b2bc23e47499),
    "s3": (0x19094c0cb541b72c62a07f40f474a32f4bf7af944e9f351b9ed41502edfda9e0ac57af2575b4ecc744340b2d2811735,
     0x53851927f8fb0f8f6b1576da998fb85a1e07f74459d9e019d7f8b88eeee9041d72ece6e0d2fe09ec9fd2c9e1e137b5),
}


def build_cubic_circuit(builder=CircuitBuilder, spec=FR):
    """x^3 + x + 5 == out with out public (tests/test_plonk.py:21), with
    either package's circuit builder."""
    cb = builder(spec)
    x = cb.new_var()
    x2 = cb.mul(x, x)
    x3 = cb.mul(x2, x)
    s = cb.add(x3, x)
    out = cb.add_const(s, 5)
    cb.public_input(out)
    return cb, {x: 3, x2: 9, x3: 27, s: 30, out: 35}


def _srs_from_ints():
    """The test SRS of `setup_test_srs(CURVE, 16, seed=3)` from python ints
    (tau^i·G by the oracle's double-and-add), on the CPU."""
    tau = random.Random(SEED ^ 0x5EED).randrange(1, CURVE.order)
    g, q = oracle.generator(CURVE), CURVE.field.p
    pts = [oracle.ec_mul(g, pow(tau, i, CURVE.order), q)
           for i in range(SRS_SIZE)]
    hp = host_pairing(pairing_for_curve(CURVE))
    aff = sw.Affine(fp.from_ints(CURVE.field, [p[0] for p in pts]),
                    fp.from_ints(CURVE.field, [p[1] for p in pts]),
                    torch.zeros(SRS_SIZE, dtype=torch.bool))
    return kzg.Srs(CURVE, aff, hp.g2_gen, hp.g2_mul(hp.g2_gen, tau), tau)


@pytest.fixture(scope="module")
def proved():
    """Keygen and one proof with blinding_rng=random.Random(1)."""
    cb, assignment = build_cubic_circuit()
    cc = cb.compile()
    cc.check_assignment(assignment, PUBLIC)
    srs = _srs_from_ints()
    pk, vk = prover.setup(CURVE, cc, srs)
    proof = prover.prove(pk, assignment, PUBLIC,
                         blinding_rng=random.Random(1))
    return srs, pk, vk, assignment, proof


def _pinned(points):
    return [None if p is None else tuple(p) for p in points]


def test_verifying_key_equals_pinned_reference(proved):
    _, _, vk, _, _ = proved
    got = {k: kzg.point_ints(CURVE, c) for k, c in vk.commitments.items()}
    assert got == dict(zip(PIN_VK, _pinned(PIN_VK.values())))


def test_proof_commitments_equal_pinned_reference(proved):
    got = convert.proof_ints(CURVE, proved[4])
    assert got["comms"] == _pinned(PIN_COMMS)


def test_proof_evaluations_equal_pinned_reference(proved):
    got = convert.proof_ints(CURVE, proved[4])
    assert got["evals"] == PIN_EVALS


def test_proof_verifies(proved):
    srs, _, vk, _, proof = proved
    assert verifier.verify(vk, srs, proof, PUBLIC)


def test_reject_wrong_public_input(proved):
    srs, _, vk, _, proof = proved
    assert not verifier.verify(vk, srs, proof, [36])


def test_reject_tampered_eval(proved):
    srs, _, vk, _, proof = proved
    bad = dict(proof.evals)
    bad["a"] = fp.add(FR, bad["a"], fp.ones(FR))
    tampered = prover.Proof(proof.wire_comms, proof.z_comm, proof.t_comms,
                            bad, proof.w_zeta, proof.w_zeta_omega)
    assert not verifier.verify(vk, srs, tampered, PUBLIC)


def test_reject_point_off_the_curve(proved):
    srs, _, vk, _, proof = proved
    x, y = kzg.point_ints(CURVE, proof.w_zeta)
    off = sw.Point(*(fp.from_ints(CURVE.field, [v])[0] for v in (x, y + 1, 1)))
    bad = prover.Proof(proof.wire_comms, proof.z_comm, proof.t_comms,
                       proof.evals, off, proof.w_zeta_omega)
    assert not verifier._points_valid(vk, [kzg.point_ints(CURVE, off)])
    assert not verifier.verify(vk, srs, bad, PUBLIC)


def test_reject_unsatisfied_witness(proved):
    srs, pk, vk, assignment, _ = proved
    bad = dict(assignment)
    bad[max(bad)] = 99                     # break the last wire
    proof = prover.prove(pk, bad, PUBLIC, blinding_rng=random.Random(2))
    assert not verifier.verify(vk, srs, proof, PUBLIC)


def test_transcript_matches_reference():
    """Challenges after the same absorbs: label, two scalars, a point, an
    identity point, a squeeze run and more scalars."""
    from zprize_tpu.curve import sw as ref_sw
    from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
    from zprize_tpu.field import fp as ref_fp
    from zprize_tpu.plonk.transcript import Transcript as RefTranscript
    ref_fq, ref_fr = REF_CURVE.field, REF_CURVE.scalar
    pt = oracle.ec_mul(oracle.generator(CURVE), 123456789, CURVE.field.p)
    ref = RefTranscript(REF_CURVE)
    ours = Transcript(CURVE)
    got, expect = [], []
    for v in (5, FR.p - 1):
        ref.absorb_fr(ref_fp.constant(ref_fr, v))
        ours.absorb_fr(v)
    ref.absorb_point(ref_sw.Point(ref_fp.constant(ref_fq, pt[0]),
                                  ref_fp.constant(ref_fq, pt[1]),
                                  ref_fp.ones(ref_fq)))
    ours.absorb_point(sw.Point(*(fp.from_ints(CURVE.field, [v])[0]
                                 for v in (*pt, 1))))
    for _ in range(3):
        expect.append(ref.challenge())
        got.append(ours.challenge())
    ref.absorb_point_ints(None)
    ours.absorb_point_ints(None)
    ref.absorb_fr(jnp.asarray(ref_fp.from_ints_np(ref_fr, [7])[0]))
    ours.absorb_fr(fp.from_ints(FR, [7])[0])
    expect.append(ref.challenge())
    got.append(ours.challenge())
    assert got == [int(ref_fp.to_ints(ref_fr, c)[()]) for c in expect]


def test_fr_from_reference():
    from zprize_tpu.field import fp as ref_fp
    from zprize_tpu.field.spec import BLS12_377_FR as REF_FR
    vals = [[0, 1, FR.p - 1], [2, 3, 4]]
    got = convert.fr_from_reference(CURVE, ref_fp.from_ints_np(REF_FR, vals),
                                    device="cpu")
    assert got.shape == (2, 3, 8)
    assert [[int(v) for v in row] for row in fp.to_ints(FR, got)] == vals


@pytest.mark.slow
def test_pin_matches_reference():
    """Re-derive the pin from the reference package: its test SRS (also
    carried across with `srs_from_reference`), keygen and proof."""
    from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
    from zprize_tpu.field.spec import BLS12_377_FR as REF_FR
    from zprize_tpu.pcs import kzg as ref_kzg
    from zprize_tpu.plonk import prover as ref_prover
    from zprize_tpu.plonk.circuit import CircuitBuilder as RefBuilder
    cb, assignment = build_cubic_circuit(RefBuilder, REF_FR)
    cc = cb.compile()
    ref_srs = ref_kzg.setup_test_srs(REF_CURVE, cc.n + 8, seed=SEED)
    srs = convert.srs_from_reference(ref_srs, device="cpu")
    ours = _srs_from_ints()
    assert (srs.tau, srs.h, srs.tau_h) == (ours.tau, ours.h, ours.tau_h)
    for a, b in zip(srs.g1_powers, ours.g1_powers):
        assert torch.equal(a, b)
    pk, vk = ref_prover.setup(REF_CURVE, cc, ref_srs)
    proof = ref_prover.prove(pk, assignment, PUBLIC,
                             blinding_rng=random.Random(1))
    got = convert.proof_ints(REF_CURVE, proof)
    assert got["comms"] == _pinned(PIN_COMMS)
    assert got["evals"] == PIN_EVALS
    assert {k: convert.point_ints(REF_CURVE, c)
            for k, c in vk.commitments.items()} == dict(
                zip(PIN_VK, _pinned(PIN_VK.values())))
