"""The port's sharded forms (zprize_tpu_torch/parallel, entry.py) on a
world of gloo ranks on the CPU, against the reference package and
python-int oracles.

One 4-rank world, spawned once for the module, runs every rank-side
check (`torch_ranks.world_checks`): the collectives, the sharded
Goldilocks four-step (its output is compared here with the reference's
`ntt_fourstep_sharded` on the 8-device CPU mesh), `dist_ntt` and the
dist_* helpers against python ints, and two subgroups at once: the
sharded PLONK proof of the cubic circuit on ranks 0 and 1 (the circuit's
n = 8 splits only in two), and `msm_sharded` on both curves against the
oracle on ranks 2 and 3.  The proof must equal the pinned reference
proof of tests/test_torch_plonk.py and verify.  The key is built once,
here, while the ranks start, and ranks 0 and 1 read their rows from a
file.  The world runs once for the whole test run: under xdist the
first worker to need it spawns it and stores its results for the others
(`_once`).  `dryrun_multichip` spawns its own 2-rank world.  Every
comparison is exact."""

import fcntl
import json
import os
import random
import threading
import types

import numpy as np
import pytest
import torch

import torch_ranks
from test_torch_plonk import (CURVE, PIN_COMMS, PIN_EVALS, PUBLIC,
                              _srs_from_ints, build_cubic_circuit)
from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.field.spec import GOLDILOCKS
from zprize_tpu_torch.entry import dryrun_multichip, entry
from zprize_tpu_torch.ntt.fourstep import twiddle_matrix
from zprize_tpu_torch.parallel import mesh, plonk_sharded
from zprize_tpu_torch.parallel.ntt_sharded import column_twiddles
from zprize_tpu_torch.plonk import prover, verifier
from torch_memory import release_memory  # noqa: F401

FR = CURVE.scalar
WORLD = 4
LOG_N1 = LOG_N2 = 5
TIMEOUT_S = 150.0


def _once(request, tmp_path_factory, name, compute):
    """compute() (plain python values) once for the whole run: under xdist
    the first worker to ask computes and stores it as JSON beside the
    workers' temporary directories, and the others wait for it and read
    it."""
    if getattr(request.config, "workerinput", None) is None:
        return json.loads(json.dumps(compute()))
    path = tmp_path_factory.getbasetemp().parent / f"{name}.json"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_text(json.dumps(compute()))
        return json.loads(path.read_text())


def _gl_values():
    rng = np.random.default_rng(2024)
    return [int(v) for v in rng.integers(
        0, GOLDILOCKS.p, 1 << (LOG_N1 + LOG_N2), dtype=np.uint64)]


def _world_results(tmp_dir):
    """The 4-rank world's results, and the verifying-key commitments
    (affine ints) of the cubic circuit's key, built here while the ranks
    start and written to a file for ranks 0 and 1."""
    key_path = tmp_dir / "key.pt"
    out = {}

    def spawn():
        try:
            out["ranks"] = mesh.spawn_world(
                torch_ranks.world_checks, WORLD, device="cpu",
                args=((_gl_values(), LOG_N1, LOG_N2), str(key_path)),
                timeout_s=TIMEOUT_S)
        except BaseException as exc:      # raised below, in this thread
            out["error"] = exc

    ranks = threading.Thread(target=spawn)
    ranks.start()
    try:
        cb, assignment = build_cubic_circuit()
        cc = cb.compile()
        pk, vk = prover.setup(CURVE, cc, _srs_from_ints())
        torch.save({"shards": [plonk_sharded.key_shard(pk, 2, r)
                               for r in range(2)],
                    "wires": fp.from_ints(FR, cc.wire_values(
                        assignment).tolist()),
                    "public": PUBLIC}, tmp_dir / "key.tmp")
        os.replace(tmp_dir / "key.tmp", key_path)
    finally:
        ranks.join()
    if "error" in out:
        raise out["error"]
    return {"ranks": out["ranks"], "vk": {
        k: sw.to_affine_ints(CURVE, c) for k, c in vk.commitments.items()}}


@pytest.fixture(scope="module")
def world(request, tmp_path_factory):
    tmp_dir = tmp_path_factory.mktemp("world")
    return _once(request, tmp_path_factory, "torch_parallel_world",
                 lambda: _world_results(tmp_dir))


@pytest.fixture(scope="module")
def ranks(world):
    """The 4-rank world's results, rank by rank."""
    return world["ranks"]


def _cases(ranks, name):
    return [(r, case, ok) for r, res in enumerate(ranks)
            for case, ok in res[name].items()]


def test_key_shard_needs_rows_that_split():
    pk = types.SimpleNamespace(circuit=types.SimpleNamespace(n=8),
                               srs=types.SimpleNamespace(size=16))
    with pytest.raises(ValueError, match="do not split"):
        plonk_sharded.key_shard(pk, 3, 0)


def test_ranks_import_neither_jax_nor_the_reference(ranks):
    assert [res["modules"] for res in ranks] == [[]] * WORLD


@pytest.mark.parametrize("axes", ["0,1", "1,0"])
def test_all_to_all_tiled_matches_numpy(ranks, axes):
    assert [res["all_to_all"][axes] for res in ranks] == [True] * WORLD


def test_shift_take_and_gather_rows(ranks):
    bad = [(r, case) for r, case, ok in _cases(ranks, "rows") if not ok]
    assert not bad


def test_column_twiddles_match_twiddle_matrix():
    full = twiddle_matrix(FR, 3, 4, True, "cpu")
    got = column_twiddles(FR, 3, 4, 4, 8, True, "cpu")
    assert torch.equal(got, full[:, 4:12])


def test_sharded_fourstep_matches_reference(ranks):
    gl_values = _gl_values()
    from zprize_tpu.field import fp as ref_fp
    from zprize_tpu.field.spec import GOLDILOCKS as REF_GL
    from zprize_tpu.parallel.mesh import make_mesh
    from zprize_tpu.parallel.ntt_sharded import flatten_output, \
        ntt_fourstep_sharded
    m = ref_fp.from_ints(REF_GL, gl_values).reshape(1 << LOG_N1,
                                                     1 << LOG_N2, -1)
    c = ntt_fourstep_sharded(REF_GL, m, make_mesh(8), LOG_N1, LOG_N2)
    want = [int(v) % REF_GL.p for v in convert._ints(
        np.asarray(flatten_output(c)))]
    assert [res["fourstep"] for res in ranks] == [want] * WORLD


@pytest.mark.parametrize("case", ["6 forward", "6 inverse", "9 forward",
                                  "9 inverse"])
def test_dist_ntt_matches_dft(ranks, case):
    assert [res["dist_ntt"][case] for res in ranks] == [True] * WORLD


@pytest.mark.parametrize("helper", ["powers", "cumprod_exclusive",
                                    "batch_inv", "eval_stack", "suffix_sum",
                                    "divide_linear"])
def test_dist_helpers_match_closed_forms(ranks, helper):
    assert [res["dist"][helper] for res in ranks] == [True] * WORLD


@pytest.mark.parametrize("curve", ["bls12_377_g1", "bls12_381_g1"])
def test_msm_sharded_matches_oracle(ranks, curve):
    assert [ranks[r][f"msm {curve}"] for r in (2, 3)] == [True, True]


def test_sharded_proof_equals_pinned_reference(ranks):
    assert ranks[0]["proof"] == ranks[1]["proof"]
    got = ranks[0]["proof"]
    assert got["comms"] == [list(p) for p in PIN_COMMS]
    assert got["evals"] == PIN_EVALS


def test_unseeded_blinding_is_drawn_once_for_every_rank(ranks):
    drawn = ranks[0]["drawn"]
    assert ranks[1]["drawn"] == drawn
    assert len(set(drawn)) == plonk_sharded.BLINDING_DRAWS
    assert all(0 <= v < FR.p for v in drawn)


def _point(xy):
    return sw.Point(*(fp.from_ints(CURVE.field, [v])[0] for v in (*xy, 1)))


def _proof(ints):
    comms = [_point(xy) for xy in ints["comms"]]
    evals = {k: fp.from_ints(FR, [v])[0] for k, v in ints["evals"].items()}
    return prover.Proof(comms[:3], comms[3], comms[4:7], evals, comms[7],
                        comms[8])


def test_sharded_proof_verifies(world):
    """Under the key's verifying key, rebuilt from its commitments, and the
    test SRS's G2 side."""
    cb, _ = build_cubic_circuit()
    cc = cb.compile()
    vk = prover.VerifyingKey(CURVE, cc.n, cc.k1, cc.k2, list(cc.public_rows),
                             {k: _point(xy) for k, xy in world["vk"].items()})
    assert verifier.verify(vk, _srs_from_ints(), _proof(world["ranks"][0][
        "proof"]), PUBLIC)


def test_entry_gives_the_fixed_shape_msm():
    """entry()'s inputs (chip_smoke.py phase 12 checks its MSM against the
    oracle on the card)."""
    fn, args = entry(device="cpu")
    assert callable(fn)
    assert [tuple(a.shape) for a in args] == [(256, 12), (256, 12), (256,),
                                              (256, 17)]


def test_dryrun_multichip_on_cpu():
    results = dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in results] == [0, 1]
    assert results[0]["msm_n"] == 128 and results[0]["ntt_ranks"] == 2


def test_backend_rule():
    cpu = torch.device("cpu")
    assert mesh.choose_backend(4, cpu, None) == "gloo"
    with pytest.raises(ValueError):
        mesh.choose_backend(2, cpu, "nccl")


def test_a_failing_rank_makes_the_call_raise():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        mesh.spawn_world(torch_ranks.fail_on_rank_one, 2, device="cpu",
                         timeout_s=60.0)


@pytest.mark.slow
def test_reference_sharded_outputs_match_pins_and_oracle():
    """Re-derive what the fast tier takes from pins and oracles with the
    reference package: its ShardedProver over a 2-device mesh proves the
    cubic circuit to the pinned proof, and its msm_sharded over the
    dryrun's inputs equals the oracle."""
    import jax.numpy as jnp
    from zprize_tpu.curve import sw as ref_sw
    from zprize_tpu.curve.spec import BLS12_377_G1 as REF_CURVE
    from zprize_tpu.field import fp as ref_fp
    from zprize_tpu.field.spec import BLS12_377_FR as REF_FR
    from zprize_tpu.parallel.mesh import make_mesh
    from zprize_tpu.parallel.msm_sharded import msm_sharded
    from zprize_tpu.parallel.plonk_sharded import ShardedProver
    from zprize_tpu.pcs import kzg as ref_kzg
    from zprize_tpu.plonk import prover as ref_prover
    from zprize_tpu.plonk.circuit import CircuitBuilder as RefBuilder
    from zprize_tpu_torch.utils import oracle
    cb, assignment = build_cubic_circuit(RefBuilder, REF_FR)
    cc = cb.compile()
    ref_srs = ref_kzg.setup_test_srs(REF_CURVE, cc.n + 8, seed=3)
    pk, _ = ref_prover.setup(REF_CURVE, cc, ref_srs)
    wires = ref_fp.from_ints(REF_FR, cc.wire_values(assignment).tolist())
    proof = ShardedProver(pk, make_mesh(2)).prove(
        wires, PUBLIC, blinding_rng=random.Random(1))
    got = convert.proof_ints(REF_CURVE, proof)
    assert got["comms"] == [tuple(p) for p in PIN_COMMS]
    assert got["evals"] == PIN_EVALS

    rng = random.Random(3)
    n = 128
    ks = [rng.randrange(1, CURVE.order) for _ in range(n)]
    scalars = [rng.randrange(CURVE.order) for _ in range(n)]
    pts = [oracle.ec_mul(oracle.generator(CURVE), k, CURVE.field.p)
           for k in ks]
    aff = ref_sw.Affine(ref_fp.from_ints(REF_CURVE.field,
                                         [q[0] for q in pts]),
                        ref_fp.from_ints(REF_CURVE.field,
                                         [q[1] for q in pts]),
                        jnp.zeros((n,), bool))
    res = msm_sharded(REF_CURVE, aff, ref_fp.from_ints(REF_FR, scalars),
                      make_mesh(2), c=6)
    want = oracle.ec_mul(oracle.generator(CURVE),
                         sum(k * s for k, s in zip(ks, scalars))
                         % CURVE.order, CURVE.field.p)
    assert convert.point_ints(REF_CURVE, res) == want
