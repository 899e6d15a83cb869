"""The port's Poseidon and Merkle trees (zprize_tpu_torch/hash) against the
snarkVM snapshot fixtures (tests/fixtures/poseidon_fr377_rate2.json) and
the reference package's `hash`, on the CPU.  Exact: canonical ints."""

import json
import os
import random

import jax.numpy as jnp
import pytest
import torch

from zprize_tpu.field import fp as ref_fp
from zprize_tpu.field.spec import BLS12_377_FR as REF_FR
from zprize_tpu.hash import merkle as ref_merkle
from zprize_tpu.hash import poseidon as ref_poseidon
from zprize_tpu.hash.grain import snarkvm_config as ref_config
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.field.spec import BLS12_377_FR as FR
from zprize_tpu_torch.hash import merkle, poseidon
from zprize_tpu_torch.hash.grain import snarkvm_config
from torch_memory import release_memory  # noqa: F401

torch.set_num_threads(1)

FIX = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures",
                                  "poseidon_fr377_rate2.json")))
CFG = snarkvm_config(FR, 2)
SNAPSHOTS = [(0, 1), (1, 1), (2, 2), (3, 5), (5, 3), (9, 9), (4, 0), (0, 9)]


def _ints(a):
    return [int(v) for v in fp.to_ints(FR, a).reshape(-1)]


def test_grain_copy_matches_snapshots_and_reference():
    assert [str(v) for row in CFG.ark for v in row] == FIX["ark_rate2"]
    assert [str(v) for row in CFG.mds for v in row] == FIX["mds_rate2"]
    ref = ref_config(REF_FR, 2)
    assert (CFG.ark, CFG.mds, CFG.alpha) == (ref.ark, ref.mds, ref.alpha)


@pytest.mark.parametrize("absorb_n,squeeze_n", SNAPSHOTS)
def test_host_sponge_matches_snapshots(absorb_n, squeeze_n):
    sponge = poseidon.Sponge(CFG, host=True)
    sponge.absorb([1237812] * absorb_n)
    got = [str(v) for v in sponge.squeeze(squeeze_n)]
    assert got == FIX["sponge_rate2"][f"{absorb_n},{squeeze_n}"]


@pytest.mark.parametrize("absorb_n,squeeze_n", [(1, 1), (3, 5), (5, 3)])
def test_sponge_matches_snapshots(absorb_n, squeeze_n):
    """The plain-engine sponge, two lanes at once (both the snapshot)."""
    sponge = poseidon.Sponge(CFG, (2,), device="cpu")
    sponge.absorb([fp.from_ints(FR, [1237812, 1237812])] * absorb_n)
    got = [_ints(o) for o in sponge.squeeze(squeeze_n)]
    expect = FIX["sponge_rate2"][f"{absorb_n},{squeeze_n}"]
    assert [str(v[0]) for v in got] == expect
    assert [str(v[1]) for v in got] == expect


def test_permute_matches_reference_at_batch_4():
    rng = random.Random(11)
    states = [[rng.randrange(FR.p) for _ in range(CFG.t)] for _ in range(4)]
    states[0] = [0, 1, FR.p - 1]
    ref = ref_poseidon.permute(ref_config(REF_FR, 2), jnp.asarray(
        ref_fp.from_ints_np(REF_FR, states)))
    expect = [int(v) for v in ref_fp.to_ints(REF_FR, ref).reshape(-1)]
    assert _ints(poseidon.permute(CFG, fp.from_ints(FR, states))) == expect
    assert [v for s in states for v in poseidon.permute_ints(CFG, s)] == expect


def test_hash_many_and_merkle_verify():
    out = poseidon.hash_many(CFG, [fp.from_ints(FR, [1237812])] * 2, 2)
    assert [str(_ints(o)[0]) for o in out] == FIX["sponge_rate2"]["2,2"]
    leaves = fp.from_ints(FR, list(range(1, 5)))
    levels = merkle.build_tree(CFG, leaves)
    root = merkle.root(levels)
    path = merkle.prove(levels, 2)
    assert merkle.verify(CFG, FR, root, leaves[2], 2, path)
    assert not merkle.verify(CFG, FR, root, leaves[3], 2, path)
    with pytest.raises(ValueError, match="power of two"):
        merkle.build_tree(CFG, leaves[:3])


def test_merkle_root_of_8_leaves_matches_reference():
    rng = random.Random(12)
    leaves = [rng.randrange(FR.p) for _ in range(8)]
    ref_levels = ref_merkle.build_tree(
        ref_config(REF_FR, 2), jnp.asarray(ref_fp.from_ints_np(REF_FR, leaves)))
    levels = merkle.build_tree(CFG, fp.from_ints(FR, leaves))
    assert len(levels) == len(ref_levels) == 4
    for ours, theirs in zip(levels, ref_levels):
        assert _ints(ours) == [int(v) for v in
                               ref_fp.to_ints(REF_FR, theirs).reshape(-1)]
    path = merkle.prove(levels, 5)
    ref_path = ref_merkle.prove(ref_levels, 5)
    assert [(_ints(s), r) for s, r in path] == [
        ([int(ref_fp.to_ints(REF_FR, s)[()])], r) for s, r in ref_path]
