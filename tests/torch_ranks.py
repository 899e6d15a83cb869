"""Rank-side functions of tests/test_torch_parallel.py.

A rank is a process started by spawn, which imports the module of the
function it runs: these functions live here, apart from the test file,
so that a rank imports the port alone.  Each takes the rank's `World`
first and returns plain python values.
"""

import os
import random
import sys
import time

import numpy as np
import torch

from zprize_tpu_torch import convert
from zprize_tpu_torch.curve import sw
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
from zprize_tpu_torch.field import fp
from zprize_tpu_torch.field.spec import GOLDILOCKS
from zprize_tpu_torch.msm.pippenger import scalar_limbs
from zprize_tpu_torch.ntt.domain import primitive_root
from zprize_tpu_torch.parallel import mesh, plonk_sharded as ps
from zprize_tpu_torch.parallel.msm_sharded import msm_sharded
from zprize_tpu_torch.parallel.ntt_sharded import flatten_output, \
    ntt_fourstep_sharded
from zprize_tpu_torch.utils import oracle

FR = BLS12_377_G1.scalar
MSM_N = 256
MSM_C = 4
HELPER_LOG = 7            # the reference's test size for the dist_* helpers


# the packages a rank must not load (spelt apart: this file's source is
# scanned for the name)
FOREIGN = ("ja" "x", "ja" "xlib", "zprize_tpu")


def modules_loaded(world):
    """The modules of FOREIGN's packages in this rank's sys.modules."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _ints(spec, t):
    return [int(v) for v in fp.to_ints(spec, t).reshape(-1)]


def all_to_all_cases(world):
    """(split, concat) -> whether all_to_all_tiled of a rank's block of a
    (8D, 4D, 3) matrix equals the block numpy's transpose of the layout
    gives: (0, 1) turns a column block into a row block, (1, 0) back."""
    d, r = world.size, world.rank
    g = np.arange(8 * d * 4 * d * 3, dtype=np.int64).reshape(8 * d, 4 * d, 3)
    # the layouts of g and of its numpy transpose: rank r's column block
    # of g is its row block of g.T
    cols = g.transpose(1, 0, 2)[4 * r:4 * (r + 1)].transpose(1, 0, 2)
    rows = g[8 * r:8 * (r + 1)]
    got = {"0,1": mesh.all_to_all_tiled(torch.from_numpy(cols.copy()), 0, 1,
                                        world),
           "1,0": mesh.all_to_all_tiled(torch.from_numpy(rows), 1, 0, world)}
    want = {"0,1": rows, "1,0": cols}
    return {k: bool(np.array_equal(got[k].numpy(), want[k])) for k in got}


def row_moves(world):
    """shift_rows and take_rows against torch.roll and slicing of the
    whole array: {case: equal}."""
    d = world.size
    g = torch.arange(8 * d * 5, dtype=torch.int64).reshape(8 * d, 5)
    x = mesh.shard_rows(g, world)
    out = {}
    for k in (-4, -1, 1, 3):
        out[f"shift {k}"] = bool(torch.equal(
            mesh.shift_rows(x, k, world),
            mesh.shard_rows(torch.roll(g, k, 0), world)))
    for lo, hi, n_out in ((0, 8 * d, 8 * d + 4 * d), (3, 8 * d - 2, 4 * d),
                          (8, 8 * d, 12 * d), (1, 6, 4 * d)):
        want = torch.zeros((n_out, 5), dtype=torch.int64)
        k = min(hi, lo + n_out) - lo
        want[:k] = g[lo:lo + k]
        out[f"take {lo}:{hi} -> {n_out}"] = bool(torch.equal(
            mesh.take_rows(x, lo, hi, n_out, world),
            mesh.shard_rows(want, world)))
    out["gather"] = bool(torch.equal(mesh.all_gather_rows(x, world), g))
    return out


def fail_on_rank_one(world):
    """Rank 1 raises; rank 0 hangs until the parent ends it."""
    if world.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(3600)


def fourstep(world, values, log_n1, log_n2):
    """The sharded Goldilocks four-step of the natural-order ints
    `values`, flattened to natural order: a list of ints."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    cols = n2 // world.size
    m = fp.from_ints(GOLDILOCKS, values).reshape(n1, n2, -1)
    c = ntt_fourstep_sharded(GOLDILOCKS, m[:, world.rank * cols:
                                         (world.rank + 1) * cols],
                             world, log_n1, log_n2)
    return _ints(GOLDILOCKS, flatten_output(c, world))


def dist_ntt_cases(world, seed):
    """{(log_n, direction): dist_ntt == the python-int DFT} at 2^6 and 2^9,
    forward and inverse."""
    p = FR.p
    rng = random.Random(seed)
    out = {}
    for log_n in (6, 9):
        vals = [rng.randrange(p) for _ in range(1 << log_n)]
        x = mesh.shard_rows(fp.from_ints(FR, vals), world)
        w = primitive_root(FR, log_n)
        fwd = oracle.ntt_ints(vals, w, p)
        inv_n = pow(1 << log_n, -1, p)
        inv = [v * inv_n % p for v in oracle.ntt_ints(vals, pow(w, -1, p), p)]
        for name, want, inverse in (("forward", fwd, False),
                                    ("inverse", inv, True)):
            got = mesh.all_gather_rows(ps.dist_ntt(FR, x, world, inverse),
                                       world)
            out[f"{log_n} {name}"] = _ints(FR, got) == want
    return out


def dist_helper_cases(world, seed):
    """{helper: result == python-int closed form} at n = 2^HELPER_LOG."""
    p, n = FR.p, 1 << HELPER_LOG
    rng = random.Random(seed)
    z = rng.randrange(1, p)
    a = [rng.randrange(p) for _ in range(n)]
    b = [rng.randrange(1, p) for _ in range(n)]
    stack = [[rng.randrange(p) for _ in range(n)] for _ in range(3)]
    a_loc = mesh.shard_rows(fp.from_ints(FR, a), world)
    b_loc = mesh.shard_rows(fp.from_ints(FR, b), world)

    def whole(t):
        return _ints(FR, mesh.all_gather_rows(t, world))

    out = {}
    zp = ps.dist_powers(FR, z, n, world)
    out["powers"] = whole(zp) == [pow(z, i, p) for i in range(n)]
    prods, acc = [], 1
    for v in b:
        prods.append(acc)
        acc = acc * v % p
    out["cumprod_exclusive"] = whole(
        ps.dist_cumprod_exclusive(FR, b_loc, world)) == prods
    out["batch_inv"] = whole(ps.dist_batch_inv(FR, b_loc, world)) == [
        pow(v, -1, p) for v in b]
    s_loc = torch.stack([mesh.shard_rows(fp.from_ints(FR, c), world)
                         for c in stack])
    out["eval_stack"] = _ints(FR, ps.dist_eval_stack(FR, s_loc, zp, world)) \
        == [sum(c * pow(z, i, p) for i, c in enumerate(cs)) % p
            for cs in stack]
    out["suffix_sum"] = whole(ps.dist_suffix_sum(FR, a_loc, world)) == [
        sum(a[j + 1:]) % p for j in range(n)]
    q = [sum(a[k] * pow(z, k - 1 - j, p) for k in range(j + 1, n)) % p
         for j in range(n)]
    out["divide_linear"] = whole(ps.dist_divide_linear(FR, a_loc, z, zp,
                                                       world)) == q
    return out


def msm_case(world, curve_name, seed):
    """The sharded MSM over this world of the chain (i+1)·G, i < MSM_N,
    and seeded scalars == the python-int oracle."""
    curve = {c.name: c for c in (BLS12_377_G1, BLS12_381_G1)}[curve_name]
    rng = random.Random(seed)
    scalars = [rng.randrange(curve.order) for _ in range(MSM_N)]
    pts = oracle.generator_chain(curve, MSM_N)
    f = curve.field
    aff = sw.Affine(mesh.shard_rows(fp.from_ints(f, [q[0] for q in pts]),
                                    world),
                    mesh.shard_rows(fp.from_ints(f, [q[1] for q in pts]),
                                    world),
                    torch.zeros(MSM_N // world.size, dtype=torch.bool))
    s = mesh.shard_rows(scalar_limbs(curve, fp.from_ints(curve.scalar,
                                                         scalars)), world)
    got = msm_sharded(curve, aff, s, world, c=MSM_C)
    return sw.to_affine_ints(curve, got) == oracle.chain_msm(curve, scalars)


def sharded_proof(world, shards, wires, public, seed):
    """The sharded proof, as `convert.proof_ints`, of the wire planes
    (3, n, nw) under the KeyShard list `shards`, blinding_rng =
    random.Random(seed); and the blinding values the prover draws when
    given no rng."""
    prover = ps.ShardedProver(shards[world.rank], world)
    m = wires.shape[1] // world.size
    local = wires[:, world.rank * m:(world.rank + 1) * m]
    proof = prover.prove(local, public, blinding_rng=random.Random(seed))
    return {"proof": convert.proof_ints(BLS12_377_G1, proof),
            "drawn": prover._drawn_on_rank0()}


def _load_when_written(path, timeout_s=120.0):
    """torch.load of a file another process writes (by rename, whole)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written in {timeout_s} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def world_checks(world, fourstep_args, key_path):
    """Everything the fast tier asks of one 4-rank world: each rank's
    results under one key a check.  The sharded proof runs on the
    subgroup of ranks 0 and 1, with the KeyShards, wires and public
    inputs that the parent writes to `key_path` while the ranks start,
    and ranks 2 and 3 run the MSMs on theirs."""
    torch.set_num_threads(1)
    out = {"modules": modules_loaded(world),
           "all_to_all": all_to_all_cases(world),
           "rows": row_moves(world),
           "fourstep": fourstep(world, *fourstep_args),
           "dist_ntt": dist_ntt_cases(world, 5),
           "dist": dist_helper_cases(world, 6)}
    low, high = world.subgroup([0, 1]), world.subgroup([2, 3])
    if low is not None:
        key = _load_when_written(key_path)
        out.update(sharded_proof(low, key["shards"], key["wires"],
                                 key["public"], 1))
    else:
        for seed, curve in enumerate((BLS12_377_G1, BLS12_381_G1)):
            out[f"msm {curve.name}"] = msm_case(high, curve.name, seed)
    return out
