"""Entry points of the port: one fixed-shape MSM, and the multichip dryrun
of the sharded forms over a world of ranks (the counterpart of the
reference's `__graft_entry__.py`).

    from zprize_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")        # 4 gloo ranks on the CPU

Both run on the card unless the caller asks for the CPU.  On the card
the ranks take one card each over NCCL; more ranks than cards need
`backend="gloo"` (see `parallel/mesh.py`).
"""

from __future__ import annotations

import random
import sys
import time

import torch

from .curve import sw
from .curve.spec import BLS12_377_G1
from .field import fp
from .field.spec import GOLDILOCKS
from .msm.pippenger import msm_jit_static, scalar_limbs
from .ntt.fourstep import ntt_fourstep
from .parallel.mesh import World, shard_rows, spawn_world
from .parallel.msm_sharded import msm_sharded
from .parallel.ntt_sharded import flatten_output, ntt_fourstep_sharded
from .utils import oracle
from .utils.device import resolve_device


def entry(device=None):
    """(fn, args): one windowed-Pippenger MSM over BLS12-377 G1 (the
    prize1a hot path) at a small fixed size, n = 256 and c = 6, on the
    generator tiled n times with scalars from random.Random(7), on
    `device`.  fn(px, py, pinf, scalars) returns the projective (x, y, z)
    planes."""
    dev = resolve_device(device)
    curve = BLS12_377_G1
    n, c = 256, 6
    rng = random.Random(7)
    px = fp.from_ints(curve.field, [curve.gen_x] * n, dev)
    py = fp.from_ints(curve.field, [curve.gen_y] * n, dev)
    pinf = torch.zeros(n, dtype=torch.bool, device=dev)
    scalars = scalar_limbs(curve, fp.from_ints(
        curve.scalar, [rng.randrange(curve.order) for _ in range(n)], dev))

    def fn(px, py, pinf, scalars):
        res = msm_jit_static(curve, sw.Affine(px, py, pinf), scalars, c=c,
                             cap_total=n, check_occupancy=False)
        return res.x, res.y, res.z

    return fn, (px, py, pinf, scalars)


def dryrun_rank(world: World) -> dict:
    """One rank's part of `dryrun_multichip`, on world.device:

    1. the points-sharded BLS12-377 G1 MSM at n = 64 D from
       random.Random(3) (points k_i·G, scalars s_i; c = 6), checked
       against the python-int oracle (sum_i s_i k_i mod r)·G;
    2. the column-sharded Goldilocks four-step NTT, 2^(2l) points with
       2^l = max(8, D) (the largest power-of-two group of ranks takes
       part), on values drawn next from the same rng, checked against
       the single-device four-step.

    Raises on a mismatch; returns the sizes and seconds."""
    if world.device.type == "cpu":
        torch.set_num_threads(1)
    curve, dev, d = BLS12_377_G1, world.device, world.size
    f = curve.field
    rng = random.Random(3)
    n = 64 * d
    ks = [rng.randrange(1, curve.order) for _ in range(n)]
    scalars = [rng.randrange(curve.order) for _ in range(n)]
    mine = range(world.rank * 64, (world.rank + 1) * 64)
    pts = [oracle.ec_mul(oracle.generator(curve), ks[i], f.p) for i in mine]
    aff = sw.Affine(fp.from_ints(f, [q[0] for q in pts], dev),
                    fp.from_ints(f, [q[1] for q in pts], dev),
                    torch.zeros(len(pts), dtype=torch.bool, device=dev))
    s_local = shard_rows(scalar_limbs(curve, fp.from_ints(
        curve.scalar, scalars, dev)), world)
    t0 = time.perf_counter()
    res = msm_sharded(curve, aff, s_local, world, c=6)
    msm_s = time.perf_counter() - t0
    expect = oracle.ec_mul(oracle.generator(curve),
                           sum(k * s for k, s in zip(ks, scalars))
                           % curve.order, f.p)
    if sw.to_affine_ints(curve, res) != expect:
        raise AssertionError(f"rank {world.rank}: sharded MSM != oracle")

    pow2 = 1 << (d.bit_length() - 1)
    sub = world if pow2 == d else world.subgroup(range(pow2))
    log_n = max(3, (pow2 - 1).bit_length())
    spec = GOLDILOCKS
    a = fp.from_ints(spec, [rng.randrange(spec.p)
                            for _ in range(1 << 2 * log_n)], dev)
    out = {"rank": world.rank, "msm_n": n, "msm_s": msm_s,
           "ntt_log_n": 2 * log_n, "ntt_ranks": pow2}
    if sub is not None:
        cols = (1 << log_n) // sub.size
        m = a.reshape(1 << log_n, 1 << log_n, -1)
        t0 = time.perf_counter()
        c_local = ntt_fourstep_sharded(
            spec, m[:, sub.rank * cols:(sub.rank + 1) * cols], sub, log_n,
            log_n)
        out["ntt_s"] = time.perf_counter() - t0
        got = flatten_output(c_local, sub)
        if not torch.equal(got, ntt_fourstep(spec, a, log_n, log_n, dev)):
            raise AssertionError(f"rank {world.rank}: sharded four-step "
                                 "!= single-device four-step")
    return out


def dryrun_multichip(n_devices: int, device=None, backend=None) -> list:
    """Run `dryrun_rank` on `n_devices` new ranks on `device` (the card
    unless the caller asks for the CPU); raises if a rank fails.  Returns
    the ranks' results."""
    t0 = time.time()
    results = spawn_world(dryrun_rank, n_devices, device, backend)
    print(f"dryrun_multichip({n_devices}): sharded MSM (n = "
          f"{results[0]['msm_n']}) verified against the oracle, sharded "
          f"four-step (2^{results[0]['ntt_log_n']} over "
          f"{results[0]['ntt_ranks']} ranks) against the single-device "
          f"NTT, in {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    return results
