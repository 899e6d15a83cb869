#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zprize_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

In order, each phase raising on failure (so the exit code is non-zero):

1. requires a CUDA device and prints the card's name and power limit;
2. builds the kernels from csrc/ (one nvcc per source, in parallel);
3. holds every MSM kernel against its plain PyTorch version on the card,
   bit for bit, on random inputs (4096 lanes, and 1000, not a multiple of
   the 128-thread block; identity, doubling and edge-value lanes 0, 1, p-1);
3b. holds the Fr NTT kernel against its plain version, bit for bit,
   forward and inverse, at n = 2, 8, 2^9, 2^10, 2^11 and 2^13 with B = 1 and
   3 rows (random inputs holding 0, 1 and p-1), and checks intt(ntt(a)) == a;
4. drives the MSM main path through the user entry points at the
   benchmark's default size: n = 2^18 BLS12-377 G1 points, 1024 distinct
   base points (i+1)·G tiled, `multi_scalar_mult_init`, then a warm-up and
   4 timed batches of seeded compact scalars; every result is checked
   against the python-int oracle (sum_i agg_i·(i+1) mod r)·G, and every
   kernel of the path must have been launched in that run;
5. profiles one MSM (device time by kernel, device idle share);
6. times each MSM kernel at the shapes the main path gives it, beside its
   plain version and the least time the card could take (integer
   multiplies or bytes, whichever bounds), and checks kernel == plain
   on those inputs too;
7. drives the PLONK prover and verifier at the benchmark's size
   (`BENCH_METRIC=plonk` of the reference: 16 Poseidon Merkle-membership
   proofs of height 8, n = 2^16 gates): the circuit and its Merkle witness,
   `setup_test_srs(n + 8)` and `setup` on the card, a warm-up proof and 2
   timed proofs; every proof must verify, a proof with a tampered
   evaluation and one with a wrong public input must be rejected, and the
   warm-up proof must have launched the Fr NTT and all four MSM kernels
   (the timed ones every kernel but te_dbl_chain, whose tables the warm-up
   built); the host time of one proof's transcript; then one profiled
   proof (device time of each port kernel and of the torch ops) and the
   Fr NTT's row at the path's shapes (2^18 forward, B = 1; 2^16 inverse,
   B = 3).

Prints one JSON line for the MSM path, one for the PLONK path, one
{"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_LOG = 18
N_BASE = 1 << 10
BATCHES = 4
SEED = 42

# H100 SXM peaks (NVIDIA data sheet, 700 W): 3.35 TB/s of HBM; 67 TFLOP/s
# float32 outside the tensor cores = 33.5 T FMA/s, and Hopper issues 32-bit
# integer multiply-adds at half the FMA rate: 16.75 T IMAD/s.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 16.75e12
# one 12-word CIOS mulmod (csrc/fq.cuh): 288 32x32->64 products (a*b and
# m*p), two IMAD slots each, and 12 low-half products for m, one each
IMAD_PER_MULMOD = 2 * 288 + 12
# the same for an 8-word (Fr) mulmod: 128 wide products and 8 low-half
IMAD_PER_MULMOD_FR = 2 * 128 + 8
MULMODS = {"madd": 7, "add": 9, "dbl": 8}
NTT_SIZES = (1, 3, 9, 10, 11, 13)          # log2 n of the phase-3b checks
PLONK_PROOFS, PLONK_HEIGHT = 16, 8         # bench.py's plonk workload
PLONK_TIMED = 2
# each port kernel's CUDA entry points (csrc/), to find them in a profile
KERNEL_SYMBOLS = {"te_dbl_chain": ("k_dbl_chain",),
                  "te_bucket_accumulate": ("k_bucket_accumulate",),
                  "te_full_add": ("k_full_add",),
                  "te_combine": ("k_combine",),
                  "fr_ntt": ("k_ntt_tile", "k_ntt_stage")}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps):
    """Mean device ms of fn() over reps calls (after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound_ms(mulmods, n_bytes, imad_per_mulmod=IMAD_PER_MULMOD):
    ops = mulmods * imad_per_mulmod / IMAD_PER_S * 1e3
    mem = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops, mem), ("operations" if ops >= mem else "bytes")


def random_elems(fp, f, shape, rng, dev):
    """Uniform field elements (Montgomery words) with every edge value."""
    count = int(np.prod(shape))
    vals = [rng.randrange(f.p) for _ in range(count)]
    vals[:3] = [0, 1, f.p - 1][:count]
    return fp.from_ints(f, np.array(vals, dtype=object).reshape(shape), dev)


def check_kernels_random(curve, dev, lanes):
    """Phase 3: every kernel == its plain version at `lanes` lanes."""
    from zprize_tpu_torch.curve import te
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    f = curve.field
    nw = fp.n_words(f)
    rng = random.Random(SEED + lanes)
    ident = te.pack(te.identity(curve, (), dev))
    pts = random_elems(fp, f, (lanes, 4), rng, dev)
    pts[1] = ident                        # identity lane
    # edge lanes: every coordinate 0, 1 or p-1 (raw words)
    for k, v in enumerate((0, 1, f.p - 1)):
        pts[2 + k] = fp.raw_words(f, v, dev).expand(4, nw)
    qs = random_elems(fp, f, (lanes, 4), rng, dev)
    qs[0] = pts[0]                        # doubling lane p + p
    qs[5] = ident
    skip = (torch.arange(lanes, device=dev) % 7 == 3).to(torch.int32)
    results = {}

    out = ak.te_dbl_chain(curve, pts, 3)
    results["te_dbl_chain"] = max_abs_err(
        out, ak.te_dbl_chain_plain(curve, pts, 3))

    out = ak.te_full_add(curve, pts, qs, skip)
    results["te_full_add"] = max_abs_err(
        out, ak.te_full_add_plain(curve, pts, qs, skip))

    ws = torch.stack([pts, qs, pts.flip(0).contiguous()])
    out = ak.te_combine(curve, ws, 2)
    results["te_combine"] = max_abs_err(
        out, ak.te_combine_plain(curve, ws, 2))

    n_rows = 4 * lanes
    rows = random_elems(fp, f, (n_rows, 3), rng, dev)
    rows[1] = te.pack(te.identity_pre(curve, (), dev))
    rows[3] = rows[2]                     # a bucket adds one point twice
    sign = torch.tensor([rng.randrange(2) for _ in range(n_rows)],
                        dtype=torch.int32, device=dev)
    sign[3] = sign[2]
    counts = torch.tensor([rng.randrange(9) for _ in range(lanes)],
                          dtype=torch.int64, device=dev)
    counts[0], counts[1] = 4, 0           # bucket 0: rows 0..3; bucket 1 empty
    starts = torch.cumsum(counts, 0) - counts
    starts = starts % (n_rows - 8)        # runs may overlap; all in range
    out = ak.te_bucket_accumulate(curve, rows, sign, starts, counts)
    results["te_bucket_accumulate"] = max_abs_err(
        out, ak.te_bucket_accumulate_plain(curve, rows, sign, starts, counts))
    torch.cuda.synchronize()
    for name, err in results.items():
        log(f"kernel vs plain, {lanes} random lanes: {name} "
            f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def main_path(curve, dev):
    """Phase 4: init + warm-up + 4 timed MSMs, each oracle-checked."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import api
    from zprize_tpu_torch.utils import oracle
    f = curve.field
    n = 1 << N_LOG
    t0 = time.time()
    base = oracle.generator_chain(curve, N_BASE)
    reps = n // N_BASE
    aff = sw.Affine(
        fp.from_ints(f, [p[0] for p in base], dev).repeat(reps, 1),
        fp.from_ints(f, [p[1] for p in base], dev).repeat(reps, 1),
        torch.zeros(n, dtype=torch.bool, device=dev))
    log(f"base points: {N_BASE} x {reps} in {time.time() - t0:.3f} s")
    rng = np.random.default_rng(SEED)
    batches = [oracle.scalar_batch_np(curve, rng, n)
               for _ in range(BATCHES + 1)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ak.reset_launches()
    t0 = time.time()
    ctx = api.multi_scalar_mult_init(curve, aff)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    init_launches = dict(ak.launches)
    p = ctx.prepared
    log(f"init: {init_s:.3f} s, plan c={p.c} g={p.g} m={p.m}, table "
        f"{p.table.numel() * 4 / 1e9:.3f} GB, launches {init_launches}")

    def check(k, res, batch):
        agg = oracle.oracle_agg(curve, batch, N_BASE)
        exp = oracle.chain_msm(curve, agg)
        if sw.to_affine_ints(curve, res) != exp:
            raise AssertionError(f"batch {k}: MSM result != oracle")

    t0 = time.time()
    res = api.multi_scalar_mult(ctx, batches[0])[0]
    log(f"warm-up MSM: {time.time() - t0:.3f} s (host clock)")
    check("warm-up", res, batches[0])
    times, per_msm = [], None
    for k in range(1, BATCHES + 1):
        s = torch.from_numpy(batches[k].astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        before = dict(ak.launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = api.multi_scalar_mult(ctx, s)[0]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        per_msm = {name: ak.launches[name] - before[name]
                   for name in ak.KERNELS}
        check(k, res, batches[k])
        log(f"batch {k}: {times[-1]:.3f} ms, result verified")
    launches = dict(ak.launches)
    missing = [name for name in ak.KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    if init_launches["te_dbl_chain"] == 0 or 0 in (
            per_msm["te_bucket_accumulate"], per_msm["te_full_add"],
            per_msm["te_combine"]):
        raise AssertionError(f"init {init_launches} / MSM {per_msm} "
                             "launches miss a kernel")
    mean = sum(times) / len(times)
    summary = {
        "metric": f"bls12_377_msm_2^{N_LOG}",
        "n": n, "c": p.c, "g": p.g, "m": p.m,
        "msm_ms": times, "msm_ms_mean": mean,
        "points_per_s": n / (mean / 1e3),
        "init_s": init_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches_init": init_launches,
        "launches_per_msm": per_msm,
        "oracle_checked_batches": BATCHES + 1,
    }
    return ctx, aff, batches[1], launches, summary


def profile_call(label, fn):
    """One call of fn under torch.profiler (after one unprofiled call):
    device time by kernel and the device busy share of the call's wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device-side events only: an aten op's own entry would count its
    # kernels' time a second time
    by_kernel = [(e.self_device_time_total / 1e3, e.count, e.key)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0]
    by_kernel.sort(reverse=True)
    busy = sum(ms for ms, _, _ in by_kernel)
    # device ms of the port's kernels (by their CUDA symbols); the rest is
    # torch ops: the plain engine's glue, sorts, gathers and copies
    ports = {name: sum(ms for ms, _, k in by_kernel
                       if any(s in k for s in symbols))
             for name, symbols in KERNEL_SYMBOLS.items()}
    out = {"profile_wall_ms": wall_ms,
           "device_busy_ms": busy if by_kernel else "not measured",
           "device_idle_share": (1 - busy / wall_ms) if by_kernel
           else "not measured",
           "port_kernels_ms": ports,
           "torch_ops_ms": busy - sum(ports.values()),
           "by_kernel": [{"name": k[:90], "ms": ms, "calls": n}
                         for ms, n, k in by_kernel[:14]]}
    log(f"profiled {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, of it the port's kernels {ports}")
    return out


def transcript_s(curve, vk, proof, public):
    """Host seconds of one proof's Fiat-Shamir transcript: the prover's
    absorbs and squeezes (plonk/prover.py) replayed on its proof."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.plonk.prover import OPEN_ORDER
    from zprize_tpu_torch.plonk.transcript import vk_transcript
    t0 = time.time()
    tr = vk_transcript(curve, vk)
    for v in public:
        tr.absorb_fr(v)
    for cm in proof.wire_comms:
        tr.absorb_point(cm)
    tr.challenge(), tr.challenge()
    tr.absorb_point(proof.z_comm)
    tr.challenge()
    for cm in proof.t_comms:
        tr.absorb_point(cm)
    tr.challenge()
    evals = torch.stack([proof.evals[k] for k in (*OPEN_ORDER, "z_omega")])
    for v in fp.to_ints(curve.scalar, evals):
        tr.absorb_fr(int(v))
    tr.challenge()
    return time.time() - t0


def profile_msm(ctx, batch):
    from zprize_tpu_torch.msm import api
    s = torch.from_numpy(batch.astype(np.int32)).to(ctx.device)
    return profile_call("MSM", lambda: api.multi_scalar_mult(ctx, s))


def kernel_rows(curve, ctx, aff, batch, launches, dev):
    """Phase 5: each kernel at the main path's shapes, timed, beside its
    plain version and its bound, and checked against the plain version."""
    from zprize_tpu_torch.curve import te
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger, te_path
    f = curve.field
    p = ctx.prepared
    pt_bytes = 4 * 4 * fp.n_words(f)
    pre_bytes = 3 * 4 * fp.n_words(f)
    rows = []
    ak.reset_launches()

    def row(name, replaces, fn, plain, reps, mulmods, n_bytes):
        ms = timed(fn, reps)
        t0 = time.time()
        ref = plain()
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = max_abs_err(fn(), ref)
        if err != 0:
            raise AssertionError(f"{name} != plain at main-path shapes")
        b_ms, b_by = bound_ms(mulmods, n_bytes)
        rows.append({"name": name, "route": "cuda",
                     "source": "zprize_tpu_torch/csrc/msm_te.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        log(f"{name}: {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}), kernel == plain")

    # te_dbl_chain: one init block, n points, c*g doublings
    tx, ty, _ = te.sw_to_te(curve, aff.x, aff.y, aff.inf)
    base = te.pack(te.TePoint(tx, ty, fp.ones(f, tx.shape[:-1], dev),
                              fp.mul(f, tx, ty)))
    shift = p.c * p.g
    n = base.shape[0]
    row("te_dbl_chain", "zprize_tpu/msm/accum_kernel.py:893",
        lambda: ak.te_dbl_chain(curve, base, shift),
        lambda: ak.te_dbl_chain_plain(curve, base, shift), 5,
        n * shift * MULMODS["dbl"], 2 * n * pt_bytes)

    # te_bucket_accumulate: bucket set 0 of a real scalar batch
    s = torch.from_numpy(batch.astype(np.int32)).to(dev)
    run = next(pippenger.bucket_runs(curve, p, aff.inf, s))
    r_rows, nbe = run[0].shape[0], run[2].shape[0]
    row("te_bucket_accumulate", "zprize_tpu/msm/accum_kernel.py:1218",
        lambda: ak.te_bucket_accumulate(curve, *run),
        lambda: ak.te_bucket_accumulate_plain(curve, *run), 5,
        int(run[3].sum()) * MULMODS["madd"],
        r_rows * (pre_bytes + 4) + nbe * (16 + pt_bytes))
    sums = ak.te_bucket_accumulate(curve, *run)

    # te_full_add: the triangle merge's W*C lanes
    c_lanes, steps = te_path.triangle_split(p.g, nbe)
    lanes = p.g * c_lanes
    a, b = sums[:lanes].contiguous(), sums[lanes:2 * lanes].contiguous()
    skip = torch.zeros(lanes, dtype=torch.int32, device=dev)
    row("te_full_add", "zprize_tpu/msm/accum_kernel.py:791",
        lambda: ak.te_full_add(curve, a, b, skip),
        lambda: ak.te_full_add_plain(curve, a, b, skip), 20,
        lanes * MULMODS["add"], lanes * (3 * pt_bytes + 4))

    # te_combine: the merge tail's c=1 fold over the chunk-weight bits.
    # These are g lanes of a serial fold, so the throughput bound below
    # (the whole card's multiply rate) is far under what one thread's
    # dependent chain of mulmods can reach: it does not bind this row.
    n_bits = max(1, (c_lanes - 1).bit_length())
    ws = sums[:n_bits * p.g].reshape(n_bits, p.g, 4, -1).contiguous()
    row("te_combine", "zprize_tpu/msm/accum_kernel.py:997",
        lambda: ak.te_combine(curve, ws, 1),
        lambda: ak.te_combine_plain(curve, ws, 1), 20,
        p.g * (n_bits - 1) * (MULMODS["dbl"] + MULMODS["add"]),
        (n_bits + 1) * p.g * pt_bytes)
    return rows


def check_ntt(dev):
    """Phase 3b: fr_ntt == its plain version, forward and inverse, and the
    round trip, at every size of NTT_SIZES with B = 1 and 3."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.field.spec import BLS12_377_FR
    from zprize_tpu_torch.ntt import fr_kernel
    from zprize_tpu_torch.ntt.domain import Domain
    f = BLS12_377_FR
    rng = random.Random(SEED)
    for log_n in NTT_SIZES:
        dom = Domain(f, log_n, dev)
        for rows in (1, 3):
            a = random_elems(fp, f, (rows, dom.n), rng, dev)
            errs = []
            for inverse in (False, True):
                out = fr_kernel.fr_ntt(dom, a, inverse)
                errs.append(max_abs_err(
                    out, fr_kernel.fr_ntt_plain(dom, a, inverse)))
            back = fr_kernel.fr_ntt(dom, fr_kernel.fr_ntt(dom, a), True)
            torch.cuda.synchronize()
            errs.append(max_abs_err(back, a))
            log(f"fr_ntt vs plain, n = 2^{log_n}, B = {rows}: forward "
                f"{errs[0]}, inverse {errs[1]}, round trip {errs[2]}")
            if any(errs):
                raise AssertionError(f"fr_ntt disagrees at 2^{log_n}, "
                                     f"B = {rows}")


def plonk_witness(cfg, fr, n_proofs, height, rng, dev):
    """bench.py's membership workload: the circuit, the Poseidon Merkle
    tree over seeded leaves (on the card), and the full assignment."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.hash import merkle
    from zprize_tpu_torch.plonk.gadgets import generate_membership_circuit
    cb, handles, indices = generate_membership_circuit(cfg, n_proofs, height)
    leaves = [rng.randrange(fr.p) for _ in range(1 << height)]
    levels = merkle.build_tree(cfg, fp.from_ints(fr, leaves, dev))
    root = int(fp.to_ints(fr, merkle.root(levels))[()])
    assignment = {}
    for (leaf_var, sib_vars), idx in zip(handles, indices):
        assignment[leaf_var] = leaves[idx]
        sibs = torch.stack([sib for sib, _ in merkle.prove(levels, idx)])
        for sv, v in zip(sib_vars, fp.to_ints(fr, sibs)):
            assignment[sv] = int(v)
    assignment = cb.compute_witness(assignment)
    cc = cb.compile()
    public = [root] * n_proofs
    cc.check_assignment(assignment, public)
    return cc, assignment, public


def plonk_path(dev, n_proofs=PLONK_PROOFS, height=PLONK_HEIGHT):
    """Phase 7: keygen, a warm-up and PLONK_TIMED timed proofs, each
    verified, and two rejections."""
    from zprize_tpu_torch.curve.spec import BLS12_377_G1
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.hash.grain import snarkvm_config
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.ntt import fr_kernel
    from zprize_tpu_torch.pcs import kzg
    from zprize_tpu_torch.plonk import prover, verifier
    curve = BLS12_377_G1
    fr = curve.scalar
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = random.Random(17)

    def counts():
        return {**ak.launches, **fr_kernel.launches}

    t0 = time.time()
    cc, assignment, public = plonk_witness(snarkvm_config(fr, 2), fr,
                                           n_proofs, height, rng, dev)
    circuit_s = time.time() - t0
    log(f"plonk: {n_proofs} membership proofs x height {height} -> n = "
        f"{cc.n} ({len(cc.public_rows)} public rows), circuit and witness "
        f"{circuit_s:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ak.reset_launches()
    fr_kernel.reset_launches()
    t0 = time.time()
    srs = kzg.setup_test_srs(curve, cc.n + 8, seed=3, device=dev)
    sync()
    srs_s = time.time() - t0
    t0 = time.time()
    pk, vk = prover.setup(curve, cc, srs)
    sync()
    keygen_s = time.time() - t0
    wires = fp.from_ints(fr, cc.wire_values(assignment).tolist(), dev)
    log(f"SRS of {srs.size} powers {srs_s:.3f} s, keygen {keygen_s:.3f} s, "
        f"launches {counts()}")

    def run():
        proof = prover.prove_planes(pk, wires, public, blinding_rng=rng)
        sync()
        return proof

    def verified(proof, pub, expect):
        t0 = time.time()
        ok = verifier.verify(vk, srs, proof, pub)
        dt = time.time() - t0
        if ok != expect:
            raise AssertionError(f"verify gave {ok}, expected {expect}")
        return dt

    per_proof, times, verify_s = [], [], []
    for k in range(PLONK_TIMED + 1):
        before = counts()
        t0 = time.time()
        proof = run()
        times.append(time.time() - t0)
        per_proof.append({name: v - before[name]
                          for name, v in counts().items()})
        verify_s.append(verified(proof, public, True))
        log(f"proof {k} ({'warm-up' if k == 0 else 'timed'}): "
            f"{times[-1]:.3f} s, verified in {verify_s[-1]:.3f} s, "
            f"launches {per_proof[-1]}")
    path_launches = counts()
    missing = [name for name, v in per_proof[0].items() if v == 0]
    if missing:
        raise AssertionError(f"the warm-up proof launched no {missing}")
    for k, launched in enumerate(per_proof[1:], 1):
        missing = [name for name, v in launched.items()
                   if v == 0 and name != "te_dbl_chain"]
        if missing:
            raise AssertionError(f"timed proof {k} launched no {missing}")
    bad = dict(proof.evals)
    bad["a"] = fp.add(fr, bad["a"], fp.ones(fr, (), dev))
    verified(prover.Proof(proof.wire_comms, proof.z_comm, proof.t_comms, bad,
                          proof.w_zeta, proof.w_zeta_omega), public, False)
    verified(proof, [(public[0] + 1) % fr.p] * n_proofs, False)
    log("tampered evaluation and wrong public input rejected")
    tr_s = transcript_s(curve, vk, proof, public)
    log(f"one proof's transcript on the host: {tr_s:.3f} s")
    mean = sum(times[1:]) / PLONK_TIMED
    summary = {
        "metric": f"bls12_377_plonk_n{cc.n}",
        "n": cc.n, "proofs": n_proofs, "height": height,
        "prove_s": times[1:], "prove_s_mean": mean,
        "ns_per_constraint": mean / cc.n * 1e9,
        "warmup_prove_s": times[0],
        "keygen_s": keygen_s, "srs_s": srs_s, "circuit_s": circuit_s,
        "verify_s": verify_s, "transcript_s": tr_s,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if dev.type == "cuda" else None),
        "launches_warmup_proof": per_proof[0],
        "launches_per_proof": per_proof[-1],
        "verified_proofs": PLONK_TIMED + 1, "rejected": 2,
    }
    return pk, wires, public, path_launches, summary


def ntt_row(pk, launches, dev):
    """The Fr NTT at the PLONK path's shapes, timed beside its plain
    version and its bound, and checked against the plain version: the
    quotient's 2^18 coset transform (forward, B = 1) first, and the wires'
    2^16 inverse (B = 3) under "shapes"."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.ntt import fr_kernel
    fr_kernel.reset_launches()
    f = pk.dom.spec
    rng = random.Random(SEED + 1)
    shapes = []
    for dom, rows, inverse in ((pk.dom4, 1, False), (pk.dom, 3, True)):
        a = random_elems(fp, f, (rows, dom.n), rng, dev)
        ms = timed(lambda: fr_kernel.fr_ntt(dom, a, inverse), 10)
        t0 = time.time()
        ref = fr_kernel.fr_ntt_plain(dom, a, inverse)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = max_abs_err(fr_kernel.fr_ntt(dom, a, inverse), ref)
        if err != 0:
            raise AssertionError("fr_ntt != plain at the path's shapes")
        n = dom.n
        mulmods = rows * (n // 2 * dom.log_n + (n if inverse else 0))
        n_bytes = rows * n * 32 * 2 + n // 2 * 32
        b_ms, b_by = bound_ms(mulmods, n_bytes, IMAD_PER_MULMOD_FR)
        shapes.append({"n": n, "rows": rows, "inverse": inverse,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by})
        way = "inverse" if inverse else "forward"
        log(f"fr_ntt 2^{dom.log_n} x {rows} {way}: {ms:.4f} ms (plain "
            f"{plain_ms:.1f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}), kernel == plain")
    first = shapes[0]
    return {"name": "fr_ntt", "route": "cuda",
            "source": "zprize_tpu_torch/csrc/ntt_fr.cu",
            "replaces": "zprize_tpu/ntt/fr_kernel.py:65",
            "launches": launches["fr_ntt"],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shapes": shapes}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from zprize_tpu_torch.curve.spec import BLS12_377_G1
    from zprize_tpu_torch.plonk import prover
    from zprize_tpu_torch.utils import build

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    logs = build.build_all()
    log(f"kernel build: {time.time() - t0:.1f} s ({len(logs)} source(s))")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.strip()}")

    curve = BLS12_377_G1
    for lanes in (4096, 1000):
        check_kernels_random(curve, dev, lanes)
    check_ntt(dev)
    ctx, aff, batch, launches, summary = main_path(curve, dev)
    summary["profile"] = profile_msm(ctx, batch)
    kernels = kernel_rows(curve, ctx, aff, batch, launches, dev)
    del ctx, aff
    pk, wires, public, plonk_launches, plonk = plonk_path(dev)
    plonk["profile"] = profile_call("PLONK proof", lambda: prover.prove_planes(
        pk, wires, public, blinding_rng=random.Random(18)))
    kernels.append(ntt_row(pk, plonk_launches, dev))
    print(json.dumps(summary), flush=True)
    print(json.dumps(plonk), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
