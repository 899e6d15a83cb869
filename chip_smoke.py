#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zprize_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

In order, each phase raising on failure (so the exit code is non-zero):

1. requires a CUDA device and prints the card's name and power limit;
2. builds the kernels from csrc/ (one nvcc per source, in parallel);
3. holds every kernel against its plain PyTorch version on the card, bit
   for bit, on random inputs (4096 lanes, and 1000, not a multiple of the
   128-thread block; identity, doubling and edge-value lanes 0, 1, p-1);
4. drives the main path through the user entry points at the benchmark's
   default size: n = 2^18 BLS12-377 G1 points, 1024 distinct base points
   (i+1)·G tiled, `multi_scalar_mult_init`, then a warm-up and 4 timed
   batches of seeded compact scalars; every result is checked against
   the python-int oracle (sum_i agg_i·(i+1) mod r)·G, and every kernel of
   the path must have been launched in that run;
5. profiles one MSM (device time by kernel, device idle share);
6. times each kernel at the shapes the main path gives it, beside its
   plain version and the least time the card could take (integer
   multiplies or bytes, whichever bounds), and checks kernel == plain
   on those inputs too.

Prints one JSON line for the main path, one {"kernels": [...]} line, the
nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

import json
import os
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
MULMODS = {"madd": 7, "add": 9, "dbl": 8}


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


def bound_ms(mulmods, n_bytes):
    ops = mulmods * IMAD_PER_MULMOD / IMAD_PER_S * 1e3
    mem = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops, mem), ("operations" if ops >= mem else "bytes")


def random_elems(fp, f, shape, rng, dev):
    """Uniform field elements (Montgomery words) with every edge value."""
    count = int(np.prod(shape))
    vals = [rng.randrange(f.p) for _ in range(count)]
    vals[:3] = [0, 1, f.p - 1]
    return fp.from_ints(f, np.array(vals, dtype=object).reshape(shape), dev)


def check_kernels_random(curve, dev, lanes):
    """Phase 3: every kernel == its plain version at `lanes` lanes."""
    import random
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


def profile_msm(ctx, batch):
    """One MSM under torch.profiler: device time by kernel and the device
    busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zprize_tpu_torch.msm import api
    s = torch.from_numpy(batch.astype(np.int32)).to(ctx.device)
    api.multi_scalar_mult(ctx, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        api.multi_scalar_mult(ctx, s)
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
    out = {"profile_wall_ms": wall_ms,
           "device_busy_ms": busy if by_kernel else "not measured",
           "device_idle_share": (1 - busy / wall_ms) if by_kernel
           else "not measured",
           "by_kernel": [{"name": k[:90], "ms": ms, "calls": n}
                         for ms, n, k in by_kernel[:14]]}
    log(f"profiled MSM: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms")
    return out


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from zprize_tpu_torch.curve.spec import BLS12_377_G1
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
    ctx, aff, batch, launches, summary = main_path(curve, dev)
    summary["profile"] = profile_msm(ctx, batch)
    kernels = kernel_rows(curve, ctx, aff, batch, launches, dev)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
