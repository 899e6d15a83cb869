#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zprize_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

In order, each phase raising on failure (so the exit code is non-zero):

1. requires a CUDA device and prints the card's name and power limit;
2. builds the kernels from csrc/ (one nvcc per source, in parallel);
3. holds every MSM kernel against its plain PyTorch version on the card,
   bit for bit, on random inputs (4096 lanes, and 1000, not a multiple of
   the 128-thread block; identity, doubling and edge-value lanes 0, 1, p-1;
   for te_gather_accumulate empty runs, runs of one, identity and
   edge-value rows, negative signs; te_bucket_accumulate also from init
   lanes (random, identity and edge-word lanes, with runs and empty, an
   empty run giving its init lane back unchanged); for te_running_sum
   chunks of S = 8 and
   16 points with an identity lane, a lane of one point repeated, whose
   suffix sum doubles, and a lane of edge values); te_combine (folded by
   groups of 4 threads) at 1, 15 and 33 lanes, c = 1, 5 and 17, 1, 2, 13
   and 16 steps (an identity lane, an identity on top, edge words);
   te_tree_sum at the shapes of TREE_CASES (one member, one segment of 64,
   several segments and a ragged one, roots only and bit sums at first = 0
   and 1; identity members and edge words), the root and every bit sum; the
   two latency probes against their plain versions and timed at two chain
   lengths on one thread, the slope being the latency of one link:
   imad_chain (2^15 and 2^18 dependent IMADs; 2 of them a mulmod is the
   card's floor for the serial folds te_combine and sw_combine, their
   bound) and fq_mul_chain (1024 and 8192 dependent mulmods: the floor of
   a design that runs each mulmod on one thread, reported beside it);
3b. holds the Fr NTT kernel against its plain version, bit for bit,
   forward and inverse, at n = 2, 8, 2^9, 2^10 (one pass), 2^11, 2^13,
   2^16, 2^17, 2^18 (two passes) and 2^21 (three) with B = 1 and 3 rows
   (random inputs holding 0, 1 and p-1), and checks intt(ntt(a)) == a;
   then profiles one 2^18 forward transform, which must show one kernel
   a pass (two);
3c. holds the Goldilocks NTT kernel gl_ntt against its plain version, bit
   for bit, forward and inverse (scaled by n^-1), at n = 2, 8, 2^9 (the
   range of the TPU's fused kernel) and 2^10, 2^12 (its stage-grid kernel)
   with B = 1 and 3 columns, and 4096 at 2^12, on random canonical values
   holding 0, 1, q-1 and 2^32-1; the transposed store (B, 2^12) at B =
   1, 3 and 4096; column passes with the two-level step twiddle, in place
   and transposed (2^3 x (3 x 2^10) in groups of 3, and the 2^24 NTT's
   2^12 x 2^12); intt(ntt(x)) == x; and the plain version against a
   python-int DFT at 2^3 and 2^9;
3d. holds the four short-Weierstrass kernels against their plain
   versions, bit for bit, with BLS12-381's and BLS12-377's constants, at
   4096 and 1000 lanes: sw_gather_accumulate over two windows (empty
   runs, runs of one, negative signs, a point added twice (P + P), a
   point and its negative (P + (-P)), curve points beside random words,
   rows at 0, 1 and p-1); sw_full_add in place (identity accumulators and
   operands, doubling, P + (-P), skip lanes, edge lanes, and the
   accumulator added to itself); sw_combine over 4 windows at c = 3
   (identity lanes, a window sum equal to the accumulator and one equal
   to its negative, edge words 0, 1 and p-1); sw_running_sum over chunks
   of S = 8 and 16 (an identity lane, a lane of one point repeated, a
   lane of P, -P, .., a lane of edge values);
3e. holds sw_tree_sum against its plain version, bit for bit, with
   BLS12-381's and BLS12-377's constants, at the shapes of TREE_CASES
   (as te_tree_sum in phase 3, and a member equal to its neighbour, so
   that the first step doubles);
4. drives the MSM main path through the user entry points at the
   benchmark's default size: n = 2^18 BLS12-377 G1 points, 1024 distinct
   base points (i+1)·G tiled, `multi_scalar_mult_init`, then a warm-up and
   4 timed batches of seeded compact scalars; every result is checked
   against the python-int oracle (sum_i agg_i·(i+1) mod r)·G, and every
   kernel of the path must have been launched in that run; then the
   collapsed gather route (`accum="gather"` on the same table: one
   te_gather_accumulate launch an MSM reading the table through the sort
   permutation, no te_bucket_accumulate), a warm-up and 4 timed batches,
   each MSM of either route checked against the oracle, timed against
   the default (sorted) route in the order default, gather, gather,
   default, ...; and te_gather_accumulate at that route's shape (2^22
   table rows, 2^16 buckets) beside its plain version and its bound;
4b. drives the prize configuration, the m = 1 route: n = 2^26 points
   (the same base set tiled 65,536 times), `multi_scalar_mult_init`
   (plan c = 17, g = 16, m = 1: one operand per point, no collapse
   table), a warm-up and 4 timed batches (CUDA events around each
   `multi_scalar_mult` call on scalars already on the card), every result
   checked against the oracle; each MSM must launch te_gather_accumulate,
   te_tree_sum (at most TREE_LAUNCHES_PER_MSM times), te_running_sum and
   te_combine, and neither te_full_add, te_bucket_accumulate nor
   te_dbl_chain (the merges' launches of one MSM are printed); then an m = 1 run at
   2^12 with skewed scalars (all equal; half zero, half equal),
   oracle-checked; then one profiled 2^26 MSM and the rows of the path's
   kernels at the launches it makes, each timed beside its plain version
   and its bound and checked against it: te_gather_accumulate over the
   full windows of a 2^26 batch in one launch (and window 0 alone),
   te_running_sum over the triangle merge's chunks of those bucket sums,
   te_tree_sum at the merges' trees (the 2^26 and 2^18 merges' U roots
   and V bit sums, the carry window; beside each time its throughput
   bound, the card's latency floor and the design floor), te_combine at
   the final combine's shape (16 steps, c = 17, one lane; bound: its 555-mulmod
   critical path times 2 dependent IMADs a mulmod); then the sorted route
   on the same table (`accum="sorted"`: per window, runs of 2^23 rows
   sorted, copied and summed by te_bucket_accumulate chained through its
   init lanes, 128 launches an MSM, no te_gather_accumulate or
   te_dbl_chain), a warm-up (its peak memory) and SORTED_BATCHES timed
   batches, each MSM of either route checked against the oracle, timed
   against the default (gather) route in the order gather, sorted,
   sorted, gather; one profiled sorted MSM; and te_bucket_accumulate at
   that route's shape (a 2^23-row run from init lanes, 2^16 buckets)
   beside its plain version and its bound;
5. profiles one 2^18 MSM (device time by kernel, device idle share);
6. times each MSM kernel of the 2^18 path that 4b's rows do not cover at
   the shapes the path gives them,
   beside its plain version and the least time the card could take
   (integer multiplies or bytes, whichever bounds), and checks
   kernel == plain on those inputs too;
7. drives the PLONK prover and verifier at the benchmark's size
   (`BENCH_METRIC=plonk` of the reference: 16 Poseidon Merkle-membership
   proofs of height 8, n = 2^16 gates): the circuit and its Merkle witness,
   `setup_test_srs(n + 8)` and `setup` on the card, a warm-up proof and 2
   timed proofs; every proof must verify, a proof with a tampered
   evaluation and one with a wrong public input must be rejected, and the
   warm-up proof must have launched the Fr NTT and all five kernels of
   the collapsed route (the timed ones every kernel but te_dbl_chain,
   whose tables the warm-up built), and no proof te_full_add (the SRS's
   double-and-add only); the host time of one proof's transcript; then
   one profiled proof (device time of each port kernel and of the torch
   ops), the Fr NTT's row at the path's shapes (2^18 forward, B = 1; 2^16
   inverse, B = 3; 2^16 forward, B = 1; with phase 3b's profile), and
   te_full_add's row at the SRS's shape.  Before the profile, on the same
   SRS: `kzg.verify_with_trapdoor` must accept an opening made on the card
   by `kzg.commit`/`open_at` and reject it with y + 1 and with a wrong
   witness, agreeing with `kzg.verify` on all three; and the proof's
   commitments, the first 8 SRS powers and the identity must come back
   from `serialize_points`/`deserialize_points` (96 bytes a record, the
   identity's flag 0x40 in its last byte).

8. (run right after 3c, before any other profile) drives the Goldilocks
   NTT at bench.py's size (`BENCH_METRIC=ntt` of the reference: 2^24
   points, four-step 2^12 x 2^12, `ntt_fourstep_packed`): bench.py's
   input (random.Random(0), 4096 draws tiled 4096 times) checked at every
   one of its 2^24 outputs against the closed form of a periodic input
   (zero unless 4096 | k, else 4096 times a python-int 4096-point
   transform); a random 2^24 input against the plain radix-2 stage loop
   on the card, bit for bit, and back through the inverse; radix2.ntt on
   a Goldilocks domain of 2^10 (Montgomery words) against python ints;
   the metric, ms per forward NTT over 8 chained dependent transforms, 5
   iterations (CUDA events), and the inverse's; a profiled chain of 8
   NTTs, which must hold 16 gl_ntt launches and no other kernel (the
   four-step transpose is in the column pass's store, so no copy runs
   between the passes); gl_ntt's row at its main-path shapes; and the
   path must have launched gl_ntt twice an NTT and no MSM or Fr kernel.

9. (run right after 8) drives the short-Weierstrass MSM route: BLS12-381
   G1 at n = 2^18 through `multi_scalar_mult_init` (c = 13: 21 windows,
   2^12 buckets in each full window), a warm-up and 4 timed batches, every
   result checked against the python-int oracle, each MSM launching
   sw_gather_accumulate, sw_running_sum, sw_tree_sum and sw_combine, and
   no sw_full_add, TE or NTT kernel (the sw_tree_sum and sw_full_add
   launches per MSM are printed);
   BLS12-377 at 2^18 with te=False against the oracle and against the TE
   route's result for the same batch; a skewed 2^12 run (all scalars
   equal; half zero, half equal); `msm_jit_batch` with B = 4 at 2^16
   against four single MSMs; `kzg.commit_batch` on a BLS12-381 test SRS
   against `commit` row by row (and python ints); `msm_jit_static` with a
   too-small cap_total on equal scalars raising "occupancy"; one profiled
   2^18 MSM; and the five kernels' rows at the path's shapes, sw_tree_sum
   at every tree of one MSM with the A/B against the per-level
   sw_full_add launches that summed them before (parent, new, new,
   parent).

10. (run after 7, so that no earlier profile is disturbed) drives
   Marlin batch verification at the benchmark's sizes
   (`BENCH_METRIC=verify` of the reference, bench.py:341-467): the
   100-constraint circuit (c = a·b public, filler constraints),
   `setup_test_srs(max(3k, 2n) + 8, seed=11)` and `indexer.index` on the
   card (its nine commitments on the collapsed TE route), `prove_batch`
   of 4 witnesses from random.Random(0xC0FFEE) (each proof verified), the
   tampered pool (g_1's y negated, `main.rs:182`), three groups of 10,
   100 and 20 proofs with faults at 1/5, 1/50 and 1/10, a warm cycle and
   a 10 s window of `verify_group` rounds on host ints; every verdict must
   be exact.  Prints marlin_verify_rounds_per_10s, the setup and proving
   seconds, and each kernel's launches in the prove_batch of 4, which
   must hold sw_gather_accumulate and fr_ntt;
11. drives Proof-of-Succinct-Work mining (`BENCH_METRIC=posw`,
   bench.py:293-339): `posw.setup()` on the card (the PoSW circuit's n =
   512, k = 1024), a warm `mine_batch` of 8 nonces at target p whose
   solution must pass `verify_work` and fail it under a target its hash
   does not meet, then 3 timed batches of 8 (posw_proofs_per_20s =
   proofs / seconds x 20; each batch's launches read, each must hold
   sw_gather_accumulate and fr_ntt, and each batch's solution passes
   `verify_work` after the clock stops), and one profiled
   prove_batch(8): device time by port kernel and torch ops, and the
   idle share.  Phases 10 and 11 set every counter to 0, the probes'
   too, before each part they count.
12. (last) checks `entry()`'s fixed-shape MSM (n = 256) against the
   oracle, then drives the sharded forms (zprize_tpu_torch/parallel) over
   worlds of rank processes that share the one card (`spawn_world`; the
   kernels were built here first): SHARD_RANKS = 4 ranks on gloo, whose
   collectives go through host memory, run (a) `msm_sharded` over
   BLS12-377 at 2^22 points (2^20 a rank; the tiled base set and a
   seeded batch made on the card), checked by rank 0 against the
   closed-form oracle and here against the single-device
   `msm_jit_static` of the same inputs; (b) the sharded Goldilocks 2^24
   four-step of bench.py's input (`BENCH_METRIC=ntt_dist`), every output
   checked by its rank against the single-device `ntt_fourstep_packed`,
   timed over 5 calls (goldilocks_ntt_dist_2^24_ms: time of the
   host-staged collective path, not of several cards); (c)
   `ShardedProver` over phase 7's key (each rank handed its rows) and
   witness with random.Random(17), which must equal the single-device
   proof of the same seed, verify, and fail with a tampered evaluation,
   and a proof with no rng (rank 0 draws the blinding) must verify;
   first, a probe of whether gloo takes CUDA tensors in all_gather and
   all_to_all_single.  A world of one NCCL rank runs (a) at 2^18 and (b).
   Rank 0's launches by part must show sw_gather_accumulate (MSM,
   proof), gl_ntt (NTT) and fr_ntt (proof).

Prints one JSON line for the 2^18 MSM path, one for the 2^26 path, one
each for the collapsed gather and the sorted route (beside the default
route's figures from the same run), one for the PLONK path, one for the
Goldilocks NTT, one for the SW route, one
for Marlin verification, one for PoSW, one for the sharded forms, one
{"kernels": [...]} line (each row also with its launches in phase 10's
prove_batch of 4, in a PoSW batch of 8, the mean of the timed batches,
and on rank 0 of phase 12's sharded MSM, NTT and proof), the total time,
the nvidia-smi line, and last {"ok": true, "device": {...}}.
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
PRIZE_LOG = 26                             # prize 1a: 2^26 points
SKEW_LOG = 12
N_BASE = 1 << 10
BATCHES = 4
SORTED_BATCHES = 2                         # phase 4b's sorted-route batches
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
MULMODS = {"madd": 7, "add": 9, "dbl": 8,
           # the SW (RCB a = 0) adds and doubling, the products by the
           # small constant 3b being additions
           "sw_madd": 11, "sw_add": 12, "sw_dbl": 8}
SW_LOG = 18                                # the SW route at 2^18 (prize 4)
SW_BATCH_LOG, SW_BATCH = 16, 4             # msm_jit_batch: B x 2^16
SW_SRS_LOG = 12                            # the BLS12-381 test SRS
# log2 n of the phase-3b checks: one pass up to 2^10 (every pass length
# from 2^1 to 2^4 among them), two from 2^11 (2^16, 2^17 and 2^18 the
# PLONK path's), three from 2^21 (2^22's (8, 7, 7) the first uneven
# three), at B = 1 and 3; from NTT_B1_LOG at B = 1 only
NTT_SIZES = (1, 2, 3, 4, 9, 10, 11, 13, 16, 17, 18, 21, 22)
NTT_B1_LOG = 22
GL_SIZES = (1, 3, 9, 10, 12)               # log2 n of the phase-3c checks
GL_LOG1, GL_LOG2 = 12, 12                  # bench.py's 2^24 NTT, four-step
GL_PERIOD = 4096                           # bench.py's input repeats
GL_CHAIN, GL_ITERS = 8, 5                  # BENCH_NTT_CHAIN, BENCH_ITERS
# a Goldilocks mulmod (csrc/ntt_gl.cu): one 64x64->128 product, four
# 32x32->64 wide products at two IMAD slots each
IMAD_PER_MULMOD_GL = 8
# te_combine's phase-3 shapes (lanes, c, steps): 1, 15 and 33 lanes (33
# fills a block of 32 fold groups and one group of the next), c = 1, 5 and
# 17, 1, 2, 13 and 16 steps
COMBINE_CASES = ((1, 17, 16), (15, 1, 13), (33, 5, 2), (33, 17, 1),
                 (15, 5, 16), (1, 1, 2), (33, 1, 13), (1, 5, 1))
# the probes' chain lengths: the latency of a link is the slope of the
# launch's time between the two (long enough that the card, not the host,
# sets the time of both)
IMAD_K = (1 << 15, 1 << 18)
MULMOD_K = (1024, 8192)
# the least dependent IMADs a mulmod takes however many threads split it:
# the product, then the reduction's multiply by a quotient taken from it
# (additions, carries and exchanges counted as free)
MULMOD_IMAD_DEPTH = 2
PLONK_PROOFS, PLONK_HEIGHT = 16, 8         # bench.py's plonk workload
PLONK_TIMED = 2
VERIFY_CONSTRAINTS = 100                   # bench.py's verify circuit
VERIFY_WINDOW_S = 10.0                     # BENCH_VERIFY_WINDOW_S
POSW_BATCH = 8                             # BENCH_POSW_BATCH
POSW_TIMED = 3                             # timed batches (bench: 20 s)
# phase 12: ranks sharing the one card (gloo), the sharded MSM's size
# (2^20 points a rank) and the world of one NCCL rank's
SHARD_RANKS = 4
SHARD_MSM_LOG, SHARD_NCCL_MSM_LOG = 22, 18
SHARD_MSM_TIMED = 2
SHARD_NTT_ITERS = 5                        # the ntt_dist metric's mean of 5
SHARD_PROOF_SEED = 17
SHARD_TIMEOUT_S = 600.0
# the MSM kernels of the collapsed route (the 2^18 MSM and the PLONK
# commits); the m = 1 route runs te_gather_accumulate instead of the
# first two
COLLAPSED_ROUTE = ("te_dbl_chain", "te_bucket_accumulate", "te_running_sum",
                   "te_tree_sum", "te_combine")
# te_tree_sum launches an MSM may make: the triangle merge's two trees
# and, at 2^26, the carry window's bit sums
TREE_LAUNCHES_PER_MSM = 4
# the tree kernels' phase-3 and 3e shapes (rows, members, weight offset or
# None for roots only): one member, one segment, several segments and a
# ragged one
TREE_CASES = ((1, 1, None), (1, 1, 0), (1, 1, 1), (3, 64, 0), (2, 64, 1),
              (2, 3 * 64 + 17, 1), (5, 1000, 0), (4, 777, None),
              (1, 8192, 0))
# seconds a profiler window stays open before and after the call it
# traces, by attempt: the profiler keeps a device event only inside its
# window, with the card's timestamps mapped onto the host clock, and in
# some processes that mapping put the first kernel of a window opened just
# before its launch outside the window (phase 8's chain lost one of its 16
# kernels in each of 3 attempts at 0.05 s), so a window that falls short
# is opened again with a wider margin
TRACE_MARGINS_S = (0.05, 0.25, 1.0, 4.0)
# each port kernel's CUDA entry points (csrc/), to find them in a profile
KERNEL_SYMBOLS = {"te_dbl_chain": ("k_dbl_chain",),
                  "te_bucket_accumulate": ("k_bucket_accumulate",),
                  "te_gather_accumulate": ("k_gather_accumulate",),
                  "te_full_add": ("k_full_add",),
                  "te_running_sum": ("k_running_sum",),
                  "te_tree_sum": ("k_tree_segment", "k_tree_finish"),
                  "te_combine": ("k_combine",),
                  "sw_gather_accumulate": ("k_sw_gather_accumulate",),
                  "sw_full_add": ("k_sw_full_add",),
                  "sw_running_sum": ("k_sw_running_sum",),
                  "sw_tree_sum": ("k_sw_tree_segment", "k_sw_tree_finish"),
                  "sw_combine": ("k_sw_combine",),
                  "fr_ntt": ("k_fr_pass",),
                  "gl_ntt": ("k_gl_ntt",)}


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


def fold_bound(depth, lat, mulmods, n_bytes):
    """A serial fold's bound: its critical path (`depth` dependent
    mulmods) times the card's floor for a mulmod, MULMOD_IMAD_DEPTH
    dependent IMADs at the latency `lat["imad"]` (ms) that imad_chain
    measured.  Returns (ms, "latency", extra fields): the depth, the floor
    of a design that runs each mulmod on one thread (depth times
    `lat["mulmod"]`, fq_mul_chain's latency) and the throughput bound of
    its `mulmods` and bytes, far below both at the paths' few lanes."""
    return depth * MULMOD_IMAD_DEPTH * lat["imad"], "latency", {
        "depth_mulmods": depth,
        "design_floor_ms": depth * lat["mulmod"],
        "throughput_bound_ms": bound_ms(mulmods, n_bytes)[0]}


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

    # te_running_sum: `lanes` chunks of S points drawn from pts and qs; an
    # identity lane, an equal lane (the suffix sum doubles at every step)
    # and a lane of edge values
    pool = torch.cat([pts, qs])
    for steps in (8, 16):
        pick = torch.tensor([[rng.randrange(pool.shape[0])
                              for _ in range(steps)] for _ in range(lanes)],
                            device=dev)
        chunks = pool[pick]
        chunks[0] = ident
        chunks[1] = pts[0]
        chunks[2] = pts[2 + torch.arange(steps, device=dev) % 3]
        t_out, u_out = ak.te_running_sum(curve, chunks)
        t_ref, u_ref = ak.te_running_sum_plain(curve, chunks)
        results[f"te_running_sum S={steps}"] = max(
            max_abs_err(t_out, t_ref), max_abs_err(u_out, u_ref))

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

    # te_bucket_accumulate from init lanes (the sorted route chains a
    # window's runs through them): random lanes, identity lanes and lanes
    # of edge words, with runs and empty, where the init lane must come
    # back unchanged
    init = random_elems(fp, f, (lanes, 4), rng, dev)
    init[4] = ident
    init[9] = ident
    for k, v in enumerate((0, 1, f.p - 1)):
        init[6 + k] = fp.raw_words(f, v, dev).expand(4, nw)
        init[10 + k] = init[6 + k]
    init_counts = counts.clone()
    init_counts[[9, 10, 11, 12]] = 0      # identity and edge lanes, empty
    init_counts[[4, 6, 7, 8]] = 3         # identity and edge lanes, a run
    out = ak.te_bucket_accumulate(curve, rows, sign, starts, init_counts,
                                  init)
    results["te_bucket_accumulate init"] = max_abs_err(
        out, ak.te_bucket_accumulate_plain(curve, rows, sign, starts,
                                           init_counts, init))
    empty = init_counts == 0
    if not torch.equal(out[empty], init[empty]):
        raise AssertionError("te_bucket_accumulate changed the init lane of "
                             "an empty run")

    # te_gather_accumulate: two windows of lanes / 2 buckets over the same
    # rows as a point table, each window with its own permutation
    n_win = 2
    for k, v in enumerate((0, 1, f.p - 1)):   # edge rows: raw words
        rows[5 + k] = fp.raw_words(f, v, dev).expand(3, nw)
    gen = torch.Generator(device=dev).manual_seed(SEED + lanes)
    perm = torch.stack([torch.randperm(n_rows, generator=gen, device=dev)
                        for _ in range(n_win)])
    # runs that hold the edge rows and the identity row
    perm[:, 4:9] = torch.tensor([4, 5, 6, 7, 1], device=dev)
    perm[0, :2] = 3                       # one row twice in a run
    gsign = torch.randint(0, 2, (n_win, n_rows), generator=gen,
                          dtype=torch.int32, device=dev)
    counts = counts.reshape(n_win, -1).contiguous()
    counts[0, 2] = 1                      # a run of one
    starts = starts.reshape(n_win, -1).contiguous()
    out = ak.te_gather_accumulate(curve, rows, perm, gsign, starts, counts)
    results["te_gather_accumulate"] = max_abs_err(
        out, ak.te_gather_accumulate_plain(curve, rows, perm, gsign, starts,
                                           counts))
    torch.cuda.synchronize()
    for name, err in results.items():
        log(f"kernel vs plain, {lanes} random lanes: {name} "
            f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def check_combine(curve, dev):
    """Phase 3: te_combine == its plain version at every shape of
    COMBINE_CASES (random words; an identity lane, an identity on top, a
    lane of edge words 0, 1 and p-1)."""
    from zprize_tpu_torch.curve import te
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    f = curve.field
    nw = fp.n_words(f)
    rng = random.Random(SEED + 9)
    ident = te.pack(te.identity(curve, (), dev))
    results = {}
    for lanes, c, steps in COMBINE_CASES:
        ws = random_elems(fp, f, (steps, lanes, 4), rng, dev)
        if lanes > 1:
            ws[:, 1] = ident                       # an identity lane
        if lanes > 2:
            ws[-1, 2] = ident                      # identity on top
        if lanes > 3:
            for k, v in enumerate((0, 1, f.p - 1)):
                ws[k % steps, 3] = fp.raw_words(f, v, dev).expand(4, nw)
        results[f"te_combine lanes={lanes} c={c} steps={steps}"] = \
            max_abs_err(ak.te_combine(curve, ws, c),
                        ak.te_combine_plain(curve, ws, c))
    torch.cuda.synchronize()
    for name, err in results.items():
        log(f"kernel vs plain: {name} max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def check_tree_sum(curve, dev, group="te"):
    """Phase 3 (group "te": te_tree_sum) and 3e ("sw": sw_tree_sum with
    the curve's constants): the kernel == its plain version at every
    shape of TREE_CASES (random words; identity members, edge words 0, 1
    and p-1; for "sw" a member equal to its neighbour, so that the first
    step doubles), the root and every bit sum."""
    from zprize_tpu_torch.curve import sw, te
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    f = curve.field
    nw = fp.n_words(f)
    law, n_coords = (te, 4) if group == "te" else (sw, 3)
    name = f"{group}_tree_sum"
    kernel, plain = getattr(ak, name), getattr(ak, f"{name}_plain")
    rng = random.Random(SEED + 11 + curve.b * (group == "sw"))
    ident = law.pack(law.identity(curve, (), dev))
    results = {}
    for rows, k, first in TREE_CASES:
        pts = random_elems(fp, f, (rows, k, n_coords), rng, dev)
        if k > 2:
            pts[0, 1] = ident                      # an identity member
            for j, v in enumerate((0, 1, f.p - 1)):
                pts[-1, k - 1 - j] = fp.raw_words(f, v, dev).expand(
                    n_coords, nw)
        if group == "sw" and k > 4:
            pts[0, 3] = pts[0, 2]                  # P + P at step 0
        sums, bits = kernel(curve, pts, first)
        ref_sums, ref_bits = plain(curve, pts, first)
        err = max_abs_err(sums, ref_sums)
        if first is not None:
            err = max(err, max_abs_err(bits, ref_bits))
        results[f"{name} rows={rows} k={k} first={first}"] = err
    torch.cuda.synchronize()
    for label, err in results.items():
        log(f"{curve.name} kernel vs plain: {label} max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{label} disagrees with its plain version")


def chain_row(name, k_pair, run, plain, bound_of):
    """A probe's row: `run(k)` (one lane's chain of k dependent links)
    timed at both k of `k_pair`; the latency of a link is the slope
    between them (the launch's fixed cost drops out).  `run(k_pair[0])`
    is held against `plain(k_pair[0])`.  Returns (row, latency ms)."""
    ms = {k: timed(lambda: run(k), 5) for k in k_pair}
    k1, k2 = k_pair
    latency = (ms[k2] - ms[k1]) / (k2 - k1)
    t0 = time.time()
    ref = plain(k1)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_abs_err(run(k1), ref)
    if err != 0:
        raise AssertionError(f"{name} != plain")
    b_ms = bound_of(k1, latency)
    log(f"{name}: {ms} ms for k = {k_pair} dependent links on one thread: "
        f"{latency * 1e6:.3f} ns a link (plain {plain_ms:.1f} ms at the "
        f"first k, bound {b_ms:.6f} ms), kernel == plain")
    return {"name": name, "route": "cuda",
            "source": "zprize_tpu_torch/csrc/msm_te.cu",
            "replaces": "none: a measurement probe of the serial folds' "
                        "latency floors",
            "launches": None, "max_abs_err": err, "ms": ms[k1],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "latency",
            "library_ms": None, "lanes": 1, "k": k1,
            "ms_by_k": {str(k): v for k, v in ms.items()},
            "latency_ns": latency * 1e6}, latency


def latency_rows(curve, dev):
    """Phase 3: the rows of the two probes, imad_chain (bound: its own k
    IMADs at the latency it measures) and fq_mul_chain (bound: its k
    mulmods at MULMOD_IMAD_DEPTH IMADs each).  Returns (rows, {"imad":
    ms, "mulmod": ms}), the latencies of one dependent link."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import probe
    f = curve.field
    rng = random.Random(SEED + 10)
    words = torch.tensor([rng.randrange(-(1 << 31), 1 << 31)
                          for _ in range(3)], dtype=torch.int32)
    x, a, b = (w.reshape(1).to(dev) for w in words)
    k_check = IMAD_K[0] + 37           # the kernel's loop and its remainder
    imad_row, imad = chain_row(
        "imad_chain", IMAD_K, lambda k: probe.imad_chain(x, a, b, k),
        lambda k: probe.imad_chain_plain(x, a, b, k), lambda k, lat: k * lat)
    err = max_abs_err(probe.imad_chain(x, a, b, k_check),
                      probe.imad_chain_plain(x, a, b, k_check))
    if err != 0:
        raise AssertionError(f"imad_chain != plain at k = {k_check}")
    fx = random_elems(fp, f, (1, 1), rng, dev)[:, 0].contiguous()
    fy = random_elems(fp, f, (1, 1), rng, dev)[:, 0].contiguous()
    mul_row, mulmod = chain_row(
        "fq_mul_chain", MULMOD_K,
        lambda k: probe.fq_mul_chain(curve, fx, fy, k),
        lambda k: probe.fq_mul_chain_plain(curve, fx, fy, k),
        lambda k, lat: k * MULMOD_IMAD_DEPTH * imad)
    log(f"a mulmod on one thread takes {mulmod / imad:.1f} dependent IMADs' "
        f"time; the card's floor is {MULMOD_IMAD_DEPTH}")
    return [imad_row, mul_row], {"imad": imad, "mulmod": mulmod}


def check_sw_kernels(curve, dev, lanes):
    """Phase 3d: the four SW kernels == their plain versions, bit for bit,
    at `lanes` lanes with `curve`'s constants."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.utils import oracle
    f = curve.field
    nw = fp.n_words(f)
    rng = random.Random(SEED + lanes + curve.b)
    gen = torch.Generator(device=dev).manual_seed(SEED + lanes + curve.b)
    results = {}

    # points: 64 curve points (i+1)·G, then random words; edge rows
    n_pts = 4 * lanes
    chain = oracle.generator_chain(curve, 64)
    px = random_elems(fp, f, (n_pts,), rng, dev)
    py = random_elems(fp, f, (n_pts,), rng, dev)
    px[:64] = fp.from_ints(f, [q[0] for q in chain], dev)
    py[:64] = fp.from_ints(f, [q[1] for q in chain], dev)
    for k, v in enumerate((0, 1, f.p - 1)):
        px[64 + k] = py[64 + k] = fp.raw_words(f, v, dev)
    n_win = 2
    perm = torch.stack([torch.randperm(n_pts, generator=gen, device=dev)
                        for _ in range(n_win)])
    sign = torch.randint(0, 2, (n_win, n_pts), generator=gen,
                         dtype=torch.int32, device=dev)
    counts = torch.randint(0, 9, (n_win, lanes // 2), generator=gen,
                           dtype=torch.int64, device=dev)
    counts[:, 1] = 0                                 # empty runs
    counts[:, 2] = 1                                 # runs of one
    counts[:, 0] = 6
    starts = (torch.cumsum(counts, 1) - counts) % (n_pts - 8)
    starts[:, 0] = 0
    # window 0, bucket 0: P + P, then P + (-P), then the edge rows
    perm[0, :6] = torch.tensor([5, 5, 9, 9, 64, 66], device=dev)
    sign[0, :6] = torch.tensor([0, 0, 0, 1, 0, 1], dtype=torch.int32,
                               device=dev)
    out = ak.sw_gather_accumulate(curve, px, py, perm, sign, starts, counts)
    results["sw_gather_accumulate"] = max_abs_err(
        out, ak.sw_gather_accumulate_plain(curve, px, py, perm, sign, starts,
                                           counts))
    if max_abs_err(out[:, 1], sw.pack(sw.identity(curve, (n_win,), dev))):
        raise AssertionError("an empty run is not the identity (0 : 1 : 0)")

    # sw_full_add: accumulators and operands with every special lane
    acc = random_elems(fp, f, (lanes, 3), rng, dev)
    q = random_elems(fp, f, (lanes, 3), rng, dev)
    real = sw.pack(sw.from_affine(curve, sw.Affine(
        px[:8], py[:8], torch.zeros(8, dtype=torch.bool, device=dev))))
    ident = sw.pack(sw.identity(curve, (), dev))
    acc[:8], q[:8] = real, real.flip(0)
    acc[8], q[8] = real[0], real[0]                  # P + P
    acc[9] = real[1]                                 # P + (-P)
    q[9] = sw.pack(sw.neg(curve, sw.unpack(real[1])))
    acc[10], q[11] = ident, ident                    # identity lanes
    acc[12] = q[12] = ident
    for k, v in enumerate((0, 1, f.p - 1)):          # edge lanes
        acc[13 + k] = fp.raw_words(f, v, dev).expand(3, nw)
    skip = (torch.arange(lanes, device=dev) % 7 == 3).to(torch.int32)
    got = ak.sw_full_add(curve, acc.clone(), q, skip)
    ref = ak.sw_full_add_plain(curve, acc.clone(), q, skip)
    results["sw_full_add"] = max_abs_err(got, ref)
    doubled = acc.clone()
    ak.sw_full_add(curve, doubled, doubled, skip)    # acc + acc in place
    results["sw_full_add (acc + acc)"] = max_abs_err(
        doubled, ak.sw_full_add_plain(curve, acc.clone(), acc, skip))

    # sw_combine: S = 4 window sums a lane, c = 3, from the same lanes;
    # lane 8 adds a window sum equal to the accumulator (2^c W_3), lane 9
    # its negative, lanes 10-12 identities, 13-15 edge words
    steps, c = 4, 3
    ws = torch.stack([acc, q, acc.flip(0), q.flip(0)]).contiguous()
    top = sw.unpack(ws[-1, 8:10])
    for _ in range(c):
        top = sw.dbl(curve, top)
    ws[-2, 8] = sw.pack(top)[0]
    ws[-2, 9] = sw.pack(sw.neg(curve, top))[1]
    ws[:, 10] = ident                                # an identity lane
    ws[-1, 11] = ident                               # identity on top
    ws[0, 12] = ident
    for k, v in enumerate((0, 1, f.p - 1)):          # edge words
        ws[k, 13 + k] = fp.raw_words(f, v, dev).expand(3, nw)
    results[f"sw_combine S={steps} c={c}"] = max_abs_err(
        ak.sw_combine(curve, ws, c), ak.sw_combine_plain(curve, ws, c))

    # sw_running_sum: chunks of S points drawn from the same lanes; an
    # identity lane, a lane of one point repeated (the suffix sum doubles
    # at every step), a lane of P, -P, .. and a lane of edge values
    pool = torch.cat([acc, q])
    minus = sw.pack(sw.neg(curve, sw.unpack(real[1])))
    for steps in (8, 16):
        pick = torch.tensor([[rng.randrange(pool.shape[0])
                              for _ in range(steps)] for _ in range(lanes)],
                            device=dev)
        chunks = pool[pick]
        chunks[0] = ident
        chunks[1] = real[0]
        chunks[2] = torch.stack([real[1], minus] * (steps // 2))
        chunks[3] = acc[13 + torch.arange(steps, device=dev) % 3]
        t_out, u_out = ak.sw_running_sum(curve, chunks)
        t_ref, u_ref = ak.sw_running_sum_plain(curve, chunks)
        results[f"sw_running_sum S={steps}"] = max(
            max_abs_err(t_out, t_ref), max_abs_err(u_out, u_ref))
    torch.cuda.synchronize()
    for name, err in results.items():
        log(f"{curve.name} kernel vs plain, {lanes} lanes: {name} "
            f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def main_path(curve, dev):
    """Phase 4: init + warm-up + 4 timed MSMs, each oracle-checked."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import api
    from zprize_tpu_torch.utils import oracle
    n = 1 << N_LOG
    t0 = time.time()
    aff = tiled_points(curve, n, dev)
    log(f"base points: {N_BASE} x {n // N_BASE} in {time.time() - t0:.3f} s")
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

    t0 = time.time()
    res = api.multi_scalar_mult(ctx, batches[0])[0]
    log(f"warm-up MSM: {time.time() - t0:.3f} s (host clock)")
    check_tiled(curve, res, batches[0], "warm-up")
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
        check_tiled(curve, res, batches[k], f"batch {k}")
        log(f"batch {k}: {times[-1]:.3f} ms, result verified")
    launches = dict(ak.launches)
    missing = [name for name in COLLAPSED_ROUTE if launches[name] == 0]
    if (missing or launches["te_gather_accumulate"]
            or launches["te_full_add"]):
        raise AssertionError(f"main path launched no {missing}, or the m = 1"
                             " route's te_gather_accumulate, or te_full_add")
    if init_launches["te_dbl_chain"] == 0 or 0 in (
            per_msm["te_bucket_accumulate"], per_msm["te_tree_sum"],
            per_msm["te_running_sum"], per_msm["te_combine"]) or \
            per_msm["te_tree_sum"] > TREE_LAUNCHES_PER_MSM:
        raise AssertionError(f"init {init_launches} / MSM {per_msm} "
                             "launches miss a kernel, or the trees take more "
                             f"than {TREE_LAUNCHES_PER_MSM} launches")
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


def prize_path(curve, dev):
    """Phase 4b: the prize configuration on the m = 1 route: init + a
    warm-up + BATCHES timed MSMs at 2^26, each oracle-checked, then the
    skewed m = 1 run at 2^12.  Batches are drawn one at a time and
    dropped after their check."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import api, pippenger
    from zprize_tpu_torch.utils import oracle
    n = 1 << PRIZE_LOG
    aff = tiled_points(curve, n, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + PRIZE_LOG)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ak.reset_launches()
    t0 = time.time()
    ctx = api.multi_scalar_mult_init(curve, aff, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    del aff
    init_launches = dict(ak.launches)
    p = ctx.prepared
    log(f"2^{PRIZE_LOG} init: {init_s:.3f} s, plan c={p.c} g={p.g} m={p.m}, "
        f"table {p.table.numel() * 4 / 1e9:.3f} GB, launches "
        f"{init_launches}")
    if (p.c, p.g, p.m) != (17, 16, 1) or any(init_launches.values()):
        raise AssertionError("the 2^26 init did not take the m = 1 plan")

    # the batches are drawn on the card from a seed (drawing 2^26 x 17
    # limbs with numpy takes about a minute a batch) and copied to the
    # host for the oracle; the warm-up goes through the API as a host
    # uint16 batch, the timed ones as int16 tensors already on the card
    t0 = time.time()
    batch = oracle.scalar_batch_torch(curve, n, gen).cpu().numpy().view(
        np.uint16)
    gen_s = time.time() - t0
    t0 = time.time()
    res = api.multi_scalar_mult(ctx, batch)[0]
    log(f"2^{PRIZE_LOG} warm-up MSM: {time.time() - t0:.3f} s (host clock, "
        f"upload included); batch made in {gen_s:.1f} s")
    check_tiled(curve, res, batch, f"2^{PRIZE_LOG} warm-up")
    times, per_msm = [], []
    for k in range(1, BATCHES + 1):
        s = oracle.scalar_batch_torch(curve, n, gen)
        torch.cuda.synchronize()
        before = dict(ak.launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = api.multi_scalar_mult(ctx, s)[0]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        per_msm.append({name: ak.launches[name] - before[name]
                        for name in ak.KERNELS})
        batch = s.cpu().numpy().view(np.uint16)
        del s
        check_tiled(curve, res, batch, f"2^{PRIZE_LOG} batch {k}")
        log(f"2^{PRIZE_LOG} batch {k}: {times[-1]:.3f} ms, result verified, "
            f"launches {per_msm[-1]}")
    launches = dict(ak.launches)
    for k, launched in enumerate(per_msm, 1):
        if (0 in (launched["te_gather_accumulate"], launched["te_tree_sum"],
                  launched["te_running_sum"], launched["te_combine"])
                or launched["te_tree_sum"] > TREE_LAUNCHES_PER_MSM
                or launched["te_full_add"] or launched["te_bucket_accumulate"]
                or launched["te_dbl_chain"]):
            raise AssertionError(f"2^{PRIZE_LOG} MSM {k} launches {launched}"
                                 " are not the m = 1 route's")
    # the merges' launches: the trees, the running sums and the merge
    # tails' folds (the final combine is the fourth te_combine)
    merge_launches = (per_msm[-1]["te_tree_sum"]
                      + per_msm[-1]["te_running_sum"]
                      + per_msm[-1]["te_combine"] - 1)
    log(f"2^{PRIZE_LOG} MSM merges: te_tree_sum {per_msm[-1]['te_tree_sum']}"
        f" + te_running_sum {per_msm[-1]['te_running_sum']} + te_combine "
        f"{per_msm[-1]['te_combine'] - 1} launches (te_full_add "
        f"{per_msm[-1]['te_full_add']})")
    peak = torch.cuda.max_memory_allocated()
    n_win = pippenger.num_windows(curve, p.c)
    in_flight = {nbe: pippenger.windows_in_flight(n, nbe, len(ws), dev)
                 for nbe, ws in pippenger.window_groups(
                     curve, p.c, n_win, 1 << (p.c - 1)).items()}
    mean = sum(times) / len(times)
    summary = {
        "metric": f"bls12_377_msm_2^{PRIZE_LOG}",
        "n": n, "c": p.c, "g": p.g, "m": p.m,
        "msm_ms": times, "msm_ms_mean": mean,
        "points_per_s": n / (mean / 1e3),
        "init_s": init_s,
        "windows_in_flight": in_flight,
        "max_memory_allocated": peak,
        "launches_init": init_launches,
        "launches_per_msm": per_msm[-1],
        "merge_launches_per_msm": merge_launches,
        "oracle_checked_batches": BATCHES + 1,
        "scalar_batch_host_s": gen_s,
    }
    summary["skewed_2^12"] = skewed_run(curve, dev, "m = 1", collapse=False)
    return ctx, batch, launches, summary


def skewed_run(curve, dev, route, **init):
    """A 2^SKEW_LOG run with skewed scalars (all equal; half zero, half
    equal), every point of a window in one bucket, oracle-checked; `init`
    goes to `multi_scalar_mult_init` (collapse=False: the m = 1 route)."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.msm import api
    from zprize_tpu_torch.utils import oracle
    n = 1 << SKEW_LOG
    pts = oracle.generator_chain(curve, n)
    one = oracle.scalar_batch_np(curve, np.random.default_rng(SEED), 1)[0]
    batch = np.stack([np.tile(one, (n, 1))] * 2)
    batch[1, ::2] = 0
    ctx = api.multi_scalar_mult_init(curve, pts, device=dev, **init)
    torch.cuda.synchronize()
    t0 = time.time()
    res = api.multi_scalar_mult(ctx, batch)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / 2
    k = sum(int(v) << (15 * j) for j, v in enumerate(one))
    for name, r, idx in (("all equal", res[0], range(n)),
                         ("half zero", res[1], range(1, n, 2))):
        exp = oracle.ec_mul(oracle.generator(curve),
                            k * sum(i + 1 for i in idx) % curve.order,
                            curve.field.p)
        if sw.to_affine_ints(curve, r) != exp:
            raise AssertionError(f"skewed {route} 2^{SKEW_LOG} run ({name}) "
                                 "!= oracle")
    log(f"skewed {route} run at 2^{SKEW_LOG} (c = {ctx.prepared.c}): all "
        f"equal and half zero verified, {ms:.1f} ms per MSM (host clock)")
    return {"n": n, "c": ctx.prepared.c, "ms_per_msm_host": ms,
            "verified": 2}


def timed_msm(ctx, s):
    """One `multi_scalar_mult` call on scalars already on the card: the
    result, its device ms (CUDA events) and the launches it made."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import api
    torch.cuda.synchronize()
    before = dict(ak.launches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = api.multi_scalar_mult(ctx, s)[0]
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end), {
        name: ak.launches[name] - before[name] for name in ak.KERNELS}


def route_ab(curve, ctx, accum, draw, timed_batches, check_launches):
    """The other accumulate `accum` on ctx's table (the context with
    `accum` set, sharing the table) against ctx's default route, in one
    process: a warm-up of `accum` on draw(0) (its peak device memory read
    from a reset just before it), then for each of `timed_batches`
    batches draw(k) both routes, the default first on odd k and `accum`
    first on even k (default, accum, accum, default, ...).  draw(k) gives
    a scalar batch on the card (int16 compact form); every result of
    either route is held against the python-int oracle, and every MSM of
    `accum` against check_launches(launches), which raises.  Returns the
    summary and the last batch on the host."""
    import dataclasses
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.msm import pippenger
    from zprize_tpu_torch.utils import oracle
    alt = dataclasses.replace(ctx, accum=accum)
    default = pippenger.accum_route(ctx.prepared, ctx.accum)
    n = ctx.prepared.n
    label = f"2^{n.bit_length() - 1} accum={accum}"
    times = {default: [], accum: []}
    per_msm = {}

    def run(route, ctx_r, s, expect, k):
        res, ms, launched = timed_msm(ctx_r, s)
        if sw.to_affine_ints(curve, res) != expect:
            raise AssertionError(f"{label} batch {k}: the {route} route's "
                                 "MSM != oracle")
        if route == accum:
            check_launches(launched)
        per_msm[route] = launched
        return ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in range(timed_batches + 1):
        s = draw(k)
        host = s.cpu().numpy().view(np.uint16)
        expect = oracle.chain_msm(curve, oracle.oracle_agg(curve, host,
                                                           N_BASE))
        if k == 0:
            warm_ms = run(accum, alt, s, expect, k)
            peak = torch.cuda.max_memory_allocated()
            continue
        order = ((default, ctx), (accum, alt))
        for route, ctx_r in order if k % 2 else order[::-1]:
            times[route].append(run(route, ctx_r, s, expect, k))
        log(f"{label} batch {k}: {accum} {times[accum][-1]:.3f} ms, "
            f"{default} (default) {times[default][-1]:.3f} ms, both "
            "verified")
        del s
    means = {r: sum(t) / len(t) for r, t in times.items()}
    summary = {
        "metric": f"bls12_377_msm_2^{n.bit_length() - 1}_{accum}",
        "n": n, "accum": accum, "c": ctx.prepared.c, "g": ctx.prepared.g,
        "m": ctx.prepared.m,
        "msm_ms": times[accum], "msm_ms_mean": means[accum],
        "points_per_s": n / (means[accum] / 1e3),
        "warm_up_ms": warm_ms,
        "max_memory_allocated_warm_up": peak,
        "launches_per_msm": per_msm[accum],
        "default_accum": default,
        "default_msm_ms": times[default],
        "default_msm_ms_mean": means[default],
        "default_points_per_s": n / (means[default] / 1e3),
        "default_launches_per_msm": per_msm[default],
        "order": "default, accum, accum, default, ... (one process)",
        "oracle_checked_batches": 2 * timed_batches + 1,
    }
    log(f"{label}: {means[accum]:.3f} ms an MSM against the default "
        f"{default} route's {means[default]:.3f} ms")
    return summary, host


def collapsed_gather_path(curve, ctx, dev):
    """Phase 4, the collapsed gather route (accum="gather" on phase 4's
    table): a warm-up and BATCHES timed batches against the default
    (sorted) route, each MSM launching te_gather_accumulate once and
    te_bucket_accumulate never; then te_gather_accumulate at the route's
    shape (the m*n table rows through the permutation, g windows of
    2^(c-1) buckets, one launch), timed beside its plain version and its
    bound and checked against the plain version."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger
    from zprize_tpu_torch.utils import oracle
    n = ctx.prepared.n
    rng = np.random.default_rng(SEED + 1)

    def draw(k):
        return torch.from_numpy(oracle.scalar_batch_np(curve, rng, n).view(
            np.int16)).to(dev)

    def check(launched):
        if (launched["te_gather_accumulate"] != 1
                or launched["te_bucket_accumulate"]
                or launched["te_dbl_chain"]):
            raise AssertionError(f"collapsed gather MSM launches {launched}")

    summary, host = route_ab(curve, ctx, "gather", draw, BATCHES, check)
    p = ctx.prepared
    s = torch.from_numpy(host.view(np.int16)).to(dev)
    runs = pippenger.sort_windows(
        pippenger.collapsed_digits(curve, p, ctx.points.inf, s).to(
            torch.int32), 1 << (p.c - 1))
    shape = accumulate_shape(
        curve, "te_gather_accumulate",
        lambda: ak.te_gather_accumulate(curve, p.table, *runs),
        lambda: ak.te_gather_accumulate_plain(curve, p.table, *runs),
        int(runs[3].sum()), 8 + 4, p.g * (1 << (p.c - 1)), 0,
        table_rows=p.m * p.n, windows=p.g, buckets=1 << (p.c - 1),
        launches_per_msm=summary["launches_per_msm"]["te_gather_accumulate"])
    return summary, shape


def sorted_streamed_path(curve, ctx, dev):
    """Phase 4b, the m = 1 sorted route (accum="sorted" on phase 4b's
    table): a warm-up (its peak memory) and SORTED_BATCHES timed batches
    against the default (gather) route, each MSM launching
    te_bucket_accumulate n_win x ceil(n / sort_run) times and neither
    te_gather_accumulate nor te_dbl_chain; one profiled MSM; then
    te_bucket_accumulate at the route's shape (window 0's second run of
    sort_run rows over 2^(c-1) buckets, from the first run's sums),
    timed beside its plain version and its bound and checked against the
    plain version."""
    import dataclasses
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger, te_path
    from zprize_tpu_torch.utils import oracle
    p = ctx.prepared
    run = ctx.sort_run
    gen = torch.Generator(device=dev).manual_seed(SEED + PRIZE_LOG + 1)
    n_win = pippenger.num_windows(curve, p.c)
    per_msm = n_win * -(-p.n // run)
    # the merge of all windows at full width: a running sum where the
    # stack splits (at 2^26: 16 x 2^16 buckets)
    merges = ("te_tree_sum", "te_combine") + (
        ("te_running_sum",) if te_path.triangle_split(n_win, 1 << (p.c - 1))
        else ())

    def check(launched):
        if (launched["te_bucket_accumulate"] != per_msm
                or launched["te_gather_accumulate"]
                or launched["te_dbl_chain"]
                or 0 in (launched[name] for name in merges)):
            raise AssertionError(f"sorted 2^{PRIZE_LOG} MSM launches "
                                 f"{launched}, not {per_msm} "
                                 "te_bucket_accumulate and the merges")

    summary, host = route_ab(
        curve, ctx, "sorted",
        lambda k: oracle.scalar_batch_torch(curve, p.n, gen),
        SORTED_BATCHES, check)
    summary["sort_run"] = run
    summary["profile"] = profile_msm(dataclasses.replace(ctx, accum="sorted"),
                                     host)
    s = torch.from_numpy(host.view(np.int16)).to(dev)
    del host
    nbe = 1 << (p.c - 1)
    digits, _ = pippenger.signed_digits_range(
        curve, p.c, 0, 1, s.t().contiguous(),
        torch.zeros(p.n, dtype=torch.int32, device=dev))
    del s
    lo = run if p.n >= 2 * run else 0

    def run_inputs(lo):
        perm, sign, starts, counts = pippenger.sort_windows(
            digits[:, lo:lo + run], nbe)
        return p.table[lo:lo + run][perm[0]], sign[0], starts[0], counts[0]

    init = ak.te_bucket_accumulate(curve, *run_inputs(0))
    args = run_inputs(lo)
    del digits
    shape = accumulate_shape(
        curve, "te_bucket_accumulate",
        lambda: ak.te_bucket_accumulate(curve, *args, init),
        lambda: ak.te_bucket_accumulate_plain(curve, *args, init),
        int(args[3].sum()), 4, nbe, 1, rows=args[0].shape[0],
        buckets=nbe, init=True, launches_per_msm=per_msm)
    return summary, shape


def accumulate_shape(curve, name, fn, plain, n_rows, row_extra_bytes,
                     lanes, init_reads, **shape):
    """An accumulate kernel at one route's shape: fn() timed (mean of 3
    after a warm-up), plain() once, and the two held equal.  Bound:
    n_rows mixed adds, against the bytes of n_rows operand rows (with
    `row_extra_bytes` of index and sign each), and per lane its run's
    bounds (16 bytes), its sum written and `init_reads` sums read."""
    from zprize_tpu_torch.field import fp
    nw = fp.n_words(curve.field)
    ms = timed(fn, 3)
    t0 = time.time()
    ref = plain()
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_abs_err(fn(), ref)
    if err != 0:
        raise AssertionError(f"{name} != plain at {shape}")
    b_ms, b_by = bound_ms(n_rows * MULMODS["madd"],
                          n_rows * (3 * 4 * nw + row_extra_bytes)
                          + lanes * (16 + (1 + init_reads) * 4 * 4 * nw))
    log(f"{name} at {shape}: {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}), kernel == plain")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "library_ms": None,
            "rows_in_buckets": n_rows, **shape}


def tiled_points(curve, n, dev):
    """N_BASE distinct points (i+1)·G tiled to n, as affine planes."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.utils import oracle
    f = curve.field
    base = oracle.generator_chain(curve, N_BASE)
    reps = n // N_BASE
    return sw.Affine(
        fp.from_ints(f, [p[0] for p in base], dev).repeat(reps, 1),
        fp.from_ints(f, [p[1] for p in base], dev).repeat(reps, 1),
        torch.zeros(n, dtype=torch.bool, device=dev))


def check_tiled(curve, res, batch, label):
    """res (an SW point) == the oracle's MSM of `batch` over the tiled
    base set."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.utils import oracle
    exp = oracle.chain_msm(curve, oracle.oracle_agg(curve, batch, N_BASE))
    if sw.to_affine_ints(curve, res) != exp:
        raise AssertionError(f"{label}: MSM result != oracle")


def lane(p, i):
    """Lane i of a lane-batched point."""
    from zprize_tpu_torch.curve import sw
    return sw.Point(*(a[i] for a in p))


def sw_path(dev):
    """Phase 9: the SW route at 2^18 on BLS12-381 (init, warm-up and
    BATCHES timed MSMs, each oracle-checked; the main path's launch
    check), then BLS12-377 with te=False against the oracle and the TE
    route, a skewed 2^12 run, the batched forms and the occupancy guard."""
    from zprize_tpu_torch.curve.spec import BLS12_381_G1
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import api, pippenger
    from zprize_tpu_torch.ntt import fr_kernel, gl_kernel
    from zprize_tpu_torch.utils import oracle
    curve = BLS12_381_G1
    n = 1 << SW_LOG
    aff = tiled_points(curve, n, dev)
    rng = np.random.default_rng(SEED + 381)
    batches = [oracle.scalar_batch_np(curve, rng, n)
               for _ in range(BATCHES + 1)]

    def all_launches():
        return {**ak.launches, **fr_kernel.launches, **gl_kernel.launches}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ak.reset_launches()
    fr_kernel.reset_launches()
    gl_kernel.reset_launches()
    t0 = time.time()
    ctx = api.multi_scalar_mult_init(curve, aff, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    p = ctx.prepared
    if (not isinstance(p, pippenger.PreparedSw)
            or p.c != pippenger.default_window_bits(n)):
        raise AssertionError(f"BLS12-381 init took {type(p).__name__}, "
                             f"c = {p.c}")
    t0 = time.time()
    res = api.multi_scalar_mult(ctx, batches[0])[0]
    log(f"bls12_381 2^{SW_LOG}: init {init_s:.3f} s (c = {p.c}), warm-up "
        f"MSM {time.time() - t0:.3f} s (host clock)")
    check_tiled(curve, res, batches[0], "bls12_381 warm-up")
    times, per_msm = [], []
    for k in range(1, BATCHES + 1):
        s = torch.from_numpy(batches[k].view(np.int16)).to(dev)
        torch.cuda.synchronize()
        before = all_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = api.multi_scalar_mult(ctx, s)[0]
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        per_msm.append({name: v - before[name]
                        for name, v in all_launches().items()})
        check_tiled(curve, res, batches[k], f"bls12_381 batch {k}")
        log(f"bls12_381 2^{SW_LOG} batch {k}: {times[-1]:.3f} ms, result "
            f"verified, launches {per_msm[-1]}")
    launches = all_launches()
    # every SW kernel but sw_full_add, whose trees sw_tree_sum took over
    route = [name for name in ak.SW_KERNELS if name != "sw_full_add"]
    for k, launched in enumerate(per_msm, 1):
        stray = {name: v for name, v in launched.items()
                 if v and name not in route}
        if stray or 0 in (launched[name] for name in route):
            raise AssertionError(f"bls12_381 MSM {k} launches {launched} "
                                 "are not the SW route's")
    log(f"bls12_381 2^{SW_LOG} MSM: sw_tree_sum "
        f"{per_msm[-1]['sw_tree_sum']}, sw_full_add "
        f"{per_msm[-1]['sw_full_add']}, sw_running_sum "
        f"{per_msm[-1]['sw_running_sum']}, sw_combine "
        f"{per_msm[-1]['sw_combine']} launches")
    mean = sum(times) / len(times)
    summary = {
        "metric": f"bls12_381_msm_2^{SW_LOG}",
        "n": n, "c": p.c, "route": "sw",
        "msm_ms": times, "msm_ms_mean": mean,
        "points_per_s": n / (mean / 1e3),
        "init_s": init_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches_per_msm": per_msm[-1],
        "sw_full_add_per_msm": [m["sw_full_add"] for m in per_msm],
        "sw_tree_sum_per_msm": [m["sw_tree_sum"] for m in per_msm],
        "oracle_checked_batches": BATCHES + 1,
    }
    summary["bls12_377_sw"] = bls377_sw_vs_te(dev)
    summary["skewed_2^12"] = skewed_run(curve, dev, "SW")
    summary["batched"] = batched_forms(curve, dev)
    return ctx, aff, batches[1], launches, summary


def bls377_sw_vs_te(dev):
    """BLS12-377 at 2^SW_LOG on the SW route (te=False): one batch against
    the oracle and against the TE route's result for the same batch."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.curve.spec import BLS12_377_G1 as curve
    from zprize_tpu_torch.msm import api, pippenger
    from zprize_tpu_torch.utils import oracle
    n = 1 << SW_LOG
    aff = tiled_points(curve, n, dev)
    batch = oracle.scalar_batch_np(curve, np.random.default_rng(SEED + 377),
                                   n)
    ctx = api.multi_scalar_mult_init(curve, aff, device=dev, te=False)
    if not isinstance(ctx.prepared, pippenger.PreparedSw):
        raise AssertionError("te=False did not take the SW route")
    c_sw = ctx.prepared.c
    torch.cuda.synchronize()
    t0 = time.time()
    res_sw = api.multi_scalar_mult(ctx, batch)[0]
    torch.cuda.synchronize()
    sw_ms = (time.time() - t0) * 1e3
    check_tiled(curve, res_sw, batch, "bls12_377 te=False")
    del ctx
    ctx = api.multi_scalar_mult_init(curve, aff, device=dev)
    res_te = api.multi_scalar_mult(ctx, batch)[0]
    if sw.to_affine_ints(curve, res_sw) != sw.to_affine_ints(curve, res_te):
        raise AssertionError("bls12_377: the SW route != the TE route")
    log(f"bls12_377 2^{SW_LOG} with te=False (c = {c_sw}; the TE route's "
        f"plan c = {ctx.prepared.c}): == oracle == TE route ({sw_ms:.1f} ms "
        "host clock)")
    return {"n": n, "sw_ms_host": sw_ms, "equals_oracle": True,
            "equals_te_route": True}


def batched_forms(curve, dev):
    """msm_jit_batch (B x 2^16) == single MSMs and the oracle; commit_batch
    on a test SRS == commit row by row and python ints; msm_jit_static
    with a too-small cap on equal scalars raises naming the occupancy."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import pippenger
    from zprize_tpu_torch.pcs import kzg
    from zprize_tpu_torch.utils import oracle
    n = 1 << SW_BATCH_LOG
    aff = tiled_points(curve, n, dev)
    rng = np.random.default_rng(SEED + SW_BATCH_LOG)
    batch = np.stack([oracle.scalar_batch_np(curve, rng, n)
                      for _ in range(SW_BATCH)])
    c = pippenger.default_window_bits(n)
    s = torch.from_numpy(batch.view(np.int16)).to(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    out = pippenger.msm_jit_batch(curve, aff, s, c, n)
    torch.cuda.synchronize()
    batch_ms = (time.time() - t0) * 1e3
    prep = pippenger.prepare_points(curve, aff)
    for b in range(SW_BATCH):
        single = pippenger.msm(curve, aff, s[b], prepared=prep)
        if (sw.to_affine_ints(curve, lane(out, b))
                != sw.to_affine_ints(curve, single)):
            raise AssertionError(f"msm_jit_batch row {b} != a single MSM")
        check_tiled(curve, single, batch[b], f"msm_jit_batch row {b}")
    log(f"msm_jit_batch {SW_BATCH} x 2^{SW_BATCH_LOG}: == {SW_BATCH} single "
        f"MSMs == oracle ({batch_ms:.1f} ms host clock)")

    t0 = time.time()
    srs = kzg.setup_test_srs(curve, 1 << SW_SRS_LOG, seed=5, device=dev)
    torch.cuda.synchronize()
    srs_s = time.time() - t0
    m = (1 << SW_SRS_LOG) - 3
    prng = random.Random(SEED)
    rows = [[prng.randrange(curve.order) for _ in range(m)]
            for _ in range(SW_BATCH)]
    coeffs = fp.from_ints(curve.scalar, rows, dev)
    coms = kzg.commit_batch(srs, coeffs)
    for b in range(SW_BATCH):
        got = kzg.point_ints(curve, lane(coms, b))
        if got != kzg.point_ints(curve, kzg.commit(srs, coeffs[b])):
            raise AssertionError(f"commit_batch row {b} != commit")
    k = sum(v * pow(srs.tau, i, curve.order)
            for i, v in enumerate(rows[0])) % curve.order
    if kzg.point_ints(curve, lane(coms, 0)) != oracle.ec_mul(
            oracle.generator(curve), k, curve.field.p):
        raise AssertionError("commit_batch row 0 != python ints")
    log(f"commit_batch {SW_BATCH} x {m} on a BLS12-381 SRS of 2^{SW_SRS_LOG} "
        f"(built in {srs_s:.2f} s): == commit row by row == python ints")

    equal = torch.from_numpy(np.tile(batch[0, :1], (n, 1)).view(
        np.int16)).to(dev)
    try:
        pippenger.msm_jit_static(curve, aff, equal, c, n // 16)
    except RuntimeError as exc:
        if "occupancy" not in str(exc):
            raise
        log(f"msm_jit_static, equal scalars, cap_total {n // 16}: raised "
            f"({exc})")
    else:
        raise AssertionError("msm_jit_static did not refuse an occupancy "
                             "over cap_total")
    return {"msm_jit_batch": [SW_BATCH, n], "batch_ms_host": batch_ms,
            "commit_batch": [SW_BATCH, m], "srs_size": 1 << SW_SRS_LOG,
            "srs_s": srs_s, "occupancy_guard": True}


def port_launches():
    """Every port kernel's launch count so far."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.ntt import fr_kernel, gl_kernel
    return {**ak.launches, **fr_kernel.launches, **gl_kernel.launches}


def device_kernels(prof):
    """(ms, launches, name) of every device kernel, copy and memset in a
    finished torch.profiler trace, summed by name.  Device-side events
    only: an aten op's own entry would count its kernels' time a second
    time."""
    from torch.autograd import DeviceType
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ms, n = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(ms, n, name) for name, (ms, n) in sums.items()]


def device_span_ms(prof):
    """[first start, last end] of the device events a finished trace kept,
    in ms from the trace's first host event, or None without them."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    dev = [(e.start_ns(), e.duration_ns()) for e in events
           if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    host = [e.start_ns() for e in events
            if e.device_type() != DeviceType.CUDA]
    if not dev:
        return None
    origin = min(host) if host else min(t for t, _ in dev)
    return [(min(t for t, _ in dev) - origin) / 1e6,
            (max(t + d for t, d in dev) - origin) / 1e6]


def profile_call(label, fn, host_ops=True):
    """One call of fn under torch.profiler (after one unprofiled call):
    device time by kernel and the device busy share of the call's wall
    time.  The trace can miss device events (seen late in a run, after
    the large profiles: none, or half, of a short window's kernels; and
    early, one kernel of 16 in a window of 0.05 s margins), so the port's
    kernels in the trace are held against their launch counts in the same
    window; a window that falls short is profiled again with the next,
    wider margin of TRACE_MARGINS_S, each short attempt is logged with the
    host-clock span of the device events it kept, and the result says
    whether it was complete.  With `host_ops` False only the device is
    traced (the host ops of a call of some 10^5 torch ops, a PoSW batch,
    stretch its wall time).  The device events are summed by kernel name
    from the profiler's raw events: torch's own summary (`key_averages`)
    first builds its event tree, some 45 s for a PoSW batch's 2 x 10^5
    device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    short = []
    for attempt, margin in enumerate(TRACE_MARGINS_S, 1):
        before = port_launches()
        with profile(activities=[ProfilerActivity.CPU] * host_ops
                     + [ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
            time.sleep(margin)
        launched = {k: v - before[k] for k, v in port_launches().items()
                    if v > before[k]}
        by_kernel = device_kernels(prof)
        # a wrapper's launch runs at least one kernel of its symbols
        traced = {name: sum(n for _, n, k in by_kernel
                            if any(s in k for s in KERNEL_SYMBOLS[name]))
                  for name in launched}
        complete = bool(by_kernel) and all(
            traced[name] >= launched[name] for name in launched)
        if complete:
            break
        span = device_span_ms(prof)
        short.append({"margin_s": margin, "traced": traced,
                      "device_span_ms": span})
        log(f"profiled {label}: attempt {attempt} at a {margin} s margin "
            f"traced {traced} of {launched}; device events span {span} ms "
            "of the window")
    by_kernel.sort(reverse=True)
    busy = sum(ms for ms, _, _ in by_kernel)
    # device ms of the port's kernels (by their CUDA symbols); the rest is
    # torch ops: the plain engine's glue, sorts, gathers and copies
    ports = {name: sum(ms for ms, _, k in by_kernel
                       if any(s in k for s in symbols))
             for name, symbols in KERNEL_SYMBOLS.items()}
    # device work of no port kernel (torch ops, copies, memsets)
    others = sorted({k[:90] for _, _, k in by_kernel
                     if not any(s in k for symbols in KERNEL_SYMBOLS.values()
                                for s in symbols)})
    out = {"profile_wall_ms": wall_ms, "attempts": attempt,
           "margin_s": margin, "short_attempts": short,
           "complete": complete, "launched": launched, "traced": traced,
           "device_busy_ms": busy if by_kernel else "not measured",
           "device_idle_share": (1 - busy / wall_ms) if complete
           else "not measured",
           "port_kernels_ms": ports,
           "torch_ops_ms": busy - sum(ports.values()),
           "other_kernels": others,
           "by_kernel": [{"name": k[:90], "ms": ms, "calls": n}
                         for ms, n, k in by_kernel[:14]]}
    log(f"profiled {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, of it the port's kernels {ports}; launched "
        f"{launched}, traced {traced}, attempt {attempt}"
        f"{'' if complete else ', INCOMPLETE trace'}")
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
    s = torch.from_numpy(batch.view(np.int16)).to(ctx.device)
    return profile_call(f"MSM at {ctx.prepared.n} points",
                        lambda: api.multi_scalar_mult(ctx, s))


def kernel_rows(curve, ctx, aff, batch, launches, lat, dev):
    """Phase 5: each kernel at the main path's shapes, timed, beside its
    plain version and its bound, and checked against the plain version;
    te_combine's bound is `fold_bound` with the probes' latencies `lat`."""
    from zprize_tpu_torch.curve import te
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger, probe, te_path
    f = curve.field
    p = ctx.prepared
    pt_bytes = 4 * 4 * fp.n_words(f)
    pre_bytes = 3 * 4 * fp.n_words(f)
    rows = []
    ak.reset_launches()

    def row(name, replaces, fn, plain, reps, mulmods, n_bytes, depth=None):
        ms = timed(fn, reps)
        t0 = time.time()
        ref = plain()
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = max_abs_err(fn(), ref)
        if err != 0:
            raise AssertionError(f"{name} != plain at main-path shapes")
        extra = {}
        if depth is None:
            b_ms, b_by = bound_ms(mulmods, n_bytes)
        else:
            b_ms, b_by, extra = fold_bound(depth, lat, mulmods, n_bytes)
        rows.append({"name": name, "route": "cuda",
                     "source": "zprize_tpu_torch/csrc/msm_te.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, **extra})
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

    c_lanes, _ = te_path.triangle_split(p.g, nbe)

    # te_combine: the merge tail's c=1 fold over the chunk-weight bits: g
    # lanes of a serial fold, bound by the latency of its chain
    n_bits = max(1, (c_lanes - 1).bit_length())
    ws = sums[:n_bits * p.g].reshape(n_bits, p.g, 4, -1).contiguous()
    row("te_combine", "zprize_tpu/msm/accum_kernel.py:997",
        lambda: ak.te_combine(curve, ws, 1),
        lambda: ak.te_combine_plain(curve, ws, 1), 20,
        p.g * (n_bits - 1) * (MULMODS["dbl"] + MULMODS["add"]),
        (n_bits + 1) * p.g * pt_bytes,
        depth=probe.te_combine_depth(n_bits, 1))
    rows[-1].update(lanes=p.g, steps=n_bits, c=1)
    return rows


def prize_rows(curve, ctx, batch, launches, per_msm, lat, dev):
    """The rows of the 2^26 path's kernels at the launches the path makes,
    each timed beside its plain version and its bound and checked against
    the plain version: te_gather_accumulate over the full windows of a
    2^26 batch in one launch (as many as `windows_in_flight` allows; 15
    when the card has room), and window 0 alone for continuity with the
    earlier rows; te_running_sum over the triangle merge's chunks of those
    bucket sums; te_tree_sum at the merges' trees (`tree_row`); te_combine
    at the final window
    combine's shape (16 steps at c = 17, one lane; bound: `fold_bound`
    with the probes' latencies `lat`).  The plain gather over all the
    windows would take many minutes, so it runs on window 0: the launch's
    lanes of window 0 are held against it, and its time is window 0's."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger, te_path
    p = ctx.prepared
    nw = fp.n_words(curve.field)
    pt_bytes = 4 * 4 * nw
    nbe = 1 << (p.c - 1)
    n_full = len(pippenger.window_groups(
        curve, p.c, pippenger.num_windows(curve, p.c), nbe)[nbe])
    limbs = torch.from_numpy(batch.view(np.int16)).to(dev).t().contiguous()
    carry = torch.zeros(p.n, dtype=torch.int32, device=dev)
    n_win = pippenger.windows_in_flight(p.n, nbe, n_full, dev)
    digits, _ = pippenger.signed_digits_range(curve, p.c, 0, n_win, limbs,
                                              carry)
    del limbs, carry
    runs = pippenger.sort_windows(digits, nbe)
    del digits
    one = [r[:1] for r in runs]                    # window 0 alone
    rows = []

    def row(name, replaces, fn, plain, ref_of, reps, mulmods, n_bytes,
            **shape):
        ms = timed(fn, reps)
        t0 = time.time()
        ref = plain()
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        out = fn()
        err = max(max_abs_err(ref_of(o), r) for o, r in zip(
            out if isinstance(out, tuple) else (out,),
            ref if isinstance(ref, tuple) else (ref,)))
        if err != 0:
            raise AssertionError(f"{name} != plain at the 2^{PRIZE_LOG} "
                                 "path's shapes")
        b_ms, b_by = bound_ms(mulmods, n_bytes)
        rows.append({"name": name, "route": "cuda",
                     "source": "zprize_tpu_torch/csrc/msm_te.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, **shape})
        log(f"{name} {shape}: {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}), kernel == plain")
        return out

    n_rows = int(runs[3].sum())        # the rows of buckets 1..nbe
    one_rows = int(one[3].sum())
    one_ms = timed(lambda: ak.te_gather_accumulate(curve, p.table, *one), 3)
    sums = row("te_gather_accumulate", "zprize_tpu/msm/accum_kernel.py:658",
               lambda: ak.te_gather_accumulate(curve, p.table, *runs),
               lambda: ak.te_gather_accumulate_plain(curve, p.table, *one),
               lambda o: o[:1], 3, n_rows * MULMODS["madd"],
               n_rows * (3 * 4 * nw + 8 + 4) + n_win * nbe * (16 + pt_bytes),
               windows=n_win, lanes=n_win * nbe, rows=n_rows,
               plain_shape="window 0 alone")
    one_bound, _ = bound_ms(one_rows * MULMODS["madd"],
                            one_rows * (3 * 4 * nw + 8 + 4)
                            + nbe * (16 + pt_bytes))
    rows[-1]["one_window"] = {"ms": one_ms, "bound_ms": one_bound,
                              "rows": one_rows}
    log(f"te_gather_accumulate, window 0 alone ({one_rows} rows): "
        f"{one_ms:.4f} ms (bound {one_bound:.4f} ms)")
    del runs, one

    c_lanes, steps = te_path.triangle_split(n_win, nbe)
    lanes = n_win * c_lanes
    chunks = sums.reshape(lanes, steps, 4, nw).contiguous()
    row("te_running_sum", "zprize_tpu/msm/accum_kernel.py:791",
        lambda: ak.te_running_sum(curve, chunks),
        lambda: ak.te_running_sum_plain(curve, chunks), lambda o: o, 10,
        lanes * 2 * (steps - 1) * MULMODS["add"],
        lanes * (steps + 2) * pt_bytes, lanes=lanes, steps=steps,
        loop_of="zprize_tpu/msm/accum_kernel.py:1444")

    rows.append(tree_row(curve, sums, c_lanes, launches["te_tree_sum"],
                         per_msm["te_tree_sum"], lat))
    rows.append(final_combine_row(curve, sums, p.c, launches["te_combine"],
                                  per_msm["te_combine"], lat))
    return rows


def tree_work(k, first):
    """(full adds, steps with an add) of one row of te_tree_sum over k
    members at weight offset `first` (None: roots only): the up-sweeps of
    `accum_kernel.te_tree_sum_plain` run on presence flags alone, per
    segment, then across the segments per component.  The adds are what
    these members need; each step with an add is one full add on the
    critical path (3 mulmods deep: the four first products, T1 T2 k, the
    closing products)."""
    from zprize_tpu_torch.msm.accum_kernel import TREE_SEG_LOG, tree_layout
    bits = first is not None
    off = first or 0
    seg = 1 << TREE_SEG_LOG
    n_seg, n_pow, n_comp = tree_layout(k, first)

    def sweep(pres, with_bits):
        adds, steps = 0, set()
        for t in range(len(pres).bit_length() - 1):
            offs = [0] + ([1 << b for b in range(t)] if with_bits else [])
            for left in range(0, len(pres), 2 << t):
                for o in offs:
                    li, ri = left + o, left + o + (1 << t)
                    if pres[ri]:
                        if pres[li]:
                            adds += 1
                            steps.add(t)
                        pres[li] = True
        return adds, steps

    adds, seg_steps, fin_steps = 0, set(), set()
    comps = [[False] * n_pow for _ in range(n_comp)]
    for s in range(n_seg):
        pres = [0 <= s * seg + i - off < k for i in range(seg)]
        a, st = sweep(pres, bits)
        adds, seg_steps = adds + a, seg_steps | st
        for c in range(n_comp):
            comps[c][s] = pres[(1 << c) >> 1]
    for c in range(n_comp):
        a, st = sweep(comps[c], bits and c == 0)
        adds, fin_steps = adds + a, fin_steps | st
    return adds, len(seg_steps) + len(fin_steps)


def tree_shape(name, run, plain, label, pts, first, add_mulmods, depth,
               design_depth, lat):
    """One tree-sum kernel (`run(pts, first)`) at one shape, timed beside
    its plain version and checked against it.  Beside the time three
    floors: the throughput bound (its adds at `add_mulmods` mulmods each
    at the card's IMAD rate, or its bytes), the card's latency floor (the
    critical path, `depth` dependent mulmods a step, at
    MULMOD_IMAD_DEPTH dependent IMADs a mulmod) and the design floor (the
    path at `design_depth` one-thread mulmods a step); `bound_ms` is the
    larger of the first two."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    rows, k = pts.shape[:2]
    ms = timed(lambda: run(pts, first), 20)
    t0 = time.time()
    ref = plain(pts, first)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    got = run(pts, first)
    err = max(max_abs_err(got[0], ref[0]),
              0 if first is None else max_abs_err(got[1], ref[1]))
    if err != 0:
        raise AssertionError(f"{name} != plain at the {label}")
    adds, steps = tree_work(k, first)
    adds *= rows
    n_out = 1 + (0 if first is None else ak.tree_bits(k, first))
    thr_ms, thr_by = bound_ms(adds * add_mulmods, rows * (k + n_out)
                              * pts[0, 0].numel() * 4)
    card_ms = depth * steps * MULMOD_IMAD_DEPTH * lat["imad"]
    design_ms = design_depth * steps * lat["mulmod"]
    b_ms, b_by = max((thr_ms, thr_by), (card_ms, "latency"))
    log(f"{name} {label} ({rows} x {k}, first {first}, {adds} adds, {steps}"
        f" steps): {ms:.4f} ms (plain {plain_ms:.1f} ms, bound {b_ms:.4f} "
        f"ms by {b_by}: throughput {thr_ms:.4f}, latency floor "
        f"{card_ms:.5f}, design floor {design_ms:.4f}), kernel == plain")
    return {"shape": label, "rows": rows, "k": k, "first": first,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "adds": adds,
            "throughput_bound_ms": thr_ms, "depth_mulmods": depth * steps,
            "latency_floor_ms": card_ms, "design_floor_ms": design_ms}


def tree_kernel_row(name, replaces, launches, shapes, **extra):
    """A tree kernel's row: its first shape's numbers, every shape under
    "shapes"."""
    head = shapes[0]
    return {"name": name, "route": "cuda",
            "source": f"zprize_tpu_torch/csrc/msm_{name[:2]}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, **extra, "shapes": shapes}


def tree_row(curve, sums, c_lanes, launches, per_msm, lat):
    """te_tree_sum at the merges' trees (`tree_shape`; bucket sums of the
    card's 2^26 run stand in for the trees' members): the 2^26 triangle
    merge's V bit sums (W x C chunk sums, first = 0) first, then under
    "shapes" its U root, the 2^18 merge's V and U (1 x 8192) and the
    carry window's bit sums (1 x 4, first = 1).  A TE add is 3 mulmods
    deep (the four first products, T1 T2 k, the closing products), and
    the group of 4 threads runs one product of each level a thread."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    n_win = sums.shape[0]
    nw = fp.n_words(curve.field)
    flat = sums.reshape(-1, 4, nw)
    shapes = []
    for label, rows, k, first in (
            (f"2^{PRIZE_LOG} merge V", n_win, c_lanes, 0),
            (f"2^{PRIZE_LOG} merge U", n_win, c_lanes, None),
            (f"2^{N_LOG} merge V", 1, 8192, 0),
            (f"2^{N_LOG} merge U", 1, 8192, None),
            (f"2^{PRIZE_LOG} carry window", 1, 4, 1)):
        pts = flat[:rows * k].reshape(rows, k, 4, nw).contiguous()
        shapes.append(tree_shape(
            "te_tree_sum", lambda x, f: ak.te_tree_sum(curve, x, f),
            lambda x, f: ak.te_tree_sum_plain(curve, x, f), label, pts,
            first, MULMODS["add"], 3, 3, lat))
    return tree_kernel_row(
        "te_tree_sum", "zprize_tpu/msm/accum_kernel.py:791 (the per-level "
        "launches of the merges' trees)", launches, shapes,
        launches_per_msm=per_msm)


def parent_sum_rows(curve, pts):
    """The SW trees as the port summed them before sw_tree_sum (the
    former `pippenger._sum_rows`): points (m, ..., 3, nw) reduced along
    axis 0 in place, one `sw_full_add` launch a level (the last half onto
    the first, the middle row of an odd count riding along).  Kept here
    for the A/B of `sw_tree_row`."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    m = pts.shape[0]
    skip = torch.zeros(pts[0].shape[:-2].numel(), dtype=torch.int32,
                       device=pts.device)
    flat = pts.reshape(m, -1, *pts.shape[-2:])
    while m > 1:
        half = m // 2
        ak.sw_full_add(curve, flat[:half].reshape(-1, *pts.shape[-2:]),
                       flat[m - half:m].reshape(-1, *pts.shape[-2:]),
                       skip.repeat(half))
        m -= half
    return pts[0]


def parent_sw_trees(curve, calls):
    """What the port ran before sw_tree_sum for the same members as the
    `calls` [(pts, first)] of one SW MSM: a roots-only call and the
    first = 0 call after it (a running-sum merge's U_q and T_q) as one
    `parent_sum_rows` over the U_q beside masked copies of the T_q, one
    row a bit; a first = 1 call (a narrow merge) as the scan of
    `sw_full_add` launches over groups of up to 128 bucket columns, then
    `parent_sum_rows` over the columns; any other roots-only call (slice
    sums) as `parent_sum_rows` over its members."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.msm import accum_kernel as ak
    i = 0
    while i < len(calls):
        pts, first = calls[i]
        n_win, k, tail = pts.shape[0], pts.shape[1], pts.shape[-2:]
        dev = pts.device
        ident = sw.pack(sw.identity(curve, (), dev))
        if first is None and i + 1 < len(calls) and calls[i + 1][1] == 0:
            t_q = calls[i + 1][0]
            n_bits = max(1, (k - 1).bit_length())
            q = torch.arange(k, device=dev)
            has_bit = ((q >> torch.arange(n_bits, device=dev)[:, None])
                       & 1).bool()
            rows = torch.cat([
                pts.transpose(0, 1)[:, None],
                torch.where(has_bit.t()[:, :, None, None, None],
                            t_q.transpose(0, 1)[:, None], ident)], dim=1)
            parent_sum_rows(curve, rows.contiguous())
            i += 2
            continue
        if first == 1:
            n_bits = max(1, k.bit_length())
            steps = max(1, k // 128)
            cols = k // steps
            ids = torch.arange(1, k + 1, device=dev).reshape(steps, cols)
            bits = torch.arange(n_bits, device=dev)
            skip = (((ids[:, :, None] >> bits) & 1) == 0).to(torch.int32)
            acc = sw.pack(sw.identity(curve, (cols, n_bits, n_win), dev))
            flat = acc.reshape(-1, *tail)
            for t in range(steps):
                q = pts[:, t * cols:(t + 1) * cols].transpose(0, 1)
                q = q[:, None].expand(cols, n_bits, n_win, *tail)
                sk = skip[t][:, :, None].expand(cols, n_bits, n_win)
                ak.sw_full_add(curve, flat, q.reshape(-1, *tail).contiguous(),
                               sk.reshape(-1).contiguous())
            parent_sum_rows(curve, acc)
        else:
            parent_sum_rows(curve, pts.transpose(0, 1).clone(
                memory_format=torch.contiguous_format))
        i += 1


def sw_tree_row(curve, p, aff, s, launches, per_msm, lat):
    """sw_tree_sum at the trees of one 2^18 BLS12-381 MSM: the members of
    every call the MSM makes (recorded from `pippenger.msm_sw` on the
    batch `s`), each timed beside its plain version and checked against
    it (`tree_shape`; the full group's bit sums of its T_q first).  An SW
    add is 2 mulmods deep (the six first products, then the six closing
    ones: the products by 3b are additions), and the group runs two
    products of each level a thread (4 on a thread's chain).  Then the
    A/B: the MSM's calls against what the port ran before for the same
    members (`parent_sw_trees`), in the order parent, new, new, parent."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger
    calls = []
    orig = pippenger.sw_tree_sum

    def record(curve_, pts, first=None):
        calls.append((pts.clone(), first))
        return orig(curve_, pts, first)

    pippenger.sw_tree_sum = record
    try:
        pippenger.msm_sw(curve, p, aff.inf, s)
    finally:
        pippenger.sw_tree_sum = orig
    head = max(range(len(calls)), key=lambda j: (calls[j][1] == 0,
                                                 calls[j][0].numel()))
    shapes = [tree_shape(
        "sw_tree_sum", lambda x, f: ak.sw_tree_sum(curve, x, f),
        lambda x, f: ak.sw_tree_sum_plain(curve, x, f),
        f"call {j} of the 2^{SW_LOG} MSM", pts, first, MULMODS["sw_add"],
        2, 4, lat) for j, (pts, first) in
        [(head, calls[head])] + [(j, c) for j, c in enumerate(calls)
                                 if j != head]]

    def new():
        for pts, first in calls:
            ak.sw_tree_sum(curve, pts, first)

    def parent():
        parent_sw_trees(curve, calls)

    ab = [timed(fn, 10) for fn in (parent, new, new, parent)]
    log(f"sw_tree_sum A/B, the trees of one 2^{SW_LOG} MSM ({len(calls)} "
        f"calls): parent {ab[0]:.4f}, new {ab[1]:.4f}, new {ab[2]:.4f}, "
        f"parent {ab[3]:.4f} ms")
    return tree_kernel_row(
        "sw_tree_sum", "zprize_tpu/msm/accum_kernel.py:138 (the per-level "
        "launches of the merges' trees: sum_points in merge_buckets_pallas, "
        "zprize_tpu/msm/accum_kernel.py:185, and merge_buckets_all, "
        "zprize_tpu/msm/pippenger.py:227)", launches, shapes,
        launches_per_msm=per_msm, calls_per_msm=len(calls),
        ab_ms={"parent": [ab[0], ab[3]], "new": [ab[1], ab[2]]})


def final_combine_row(curve, sums, c, launches, per_msm, lat):
    """te_combine at the 2^PRIZE_LOG final combine's shape: num_windows
    steps at window bits c, one lane (the first of `sums`, bucket sums of
    the card's run, stand in for the window sums), timed beside its plain
    version and its bound (`fold_bound` with the probes' latencies
    `lat`), and checked against the plain version."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger, probe
    nw = fp.n_words(curve.field)
    pt_bytes = 4 * 4 * nw
    n_steps = pippenger.num_windows(curve, c)
    ws = sums.reshape(-1, 4, nw)[:n_steps].reshape(
        n_steps, 1, 4, nw).contiguous()
    depth = probe.te_combine_depth(n_steps, c)
    mulmods = (n_steps - 1) * (c * MULMODS["dbl"] + MULMODS["add"])
    b_ms, b_by, extra = fold_bound(depth, lat, mulmods,
                                   (n_steps + 1) * pt_bytes)
    ms = timed(lambda: ak.te_combine(curve, ws, c), 20)
    t0 = time.time()
    ref = ak.te_combine_plain(curve, ws, c)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_abs_err(ak.te_combine(curve, ws, c), ref)
    if err != 0:
        raise AssertionError("te_combine != plain at the final combine")
    log(f"te_combine, the 2^{PRIZE_LOG} final combine ({n_steps} steps, c = "
        f"{c}, depth {depth}): {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}), kernel == plain")
    return {"name": "te_combine", "route": "cuda",
            "source": "zprize_tpu_torch/csrc/msm_te.cu",
            "replaces": "zprize_tpu/msm/accum_kernel.py:997",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "lanes": 1, "steps": n_steps, "c": c,
            **extra, "launches_per_msm": per_msm}


def sw_rows(curve, ctx, aff, batch, launches, per_msm, lat, dev):
    """The five SW kernels at the 2^18 path's shapes, timed beside their
    plain versions and bounds, and checked against the plain versions:
    sw_gather_accumulate over the full-width window group of one batch,
    sw_running_sum over that group's merge chunks, sw_tree_sum at the
    MSM's trees with the A/B against the per-level launches before it
    (`sw_tree_row`), sw_full_add at the widest of those levels (the
    full group's tree, which it no longer runs), sw_combine over the
    MSM's window sums (one lane; bound: `fold_bound` with the probes'
    latencies `lat`)."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import pippenger, probe, te_path
    p = ctx.prepared
    nw = fp.n_words(curve.field)
    pt_bytes = 3 * 4 * nw
    full = 1 << (p.c - 1)
    s = torch.from_numpy(batch.view(np.int16)).to(dev)
    digits = pippenger.sw_digits(curve, p.c, s, aff.inf)
    groups = pippenger.window_groups(curve, p.c, digits.shape[0], full)
    ws = groups[full]
    runs = pippenger.sort_windows(digits[torch.tensor(ws, device=dev)], full)
    out = []

    def row(name, replaces, fn, plain, reps, mulmods, n_bytes, depth=None,
            **shape):
        ms = timed(fn, reps)
        t0 = time.time()
        ref = plain()
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = max(max_abs_err(a, b) for a, b in zip(
            fn() if isinstance(ref, tuple) else (fn(),),
            ref if isinstance(ref, tuple) else (ref,)))
        if err != 0:
            raise AssertionError(f"{name} != plain at the SW path's shapes")
        if depth is None:
            b_ms, b_by = bound_ms(mulmods, n_bytes)
        else:
            b_ms, b_by, extra = fold_bound(depth, lat, mulmods, n_bytes)
            shape.update(extra)
        out.append({"name": name, "route": "cuda",
                    "source": "zprize_tpu_torch/csrc/msm_sw.cu",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    **shape})
        log(f"{name} {shape}: {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.4f} ms by {b_by}), kernel == plain")
        return ref

    points = int(runs[3].sum())          # the points of buckets 1..full
    lanes = len(ws) * full
    sums = row("sw_gather_accumulate", "zprize_tpu/msm/accum_kernel.py:60",
               lambda: ak.sw_gather_accumulate(curve, p.x, p.y, *runs),
               lambda: ak.sw_gather_accumulate_plain(curve, p.x, p.y,
                                                     *runs),
               5, points * MULMODS["sw_madd"],
               points * (2 * 4 * nw + 8 + 4) + lanes * (16 + pt_bytes),
               windows=len(ws), buckets=full, points=points,
               also_replaces=["zprize_tpu/msm/accum_kernel.py:252",
                              "zprize_tpu/msm/accum_kernel.py:304"])
    del runs
    # the merge's running sums: the chunks of the group's bucket sums
    n_chunks, steps = te_path.triangle_split(len(ws), full)
    chunks = sums.reshape(len(ws) * n_chunks, steps, 3, nw)
    lanes = chunks.shape[0]
    row("sw_running_sum",
        "zprize_tpu/msm/accum_kernel.py:138 (the scan of "
        "merge_buckets_pallas, zprize_tpu/msm/accum_kernel.py:185)",
        lambda: ak.sw_running_sum(curve, chunks),
        lambda: ak.sw_running_sum_plain(curve, chunks), 10,
        lanes * 2 * (steps - 1) * MULMODS["sw_add"],
        chunks.numel() * 4 + 2 * lanes * pt_bytes, lanes=lanes, steps=steps)
    out.append(sw_tree_row(curve, p, aff, s, launches["sw_tree_sum"],
                           per_msm["sw_tree_sum"], lat))
    # the widest level of the full group's tree as per-level launches ran
    # it (parent_sw_trees): C/2 x (1 + bits) x W lanes
    lanes = n_chunks // 2 * (1 + (n_chunks - 1).bit_length()) * len(ws)
    flat = sums.reshape(-1, 3, nw)
    idx = torch.arange(lanes, device=dev)
    acc, q = flat[idx % flat.shape[0]], flat[(idx + 1) % flat.shape[0]]
    skip = torch.zeros(lanes, dtype=torch.int32, device=dev)
    row("sw_full_add", "zprize_tpu/msm/accum_kernel.py:138",
        lambda: ak.sw_full_add(curve, acc.clone(), q, skip),
        lambda: ak.sw_full_add_plain(curve, acc.clone(), q, skip), 20,
        lanes * MULMODS["sw_add"], lanes * (3 * pt_bytes + 4), lanes=lanes)
    del sums, acc, q
    # the final combine: the MSM's window sums, one lane
    window_sums = pippenger.window_sums_sw(curve, p.c, p.x, p.y, digits,
                                           groups)[:, None].contiguous()
    n_steps = window_sums.shape[0]
    row("sw_combine",
        "zprize_tpu/msm/accum_kernel.py:138 (the serial launches of "
        "combine_windows, zprize_tpu/msm/pippenger.py:235)",
        lambda: ak.sw_combine(curve, window_sums, p.c),
        lambda: ak.sw_combine_plain(curve, window_sums, p.c), 10,
        (n_steps - 1) * (p.c * MULMODS["sw_dbl"] + MULMODS["sw_add"]),
        window_sums.numel() * 4 + pt_bytes,
        depth=probe.sw_combine_depth(n_steps, p.c), lanes=1, steps=n_steps,
        c=p.c)
    return out


def random_fr(fp, f, shape, rng, gen, dev):
    """Fr elements for the NTT checks: `random_elems` up to 2^16 values,
    above that random words on the card below p (the top word cut under
    p's) with 0, 1 and p-1 in the first places."""
    count = int(np.prod(shape))
    if count <= 1 << 16:
        return random_elems(fp, f, shape, rng, dev)
    nw = fp.n_words(f)
    w = torch.randint(0, 1 << 32, (count, nw), generator=gen,
                      dtype=torch.int64, device=dev)
    w[:, -1] %= f.p >> (32 * (nw - 1))
    w = w.to(torch.int32)
    w[:3] = fp.from_ints(f, [0, 1, f.p - 1], dev)
    return w.reshape(*shape, nw)


def check_ntt(dev):
    """Phase 3b: fr_ntt == its plain version, forward and inverse, and the
    round trip, at every size of NTT_SIZES with B = 1 and 3 (B = 1 from
    NTT_B1_LOG; each pass count of `fr_kernel.plan`)."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.field.spec import BLS12_377_FR
    from zprize_tpu_torch.ntt import fr_kernel
    from zprize_tpu_torch.ntt.domain import Domain
    f = BLS12_377_FR
    rng = random.Random(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    for log_n in NTT_SIZES:
        dom = Domain(f, log_n, dev)
        for rows in (1, 3) if log_n < NTT_B1_LOG else (1,):
            a = random_fr(fp, f, (rows, dom.n), rng, gen, dev)
            errs = []
            for inverse in (False, True):
                out = fr_kernel.fr_ntt(dom, a, inverse)
                errs.append(max_abs_err(
                    out, fr_kernel.fr_ntt_plain(dom, a, inverse)))
            back = fr_kernel.fr_ntt(dom, fr_kernel.fr_ntt(dom, a), True)
            torch.cuda.synchronize()
            errs.append(max_abs_err(back, a))
            log(f"fr_ntt vs plain, n = 2^{log_n}, B = {rows} (passes "
                f"{fr_kernel.plan(log_n)}): forward {errs[0]}, inverse "
                f"{errs[1]}, round trip {errs[2]}")
            if any(errs):
                raise AssertionError(f"fr_ntt disagrees at 2^{log_n}, "
                                     f"B = {rows}")


def gl_random(shape, gen, dev):
    """Canonical Goldilocks values from a seeded generator, with 0, 1, q-1
    and 2^32-1 in the first places."""
    from zprize_tpu_torch.ntt import gl_ops
    x = gl_ops.gl_canon(torch.randint(-2 ** 63, 2 ** 63 - 1, shape,
                                      generator=gen, dtype=torch.int64,
                                      device=dev))
    edges = gl_ops.from_ints([0, 1, gl_ops.Q - 1, (1 << 32) - 1], dev)
    flat = x.view(-1)
    k = min(4, flat.numel())
    flat[:k] = edges[:k]
    return x


def check_gl_ntt(dev):
    """Phase 3c: gl_ntt == its plain version, forward and inverse, at
    every size of GL_SIZES with B = 1 and 3 (and 4096 at 2^12), the
    transposed store at 2^12 (B = 1, 3, 4096), column passes with the
    step twiddle (in place and transposed), the round trip, and the plain
    version against python ints at 2^3 and 2^9."""
    from zprize_tpu_torch.field.spec import GOLDILOCKS
    from zprize_tpu_torch.ntt import gl_kernel, gl_ops
    from zprize_tpu_torch.ntt.domain import primitive_root
    from zprize_tpu_torch.utils.oracle import dft_ints, ntt_ints
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    q = gl_ops.Q
    cases = [(log_n, b) for log_n in GL_SIZES for b in (1, 3)]
    cases.append((12, 4096))
    for log_n, b in cases:
        x = gl_random((1 << log_n, b), gen, dev)
        errs = []
        for inverse in (False, True):
            scale = pow(1 << log_n, -1, q) if inverse else None
            out = gl_kernel.gl_ntt(x, log_n, inverse, scale=scale)
            errs.append(max_abs_err(out, gl_kernel.gl_ntt_plain(
                x, log_n, inverse, scale=scale)))
        back = gl_kernel.ntt_packed(
            log_n, gl_kernel.ntt_packed(log_n, x, device=dev), True, dev)
        torch.cuda.synchronize()
        errs.append(int((back != x).sum()))
        log(f"gl_ntt vs plain, n = 2^{log_n}, B = {b}: forward {errs[0]}, "
            f"inverse {errs[1]}, round trip {errs[2]}")
        if any(errs):
            raise AssertionError(f"gl_ntt disagrees at 2^{log_n}, B = {b}")
    # the transposed store: (B, 2^12) at B = 1, 3 and 4096
    for b in (1, 3, 4096):
        x = gl_random((1 << 12, b), gen, dev)
        errs = [max_abs_err(gl_kernel.gl_ntt(x, 12, inverse,
                                             transpose_out=True),
                            gl_kernel.gl_ntt_plain(x, 12, inverse,
                                                   transpose_out=True))
                for inverse in (False, True)]
        log(f"gl_ntt, transposed store, 2^12 x {b}: forward {errs[0]}, "
            f"inverse {errs[1]}")
        if any(errs):
            raise AssertionError(f"gl_ntt's transposed store disagrees at "
                                 f"B = {b}")
    # column passes of a four-step level with the step twiddle: 2^3 points,
    # 3 x 2^10 columns (both two-level tables, 2^10 > 2^8 columns), in
    # place and with the transposed store in groups of inner = 3; and the
    # 2^24 NTT's column pass, 2^12 x 2^12, transposed
    for log_n, step_log, inner in ((3, 10, 3), (12, 12, 1)):
        x = gl_random((1 << log_n, inner << step_log), gen, dev)
        for inverse in (False, True):
            for tr in (False, True):
                args = (x, log_n, inverse, step_log, inner, None, tr)
                err = max_abs_err(gl_kernel.gl_ntt(*args),
                                  gl_kernel.gl_ntt_plain(*args))
                log(f"gl_ntt with the step twiddle, 2^{log_n} x ({inner} x "
                    f"2^{step_log}), {'inverse' if inverse else 'forward'}"
                    f"{', transposed' if tr else ''}: {err}")
                if err:
                    raise AssertionError("gl_ntt disagrees with the step "
                                         "twiddle")
    for log_n in (3, 9):
        x = gl_random((1 << log_n, 1), gen, dev)
        vals = gl_ops.to_ints(x)
        w = primitive_root(GOLDILOCKS, log_n)
        expect = dft_ints(vals, w, q)
        if (gl_ops.to_ints(gl_kernel.gl_ntt_plain(x, log_n)) != expect
                or ntt_ints(vals, w, q) != expect):
            raise AssertionError(f"gl_ntt_plain or ntt_ints != the python "
                                 f"DFT at 2^{log_n}")
        log(f"gl_ntt_plain and ntt_ints == python DFT at 2^{log_n}")


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
    from zprize_tpu_torch.hash.poseidon import default_fr377_sponge_config
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.ntt import fr_kernel
    from zprize_tpu_torch.pcs import kzg
    from zprize_tpu_torch.plonk import prover, verifier
    curve = BLS12_377_G1
    fr = curve.scalar
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = random.Random(17)

    def counts():
        return {**{k: ak.launches[k] for k in (*COLLAPSED_ROUTE,
                                               "te_full_add")},
                **fr_kernel.launches}

    t0 = time.time()
    cc, assignment, public = plonk_witness(default_fr377_sponge_config(),
                                           fr, n_proofs, height, rng, dev)
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
    # te_full_add builds the SRS (its double-and-add) and runs in no proof
    if path_launches["te_full_add"] == 0 or any(
            launched["te_full_add"] for launched in per_proof):
        raise AssertionError("te_full_add ran in a proof, or not for the "
                             f"SRS: {per_proof}")
    missing = [name for name, v in per_proof[0].items()
               if v == 0 and name != "te_full_add"]
    if missing:
        raise AssertionError(f"the warm-up proof launched no {missing}")
    for k, launched in enumerate(per_proof[1:], 1):
        missing = [name for name, v in launched.items()
                   if v == 0 and name not in ("te_dbl_chain", "te_full_add")]
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
    extras = trapdoor_and_bytes(srs, proof, dev)
    mean = sum(times[1:]) / PLONK_TIMED
    summary = {
        "metric": f"bls12_377_plonk_n{cc.n}",
        "n": cc.n, "proofs": n_proofs, "height": height,
        "prove_s": times[1:], "prove_s_mean": mean,
        "ns_per_constraint": mean / cc.n * 1e9,
        "warmup_prove_s": times[0],
        "keygen_s": keygen_s, "srs_s": srs_s, "srs_size": srs.size,
        "circuit_s": circuit_s,
        "verify_s": verify_s, "transcript_s": tr_s,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if dev.type == "cuda" else None),
        "launches_warmup_proof": per_proof[0],
        "launches_per_proof": per_proof[-1],
        "verified_proofs": PLONK_TIMED + 1, "rejected": 2,
        **extras,
    }
    return pk, wires, public, path_launches, summary


def trapdoor_and_bytes(srs, proof, dev):
    """Phase 7's trapdoor check and byte form of points: an opening made on
    the card by `kzg.commit` and `open_at` (the proof's length, whose table
    the prover built), and the same with y + 1 and with W + G, each through
    `verify_with_trapdoor` and `kzg.verify`, which must agree (the honest
    opening accepted, both others rejected); then the proof's nine
    commitments, the first 8 SRS powers and the identity through
    `serialize_points` and back (96 bytes a record)."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.pcs import kzg
    from zprize_tpu_torch.utils import native, oracle
    curve = srs.curve
    fr, f = curve.scalar, curve.field
    rng = random.Random(7)
    t0 = time.time()
    n = srs.size - 8
    coeffs = random_elems(fp, fr, (n,), rng, dev)
    z = fp.from_ints(fr, [rng.randrange(fr.p)], dev)[0]
    com = kzg.commit(srs, coeffs)
    w, y = kzg.open_at(srs, coeffs, z)
    torch.cuda.synchronize()
    open_s = time.time() - t0
    w_pt = kzg.point_ints(curve, w)
    openings = {
        "honest": (com, z, y, w),
        "y_plus_1": (com, z, (kzg.fr_int(curve, y) + 1) % fr.p, w),
        "wrong_witness": (com, z, y, oracle.ec_add(
            w_pt, oracle.generator(curve), f.p)),
    }
    verdicts, pairing, trapdoor_s, verify_s = {}, {}, {}, {}
    for case, args in openings.items():
        t0 = time.time()
        verdicts[case] = kzg.verify_with_trapdoor(srs, *args)
        trapdoor_s[case] = time.time() - t0
        t0 = time.time()
        pairing[case] = kzg.verify(srs, *args)
        verify_s[case] = time.time() - t0
    expect = {"honest": True, "y_plus_1": False, "wrong_witness": False}
    if verdicts != expect or pairing != expect:
        raise AssertionError(f"trapdoor verdicts {verdicts}, kzg.verify "
                             f"{pairing}, expected {expect}")
    log(f"trapdoor check on an opening of {n} coefficients made on the card "
        f"({open_s:.3f} s): {verdicts}, as kzg.verify; seconds "
        f"{trapdoor_s} against kzg.verify's {verify_s}")

    comms = [*proof.wire_comms, proof.z_comm, *proof.t_comms, proof.w_zeta,
             proof.w_zeta_omega]
    pts = [kzg.point_ints(curve, c) for c in comms]
    g1 = srs.g1_powers
    pts += [None if inf else (int(x), int(y)) for x, y, inf in zip(
        fp.to_ints(f, g1.x[:8]), fp.to_ints(f, g1.y[:8]),
        g1.inf[:8].tolist())]
    pts.append(None)
    t0 = time.time()
    data = native.serialize_points(curve, pts)
    back = native.deserialize_points(curve, data)
    bytes_s = time.time() - t0
    if (len(data) != 96 * len(pts) or back != pts
            or data[:48] != pts[0][0].to_bytes(48, "little")
            or data[-96:] != bytes(95) + b"\x40"):
        raise AssertionError("the byte form of the commitments and SRS powers "
                             "did not round-trip")
    log(f"byte form: {len(comms)} commitments, 8 SRS powers and the identity "
        f"in {len(data)} bytes, round trip exact in {bytes_s * 1e3:.3f} ms, "
        f"identity flag 0x40")
    return {"trapdoor": verdicts, "trapdoor_kzg_verify": pairing,
            "trapdoor_open_n": n, "trapdoor_open_s": open_s,
            "trapdoor_s": trapdoor_s, "trapdoor_verify_s": verify_s,
            "point_bytes": {"records": len(pts), "bytes": len(data),
                            "round_trip": True, "seconds": bytes_s}}


def verify_circuit(fr, n_constraints):
    """bench.py's verify circuit (`main.rs:73-116`): c = a·b public, and
    filler constraints a·b up to n_constraints."""
    from zprize_tpu_torch.marlin.r1cs import R1CSBuilder
    rb = R1CSBuilder(fr, num_public=1)
    a_v = rb.new_witness()
    b_v = rb.new_witness()
    c_v = rb.mul(a_v, b_v)
    for _ in range(n_constraints - 2):
        rb.mul(a_v, b_v)
    rb.enforce_equal(c_v, rb.public(0))
    r1 = rb.build()

    def witness(a_i, b_i):
        c_i = a_i * b_i % fr.p
        return [1, c_i, a_i % fr.p, b_i % fr.p] + [c_i] * (n_constraints - 1)

    return r1, witness


def reset_all_launches():
    """Set every port counter to 0: the path kernels' and the probes'."""
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.msm import probe
    from zprize_tpu_torch.ntt import fr_kernel, gl_kernel
    for counters in (ak, fr_kernel, gl_kernel, probe):
        counters.reset_launches()


def all_launches():
    """Every port counter's launch count since reset_all_launches()."""
    from zprize_tpu_torch.msm import probe
    return {**port_launches(), **probe.launches}


def verify_path(dev):
    """Phase 10: bench.py's verify metric (`bench_verify`, bench.py:341-467)
    through the port: the 100-constraint circuit, the test SRS and the
    index on the card, prove_batch of 4 witnesses (each proof verified),
    the tampered pool (g_1's y negated, `main.rs:182`), three groups of
    10, 100 and 20 proofs with faults at 1/5, 1/50 and 1/10, a warm cycle
    and a VERIFY_WINDOW_S window of `verify_group` rounds, every verdict
    exact.  The verifier runs on host ints."""
    import copy
    from zprize_tpu_torch.curve.spec import BLS12_377_G1
    from zprize_tpu_torch.marlin import ahp, indexer
    from zprize_tpu_torch.pcs import kzg
    curve = BLS12_377_G1
    fr = curve.scalar
    p = fr.p
    r1, witness = verify_circuit(fr, VERIFY_CONSTRAINTS)
    rng = random.Random(0xC0FFEE)
    reset_all_launches()
    t0 = time.time()
    n = 1 << max(r1.num_constraints, r1.num_vars, 2).bit_length()
    k = 1 << max(len(r1.a), len(r1.b), len(r1.c), 2).bit_length()
    srs = kzg.setup_test_srs(curve, max(3 * k, 2 * n) + 8, seed=11,
                             device=dev)
    pk = indexer.index(curve, r1, srs, device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    setup_launches = all_launches()
    log(f"verify: SRS of {srs.size} powers and index: {setup_s:.3f} s; "
        f"{r1.num_constraints} constraints, n = {1 << pk.log_n}, "
        f"k = {1 << pk.log_k}; launches {setup_launches}")
    zs = [witness(rng.randrange(1, p), rng.randrange(1, p)) for _ in range(4)]
    for z in zs:
        if not r1.is_satisfied(z):
            raise AssertionError("verify circuit: witness unsatisfied")
    reset_all_launches()
    t0 = time.time()
    proofs = ahp.prove_batch(pk, zs, device=dev)
    prove_s = time.time() - t0
    launches = all_launches()
    log(f"proved 4 instances in one prove_batch: {prove_s:.3f} s, "
        f"launches {launches}")
    for name in ("sw_gather_accumulate", "fr_ntt"):
        if launches[name] == 0:
            raise AssertionError(f"prove_batch launched no {name}")
    pool = [(z[:r1.num_public], pr) for z, pr in zip(zs, proofs)]
    for pub, pr in pool:
        if not ahp.verify(pk.vk, srs, pub, pr):
            raise AssertionError("a proof of the verify circuit failed")

    def tampered(proof):
        bad = copy.deepcopy(proof)
        x, y = bad.comms["g_1"]
        bad.comms["g_1"] = (x, (-y) % curve.field.p)
        return bad

    bad_pool = [(pub, tampered(pr)) for pub, pr in pool]

    def build_group(count, fault_denom):
        group, faulty = [], []
        for _ in range(count):
            is_bad = rng.randrange(fault_denom) == 0
            src = bad_pool if is_bad else pool
            group.append(src[rng.randrange(len(src))])
            faulty.append(is_bad)
        return group, faulty

    groups = [build_group(10, 5), build_group(100, 50), build_group(20, 10)]
    vrng = random.Random(7)

    def round_ok(g, f):
        verdicts = ahp.verify_group(pk.vk, srs, g, rng=vrng)
        if verdicts != [not x for x in f]:
            raise AssertionError("verify_group: a verdict is wrong")

    t0 = time.time()
    for g, f in groups:
        round_ok(g, f)
    warm_s = time.time() - t0
    rounds = 0
    t0 = time.time()
    while True:
        round_ok(*groups[rounds % 3])
        rounds += 1
        if time.time() - t0 > VERIFY_WINDOW_S:
            break
    dt = time.time() - t0
    rate = rounds / dt * 10.0
    log(f"verify: {rounds} rounds in {dt:.3f} s -> {rate:.4f} rounds/10 s; "
        f"groups of {[len(g) for g, _ in groups]} proofs with "
        f"{[sum(f) for _, f in groups]} faulty, every verdict exact")
    return launches, {
        "metric": "marlin_verify_rounds_per_10s", "value": rate,
        "unit": "rounds/10s", "rounds": rounds, "window_s": dt,
        "constraints": r1.num_constraints, "n": 1 << pk.log_n,
        "k": 1 << pk.log_k, "srs_size": srs.size, "setup_s": setup_s,
        "prove_batch_4_s": prove_s, "warm_cycle_s": warm_s,
        "groups": [len(g) for g, _ in groups],
        "faulty": [sum(f) for _, f in groups],
        "launches_setup": setup_launches,
        "launches_prove_batch_4": launches}


def posw_path(dev):
    """Phase 11: bench.py's posw metric (`bench_posw`, bench.py:293-339)
    through the port: `posw.setup()` on the card, a warm mine_batch of
    POSW_BATCH nonces at target p whose solution must pass verify_work and
    fail it under a tightened target, POSW_TIMED timed batches (their
    launches read batch by batch, each batch's solution verified after
    the clock stops), and one profiled prove_batch of POSW_BATCH."""
    from zprize_tpu_torch.field.spec import BLS12_377_FR
    from zprize_tpu_torch.marlin import ahp
    from zprize_tpu_torch.posw import posw
    p = BLS12_377_FR.p
    reset_all_launches()
    t0 = time.time()
    keys = posw.setup(device=dev)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    setup_launches = all_launches()
    log(f"posw keygen: {setup_s:.3f} s; n = {1 << keys.pk.log_n}, "
        f"k = {1 << keys.pk.log_k}, SRS of {keys.pk.srs.size} powers; "
        f"launches {setup_launches}")
    t0 = time.time()
    sol = posw.mine_batch(keys, header=42, target=p, start_nonce=1,
                          max_nonces=POSW_BATCH, batch=POSW_BATCH)
    warm_s = time.time() - t0
    if sol is None or not posw.verify_work(keys, keys.pk.srs, sol, p):
        raise AssertionError("the warm PoSW solution did not verify")
    d = posw.proof_difficulty(keys, sol["proof"])
    if posw.verify_work(keys, keys.pk.srs, sol, d):
        raise AssertionError("verify_work passed under a target the "
                             "proof's hash does not meet")
    log(f"warm batch of {POSW_BATCH}: {warm_s:.3f} s, solution verified, "
        "refused under the tightened target")
    nonce, proofs, times, sols, per_batch = 1 + POSW_BATCH, 0, [], [], []
    for _ in range(POSW_TIMED):
        reset_all_launches()
        t1 = time.time()
        sol = posw.mine_batch(keys, header=42, target=p, start_nonce=nonce,
                              max_nonces=POSW_BATCH, batch=POSW_BATCH)
        times.append(time.time() - t1)
        per_batch.append(all_launches())
        if sol is None:
            raise AssertionError("target p refused a proof")
        sols.append(sol)
        nonce += POSW_BATCH
        proofs += POSW_BATCH
    dt = sum(times)
    rate = proofs / dt * 20.0
    for sol in sols:
        if not posw.verify_work(keys, keys.pk.srs, sol, p):
            raise AssertionError("a timed batch's solution did not verify")
    for counts in per_batch:
        for name in ("sw_gather_accumulate", "fr_ntt"):
            if counts[name] == 0:
                raise AssertionError(f"a timed batch launched no {name}")
    total = {k: sum(b[k] for b in per_batch) for k in per_batch[0]}
    launches = {k: v // POSW_TIMED if v % POSW_TIMED == 0
                else v / POSW_TIMED for k, v in total.items()}
    log(f"posw: {proofs} proofs in {dt:.3f} s -> {rate:.4f} proofs/20 s "
        f"(batches {times}); each batch's solution verified; launches "
        f"per batch {launches}")
    zs = [posw._witness(keys.circuit, 42, 1000 + i)
          for i in range(POSW_BATCH)]
    prof = profile_call(f"PoSW prove_batch({POSW_BATCH})",
                        lambda: ahp.prove_batch(keys.pk, zs, device=dev),
                        host_ops=False)
    return launches, {
        "metric": "posw_proofs_per_20s", "value": rate,
        "unit": "proofs/20s", "proofs": proofs, "seconds": dt,
        "batch_s": times, "batch": POSW_BATCH, "n": 1 << keys.pk.log_n,
        "k": 1 << keys.pk.log_k, "srs_size": keys.pk.srs.size,
        "constraints": keys.pk.r1cs.num_constraints,
        "setup_s": setup_s, "warm_batch_s": warm_s,
        "launches_setup": setup_launches,
        "launches_timed_batches": per_batch,
        "launches_per_batch": launches, "profile": prof}


def profile_ntt(dev):
    """Phase 3b: one profiled 2^18 forward fr_ntt (the PLONK quotient's
    size), which must run one kernel a pass of `fr_kernel.plan` (two: two
    trips through device memory).  Run early, as phase 8: late in a run,
    after the large profiles, this short window's trace came back without
    its device events."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.field.spec import BLS12_377_FR
    from zprize_tpu_torch.ntt import fr_kernel
    from zprize_tpu_torch.ntt.domain import Domain
    dom = Domain(BLS12_377_FR, N_LOG, dev)
    a = random_elems(fp, BLS12_377_FR, (1, dom.n), random.Random(SEED + 1),
                     dev)
    prof = profile_call(f"fr_ntt 2^{N_LOG} forward",
                        lambda: fr_kernel.fr_ntt(dom, a))
    passes = len(fr_kernel.plan(N_LOG))
    if not prof["complete"] or prof["traced"].get("fr_ntt") != passes:
        raise AssertionError(f"a 2^{N_LOG} fr_ntt traced {prof['traced']} "
                             f"kernels, not {passes} passes")
    log(f"fr_ntt 2^{N_LOG}: {passes} passes traced, device "
        f"{prof['port_kernels_ms']['fr_ntt']:.4f} ms")
    return {k: prof[k] for k in ("traced", "by_kernel", "port_kernels_ms",
                                 "complete")}


def ntt_row(pk, launches, prof, dev):
    """The Fr NTT at the PLONK path's shapes, timed beside its plain
    version and its bound, and checked against the plain version: the
    quotient's 2^18 coset transform (forward, B = 1) first, and under
    "shapes" the wires' 2^16 inverse (B = 3) and a 2^16 forward (B = 1);
    `prof` is phase 3b's profiled 2^18 transform."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.ntt import fr_kernel
    fr_kernel.reset_launches()
    f = pk.dom.spec
    rng = random.Random(SEED + 1)
    shapes = []
    for dom, rows, inverse in ((pk.dom4, 1, False), (pk.dom, 3, True),
                               (pk.dom, 1, False)):
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
                       "passes": fr_kernel.plan(dom.log_n),
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
            "library_ms": None, "shapes": shapes,
            f"profile_2^{N_LOG}": prof}


def srs_full_add_row(curve, lanes, launches, dev):
    """te_full_add at the shape the test SRS gives it (`kzg.scalar_mul_te`:
    one add of `lanes` lanes a scalar bit, the bit as the skip mask),
    timed beside its plain version and its bound, and checked against
    it."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import accum_kernel as ak
    f = curve.field
    rng = random.Random(SEED + 2)
    p = random_elems(fp, f, (lanes, 4), rng, dev)
    q = random_elems(fp, f, (lanes, 4), rng, dev)
    skip = torch.randint(0, 2, (lanes,), dtype=torch.int32, device=dev)
    ms = timed(lambda: ak.te_full_add(curve, p, q, skip), 20)
    t0 = time.time()
    ref = ak.te_full_add_plain(curve, p, q, skip)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_abs_err(ak.te_full_add(curve, p, q, skip), ref)
    if err != 0:
        raise AssertionError("te_full_add != plain at the SRS's shape")
    added = int((skip == 0).sum())
    pt_bytes = 4 * 4 * fp.n_words(f)
    # p, the mask and the output of every lane; q only where the lane adds
    b_ms, b_by = bound_ms(added * MULMODS["add"],
                          lanes * (2 * pt_bytes + 4) + added * pt_bytes)
    log(f"te_full_add at the SRS's {lanes} lanes: {ms:.4f} ms (plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by}), kernel == plain")
    return {"name": "te_full_add", "route": "cuda",
            "source": "zprize_tpu_torch/csrc/msm_te.cu",
            "replaces": "zprize_tpu/msm/accum_kernel.py:791",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "lanes": lanes, "added_lanes": added,
            "launches_of": "the PLONK path's test SRS"}


def gl_bound(log_n, b, step_log=0, scale=False):
    """(mulmods, bytes) of one gl_ntt call on (2^log_n, b): the butterflies
    of stages 2..log_n, one or two step-twiddle products (two-level tables
    above 2^8 columns) and the scale per element; each input and output
    read or written once, the power table and the step tables once."""
    n = 1 << log_n
    split = min(step_log, 8)
    step_mul = (2 if step_log > split else 1) if step_log else 0
    mulmods = b * (n // 2 * max(0, log_n - 1) + n * (step_mul + scale))
    tables = n * ((1 << split) + (1 << (step_log - split))) if step_log else 0
    return mulmods, 8 * (2 * n * b + max(1, n // 2) + tables)


def goldilocks_path(dev):
    """Phase 8: the Goldilocks 2^24 NTT (bench.py's BENCH_METRIC=ntt) on
    the card, oracle-checked, timed and profiled."""
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.field.spec import GOLDILOCKS
    from zprize_tpu_torch.msm import accum_kernel as ak
    from zprize_tpu_torch.ntt import fr_kernel, gl_kernel, gl_ops, radix2
    from zprize_tpu_torch.ntt.domain import Domain, primitive_root
    from zprize_tpu_torch.utils.oracle import ntt_ints
    q = gl_ops.Q
    log_n = GL_LOG1 + GL_LOG2
    n = 1 << log_n

    def fwd(v):
        return gl_kernel.ntt_fourstep_packed(GL_LOG1, GL_LOG2, v, dev)

    def inv(v):
        return gl_kernel.ntt_packed(log_n, v[:, None], True, dev)[:, 0]

    # bench.py's input: 4096 seeded draws, tiled
    rng = random.Random(0)
    sample = [rng.randrange(q) for _ in range(GL_PERIOD)]
    x = gl_ops.from_ints(sample, dev).repeat(n // GL_PERIOD)
    ak.reset_launches()
    fr_kernel.reset_launches()
    gl_kernel.reset_launches()
    t0 = time.time()
    out = fwd(x)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    # the closed form of a period-P input: A[k] = 0 unless n/P | k, and
    # A[(n/P) k'] = (n/P) * DFT_P(sample)[k'] with the root w^(n/P)
    reps = n // GL_PERIOD
    w = primitive_root(GOLDILOCKS, log_n)
    expect = [reps * v % q for v in ntt_ints(sample, pow(w, reps, q), q)]
    grid = out.view(GL_PERIOD, reps)
    nonzero = int((grid[:, 1:] != 0).sum())
    if nonzero or gl_ops.to_ints(grid[:, 0]) != expect:
        raise AssertionError(f"2^{log_n} NTT of bench.py's input != the "
                             f"closed form ({nonzero} stray nonzeros)")
    log(f"goldilocks 2^{log_n}: bench.py's input, all {n} outputs equal the "
        f"closed form (first call {first_s:.3f} s with its tables)")

    # a random input against the plain radix-2 stage loop (no four-step)
    gen = torch.Generator(device=dev).manual_seed(SEED + log_n)
    r = gl_random((n,), gen, dev)
    got = fwd(r)
    t0 = time.time()
    ref = gl_kernel.gl_ntt_plain(r[:, None], log_n)[:, 0]
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    err = max_abs_err(got, ref)
    back_diff = int((inv(got) != r).sum())
    torch.cuda.synchronize()
    log(f"goldilocks 2^{log_n} random input: four-step vs plain stage loop "
        f"{err} ({plain_s:.3f} s for the plain loop with its table), "
        f"inverse round trip {back_diff}")
    if err or back_diff:
        raise AssertionError("the random 2^24 NTT disagrees")
    del ref

    # the generic route: radix2.ntt on a Goldilocks domain (words)
    dom = Domain(GOLDILOCKS, 10, dev)
    rows = [[rng.randrange(q) for _ in range(dom.n)] for _ in range(2)]
    before = gl_kernel.launches["gl_ntt"]
    words = radix2.ntt(dom, fp.from_ints(GOLDILOCKS, rows, dev))
    got = [int(v) for v in fp.to_ints(GOLDILOCKS, words).reshape(-1)]
    if got != [v for row in rows for v in ntt_ints(row, dom.w, q)] or \
            gl_kernel.launches["gl_ntt"] == before:
        raise AssertionError("radix2.ntt on a Goldilocks domain is wrong or "
                             "did not launch gl_ntt")
    log("radix2.ntt on a 2^10 Goldilocks domain == python ints, via gl_ntt")

    # the metric: K chained dependent transforms per iteration
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def chain_ms(step):
        v = x
        for _ in range(GL_CHAIN):                  # warm-up
            v = step(v)
        times = []
        for _ in range(GL_ITERS):
            v = x
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(GL_CHAIN):
                v = step(v)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / GL_CHAIN)
        return times

    before = gl_kernel.launches["gl_ntt"]
    fwd_ms = chain_ms(fwd)
    per_ntt = (gl_kernel.launches["gl_ntt"] - before) / (
        GL_CHAIN * (GL_ITERS + 1))
    inv_ms = chain_ms(inv)
    peak = torch.cuda.max_memory_allocated()
    launches = {**gl_kernel.launches, **fr_kernel.launches,
                **{k: ak.launches[k] for k in ak.KERNELS}}
    stray = {k: v for k, v in launches.items() if k != "gl_ntt" and v}
    if launches["gl_ntt"] == 0 or stray:
        raise AssertionError(f"the Goldilocks path launched {launches}")
    mean = sum(fwd_ms) / GL_ITERS
    log(f"goldilocks_ntt_2^{log_n}_ms: {mean:.4f} (forward, {GL_CHAIN}-chain "
        f"x {GL_ITERS}), inverse {sum(inv_ms) / GL_ITERS:.4f} ms, "
        f"{per_ntt:g} gl_ntt launches per NTT, peak {peak / 1e9:.3f} GB")
    summary = {
        "metric": f"goldilocks_ntt_2^{log_n}_ms", "value": mean,
        "unit": "ms", "n": n, "split": [GL_LOG1, GL_LOG2],
        "ntt_ms": fwd_ms, "intt_ms": inv_ms,
        "intt_ms_mean": sum(inv_ms) / GL_ITERS,
        "chain": GL_CHAIN, "iters": GL_ITERS,
        "first_call_s": first_s,
        "max_memory_allocated": peak,
        "gl_ntt_launches_per_ntt": per_ntt,
        "launches": launches,
        "checked": {"bench_input_outputs": n, "random_vs_plain": n,
                    "round_trip": n, "radix2_domain_2^10": 2 * dom.n},
    }
    def fwd_chain():
        v = x
        for _ in range(GL_CHAIN):
            v = fwd(v)

    summary["profile"] = profile_call(
        f"goldilocks 2^{log_n} NTT x {GL_CHAIN} (chained)", fwd_chain)
    summary["profile"]["ntts"] = GL_CHAIN
    # the four-step transpose is in gl_ntt's store: the chain runs the
    # kernel twice an NTT and nothing else (no copy between the passes)
    prof = summary["profile"]
    if per_ntt != 2 or not prof["complete"] or prof["other_kernels"] or \
            prof["traced"].get("gl_ntt") != 2 * GL_CHAIN:
        raise AssertionError(f"the 2^{log_n} NTT chain launched gl_ntt "
                             f"{per_ntt} times an NTT, traced "
                             f"{prof['traced']}, other device work "
                             f"{prof['other_kernels']}")
    log(f"goldilocks 2^{log_n}: 2 gl_ntt launches an NTT and no other "
        "kernel in the profiled chain")
    return x, launches, summary


def gl_row(x, launches, dev):
    """gl_ntt at the main path's shapes, timed beside its plain version
    and its bound, and checked against the plain version: the column pass
    of the 2^24 four-step (2^12 x 4096 with the step twiddle and the
    transposed store) first; under "shapes" the row pass, the inverse's
    row pass (with n^-1), and 2^9 x 32768, a size of the TPU's fused
    kernel."""
    from zprize_tpu_torch.ntt import gl_kernel, gl_ops
    q = gl_ops.Q
    shapes = []
    cols = x.view(1 << GL_LOG1, 1 << GL_LOG2)
    rows = x.view(1 << GL_LOG2, 1 << GL_LOG1)
    small = x.view(1 << 9, -1)
    n_inv = pow(1 << (GL_LOG1 + GL_LOG2), -1, q)
    for label, v, log_n, inverse, step_log, scale, tr in (
            ("column pass", cols, GL_LOG1, False, GL_LOG2, None, True),
            ("row pass", rows, GL_LOG2, False, 0, None, False),
            ("inverse row pass", rows, GL_LOG2, True, 0, n_inv, False),
            ("2^9 columns", small, 9, False, 0, None, False)):
        args = (v, log_n, inverse, step_log, 1, scale, tr)
        ms = timed(lambda: gl_kernel.gl_ntt(*args), 20)
        t0 = time.time()
        ref = gl_kernel.gl_ntt_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = max_abs_err(gl_kernel.gl_ntt(*args), ref)
        if err != 0:
            raise AssertionError(f"gl_ntt != plain at the {label}")
        mulmods, n_bytes = gl_bound(log_n, v.shape[1], step_log,
                                    scale is not None)
        b_ms, b_by = bound_ms(mulmods, n_bytes, IMAD_PER_MULMOD_GL)
        shapes.append({"shape": label, "n": 1 << log_n, "batch": v.shape[1],
                       "inverse": inverse, "step_twiddle": bool(step_log),
                       "transposed_store": tr,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by})
        log(f"gl_ntt {label} 2^{log_n} x {v.shape[1]}: {ms:.4f} ms (plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by}), "
            "kernel == plain")
    first = shapes[0]
    return {"name": "gl_ntt", "route": "cuda",
            "source": "zprize_tpu_torch/csrc/ntt_gl.cu",
            "replaces": "zprize_tpu/ntt/gl_kernel.py:110",
            "also_replaces": "zprize_tpu/ntt/gl_kernel.py:179",
            "launches": launches["gl_ntt"],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shapes": shapes}


def _rank_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gloo_cuda_probe(world):
    """Whether gloo takes tensors on the card in all_gather and
    all_to_all_single (the collectives of parallel/mesh.py) without their
    going through the host: "ok", or the error's first line."""
    import torch.distributed as dist
    out = {}
    x = torch.full((4, 2), world.rank, dtype=torch.int32, device=world.device)
    for name in ("all_gather", "all_to_all_single"):
        try:
            if name == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world.size)]
                dist.all_gather(parts, x, group=world.group)
                good = all(int(p[0, 0]) == r for r, p in enumerate(parts))
            else:
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x, group=world.group)
                good = [int(v) for v in y[:, 0]] == [
                    r for r in range(world.size)
                    for _ in range(4 // world.size)]
            out[name] = "ok" if good else "wrong result"
        except Exception as exc:       # the finding is the error itself
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    return out


def shard_msm(world, log_n, timed_reps):
    """Phase 12a on one rank: the points-sharded BLS12-377 MSM of 2^log_n
    tiled points (N_BASE distinct (i+1)·G; this rank's block) and one
    seeded compact scalar batch made on the card (the same on every
    rank), c from `default_window_bits` of the rank's rows.  A warm-up
    (its launches counted) and `timed_reps` timed calls on the host clock
    (each ends in the all-gather, so it waits for the slowest rank); rank
    0 checks the result against the closed-form oracle."""
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.curve.spec import BLS12_377_G1
    from zprize_tpu_torch.msm import pippenger
    from zprize_tpu_torch.parallel.mesh import shard_rows
    from zprize_tpu_torch.parallel.msm_sharded import msm_sharded
    from zprize_tpu_torch.utils import oracle
    curve, dev = BLS12_377_G1, world.device
    n = 1 << log_n
    n_local = n // world.size
    aff = tiled_points(curve, n_local, dev)      # the block of the tiling
    gen = torch.Generator(device=dev).manual_seed(SEED + log_n)
    batch = oracle.scalar_batch_torch(curve, n, gen)
    s_local = shard_rows(batch, world)
    c = pippenger.default_window_bits(n_local)
    reset_all_launches()
    res = msm_sharded(curve, aff, s_local, world, c=c)
    _rank_sync(dev)
    launches = all_launches()
    times = []
    for _ in range(timed_reps):
        _rank_sync(dev)
        t0 = time.perf_counter()
        res = msm_sharded(curve, aff, s_local, world, c=c)
        _rank_sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    if world.rank == 0:
        check_tiled(curve, res, batch.cpu().numpy(),
                    f"sharded MSM 2^{log_n} over {world.size} ranks")
    return {"n": n, "n_local": n_local, "c": c,
            "affine": sw.to_affine_ints(curve, res), "ms": times,
            "launches": launches, "oracle_checked": world.rank == 0}


def shard_ntt(world, log_n1, log_n2, period, iters):
    """Phase 12b on one rank: the column-sharded Goldilocks four-step of
    bench.py's periodic input (`period` draws of random.Random(0), tiled),
    a warm-up (its launches counted, its tables built) and `iters` timed
    calls on the host clock, on the card one more call traced on rank 0;
    the rank's rows of the output checked bit for bit against the
    single-device `ntt_fourstep_packed`."""
    from zprize_tpu_torch.field.spec import GOLDILOCKS
    from zprize_tpu_torch.ntt import gl_kernel, gl_ops
    from zprize_tpu_torch.parallel.ntt_sharded import ntt_fourstep_sharded
    dev, d, r = world.device, world.size, world.rank
    n1, n2 = 1 << log_n1, 1 << log_n2
    rng = random.Random(0)
    sample = [rng.randrange(gl_ops.Q) for _ in range(period)]
    x = gl_ops.from_ints(sample, dev).repeat(n1 * n2 // period)
    cols, rows = n2 // d, n1 // d
    m_local = gl_ops.to_words(x.view(n1, n2)[:, r * cols:(r + 1) * cols])
    reset_all_launches()
    c_local = ntt_fourstep_sharded(GOLDILOCKS, m_local, world, log_n1,
                                   log_n2)
    _rank_sync(dev)
    launches = all_launches()
    times = []
    for _ in range(iters):
        _rank_sync(dev)
        t0 = time.perf_counter()
        c_local = ntt_fourstep_sharded(GOLDILOCKS, m_local, world, log_n1,
                                       log_n2)
        _rank_sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    profile = None
    if dev.type == "cuda":
        # one more call, traced on rank 0: the device time by kernel and
        # op (the collective's host side does not show)
        from torch.profiler import ProfilerActivity, profile as trace
        _rank_sync(dev)
        if r == 0:
            t0 = time.perf_counter()
            with trace(activities=[ProfilerActivity.CUDA]) as prof:
                ntt_fourstep_sharded(GOLDILOCKS, m_local, world, log_n1,
                                     log_n2)
                _rank_sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
            ops = sorted(device_kernels(prof), reverse=True)
            profile = {"wall_ms": wall,
                       "device_ms": sum(ms for ms, _, _ in ops),
                       "top": [[round(ms, 4), k, name[:60]]
                               for ms, k, name in ops[:8]]}
        else:
            ntt_fourstep_sharded(GOLDILOCKS, m_local, world, log_n1, log_n2)
    # C[k1, k2] = A[k1 + n1 k2]: the rank's rows k1 of A read as (n2, n1)
    ref = gl_kernel.ntt_fourstep_packed(log_n1, log_n2, x, dev)
    mine = ref.view(n2, n1).t()[r * rows:(r + 1) * rows]
    wrong = int((gl_ops.from_words(c_local) != mine).sum())
    if wrong:
        raise AssertionError(f"rank {r}: {wrong} outputs of the sharded "
                             "four-step != the single-device four-step")
    return {"log_n": log_n1 + log_n2, "ms": times,
            "ms_mean": sum(times) / len(times), "launches": launches,
            "checked_outputs": rows * n2, "profile": profile}


def shard_proof(world, shards, wires, public, seed):
    """Phase 12c on one rank: ShardedProver over this rank's KeyShard, a
    warm-up proof (its launches counted) and a timed one, each with
    blinding_rng = random.Random(seed), so both are the same proof; then
    one with no rng (rank 0 draws the blinding for every rank)."""
    from zprize_tpu_torch import convert
    from zprize_tpu_torch.curve.spec import BLS12_377_G1
    from zprize_tpu_torch.parallel.plonk_sharded import ShardedProver
    dev, d, r = world.device, world.size, world.rank
    t0 = time.perf_counter()
    prover = ShardedProver(shards[r], world)
    m = wires.shape[1] // d
    local = wires[:, r * m:(r + 1) * m].to(dev)
    _rank_sync(dev)
    init_s = time.perf_counter() - t0
    reset_all_launches()
    times, proofs = [], []
    for k in range(2):
        _rank_sync(dev)
        t0 = time.perf_counter()
        proof = prover.prove(local, public, blinding_rng=random.Random(seed))
        _rank_sync(dev)
        times.append(time.perf_counter() - t0)
        if k == 0:
            launches = all_launches()
        proofs.append(convert.proof_ints(BLS12_377_G1, proof))
    if proofs[0] != proofs[1]:
        raise AssertionError(f"rank {r}: two proofs of one seed differ")
    unseeded = convert.proof_ints(BLS12_377_G1, prover.prove(local, public))
    return {"proof": proofs[0], "unseeded_proof": unseeded,
            "init_s": init_s, "warmup_s": times[0], "prove_s": times[1],
            "launches": launches}


def sharded_rank(world, msm, ntt, proof, probe):
    """Phase 12 on one rank of `world`: `msm` (log n, timed calls), `ntt`
    (log n1, log n2, period, iterations) and `proof` (KeyShards, wires,
    public, seed) each None or the arguments of its part; with `probe`,
    the gloo probe first.  Prints nothing: the parent reports."""
    out = {"rank": world.rank, "device": str(world.device)}
    if probe:
        out["gloo_cuda"] = gloo_cuda_probe(world)
    if msm is not None:
        out["msm"] = shard_msm(world, *msm)
    if ntt is not None:
        out["ntt"] = shard_ntt(world, *ntt)
    if proof is not None:
        out["proof"] = shard_proof(world, *proof)
    return out


def _same_on_every_rank(results, part, key):
    vals = [res[part][key] for res in results]
    if any(v != vals[0] for v in vals):
        raise AssertionError(f"{part}: the ranks disagree on {key}")
    return vals[0]


def _proof_from_ints(curve, ints, dev):
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.plonk.prover import Proof
    f, fr = curve.field, curve.scalar
    comms = [sw.Point(*(fp.from_ints(f, [v], dev)[0] for v in (*xy, 1)))
             for xy in ints["comms"]]
    evals = {k: fp.from_ints(fr, [v], dev)[0]
             for k, v in ints["evals"].items()}
    return Proof(comms[:3], comms[3], comms[4:7], evals, comms[7], comms[8])


def sharded_path(dev, pk, wires, public):
    """Phase 12: the sharded forms (parallel/) over worlds of ranks that
    share the one card: SHARD_RANKS gloo ranks run the 2^SHARD_MSM_LOG
    sharded MSM, the sharded Goldilocks 2^24 four-step and the sharded
    PLONK proof of phase 7's key and witness; a world of one NCCL rank
    runs the MSM at 2^SHARD_NCCL_MSM_LOG and the four-step; first,
    `entry()`'s fixed-shape MSM.  Every result is checked (oracle,
    single-device forms, verifier) in the ranks or here; returns (rank
    0's launches by part, summary)."""
    from zprize_tpu_torch import convert
    from zprize_tpu_torch.curve import sw
    from zprize_tpu_torch.curve.spec import BLS12_377_G1
    from zprize_tpu_torch.entry import entry
    from zprize_tpu_torch.field import fp
    from zprize_tpu_torch.msm import pippenger
    from zprize_tpu_torch.parallel import mesh, plonk_sharded
    from zprize_tpu_torch.plonk import prover, verifier
    from zprize_tpu_torch.utils import oracle
    curve = BLS12_377_G1
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # the single-chip entry: one fixed-shape MSM of the generator tiled
    fn, args = entry(dev)
    got = sw.to_affine_ints(curve, sw.Point(*fn(*args)))
    limbs = args[3].cpu().numpy().astype(object)        # base 2^15
    total = int((limbs @ [1 << 15 * j for j in range(limbs.shape[1])]).sum())
    if got != oracle.ec_mul(oracle.generator(curve), total % curve.order,
                            curve.field.p):
        raise AssertionError("entry(): its MSM != the oracle")
    log("entry(): the fixed-shape MSM (n = 256, c = 6) == the oracle")
    ntt_args = (GL_LOG1, GL_LOG2, GL_PERIOD, SHARD_NTT_ITERS)
    shards = [plonk_sharded.key_shard(pk, SHARD_RANKS, r)
              for r in range(SHARD_RANKS)]
    proof_args = (shards, wires.cpu(), public, SHARD_PROOF_SEED)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    ranks = mesh.spawn_world(
        sharded_rank, SHARD_RANKS, dev, "gloo",
        args=((SHARD_MSM_LOG, SHARD_MSM_TIMED), ntt_args, proof_args,
              dev.type == "cuda"), timeout_s=SHARD_TIMEOUT_S)
    gloo_s = time.time() - t0
    r0 = ranks[0]
    log(f"phase 12 gloo world of {SHARD_RANKS} on {dev}: {gloo_s:.1f} s "
        f"with the spawn; gloo on CUDA tensors: {r0.get('gloo_cuda')}")

    def msm_reference(log_n, got):
        """The single-device msm_jit_static of the same inputs."""
        n = 1 << log_n
        gen = torch.Generator(device=dev).manual_seed(SEED + log_n)
        batch = oracle.scalar_batch_torch(curve, n, gen)
        c = got["c"]
        ref = pippenger.msm_jit_static(curve, tiled_points(curve, n, dev),
                                       batch, c, n)
        sync()
        if sw.to_affine_ints(curve, ref) != tuple(got["affine"]):
            raise AssertionError(f"sharded MSM 2^{log_n} != the "
                                 "single-device MSM")

    msm = dict(r0["msm"], affine=_same_on_every_rank(ranks, "msm",
                                                     "affine"))
    msm_reference(SHARD_MSM_LOG, msm)
    log(f"sharded MSM 2^{SHARD_MSM_LOG} ({SHARD_RANKS} x "
        f"{msm['n_local']}, c = {msm['c']}): "
        f"{msm['ms']} ms (rank 0, host clock), == oracle and == the "
        "single-device MSM")
    ntt = r0["ntt"]
    log(f"sharded goldilocks 2^{ntt['log_n']}: {ntt['ms']} ms, every output "
        "== the single-device four-step")

    proof_ints = _same_on_every_rank(ranks, "proof", "proof")
    ref_proof = prover.prove_planes(pk, wires, public,
                                    blinding_rng=random.Random(
                                        SHARD_PROOF_SEED))
    if convert.proof_ints(curve, ref_proof) != proof_ints:
        raise AssertionError("the sharded proof != phase 7's single-device "
                             "proof")
    sharded = _proof_from_ints(curve, proof_ints, dev)
    if not verifier.verify(pk.vk, pk.srs, sharded, public):
        raise AssertionError("the sharded proof does not verify")
    bad = dict(sharded.evals)
    bad["a"] = fp.add(curve.scalar, bad["a"], fp.ones(curve.scalar, (), dev))
    if verifier.verify(pk.vk, pk.srs, prover.Proof(
            sharded.wire_comms, sharded.z_comm, sharded.t_comms, bad,
            sharded.w_zeta, sharded.w_zeta_omega), public):
        raise AssertionError("a tampered sharded proof verifies")
    unseeded = _proof_from_ints(curve, _same_on_every_rank(
        ranks, "proof", "unseeded_proof"), dev)
    if not verifier.verify(pk.vk, pk.srs, unseeded, public):
        raise AssertionError("the sharded proof blinded from the host's "
                             "entropy does not verify")
    log(f"sharded PLONK n = {pk.circuit.n}: warm-up "
        f"{r0['proof']['warmup_s']:.3f} s, timed {r0['proof']['prove_s']:.3f}"
        " s (rank 0); == the single-device proof, verified, a tampered "
        "evaluation rejected; a proof with no rng verified")

    t0 = time.time()
    one = mesh.spawn_world(
        sharded_rank, 1, dev, None,
        args=((SHARD_NCCL_MSM_LOG, SHARD_MSM_TIMED), ntt_args, None, False),
        timeout_s=SHARD_TIMEOUT_S)[0]
    nccl_s = time.time() - t0
    msm_reference(SHARD_NCCL_MSM_LOG, one["msm"])
    log(f"phase 12 world of 1 ({'nccl' if dev.type == 'cuda' else 'gloo'}):"
        f" {nccl_s:.1f} s with the spawn; MSM 2^{SHARD_NCCL_MSM_LOG} "
        f"{one['msm']['ms']} ms, goldilocks 2^{one['ntt']['log_n']} "
        f"{one['ntt']['ms']} ms, both checked")

    launches = {"msm": r0["msm"]["launches"], "ntt": r0["ntt"]["launches"],
                "proof": r0["proof"]["launches"]}
    for part, names in (("msm", ("sw_gather_accumulate",)),
                        ("ntt", ("gl_ntt",)),
                        ("proof", ("sw_gather_accumulate", "fr_ntt"))):
        missing = [k for k in names if not launches[part][k]]
        if missing:
            raise AssertionError(f"rank 0's sharded {part} launched no "
                                 f"{missing}")
    if not (one["msm"]["launches"]["sw_gather_accumulate"]
            and one["ntt"]["launches"]["gl_ntt"]):
        raise AssertionError("the world of one launched no "
                             "sw_gather_accumulate or no gl_ntt")
    summary = {
        "metric": "sharded",
        "world": SHARD_RANKS, "backend": "gloo",
        "ranks_per_card": SHARD_RANKS if dev.type == "cuda" else None,
        "collectives_staged_through_host": dev.type == "cuda",
        "gloo_cuda_probe": r0.get("gloo_cuda"),
        f"goldilocks_ntt_dist_2^{ntt['log_n']}_ms": ntt["ms_mean"],
        "goldilocks_ntt_dist_ms": ntt["ms"],
        f"msm_sharded_2^{SHARD_MSM_LOG}_ms": msm["ms"],
        "msm_sharded_c": msm["c"],
        "sharded_proof_n": pk.circuit.n,
        "sharded_prove_s": r0["proof"]["prove_s"],
        "sharded_warmup_prove_s": r0["proof"]["warmup_s"],
        "sharded_prover_init_s": r0["proof"]["init_s"],
        "gloo_world_s": gloo_s,
        "nccl_world": {
            "world": 1, "backend": "nccl" if dev.type == "cuda" else "gloo",
            f"msm_2^{SHARD_NCCL_MSM_LOG}_ms": one["msm"]["ms"],
            f"goldilocks_ntt_dist_2^{one['ntt']['log_n']}_ms":
                one["ntt"]["ms_mean"],
            "ntt_profile": one["ntt"]["profile"],
            "world_s": nccl_s},
        "goldilocks_ntt_dist_profile_rank0": ntt["profile"],
        "launches_rank0": launches,
        "checks": ["msm == oracle and == single-device",
                   "ntt == single-device four-step (every output)",
                   "proof == single-device proof, verifies, tamper "
                   "rejected; an unseeded proof verifies",
                   "world of 1: msm == oracle and == single-device, ntt =="
                   " single-device"],
    }
    return launches, summary


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
    from zprize_tpu_torch.msm import probe
    from zprize_tpu_torch.plonk import prover
    from zprize_tpu_torch.utils import build

    start_s = time.time()
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
    check_combine(curve, dev)
    check_tree_sum(curve, dev)
    probe_rows, lat = latency_rows(curve, dev)
    # the probes are on no path: count their launches over all of them
    probe.reset_launches()
    t0 = time.time()
    for sw_curve in (BLS12_381_G1, BLS12_377_G1):
        for lanes in (4096, 1000):
            check_sw_kernels(sw_curve, dev, lanes)
    log(f"phase 3d: {time.time() - t0:.1f} s")
    t0 = time.time()
    for sw_curve in (BLS12_381_G1, BLS12_377_G1):
        check_tree_sum(sw_curve, dev, "sw")
    log(f"phase 3e: {time.time() - t0:.1f} s")
    check_ntt(dev)
    ntt_prof = profile_ntt(dev)
    check_gl_ntt(dev)
    # phase 8 runs before the MSM phases: late in a run, after their large
    # profiles, the trace of its short window came back without some or
    # all of its device events
    gl_x, gl_launches, goldilocks = goldilocks_path(dev)
    gl_kernel_row = gl_row(gl_x, gl_launches, dev)
    del gl_x
    torch.cuda.empty_cache()
    t0 = time.time()
    sw_ctx, sw_aff, sw_batch, sw_launches, sw_msm = sw_path(dev)
    sw_msm["profile"] = profile_msm(sw_ctx, sw_batch)
    sw_kernel_rows = sw_rows(BLS12_381_G1, sw_ctx, sw_aff, sw_batch,
                             sw_launches, sw_msm["launches_per_msm"], lat,
                             dev)
    log(f"phase 9: {time.time() - t0:.1f} s")
    del sw_ctx, sw_aff
    torch.cuda.empty_cache()
    ctx, aff, batch, launches, summary = main_path(curve, dev)
    summary["profile"] = profile_msm(ctx, batch)
    kernels = kernel_rows(curve, ctx, aff, batch, launches, lat, dev)
    t0 = time.time()
    gather, gather_shape = collapsed_gather_path(curve, ctx, dev)
    log(f"phase 4, collapsed gather route: {time.time() - t0:.1f} s")
    del ctx, aff
    torch.cuda.empty_cache()
    ctx, batch, launches, prize = prize_path(curve, dev)
    prize["profile"] = profile_msm(ctx, batch)
    kernels.extend(prize_rows(curve, ctx, batch, launches,
                              prize["launches_per_msm"], lat, dev))
    del batch
    t0 = time.time()
    sorted_msm, sorted_shape = sorted_streamed_path(curve, ctx, dev)
    log(f"phase 4b, sorted route: {time.time() - t0:.1f} s")
    del ctx
    torch.cuda.empty_cache()
    # the accumulates' rows at the other routes' shapes
    for row in kernels:
        if row["name"] == "te_gather_accumulate":
            row["collapsed_gather_2^18"] = gather_shape
        elif row["name"] == "te_bucket_accumulate":
            row[f"sorted_streamed_2^{PRIZE_LOG}"] = sorted_shape
    pk, wires, public, plonk_launches, plonk = plonk_path(dev)
    plonk["profile"] = profile_call("PLONK proof", lambda: prover.prove_planes(
        pk, wires, public, blinding_rng=random.Random(18)))
    kernels.append(ntt_row(pk, plonk_launches, ntt_prof, dev))
    kernels.append(srs_full_add_row(curve, plonk["srs_size"],
                                    plonk_launches["te_full_add"], dev))
    kernels.append(gl_kernel_row)
    kernels.extend(sw_kernel_rows)
    torch.cuda.empty_cache()
    # phases 10 and 11 reset every counter, the probes' too: read the
    # probes' count over phases 3d to 7 first
    for row in probe_rows:
        row["launches"] = probe.launches[row["name"]]
    t0 = time.time()
    verify_launches, verify = verify_path(dev)
    log(f"phase 10: {time.time() - t0:.1f} s")
    t0 = time.time()
    posw_launches, posw_summary = posw_path(dev)
    log(f"phase 11: {time.time() - t0:.1f} s")
    t0 = time.time()
    shard_launches, sharded = sharded_path(dev, pk, wires, public)
    log(f"phase 12: {time.time() - t0:.1f} s")
    del pk, wires
    torch.cuda.empty_cache()
    for row in probe_rows:
        if (row["launches"] or verify_launches[row["name"]]
                or posw_launches[row["name"]]):
            raise AssertionError(f"{row['name']}, a probe, was launched on "
                                 "a path")
    kernels.extend(probe_rows)
    for row in kernels:
        row["launches_marlin_prove_batch_4"] = verify_launches[row["name"]]
        row["launches_posw_batch_8"] = posw_launches[row["name"]]
        for part, counts in shard_launches.items():
            row[f"launches_sharded_{part}_rank0"] = counts[row["name"]]
    print(json.dumps(summary), flush=True)
    print(json.dumps(prize), flush=True)
    print(json.dumps(gather), flush=True)
    print(json.dumps(sorted_msm), flush=True)
    print(json.dumps(plonk), flush=True)
    print(json.dumps(goldilocks), flush=True)
    print(json.dumps(sw_msm), flush=True)
    print(json.dumps(verify), flush=True)
    print(json.dumps(posw_summary), flush=True)
    print(json.dumps(sharded), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"chip_smoke total: {time.time() - start_s:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
