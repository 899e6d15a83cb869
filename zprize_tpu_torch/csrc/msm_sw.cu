// Short-Weierstrass (y^2 = x^3 + b, a = 0) MSM kernels for Hopper: the
// bucket accumulate, the complete add, the bucket merge's running sums and
// trees, and the window combine of the SW route.
//
// Five kernels (the tree sum in two launches), each with a plain C
// launcher that ctypes binds
// (zprize_tpu_torch/msm/accum_kernel.py holds the wrappers and the plain
// PyTorch version of each).  A launcher takes device pointers, sizes, the
// curve's 3b and the stream, allocates nothing, launches on that stream
// without synchronising, and returns cudaGetLastError().
//
// Layouts (int32 words, contiguous, row-major):
//   point   (..., 3, 12): X, Y, Z in Montgomery form (csrc/fq.cuh), the
//                         identity (0 : 1 : 0)
//   affine  (n, 12) x and (n, 12) y planes, one 48-byte row a point
// The params tensor is fq.cuh's, with k = 3b in Montgomery form (unused:
// the kernels multiply by 3b as additions).
//
// The formulas are the Renes-Costello-Batina complete a = 0 sequences of
// zprize_tpu_torch/curve/sw.py (add_mixed, add, dbl_a0): keep them in
// lockstep, since kernel and plain version must agree word for word.
//
// What bounds them on an H100: 32-bit integer multiplies.  One field
// multiplication (mulmod) is 588 IMAD slots (csrc/fq.cuh).  A mixed add
// is 11 mulmods and a full add 12; the two products by the small constant
// 3b of each add run as a chain of modular additions (3b = 12 for
// BLS12-381, 3 for BLS12-377: four and two additions), a template
// argument that the launcher picks from the curve's 3b.  Every result is
// fully reduced either way, so the words equal the plain version's
// products by 3b.  The bytes per add (a 96-byte affine row, an index and
// a sign) are far below the multiplies.  The design answer is the one of
// csrc/msm_te.cu: one thread per independent chain with the whole point
// in registers, 128-thread blocks.  The gather keeps its next row in
// flight (cp.async into a two-stage ring, csrc/ring.cuh); the bucket
// merge walks chunks of buckets with both running sums in registers; its
// trees run an up-sweep in shared memory, each add on a group of 4
// threads; the window combine folds all windows in one launch.  Measured
// on an H100 at the 2^18 BLS12-381 path's shapes (PERF.md): the gather at
// 55 % of its bound, the running sum at 22 % (9,728 lanes: under one
// wave), the trees 0.06-0.07 ms a call, the final combine one thread's
// serial chain of 2.37 ms.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fq.cuh"
#include "ring.cuh"

// BLS12-377/381 base field: 12 words (csrc/fq.cuh)
constexpr int NW = 12;
using Fq = fq::Fe<NW>;
using Params = fq::Params<NW>;

namespace {

constexpr int BLOCK = 128;
constexpr int PT_WORDS = 3 * NW;
constexpr int ROW_CHUNKS = 2 * NW / 4;     // 16-byte words of an x, y row
constexpr int STAGE = ROW_CHUNKS * BLOCK;  // one stage of the gather's ring

// Blocks of 128 threads a SM that ptxas must fit in the SM's 65,536
// registers: 3 leaves 168 registers a thread, 2 leaves 255.  At 3 the
// BLS12-381 gather keeps a 24-byte stack frame; at 2 it has none but ran
// 13 % slower on an H100 (PERF.md), so the gather takes 3.
constexpr int GATHER_MIN_BLOCKS = 3;
constexpr int RUNNING_SUM_MIN_BLOCKS = 2;

struct Pt {
  Fq x, y, z;
};

__device__ __forceinline__ Pt load_pt(const uint32_t* src) {
  return {fq::load<NW>(src), fq::load<NW>(src + NW),
          fq::load<NW>(src + 2 * NW)};
}

__device__ __forceinline__ void store_pt(uint32_t* dst, const Pt& a) {
  fq::store(dst, a.x);
  fq::store(dst + NW, a.y);
  fq::store(dst + 2 * NW, a.z);
}

// K * x mod p for a small constant K > 0, as modular additions: K even,
// twice (K/2) x; K odd, (K-1) x + x.
template <int K>
__device__ __forceinline__ Fq mul_small(const Fq& x, const Params& P) {
  static_assert(K > 0, "the constant must be positive");
  if constexpr (K == 1) {
    return x;
  } else if constexpr (K % 2 == 0) {
    const Fq h = mul_small<K / 2>(x, P);
    return fq::add(h, h, P);
  } else {
    return fq::add(mul_small<K - 1>(x, P), x, P);
  }
}

// The shared tail of the RCB adds (sw.py: _add_tail), B3 = 3b.
template <int B3>
__device__ __forceinline__ Pt add_tail(const Fq& t0, const Fq& t1,
                                       const Fq& t2, const Fq& m_xy,
                                       const Fq& m_yz, const Fq& m_xz,
                                       const Params& P) {
  Fq b3t2 = mul_small<B3>(t2, P);
  Fq u = fq::sub(t1, b3t2, P);
  Fq v = fq::add(t1, b3t2, P);
  Fq w = mul_small<B3>(m_xz, P);
  Fq t3 = fq::add(fq::add(t0, t0, P), t0, P);
  return {fq::sub(fq::mul(m_xy, u, P), fq::mul(m_yz, w, P), P),
          fq::add(fq::mul(v, u, P), fq::mul(t3, w, P), P),
          fq::add(fq::mul(m_yz, v, P), fq::mul(m_xy, t3, P), P)};
}

// Complete mixed add p + (x, y) (sw.py: add_mixed); a(j) gives the
// affine operand's coordinate j (0: x, 1: y), read where it is used.
template <int B3, class A>
__device__ __forceinline__ Pt madd(const Pt& p, const A& a,
                                   const Params& P) {
  Fq t0 = fq::mul(p.x, a(0), P);
  Fq t1 = fq::mul(p.y, a(1), P);
  Fq m_xy = fq::sub(fq::mul(fq::add(p.x, p.y, P), fq::add(a(0), a(1), P), P),
                    fq::add(t0, t1, P), P);
  Fq m_yz = fq::add(fq::mul(a(1), p.z, P), p.y, P);
  Fq m_xz = fq::add(fq::mul(a(0), p.z, P), p.x, P);
  return add_tail<B3>(t0, t1, p.z, m_xy, m_yz, m_xz, P);
}

// Complete projective add p + q (sw.py: add); q(j) gives coordinate j of
// the second point (0: X, 1: Y, 2: Z).
template <int B3, class Q>
__device__ __forceinline__ Pt full_add(const Pt& p, const Q& q,
                                       const Params& P) {
  Fq t0 = fq::mul(p.x, q(0), P);
  Fq t1 = fq::mul(p.y, q(1), P);
  Fq t2 = fq::mul(p.z, q(2), P);
  Fq m_xy = fq::sub(fq::mul(fq::add(p.x, p.y, P), fq::add(q(0), q(1), P), P),
                    fq::add(t0, t1, P), P);
  Fq m_yz = fq::sub(fq::mul(fq::add(p.y, p.z, P), fq::add(q(1), q(2), P), P),
                    fq::add(t1, t2, P), P);
  Fq m_xz = fq::sub(fq::mul(fq::add(p.x, p.z, P), fq::add(q(0), q(2), P), P),
                    fq::add(t0, t2, P), P);
  return add_tail<B3>(t0, t1, t2, m_xy, m_yz, m_xz, P);
}

template <int B3>
__device__ __forceinline__ Pt full_add(const Pt& p, const Pt& q,
                                       const Params& P) {
  return full_add<B3>(
      p, [&](int j) { return j == 0 ? q.x : j == 1 ? q.y : q.z; }, P);
}

// The dedicated a = 0 doubling (Renes-Costello-Batina, eprint 2015/1060,
// Algorithm 9; sw.py: dbl_a0): 6 multiplications, 2 squarings and the
// product by 3b as additions, against the complete add's 12.  Complete:
// the identity doubles to the identity.
template <int B3>
__device__ __forceinline__ Pt dbl(const Pt& p, const Params& P) {
  Fq t0 = fq::sqr(p.y, P);
  Fq z8 = mul_small<8>(t0, P);
  Fq t2 = mul_small<B3>(fq::sqr(p.z, P), P);
  Fq x3 = fq::mul(t2, z8, P);
  Fq y3 = fq::add(t0, t2, P);
  Fq z3 = fq::mul(fq::mul(p.y, p.z, P), z8, P);
  t0 = fq::sub(t0, mul_small<3>(t2, P), P);
  y3 = fq::add(x3, fq::mul(t0, y3, P), P);
  x3 = fq::mul(t0, fq::mul(p.x, p.y, P), P);
  return {fq::add(x3, x3, P), y3, z3};
}

// point at src, read coordinate by coordinate where it is used
__device__ __forceinline__ auto point_at(const uint32_t* src) {
  return [src](int j) { return fq::load<NW>(src + j * NW); };
}

// Copy one point's x and y rows (48 bytes each, 16-byte aligned) into a
// thread's ring slot: x as chunks 0..2, y as chunks 3..5 (csrc/ring.cuh).
__device__ __forceinline__ void copy_row(uint4* slot, const uint32_t* x,
                                         const uint32_t* y) {
  const uint4* sx = reinterpret_cast<const uint4*>(x);
  const uint4* sy = reinterpret_cast<const uint4*>(y);
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    ring::copy16(slot + k * BLOCK, sx + k);
    ring::copy16(slot + (NW / 4 + k) * BLOCK, sy + k);
  }
}

// sw_gather_accumulate: replaces make_mixed_add, make_mixed_add_multi and
// make_mixed_add_rect (zprize_tpu/msm/accum_kernel.py) with the rank
// loops that drive them (accumulate_pass_pallas, accumulate_rect_pallas).
// Lane i = w * nbe + b of W windows sums bucket b of window w: the points
// perm[w, r] for r in starts[i] .. starts[i] + counts[i], each negated
// where sign[w, r] != 0.  Bound: 11 mulmods (6468 IMADs) per point;
// bytes are a 96-byte affine row, an 8-byte index and a 4-byte sign per
// point, far below.  Design: one thread per bucket lane walks its whole
// run from the identity with the point in registers, reading x and y
// through the index straight from the coordinate planes.  The random row
// reads are off the critical path, as in k_gather_accumulate
// (csrc/msm_te.cu): while a thread adds point k, point k + 1's x and y
// are on their way into the thread's slot of a two-stage ring in shared
// memory (cp.async, 2 x 128 x 96 = 24,576 bytes a block) and the index of
// point k + 2 into a register; no barrier, since a thread reads only its
// own slot.  The madd reads x and y from the slot where it uses them, and
// a negative sign negates y there, so the row takes no registers.
// ptxas: 168 registers at 3 blocks of 128 a SM, no stack frame for
// BLS12-377 (3b = 3) and 24 bytes for BLS12-381 (3b = 12).  Measured on
// an H100 (PERF.md): 3.50-3.55 ms over the 19 full windows of a 2^18
// batch (4.98e6 points) against a 1.92 ms bound, 55 % of it (without the
// ring and the additions: 4.08-4.11 ms).  The thread's walk takes the
// place of the TPU's fixed-depth rank loop, its tier schedule and its
// fallback passes.
// A bucket holding most points (skewed scalars) makes one thread walk
// them all: right, but serial.  Offsets are 64-bit.
template <int B3>
__global__ void __launch_bounds__(BLOCK, GATHER_MIN_BLOCKS)
    k_sw_gather_accumulate(const uint32_t* params,
                           const uint32_t* __restrict__ px,
                           const uint32_t* __restrict__ py,
                           const long long* __restrict__ perm,
                           const int32_t* __restrict__ sign,
                           const long long* __restrict__ starts,
                           const long long* __restrict__ counts,
                           uint32_t* out, long long n, long long nbe,
                           long long lanes) {
  __shared__ Params P;
  __shared__ uint4 stages[2 * STAGE];
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  const long long r0 = (i / nbe) * n + starts[i];
  const long long count = counts[i];
  const long long* idx = perm + r0;
  const int32_t* sg = sign + r0;
  uint4* const slot0 = stages + threadIdx.x;  // stage s at slot0 + s * STAGE
  // points 0 and 1 in flight, one copy group each
  if (count > 0) copy_row(slot0, px + idx[0] * NW, py + idx[0] * NW);
  ring::commit();
  if (count > 1) {
    copy_row(slot0 + STAGE, px + idx[1] * NW, py + idx[1] * NW);
  }
  ring::commit();
  long long next = count > 2 ? idx[2] : 0;
  bool neg = count > 0 && sg[0] != 0;
  Pt acc = {fq::zero<NW>(), fq::load<NW>(P.one), fq::zero<NW>()};
#pragma unroll 1
  for (long long k = 0; k < count; ++k) {
    const long long ahead = k + 3 < count ? idx[k + 3] : 0;
    const bool neg_next = k + 1 < count && sg[k + 1] != 0;
    uint4* const slot = slot0 + (k & 1) * STAGE;
    ring::wait<1>();  // every group but the newest has landed: point k has
    acc = madd<B3>(acc, [&](int j) {
      const Fq v = ring::word<NW, BLOCK>(slot, j);
      return j == 1 ? fq::select(neg, fq::neg(v, P), v) : v;
    }, P);
    if (k + 2 < count) copy_row(slot, px + next * NW, py + next * NW);
    ring::commit();
    next = ahead;
    neg = neg_next;
  }
  store_pt(out + i * PT_WORDS, acc);
}

// sw_full_add: replaces make_full_add (zprize_tpu/msm/accum_kernel.py),
// the adder of the bucket-sum trees and of the narrow windows'
// bit-decomposed merge.  Bound: 12 mulmods per lane.  Design: one thread
// per lane; the sum overwrites acc in place (acc and q may be the same
// tensor: each thread reads both before it writes), and skip lanes leave
// acc as it is.
template <int B3>
__global__ void __launch_bounds__(BLOCK)
    k_sw_full_add(const uint32_t* params, uint32_t* acc, const uint32_t* q,
                  const int32_t* skip, long long n) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || skip[i] != 0) return;
  Pt a = load_pt(acc + i * PT_WORDS);
  Pt b = load_pt(q + i * PT_WORDS);
  store_pt(acc + i * PT_WORDS, full_add<B3>(a, b, P));
}

// sw_running_sum: replaces the nbe/128 make_full_add launches of the
// bit-decomposed merge's scan (merge_buckets_pallas,
// zprize_tpu/msm/accum_kernel.py) for windows of 1024 buckets or more.  Lane
// l of L sums its chunk of S bucket sums B_0..B_{S-1} (pts (L, S, 3, 12))
// from the top:
//   T = B_{S-1}, U = T;  for j = S-2 .. 0:  T += B_j, U += T
// so T = sum_j B_j and U = sum_j (j+1) B_j.  Bound: 2 (S - 1) full adds,
// 24 (S - 1) mulmods a lane; the bytes (each bucket sum read once, two
// points written a lane) are far below.  Design: k_running_sum
// (csrc/msm_te.cu) on the SW add: one thread per lane, both sums in
// registers, each B_j's coordinates read where they are used; one launch
// takes the place of the scan's launches over (column, bit, window)
// lanes, and 2 nbe adds a window that of nbe * log2(nbe).  ptxas: 246
// and 252 registers at 2 blocks of 128 a SM, no stack frame.  Measured on
// an H100 (PERF.md): 0.26 ms at the 2^18 path's 9,728 lanes x 8 steps
// against a 0.057 ms bound (the lanes fill under one wave of the card);
// the group's whole merge 1.0-1.4 ms where the scan took 3.7-5.1.
template <int B3>
__global__ void __launch_bounds__(BLOCK, RUNNING_SUM_MIN_BLOCKS)
    k_sw_running_sum(const uint32_t* params, const uint32_t* __restrict__ pts,
                     uint32_t* t_out, uint32_t* u_out, long long lanes,
                     int steps) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  const uint32_t* src = pts + i * steps * PT_WORDS;
  Pt t = load_pt(src + (long long)(steps - 1) * PT_WORDS);
  Pt u = t;
#pragma unroll 1
  for (int j = steps - 2; j >= 0; --j) {
    t = full_add<B3>(t, point_at(src + (long long)j * PT_WORDS), P);
    u = full_add<B3>(u, t, P);
  }
  store_pt(t_out + i * PT_WORDS, t);
  store_pt(u_out + i * PT_WORDS, u);
}

// sw_combine: replaces the serial make_full_add launches of the window
// combine and of the merge's fold sum_j 2^j S_j (combine_windows of
// zprize_tpu/msm/pippenger.py, the end of merge_buckets_pallas of
// zprize_tpu/msm/accum_kernel.py).  Lane i of
// ws (n_steps, lanes, 3, 12) folds MSB-first: acc = W_{n_steps-1}, then
// for w = n_steps-2 .. 0, c doublings and one add of W_w.  Bound:
// (n_steps - 1) c doublings of 8 mulmods and n_steps - 1 adds of 12,
// sequential in the lane: one thread's chain of dependent multiplies, far
// from the card's throughput bound (the final combine at c = 13 is 2,320
// mulmods in a row).  Design: one thread per lane with the accumulator in
// registers (k_combine of csrc/msm_te.cu on the SW group law), and the
// dedicated doubling (dbl) where the launch-by-launch walk added the
// accumulator to itself: a third fewer multiplies on the serial chain.
// Any number of lanes.  Measured on an H100 (PERF.md): the final combine
// at c = 13 over 21 windows 2.36-2.40 ms, where 280 launches took
// 4.38-4.94.
template <int B3>
__global__ void __launch_bounds__(BLOCK)
    k_sw_combine(const uint32_t* params, const uint32_t* ws, uint32_t* out,
                 int n_steps, long long lanes, int c) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  Pt acc = load_pt(ws + ((long long)(n_steps - 1) * lanes + i) * PT_WORDS);
#pragma unroll 1
  for (int w = n_steps - 2; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < c; ++k) acc = dbl<B3>(acc, P);
    acc = full_add<B3>(
        acc, point_at(ws + ((long long)w * lanes + i) * PT_WORDS), P);
  }
  store_pt(out + i * PT_WORDS, acc);
}

// sw_tree_sum: replaces the per-level make_full_add launches
// (zprize_tpu/msm/accum_kernel.py) through which the SW merges reduce
// their trees: sum_points over the group columns and the per-bit sums of
// merge_buckets_pallas, the bit-decomposed merge_buckets_all
// (zprize_tpu/msm/pippenger.py), and the slice sums.  It computes the row
// sums of pts (rows, k, 3, 12) and, for a weight offset `first`, the bit
// sums S_j[r] = sum of the members m whose weight first + m has bit j
// set, the identity (0 : 1 : 0) where none has.
//
// The order of the adds is sw_tree_sum_plain's (msm/accum_kernel.py), so
// the words agree: the up-sweep of te_tree_sum (csrc/msm_te.cu) on the SW
// group law.  Member m sits in slot first + m of its row, the slots are
// cut into segments of TREE_SEG, and each segment is summed in place in
// shared memory: at step t, x[L] += x[R] for L = 2 j 2^t, R = L + 2^t,
// and with bits also x[L + 2^b] += x[R + 2^b] for b < t, so that x[0]
// ends as the segment's root and x[2^b] as its part of S_b.  An absent
// right operand leaves the left as it is, an absent left takes the
// right's words: no identity is materialised or added.  A second kernel
// runs the same up-sweep across the segments of each row, one block per
// (row, component): the roots (with the bits above the segment) and,
// apart, each bit's partials.
//
// What bounds it: the chain, not the multiplies.  About 2k full adds a
// row with bits (k without), 12 mulmods each: the 2^18 BLS12-381 path's
// widest tree (19 rows of 512 chunk sums, 9 bits) is 0.0037 ms of the
// card's multiply rate, while its critical path is log2(first + k)
// steps of one add plus a second launch.  Design: a group of TREE_GROUP
// = 4 threads of one warp runs one add.  Thread c (0, 1, 2: X, Y, Z; the
// fourth shadows the third and stores nothing) reads both operands where
// they lie and forms two of the six independent first products (t_c =
// P_c Q_c and the cross product s_c of the pair xy, yz or xz); the group
// trades them through shared-memory slots under __syncwarp of its mask;
// each thread then forms the tail's additions and the two closing
// products of its own output coordinate (X3 = m_xy u - m_yz w, Y3 = v u
// + t3 w, Z3 = m_yz v + m_xy t3).  An add is 4 mulmods deep on the chain
// instead of 12.  A segment of 64 slots (9 KB) sits in shared memory
// under a block of 32 groups; the segments' partials go through global
// memory to the second launch.  ptxas: 127 and 128 registers, no stack
// frame, 21,968 bytes of shared memory a segment block and 12,496 a
// finish block.  Measured on an H100 (PERF.md): 0.071 ms at the 2^18
// path's widest tree (19 rows of 512, 9 bit sums), about twice its design
// floor; the trees of one MSM 0.23-0.37 ms, where the per-level
// sw_full_add launches took 2.8-5.5 ms.
constexpr int TREE_GROUP = 4;
constexpr int TREE_GROUPS = BLOCK / TREE_GROUP;
constexpr int TREE_SEG_LOG = 6;
constexpr int TREE_SEG = 1 << TREE_SEG_LOG;

// Thread t's slot h (0: t_c, 1: s_c) holds NW words strided by the
// block, so that a warp's stores hit distinct banks.
__device__ __forceinline__ void put_slot(uint32_t* slots, int h,
                                         const Fq& x) {
#pragma unroll
  for (int j = 0; j < NW; ++j)
    slots[(h * NW + j) * BLOCK + threadIdx.x] = x.v[j];
}

__device__ __forceinline__ Fq get_slot(const uint32_t* slots, int h, int t) {
  Fq r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = slots[(h * NW + j) * BLOCK + t];
  return r;
}

// p + q on a fold group (sw.py: add): lp, rp the points (PT_WORDS each,
// shared or global memory), c the caller's coordinate; returns
// coordinate c of the sum.  Reads lp and rp before the group's first
// barrier, so the caller may store the result over lp.
template <int B3>
__device__ __forceinline__ Fq group_add(const uint32_t* lp,
                                        const uint32_t* rp, int c,
                                        uint32_t* slots, unsigned mask,
                                        const Params& P) {
  const int a = c == 1 ? 1 : 0, b = c == 0 ? 1 : 2;  // xy, yz, xz
  const Fq t = fq::mul(fq::load<NW>(lp + c * NW), fq::load<NW>(rp + c * NW),
                       P);
  const Fq s = fq::mul(
      fq::add(fq::load<NW>(lp + a * NW), fq::load<NW>(lp + b * NW), P),
      fq::add(fq::load<NW>(rp + a * NW), fq::load<NW>(rp + b * NW), P), P);
  __syncwarp(mask);                 // the group has read its last slots
  put_slot(slots, 0, t);
  put_slot(slots, 1, s);
  __syncwarp(mask);
  const int g0 = threadIdx.x & ~(TREE_GROUP - 1);
  auto peer = [&](int h, int j) { return get_slot(slots, h, g0 + j); };
  const Fq t0 = peer(0, 0), t1 = peer(0, 1), t2 = peer(0, 2);
  const Fq m_xy = fq::sub(peer(1, 0), fq::add(t0, t1, P), P);
  const Fq m_yz = fq::sub(peer(1, 1), fq::add(t1, t2, P), P);
  const Fq m_xz = fq::sub(peer(1, 2), fq::add(t0, t2, P), P);
  const Fq b3t2 = mul_small<B3>(t2, P);
  const Fq u = fq::sub(t1, b3t2, P);
  const Fq v = fq::add(t1, b3t2, P);
  const Fq w = mul_small<B3>(m_xz, P);
  const Fq t3 = fq::add(fq::add(t0, t0, P), t0, P);
  const Fq p1 = fq::mul(fq::select(c == 0, m_xy, fq::select(c == 1, v, m_yz)),
                        fq::select(c == 2, v, u), P);
  const Fq p2 = fq::mul(fq::select(c == 0, m_yz, fq::select(c == 1, t3, m_xy)),
                        fq::select(c == 2, t3, w), P);
  return fq::select(c == 0, fq::sub(p1, p2, P), fq::add(p1, p2, P));
}

// One step t of the up-sweep over the positions of x (PT_WORDS each) and
// their presence flags: positions n_live and up are absent, n_pos is a
// power of two.  Item (j, e) of the step is pair j's node add (e = 0) or
// its bit-(e - 1) partials (e = 1 .. t, when `bits`); group grp takes
// items grp, grp + TREE_GROUPS, ...  The items of a step touch disjoint
// positions; the caller puts a barrier between steps.
template <int B3>
__device__ __forceinline__ void tree_step(uint32_t* x, int32_t* present,
                                          int n_live, int n_pos, int t,
                                          bool bits, int grp, int g,
                                          unsigned mask, uint32_t* slots,
                                          const Params& P) {
  const int c = g < 3 ? g : 2;
  const int pairs = n_pos >> (t + 1);
  const int items = pairs * (bits ? t + 1 : 1);
  for (int it = grp; it < items; it += TREE_GROUPS) {
    const int j = it % pairs, e = it / pairs;
    const int li = (j << (t + 1)) + (e ? 1 << (e - 1) : 0);
    const int ri = li + (1 << t);
    if (ri >= n_live || !present[ri]) continue;   // the same in the group
    const bool pl = present[li] != 0;
    __syncwarp(mask);                   // the group has read the flags
    uint32_t* const lp = x + (long long)li * PT_WORDS;
    const uint32_t* const rp = x + (long long)ri * PT_WORDS;
    const Fq v = pl ? group_add<B3>(lp, rp, c, slots, mask, P)
                    : fq::load<NW>(rp + c * NW);
    if (g < 3) fq::store(lp + c * NW, v);
    if (g == 0) present[li] = 1;
  }
}

// Pass 1: block (row, s) sums segment s of its row.  Writes component e
// of the segment (e = 0 the root, e = 1 + b the partial of bit b) to
// seg_pts[row, e, s] and its presence to seg_flags[row, e, s], for e <
// n_comp.
template <int B3>
__global__ void __launch_bounds__(BLOCK)
    k_sw_tree_segment(const uint32_t* params, const uint32_t* pts,
                      uint32_t* seg_pts, int32_t* seg_flags, long long k,
                      int first, int n_seg, int n_comp, int n_pow,
                      int bits) {
  __shared__ Params P;
  __shared__ uint32_t xs[TREE_SEG * PT_WORDS];
  __shared__ int32_t present[TREE_SEG];
  __shared__ uint32_t slots[2 * NW * BLOCK];
  fq::load_params(P, params);
  const long long row = blockIdx.x / n_seg;
  const int s = blockIdx.x % n_seg;
  const long long m0 = (long long)s * TREE_SEG - first;  // slot 0's member
  const uint32_t* const src = pts + row * k * PT_WORDS;
  for (int e = threadIdx.x; e < TREE_SEG * PT_WORDS; e += BLOCK) {
    const long long m = m0 + e / PT_WORDS;
    xs[e] = m >= 0 && m < k ? src[m * PT_WORDS + e % PT_WORDS] : 0;
  }
  for (int i = threadIdx.x; i < TREE_SEG; i += BLOCK)
    present[i] = m0 + i >= 0 && m0 + i < k;
  __syncthreads();
  const int grp = threadIdx.x / TREE_GROUP, g = threadIdx.x % TREE_GROUP;
  const unsigned mask = ((1u << TREE_GROUP) - 1)
                        << (threadIdx.x & 31 & ~(TREE_GROUP - 1));
  for (int t = 0; t < TREE_SEG_LOG; ++t) {
    tree_step<B3>(xs, present, TREE_SEG, TREE_SEG, t, bits != 0, grp, g,
                  mask, slots, P);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n_comp * PT_WORDS; e += BLOCK) {
    const int c = e / PT_WORDS, w = e % PT_WORDS;
    const int pos = c ? 1 << (c - 1) : 0;
    seg_pts[((row * n_comp + c) * n_pow + s) * PT_WORDS + w] =
        xs[pos * PT_WORDS + w];
  }
  for (int c = threadIdx.x; c < n_comp; c += BLOCK)
    seg_flags[(row * n_comp + c) * n_pow + s] = present[c ? 1 << (c - 1) : 0];
}

// dst = the point at src if `live`, else the identity (0 : 1 : 0)
__device__ __forceinline__ void copy_or_identity(uint32_t* dst,
                                                 const uint32_t* src,
                                                 bool live, const Params& P) {
  for (int w = threadIdx.x; w < PT_WORDS; w += BLOCK)
    dst[w] = live ? src[w] : w / NW == 1 ? P.one[w % NW] : 0;
}

// Pass 2: block (row, e) runs the up-sweep over the n_seg segments'
// component e in place in seg_pts (with the bits above the segment for e
// = 0 when `bits`), then writes the row sum (e = 0) and the bit sums:
// bit b < TREE_SEG_LOG from component 1 + b, bit TREE_SEG_LOG + b from
// position 2^b of component 0; an absent one as the identity.
template <int B3>
__global__ void __launch_bounds__(BLOCK)
    k_sw_tree_finish(const uint32_t* params, uint32_t* seg_pts,
                     int32_t* seg_flags, uint32_t* sums, uint32_t* bit_sums,
                     long long rows, int n_seg, int n_comp, int n_pow,
                     int n_bits) {
  __shared__ Params P;
  __shared__ uint32_t slots[2 * NW * BLOCK];
  fq::load_params(P, params);
  const long long row = blockIdx.x / n_comp;
  const int e = blockIdx.x % n_comp;
  uint32_t* const x = seg_pts + (row * n_comp + e) * n_pow * PT_WORDS;
  int32_t* const present = seg_flags + (row * n_comp + e) * n_pow;
  const int grp = threadIdx.x / TREE_GROUP, g = threadIdx.x % TREE_GROUP;
  const unsigned mask = ((1u << TREE_GROUP) - 1)
                        << (threadIdx.x & 31 & ~(TREE_GROUP - 1));
  const bool bits = bit_sums != nullptr;
  for (int t = 0; (1 << (t + 1)) <= n_pow; ++t) {
    tree_step<B3>(x, present, n_seg, n_pow, t, bits && e == 0, grp, g, mask,
                  slots, P);
    __syncthreads();
  }
  if (e == 0) {
    copy_or_identity(sums + row * PT_WORDS, x, true, P);
    for (int j = TREE_SEG_LOG; bits && j < n_bits; ++j) {
      const int pos = 1 << (j - TREE_SEG_LOG);
      copy_or_identity(bit_sums + ((long long)j * rows + row) * PT_WORDS,
                       x + (long long)pos * PT_WORDS,
                       pos < n_seg && present[pos], P);
    }
  } else {
    copy_or_identity(bit_sums + ((long long)(e - 1) * rows + row) * PT_WORDS,
                     x, present[0] != 0, P);
  }
}

unsigned grid_for(long long n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

// Launch `launch(std::integral_constant<int, B3>)` for the curve's 3b:
// one instantiation per supported constant (BLS12-377's SW form and
// BLS12-381); any other value is refused.
template <class F>
int with_b3(int b3, F launch) {
  switch (b3) {
    case 3:
      launch(std::integral_constant<int, 3>{});
      break;
    case 12:
      launch(std::integral_constant<int, 12>{});
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sw_gather_accumulate(const void* params, int b3, const void* px,
                         const void* py, const void* perm, const void* sign,
                         const void* starts, const void* counts, void* out,
                         long long n, long long nbe, long long lanes,
                         void* stream) {
  if (lanes <= 0) return 0;
  return with_b3(b3, [&](auto k) {
    k_sw_gather_accumulate<decltype(k)::value>
        <<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)params, (const uint32_t*)px,
            (const uint32_t*)py, (const long long*)perm,
            (const int32_t*)sign, (const long long*)starts,
            (const long long*)counts, (uint32_t*)out, n, nbe, lanes);
  });
}

int sw_full_add(const void* params, int b3, void* acc, const void* q,
                const void* skip, long long n, void* stream) {
  if (n <= 0) return 0;
  return with_b3(b3, [&](auto k) {
    k_sw_full_add<decltype(k)::value>
        <<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)params, (uint32_t*)acc, (const uint32_t*)q,
            (const int32_t*)skip, n);
  });
}

int sw_running_sum(const void* params, int b3, const void* pts, void* t_out,
                   void* u_out, long long lanes, int steps, void* stream) {
  if (lanes <= 0) return 0;
  return with_b3(b3, [&](auto k) {
    k_sw_running_sum<decltype(k)::value>
        <<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)params, (const uint32_t*)pts, (uint32_t*)t_out,
            (uint32_t*)u_out, lanes, steps);
  });
}

// sums (rows, 3, 12) = the row sums of pts (rows, k, 3, 12); if bit_sums
// is not null, also the bit sums (n_bits, rows, 3, 12) of weights first
// + m.  seg_pts (rows, n_comp, n_pow, 3, 12) and seg_flags (rows,
// n_comp, n_pow) are scratch, with n_seg = ceil((first + k) / 2^seg_log),
// n_pow the power of two at or above it and n_comp = 1 + min(seg_log,
// n_bits) with bits, else 1; seg_log must be TREE_SEG_LOG (the caller's
// sizes follow it).  Two launches on `stream`.
int sw_tree_sum(const void* params, int b3, const void* pts, void* seg_pts,
                void* seg_flags, void* sums, void* bit_sums, long long rows,
                long long k, int first, int n_bits, int seg_log,
                void* stream) {
  if (rows <= 0) return 0;
  if (seg_log != TREE_SEG_LOG || k < 1 || first < 0 || n_bits < 1)
    return (int)cudaErrorInvalidValue;
  const int n_seg = (int)((first + k + TREE_SEG - 1) / TREE_SEG);
  int n_pow = 1;
  while (n_pow < n_seg) n_pow *= 2;
  const bool bits = bit_sums != nullptr;
  const int n_comp =
      bits ? 1 + (n_bits < TREE_SEG_LOG ? n_bits : TREE_SEG_LOG) : 1;
  cudaStream_t st = (cudaStream_t)stream;
  return with_b3(b3, [&](auto kb) {
    constexpr int B3 = decltype(kb)::value;
    k_sw_tree_segment<B3><<<(unsigned)(rows * n_seg), BLOCK, 0, st>>>(
        (const uint32_t*)params, (const uint32_t*)pts, (uint32_t*)seg_pts,
        (int32_t*)seg_flags, k, first, n_seg, n_comp, n_pow, bits);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    k_sw_tree_finish<B3><<<(unsigned)(rows * n_comp), BLOCK, 0, st>>>(
        (const uint32_t*)params, (uint32_t*)seg_pts, (int32_t*)seg_flags,
        (uint32_t*)sums, (uint32_t*)bit_sums, rows, n_seg, n_comp, n_pow,
        n_bits);
  });
}

int sw_combine(const void* params, int b3, const void* ws, void* out,
               int n_steps, long long lanes, int c, void* stream) {
  if (lanes <= 0) return 0;
  return with_b3(b3, [&](auto k) {
    k_sw_combine<decltype(k)::value>
        <<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)params, (const uint32_t*)ws, (uint32_t*)out,
            n_steps, lanes, c);
  });
}

const char* msm_sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
