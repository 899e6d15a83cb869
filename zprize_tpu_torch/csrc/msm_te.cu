// Twisted-Edwards (a = -1, extended coordinates) MSM kernels for Hopper.
//
// Seven kernels (te_tree_sum's in two launches) and two measurement
// probes (k_mul_chain, k_imad_chain),
// each with a plain C launcher that ctypes binds
// (zprize_tpu_torch/msm/accum_kernel.py holds the kernels' wrappers and
// plain PyTorch versions, zprize_tpu_torch/msm/probe.py the probes').  A
// launcher takes device pointers, sizes and the stream, allocates
// nothing, launches on that stream without synchronising, and returns
// cudaGetLastError().
//
// Layouts (int32 words, contiguous, row-major):
//   point    (..., 4, 12): X, Y, Z, T in Montgomery form (csrc/fq.cuh)
//   operand  (..., 3, 12): Y+X, Y-X, 2d*X*Y of an affine point (144 bytes,
//                          nine 16-byte words)
//
// The formulas are the op sequences of zprize_tpu_torch/curve/te.py
// (add_mixed, add, dbl): keep them in lockstep, since kernel and plain
// version must agree bit for bit.
//
// What bounds five of the seven on an H100: 32-bit integer multiplies
// (k_combine, a serial fold, and te_tree_sum's trees are bound by the
// latency of their chains).  One
// field multiplication (mulmod) is 588 IMADs on the carry chains of
// csrc/fq.cuh;
// the kernels read and write a few hundred bytes per thousands of
// multiplies, so memory is far from the limit.  A mixed add costs 7
// mulmods, a full add 9 and a doubling 8.  The design answer is one
// thread per independent chain with the whole point state in registers,
// so every multiply feeds the next without a trip through memory, and
// 128-thread blocks.  The two kernels of the 2^26 MSM's path carry more:
// k_gather_accumulate keeps the next operand row in flight (cp.async into
// a two-stage ring in shared memory) and reads its operands from there;
// k_running_sum walks a chunk of buckets with both running sums in
// registers, so the triangle merge is one launch.  The multiplies run at
// 80 % (gather) and 65 % (running sum) of that bound on the 2^26 MSM's
// path (PERF.md).  Load balance across buckets (skewed scalars) is
// later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"
#include "ring.cuh"

// BLS12-377/381 base field: 12 words (csrc/fq.cuh)
constexpr int NW = 12;
using Fq = fq::Fe<NW>;
using Params = fq::Params<NW>;

namespace {

constexpr int BLOCK = 128;
constexpr int PT_WORDS = 4 * NW;
constexpr int PRE_WORDS = 3 * NW;
constexpr int ROW_CHUNKS = PRE_WORDS / 4;  // 16-byte words of an operand row
constexpr int STAGE = ROW_CHUNKS * BLOCK;  // one stage of the gather's ring

// Blocks of 128 threads a SM that ptxas must fit in the SM's 65,536
// registers: 3 leaves 168 registers a thread, 2 leaves 255.  One more
// block makes ptxas spill (4 for the gather: 128 registers and a 40-byte
// stack frame; 3 for the running sum: 168 and 160 bytes).
constexpr int GATHER_MIN_BLOCKS = 3;
constexpr int RUNNING_SUM_MIN_BLOCKS = 2;

struct Pt {
  Fq x, y, z, t;
};

__device__ __forceinline__ Pt load_pt(const uint32_t* src) {
  return {fq::load<NW>(src), fq::load<NW>(src + NW),
          fq::load<NW>(src + 2 * NW), fq::load<NW>(src + 3 * NW)};
}

__device__ __forceinline__ void store_pt(uint32_t* dst, const Pt& a) {
  fq::store(dst, a.x);
  fq::store(dst + NW, a.y);
  fq::store(dst + 2 * NW, a.z);
  fq::store(dst + 3 * NW, a.t);
}

__device__ __forceinline__ Pt identity(const Params& P) {
  return {fq::zero<NW>(), fq::load<NW>(P.one), fq::load<NW>(P.one),
          fq::zero<NW>()};
}

// Shared tail of the hwcd-3 adds: E=B-A, F=D-C, G=D+C, H=B+A.
__device__ __forceinline__ Pt finish(const Fq& a, const Fq& b, const Fq& c,
                                     const Fq& d, const Params& P) {
  Fq e = fq::sub(b, a, P);
  Fq f = fq::sub(d, c, P);
  Fq g = fq::add(d, c, P);
  Fq h = fq::add(b, a, P);
  return {fq::mul(e, f, P), fq::mul(g, h, P), fq::mul(f, g, P),
          fq::mul(e, h, P)};
}

// madd-2008-hwcd-3 (7M); `neg` adds -Q: Y+X and Y-X swap and C changes
// sign.  row(w) gives the operand's word w (0: Y+X, 1: Y-X, 2: 2dXY),
// read where it is multiplied, so no operand is held across the add.
template <class Row>
__device__ __forceinline__ Pt madd(const Pt& p, const Row& row, bool neg,
                                   const Params& P) {
  Fq a = fq::mul(fq::sub(p.y, p.x, P), row(neg ? 0 : 1), P);
  Fq b = fq::mul(fq::add(p.y, p.x, P), row(neg ? 1 : 0), P);
  Fq c = fq::mul(p.t, row(2), P);
  c = fq::select(neg, fq::neg(c, P), c);
  Fq d = fq::add(p.z, p.z, P);
  return finish(a, b, c, d, P);
}

// add-2008-hwcd-3 with k = 2d (9M); q(j) gives coordinate j of the
// second point (0: X, 1: Y, 2: Z, 3: T).
template <class Q>
__device__ __forceinline__ Pt full_add(const Pt& p, const Q& q,
                                       const Params& P) {
  Fq a = fq::mul(fq::sub(p.y, p.x, P), fq::sub(q(1), q(0), P), P);
  Fq b = fq::mul(fq::add(p.y, p.x, P), fq::add(q(1), q(0), P), P);
  Fq c = fq::mul(fq::mul(p.t, q(3), P), fq::load<NW>(P.k), P);
  Fq zz = fq::mul(p.z, q(2), P);
  Fq d = fq::add(zz, zz, P);
  return finish(a, b, c, d, P);
}

__device__ __forceinline__ Pt full_add(const Pt& p, const Pt& q,
                                       const Params& P) {
  return full_add(p, [&](int j) {
    return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.t;
  }, P);
}

// dbl-2008-hwcd with a = -1 (4M + 4S).
__device__ __forceinline__ Pt dbl(const Pt& p, const Params& P) {
  Fq a = fq::sqr(p.x, P);
  Fq b = fq::sqr(p.y, P);
  Fq zz = fq::sqr(p.z, P);
  Fq c = fq::add(zz, zz, P);
  Fq d = fq::neg(a, P);
  Fq e = fq::sub(fq::sqr(fq::add(p.x, p.y, P), P), fq::add(a, b, P), P);
  Fq g = fq::add(d, b, P);
  Fq f = fq::sub(g, c, P);
  Fq h = fq::sub(d, b, P);
  return {fq::mul(e, f, P), fq::mul(g, h, P), fq::mul(f, g, P),
          fq::mul(e, h, P)};
}

// te_dbl_chain: replaces make_te_dbl_chain (zprize_tpu/msm/accum_kernel.py),
// which builds the init-stage window-collapse table.  Bound: 8 mulmods
// per doubling, n * n_dbls doublings, all integer multiplies; one read and
// one write of 192 bytes per point.  Design: one thread per point runs the
// whole chain with the point in registers.
__global__ void __launch_bounds__(BLOCK)
    k_dbl_chain(const uint32_t* params, const uint32_t* in, uint32_t* out,
                long long n, int n_dbls) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Pt a = load_pt(in + i * PT_WORDS);
#pragma unroll 1
  for (int k = 0; k < n_dbls; ++k) a = dbl(a, P);
  store_pt(out + i * PT_WORDS, a);
}

// te_bucket_accumulate: replaces make_te_mixed_add_slab and the strip/tier
// loop of accumulate_te_sorted (zprize_tpu/msm/accum_kernel.py).  Bound: 7
// mulmods per row of the sorted table; the rows are read once (144 bytes
// each).  Design: one thread per bucket walks its whole run of sorted rows
// from the identity; a loop inside the thread takes the place of the TPU's
// fixed-depth slabs and occupancy tiers.  Buckets of unequal size leave
// threads idle at the end: balancing them is later work.
__global__ void __launch_bounds__(BLOCK)
    k_bucket_accumulate(const uint32_t* params, const uint32_t* rows,
                        const int32_t* sign, const long long* starts,
                        const long long* counts, uint32_t* out,
                        long long nbe) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long b = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (b >= nbe) return;
  Pt acc = identity(P);
  long long r0 = starts[b], r1 = starts[b] + counts[b];
#pragma unroll 1
  for (long long r = r0; r < r1; ++r) {
    const uint32_t* row = rows + r * PRE_WORDS;
    acc = madd(acc, [&](int w) { return fq::load<NW>(row + w * NW); },
               sign[r] != 0, P);
  }
  store_pt(out + b * PT_WORDS, acc);
}

// Copy one 144-byte operand row (nine 16-byte words, 16-byte aligned) into
// a thread's ring slot (csrc/ring.cuh).
__device__ __forceinline__ void copy_row(uint4* slot, const uint32_t* row) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < ROW_CHUNKS; ++k) {
    ring::copy16(slot + k * BLOCK, src + k);
  }
}

// te_gather_accumulate: replaces make_te_mixed_add (and the rank loop of
// accumulate_te_pallas, zprize_tpu/msm/accum_kernel.py), the m = 1
// route's accumulate.  Lane i = w * nbe + b of W windows sums bucket b of
// window w: the rows table[perm[w, r]] for r in starts[i] .. starts[i] +
// counts[i], each negated where sign[w, r] != 0.  Bound: 7 mulmods (4116
// IMADs) per row; bytes are a 144-byte row, an 8-byte index and a 4-byte
// sign per row, far below the multiplies.  Design: one thread per bucket
// lane walks its whole run from the identity with the point in
// registers, and reads each row through the index straight from the
// point table (no sorted copy of the table is written and read again).
// The random 144-byte row reads are taken off the critical path: while a
// thread adds row k, row k + 1 is on its way into the thread's slot of a
// two-stage ring in shared memory (cp.async, 2 x 128 x 144 = 36,864 bytes
// a block), and the index of row k + 2 is on its way into a register.  A
// thread reads only its own slot, so no barrier is needed: the wait for
// its own copies (cp.async.wait_group) orders them, and a slot is
// refilled only after the add that read it.  The madd takes its operand
// words from the slot where it multiplies them, so the row takes no
// registers, and a negative sign picks the operand by index, so nothing
// goes to local memory.  ptxas: 168 registers, no stack frame, no
// spills at 3 blocks of 128 a SM (12 warps).  Measured on an H100
// (PERF.md): 309.5 ms for the 2^26 MSM's launch over 15 windows (983,040
// lanes, 1.007e9 rows) against a 247.4 ms bound, 80 % of it (without the
// ring and on the 64-bit field engine: 630 ms, 39 %).  The thread's walk takes the place of the TPU's
// tier loop and the sort by |digit| that of its tier schedule.  A bucket
// holding most rows (skewed scalars) makes one thread walk them all:
// right, but serial.  Offsets are 64-bit: a 2^26-point table holds 2.4e9
// words.
__global__ void __launch_bounds__(BLOCK, GATHER_MIN_BLOCKS)
    k_gather_accumulate(const uint32_t* params,
                        const uint32_t* __restrict__ table,
                        const long long* __restrict__ perm,
                        const int32_t* __restrict__ sign,
                        const long long* __restrict__ starts,
                        const long long* __restrict__ counts, uint32_t* out,
                        long long n, long long nbe, long long lanes) {
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
  // rows 0 and 1 in flight, one copy group each
  if (count > 0) copy_row(slot0, table + idx[0] * PRE_WORDS);
  ring::commit();
  if (count > 1) copy_row(slot0 + STAGE, table + idx[1] * PRE_WORDS);
  ring::commit();
  long long next = count > 2 ? idx[2] : 0;
  bool neg = count > 0 && sg[0] != 0;
  Pt acc = identity(P);
#pragma unroll 1
  for (long long k = 0; k < count; ++k) {
    const long long ahead = k + 3 < count ? idx[k + 3] : 0;
    const bool neg_next = k + 1 < count && sg[k + 1] != 0;
    uint4* const slot = slot0 + (k & 1) * STAGE;
    ring::wait<1>();  // every group but the newest has landed: row k has
    acc = madd(acc, [&](int w) { return ring::word<NW, BLOCK>(slot, w); },
               neg, P);
    if (k + 2 < count) copy_row(slot, table + next * PRE_WORDS);
    ring::commit();
    next = ahead;
    neg = neg_next;
  }
  store_pt(out + i * PT_WORDS, acc);
}

// te_full_add: replaces make_te_full_add (zprize_tpu/msm/accum_kernel.py),
// a lane-wise full add (the test SRS's double-and-add; the merges' trees
// are te_tree_sum's).  Bound: 9 mulmods per lane.  Design: one thread per
// lane; skip lanes pass p through.
__global__ void __launch_bounds__(BLOCK)
    k_full_add(const uint32_t* params, const uint32_t* p, const uint32_t* q,
               const int32_t* skip, uint32_t* out, long long n) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Pt a = load_pt(p + i * PT_WORDS);
  if (skip[i] == 0) a = full_add(a, load_pt(q + i * PT_WORDS), P);
  store_pt(out + i * PT_WORDS, a);
}

// te_running_sum: replaces the 2S launches of make_te_full_add through
// which the triangle merge (merge_te_triangle_pallas,
// zprize_tpu/msm/accum_kernel.py) walks its chunks.  Lane l of L sums its
// chunk of S bucket sums B_0..B_{S-1} (pts (L, S, 4, 12)) from the top:
//   T = B_{S-1}, U = T;  for j = S-2 .. 0:  T += B_j, U += T
// so T = sum_j B_j and U = sum_j (j+1) B_j.  Bound: 2 (S - 1) full adds,
// 18 (S - 1) mulmods a lane; the bytes (each bucket sum read once, two
// points written a lane) are far below.  Design: one thread per lane,
// both sums in registers, each B_j's coordinates read where they are
// multiplied; one launch takes the place of 2S launches of a few thousand
// lanes each.  triangle_split (msm/te_path.py) picks L, about one wave of
// the card.  ptxas: 228 registers, no stack frame, no spills at 2 blocks
// of 128 a SM.  Measured on an H100 (PERF.md): 0.928 ms at the 2^26
// merge's 30,720 lanes x 32 steps against a 0.602 ms bound (65 %); the
// whole merge 2.1 ms where the 2S launches took 21.5.
__global__ void __launch_bounds__(BLOCK, RUNNING_SUM_MIN_BLOCKS)
    k_running_sum(const uint32_t* params, const uint32_t* __restrict__ pts,
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
    const uint32_t* b = src + (long long)j * PT_WORDS;
    t = full_add(t, [&](int c) { return fq::load<NW>(b + c * NW); }, P);
    u = full_add(u, t, P);
  }
  store_pt(t_out + i * PT_WORDS, t);
  store_pt(u_out + i * PT_WORDS, u);
}

// te_combine: replaces make_te_combine (zprize_tpu/msm/accum_kernel.py),
// used for the final window combine and the merge-tail folds.  Lane i of
// ws (n_steps, lanes, 4, 12) folds MSB-first: acc = W_{n_steps-1}, then
// for w = n_steps-2 .. 0, c doublings and one full add of W_w.
//
// What bounds it: latency, not throughput.  The fold is (n_steps - 1)
// (8c + 9) mulmods, but a final combine has one lane, so the card's
// multiply rate is beside the point: what counts is the chain of
// dependent mulmods.  Within a doubling the 4 squarings are independent,
// then the 4 products; within a full add a, b, zz and T1 T2 are
// independent, then c = T1 T2 k, then the 4 products.  The critical path
// is 2 mulmods a doubling and 3 a full add, (n_steps - 1)(2c + 3) in all
// (555 for the 2^26 final combine, 16 steps at c = 17, where one thread
// runs 2,175).  The card's floor is that depth times 2 dependent IMADs a
// mulmod (k_imad_chain below measures one), whatever splits the mulmod;
// a design that runs each mulmod on one thread has a higher floor, the
// depth times one such mulmod's latency (k_mul_chain).
//
// Design: a group of GROUP = 4 threads of one warp folds one lane.
// Thread g holds coordinate g of the accumulator (X, Y, Z, T) and runs
// one of each step's 4 independent products; the group trades its 12-word
// operands through its slots in shared memory (one slot a thread, words
// strided by the block so that a warp's stores hit distinct banks) with
// __syncwarp on the group's mask between a write and the reads.  The
// field additions between the products are run by every thread of the
// group on the same operands, each keeping what its next product needs.
// The second operand of each full add (Y2 - X2, Y2 + X2, Z2 or T2) is
// read before the step's doublings, off the chain.  The op sequence on
// the values is that of te.dbl and te.add, and every value is fully
// reduced, so the words equal te_combine_plain's.  32 lanes a block of
// 128 threads; any number of lanes (a lane count that is not a multiple
// of 32 leaves whole groups idle in the last block).  ptxas: 113
// registers, no stack.  Measured on an H100 (PERF.md): the 2^26 final
// combine 0.63 ms (one thread took 2.05), 1.15 times the one-thread
// mulmod floor of 0.55 ms; a 13-step c = 1 fold 0.075 ms, 1.26 times its
// 0.059.  The card's floor is hundreds of times lower (PERF.md): a
// product split across threads is the lever left.
constexpr int GROUP = 4;

// Thread g of a fold group publishes x in its slot (after the group has
// read the previous values) and waits for the group's other slots.
__device__ __forceinline__ void publish(uint32_t* slots, const Fq& x,
                                        unsigned mask) {
  __syncwarp(mask);
#pragma unroll
  for (int j = 0; j < NW; ++j) slots[j * BLOCK + threadIdx.x] = x.v[j];
  __syncwarp(mask);
}

// the value that thread j of the caller's group published
__device__ __forceinline__ Fq peer(const uint32_t* slots, int j) {
  const int t = (threadIdx.x & ~(GROUP - 1)) + j;
  Fq r;
#pragma unroll
  for (int w = 0; w < NW; ++w) r.v[w] = slots[w * BLOCK + t];
  return r;
}

// The closing products of dbl and finish, X3 = E F, Y3 = G H, Z3 = F G,
// T3 = E H: thread g computes coordinate g.
__device__ __forceinline__ Fq closing_product(int g, const Fq& e, const Fq& f,
                                              const Fq& gg, const Fq& h,
                                              const Params& P) {
  const Fq l = fq::select(g == 1, gg, fq::select(g == 2, f, e));
  const Fq r = fq::select(g == 0, f, fq::select(g == 2, gg, h));
  return fq::mul(l, r, P);
}

// dbl on a fold group: v is coordinate g of the point, and so is the
// result.
__device__ __forceinline__ Fq group_dbl(const Fq& v, int g, uint32_t* slots,
                                        unsigned mask, const Params& P) {
  publish(slots, v, mask);
  const Fq xy = fq::add(peer(slots, 0), peer(slots, 1), P);
  // X^2, Y^2, Z^2, (X + Y)^2
  publish(slots, fq::sqr(fq::select(g == 3, xy, v), P), mask);
  const Fq a = peer(slots, 0), b = peer(slots, 1);
  const Fq ab = fq::add(a, b, P);
  const Fq e = fq::sub(peer(slots, 3), ab, P);
  const Fq gg = fq::sub(b, a, P);
  const Fq zz = peer(slots, 2);
  const Fq f = fq::sub(gg, fq::add(zz, zz, P), P);
  return closing_product(g, e, f, gg, fq::neg(ab, P), P);
}

// full_add on a fold group: v is coordinate g of the accumulator, q2
// thread g's operand of the second point (Y2 - X2, Y2 + X2, Z2, T2).
__device__ __forceinline__ Fq group_add(const Fq& v, const Fq& q2, int g,
                                        uint32_t* slots, unsigned mask,
                                        const Params& P) {
  publish(slots, v, mask);
  const Fq x = peer(slots, 0), y = peer(slots, 1);
  const Fq l = fq::select(g == 0, fq::sub(y, x, P),
                          fq::select(g == 1, fq::add(y, x, P), v));
  Fq m = fq::mul(l, q2, P);                 // a, b, Z1 Z2, T1 T2
  if (g == 3) m = fq::mul(m, fq::load<NW>(P.k), P);
  publish(slots, m, mask);
  const Fq a = peer(slots, 0), b = peer(slots, 1);
  const Fq zz = peer(slots, 2), c = peer(slots, 3);
  const Fq d = fq::add(zz, zz, P);
  return closing_product(g, fq::sub(b, a, P), fq::sub(d, c, P),
                         fq::add(d, c, P), fq::add(b, a, P), P);
}

// thread g's operand of the point at src (4 coordinates of NW words)
__device__ __forceinline__ Fq add_operand(const uint32_t* src, int g,
                                          const Params& P) {
  const Fq x = fq::load<NW>(src), y = fq::load<NW>(src + NW);
  return fq::select(g == 0, fq::sub(y, x, P),
                    fq::select(g == 1, fq::add(y, x, P),
                               fq::load<NW>(src + g * NW)));
}

__global__ void __launch_bounds__(BLOCK)
    k_combine(const uint32_t* params, const uint32_t* ws, uint32_t* out,
              int n_steps, long long lanes, int c) {
  __shared__ Params P;
  __shared__ uint32_t slots[NW * BLOCK];
  fq::load_params(P, params);
  const long long i = ((long long)blockIdx.x * BLOCK + threadIdx.x) / GROUP;
  if (i >= lanes) return;                   // whole groups leave together
  const int g = threadIdx.x & (GROUP - 1);
  const unsigned mask = ((1u << GROUP) - 1)
                        << (threadIdx.x & 31 & ~(GROUP - 1));
  Fq v = fq::load<NW>(ws + ((long long)(n_steps - 1) * lanes + i) * PT_WORDS +
                      g * NW);
#pragma unroll 1
  for (int w = n_steps - 2; w >= 0; --w) {
    const Fq q2 =
        add_operand(ws + ((long long)w * lanes + i) * PT_WORDS, g, P);
#pragma unroll 1
    for (int k = 0; k < c; ++k) v = group_dbl(v, g, slots, mask, P);
    v = group_add(v, q2, g, slots, mask, P);
  }
  fq::store(out + i * PT_WORDS + g * NW, v);
}

// te_tree_sum: replaces the per-level launches of make_te_full_add
// (zprize_tpu/msm/accum_kernel.py) through which the bucket merges reduce
// their trees: the row sums of pts (rows, k, 4, 12) and, for a weight
// offset `first`, the bit sums S_j[r] = sum of the members m whose
// weight first + m has bit j set.
//
// The order of the adds is te_tree_sum_plain's (msm/accum_kernel.py),
// so the words agree.  Member m sits in slot first + m of its row (the
// first slots and the tail are absent); the slots are cut into
// segments of TREE_SEG.  Each segment is summed by an in-place up-sweep:
// at step t the nodes of level t pair up, L = 2 j 2^t and R = L + 2^t,
// and x[L] += x[R].  A position m != 0 is then left holding the odd node
// of level tz(m) (tz: trailing zeros) that starts there, and a weight has
// bit j set exactly when it lies in an odd level-j node: S_j is the sum
// of the positions with tz = j.  Those sums ride in the same up-sweep:
// step t also adds x[L + 2^b] += x[R + 2^b] for b < t, so after the last
// step x[2^b] holds the segment's part of S_b and x[0] its root.  An
// absent right operand leaves the left as it is, an absent left takes
// the right's words: no identity is materialised or added.  A second
// kernel runs the same up-sweep across the segments of each row, one
// block per (row, component): the roots (with the bits above the
// segment) and, apart, each bit's partials (no bits).
//
// What bounds it: the chain, not the multiplies.  About 2k full adds a
// row with bits (k without), each 9 mulmods; at the 2^26 merge's 15 rows
// of 2048 that is 0.03 ms of the card's multiply rate, while the
// critical path is log2(first + k) steps of one full add (3 mulmods
// deep) plus a second launch.  Design: a group of GROUP threads runs one
// add (te_combine's group_add: thread g holds coordinate g and one of
// the four independent products), a segment of 64 slots sits in shared
// memory (12 KB) under a block of 32 groups, and the segments' partials
// go through global memory to the second launch.
constexpr int TREE_SEG_LOG = 6;
constexpr int TREE_SEG = 1 << TREE_SEG_LOG;
constexpr int TREE_GROUPS = BLOCK / GROUP;

// One step t of the up-sweep over the positions of x (PT_WORDS each) and
// their presence flags: positions n_live and up are absent, n_pos is a
// power of two.  Item (j, c) of the step is pair j's node add (c = 0) or
// its bit-(c - 1) partials (c = 1 .. t, when `bits`); group grp takes
// items grp, grp + TREE_GROUPS, ...  The items of a step touch disjoint
// positions; the caller puts a barrier between steps.
__device__ __forceinline__ void tree_step(uint32_t* x, int32_t* present,
                                          int n_live, int n_pos, int t,
                                          bool bits, int grp, int g,
                                          unsigned mask, uint32_t* slots,
                                          const Params& P) {
  const int pairs = n_pos >> (t + 1);
  const int items = pairs * (bits ? t + 1 : 1);
  for (int it = grp; it < items; it += TREE_GROUPS) {
    const int j = it % pairs, c = it / pairs;
    const int li = (j << (t + 1)) + (c ? 1 << (c - 1) : 0);
    const int ri = li + (1 << t);
    if (ri >= n_live || !present[ri]) continue;   // the same in the group
    const bool pl = present[li] != 0;
    __syncwarp(mask);                   // the group has read the flags
    uint32_t* const lp = x + (long long)li * PT_WORDS;
    const uint32_t* const rp = x + (long long)ri * PT_WORDS;
    Fq v;
    if (pl) {
      v = group_add(fq::load<NW>(lp + g * NW), add_operand(rp, g, P), g,
                    slots, mask, P);
    } else {
      v = fq::load<NW>(rp + g * NW);
    }
    fq::store(lp + g * NW, v);
    if (g == 0) present[li] = 1;
  }
}

// Pass 1: block (row, s) sums segment s of its row.  Writes component c
// of the segment (c = 0 the root, c = 1 + b the partial of bit b) to
// seg_pts[row, c, s] and its presence to seg_flags[row, c, s], for c <
// n_comp.
__global__ void __launch_bounds__(BLOCK)
    k_tree_segment(const uint32_t* params, const uint32_t* pts,
                   uint32_t* seg_pts, int32_t* seg_flags, long long k,
                   int first, int n_seg, int n_comp, int n_pow, int bits) {
  __shared__ Params P;
  __shared__ uint32_t xs[TREE_SEG * PT_WORDS];
  __shared__ int32_t present[TREE_SEG];
  __shared__ uint32_t slots[NW * BLOCK];
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
  const int grp = threadIdx.x / GROUP, g = threadIdx.x & (GROUP - 1);
  const unsigned mask = ((1u << GROUP) - 1)
                        << (threadIdx.x & 31 & ~(GROUP - 1));
  for (int t = 0; t < TREE_SEG_LOG; ++t) {
    tree_step(xs, present, TREE_SEG, TREE_SEG, t, bits != 0, grp, g, mask,
              slots, P);
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

// dst = the point at src if `live`, else the identity (thread by thread)
__device__ __forceinline__ void copy_or_identity(uint32_t* dst,
                                                 const uint32_t* src,
                                                 bool live, const Params& P) {
  for (int w = threadIdx.x; w < PT_WORDS; w += BLOCK) {
    const int c = w / NW;
    dst[w] = live ? src[w] : (c == 1 || c == 2) ? P.one[w % NW] : 0;
  }
}

// Pass 2: block (row, c) runs the up-sweep over the n_seg segments'
// component c in place in seg_pts (with the bits above the segment for
// c = 0 when `bits`), then writes the row sum (c = 0) and the bit sums:
// bit b < TREE_SEG_LOG from component 1 + b, bit TREE_SEG_LOG + b from
// position 2^b of component 0; an absent one as the identity.
__global__ void __launch_bounds__(BLOCK)
    k_tree_finish(const uint32_t* params, uint32_t* seg_pts,
                  int32_t* seg_flags, uint32_t* sums, uint32_t* bit_sums,
                  long long rows, int n_seg, int n_comp, int n_pow,
                  int n_bits) {
  __shared__ Params P;
  __shared__ uint32_t slots[NW * BLOCK];
  fq::load_params(P, params);
  const long long row = blockIdx.x / n_comp;
  const int c = blockIdx.x % n_comp;
  uint32_t* const x = seg_pts + (row * n_comp + c) * n_pow * PT_WORDS;
  int32_t* const present = seg_flags + (row * n_comp + c) * n_pow;
  const int grp = threadIdx.x / GROUP, g = threadIdx.x & (GROUP - 1);
  const unsigned mask = ((1u << GROUP) - 1)
                        << (threadIdx.x & 31 & ~(GROUP - 1));
  const bool bits = bit_sums != nullptr;
  for (int t = 0; (1 << (t + 1)) <= n_pow; ++t) {
    tree_step(x, present, n_seg, n_pow, t, bits && c == 0, grp, g, mask,
              slots, P);
    __syncthreads();
  }
  if (c == 0) {
    copy_or_identity(sums + row * PT_WORDS, x, true, P);
    for (int j = TREE_SEG_LOG; bits && j < n_bits; ++j) {
      const int pos = 1 << (j - TREE_SEG_LOG);
      copy_or_identity(bit_sums + ((long long)j * rows + row) * PT_WORDS,
                       x + (long long)pos * PT_WORDS,
                       pos < n_seg && present[pos], P);
    }
  } else {
    copy_or_identity(bit_sums + ((long long)(c - 1) * rows + row) * PT_WORDS,
                     x, present[0] != 0, P);
  }
}

// fq_mul_chain: replaces no TPU kernel.  A measurement probe: lane i
// multiplies x_i by y_i k times in a row (Montgomery products, so out_i =
// x_i y_i^k R^-k), each product waiting for the one before, so its time
// over k is the latency of one dependent 12-word mulmod on one thread:
// times a serial fold's depth (te_combine above, sw_combine of
// csrc/msm_sw.cu), the floor of a design that runs each mulmod on one
// thread.  Bound: its k mulmods at 2 dependent IMADs each (k_imad_chain);
// the lanes are independent, so many lanes would measure throughput
// instead.
__global__ void __launch_bounds__(BLOCK)
    k_mul_chain(const uint32_t* params, const uint32_t* x, const uint32_t* y,
                uint32_t* out, long long lanes, int k) {
  __shared__ Params P;
  fq::load_params(P, params);
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  Fq a = fq::load<NW>(x + i * NW);
  const Fq b = fq::load<NW>(y + i * NW);
#pragma unroll 1
  for (int j = 0; j < k; ++j) a = fq::mul(a, b, P);
  fq::store(out + i * NW, a);
}

// imad_chain: replaces no TPU kernel.  A measurement probe: lane i sets
// v = x_i, then k times v = v a_i + b_i (mod 2^32), one mad.lo.u32 (one
// IMAD) that waits for the one before, so its time over k is the latency
// of one dependent IMAD on this card.  However many threads split a
// mulmod, it needs two such multiplies one after the other: the product,
// then the reduction's multiply by a quotient taken from it; so depth x 2
// x this latency is a floor for the serial folds that no design can beat.
// Bound: that latency (what it measures).
constexpr int IMAD_UNROLL = 64;

__global__ void __launch_bounds__(BLOCK)
    k_imad_chain(const uint32_t* x, const uint32_t* a, const uint32_t* b,
                 uint32_t* out, long long lanes, int k) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  uint32_t v = x[i];
  const uint32_t m = a[i], d = b[i];
  int j = 0;
#pragma unroll 1
  for (; j + IMAD_UNROLL <= k; j += IMAD_UNROLL) {
#pragma unroll
    for (int u = 0; u < IMAD_UNROLL; ++u)
      asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(v) : "r"(m), "r"(d));
  }
#pragma unroll 1
  for (; j < k; ++j)
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(v) : "r"(m), "r"(d));
  out[i] = v;
}

unsigned grid_for(long long n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" {

int te_dbl_chain(const void* params, const void* in, void* out, long long n,
                 int n_dbls, void* stream) {
  if (n <= 0) return 0;
  k_dbl_chain<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)in, (uint32_t*)out, n, n_dbls);
  return (int)cudaGetLastError();
}

int te_bucket_accumulate(const void* params, const void* rows,
                         const void* sign, const void* starts,
                         const void* counts, void* out, long long nbe,
                         void* stream) {
  if (nbe <= 0) return 0;
  k_bucket_accumulate<<<grid_for(nbe), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)rows, (const int32_t*)sign,
      (const long long*)starts, (const long long*)counts, (uint32_t*)out, nbe);
  return (int)cudaGetLastError();
}

int te_gather_accumulate(const void* params, const void* table,
                         const void* perm, const void* sign,
                         const void* starts, const void* counts, void* out,
                         long long n, long long nbe, long long lanes,
                         void* stream) {
  if (lanes <= 0) return 0;
  k_gather_accumulate<<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)table, (const long long*)perm,
      (const int32_t*)sign, (const long long*)starts,
      (const long long*)counts, (uint32_t*)out, n, nbe, lanes);
  return (int)cudaGetLastError();
}

int te_full_add(const void* params, const void* p, const void* q,
                const void* skip, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  k_full_add<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)p, (const uint32_t*)q,
      (const int32_t*)skip, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int te_running_sum(const void* params, const void* pts, void* t_out,
                   void* u_out, long long lanes, int steps, void* stream) {
  if (lanes <= 0) return 0;
  k_running_sum<<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)pts, (uint32_t*)t_out,
      (uint32_t*)u_out, lanes, steps);
  return (int)cudaGetLastError();
}

int te_combine(const void* params, const void* ws, void* out, int n_steps,
               long long lanes, int c, void* stream) {
  if (lanes <= 0) return 0;
  k_combine<<<grid_for(lanes * GROUP), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)ws, (uint32_t*)out, n_steps,
      lanes, c);
  return (int)cudaGetLastError();
}

// sums (rows, 4, 12) = the row sums of pts (rows, k, 4, 12); if bit_sums
// is not null, also the bit sums (n_bits, rows, 4, 12) of weights first
// + m.  seg_pts (rows, n_comp, n_pow, 4, 12) and seg_flags (rows,
// n_comp, n_pow) are scratch, with n_seg = ceil((first + k) / 2^seg_log),
// n_pow the power of two at or above it and n_comp = 1 + min(seg_log,
// n_bits) with bits, else 1; seg_log must be TREE_SEG_LOG (the caller's
// sizes follow it).  Two launches on `stream`.
int te_tree_sum(const void* params, const void* pts, void* seg_pts,
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
  k_tree_segment<<<(unsigned)(rows * n_seg), BLOCK, 0, st>>>(
      (const uint32_t*)params, (const uint32_t*)pts, (uint32_t*)seg_pts,
      (int32_t*)seg_flags, k, first, n_seg, n_comp, n_pow, bits);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  k_tree_finish<<<(unsigned)(rows * n_comp), BLOCK, 0, st>>>(
      (const uint32_t*)params, (uint32_t*)seg_pts, (int32_t*)seg_flags,
      (uint32_t*)sums, (uint32_t*)bit_sums, rows, n_seg, n_comp, n_pow,
      n_bits);
  return (int)cudaGetLastError();
}

int fq_mul_chain(const void* params, const void* x, const void* y, void* out,
                 long long lanes, int k, void* stream) {
  if (lanes <= 0) return 0;
  k_mul_chain<<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)x, (const uint32_t*)y,
      (uint32_t*)out, lanes, k);
  return (int)cudaGetLastError();
}

int imad_chain(const void* x, const void* a, const void* b, void* out,
               long long lanes, int k, void* stream) {
  if (lanes <= 0) return 0;
  k_imad_chain<<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)a, (const uint32_t*)b,
      (uint32_t*)out, lanes, k);
  return (int)cudaGetLastError();
}

const char* msm_te_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
