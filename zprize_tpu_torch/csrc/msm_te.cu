// Twisted-Edwards (a = -1, extended coordinates) MSM kernels for Hopper.
//
// Six kernels, each with a plain C launcher that ctypes binds
// (zprize_tpu_torch/msm/accum_kernel.py holds the wrappers and the plain
// PyTorch version of each).  A launcher takes device pointers, sizes and
// the stream, allocates nothing, launches on that stream without
// synchronising, and returns cudaGetLastError().
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
// What bounds all six on an H100: 32-bit integer multiplies.  One field
// multiplication (mulmod) is 588 IMADs on the carry chains of csrc/fq.cuh;
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
// a thread's ring slot: chunk k goes to slot[k * BLOCK], so the lanes of a
// warp read a chunk back as one conflict-free 128-bit access.  cp.async.cg
// goes through L2 only: the rows are gathered at random and read once.
__device__ __forceinline__ void copy_row(uint4* slot, const uint32_t* row) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < ROW_CHUNKS; ++k) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slot + k * BLOCK);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(src + k)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` of this thread's copy groups are in flight
template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// operand word w (three chunks) of the row in a ring slot
__device__ __forceinline__ Fq slot_word(const uint4* slot, int w) {
  Fq r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 v = slot[(3 * w + k) * BLOCK];
    r.v[4 * k] = v.x;
    r.v[4 * k + 1] = v.y;
    r.v[4 * k + 2] = v.z;
    r.v[4 * k + 3] = v.w;
  }
  return r;
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
  __shared__ uint4 ring[2 * STAGE];
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  const long long r0 = (i / nbe) * n + starts[i];
  const long long count = counts[i];
  const long long* idx = perm + r0;
  const int32_t* sg = sign + r0;
  uint4* const slot0 = ring + threadIdx.x;  // stage s at slot0 + s * STAGE
  // rows 0 and 1 in flight, one copy group each
  if (count > 0) copy_row(slot0, table + idx[0] * PRE_WORDS);
  copy_commit();
  if (count > 1) copy_row(slot0 + STAGE, table + idx[1] * PRE_WORDS);
  copy_commit();
  long long next = count > 2 ? idx[2] : 0;
  bool neg = count > 0 && sg[0] != 0;
  Pt acc = identity(P);
#pragma unroll 1
  for (long long k = 0; k < count; ++k) {
    const long long ahead = k + 3 < count ? idx[k + 3] : 0;
    const bool neg_next = k + 1 < count && sg[k + 1] != 0;
    uint4* const slot = slot0 + (k & 1) * STAGE;
    copy_wait<1>();  // every group but the newest has landed: row k has
    acc = madd(acc, [&](int w) { return slot_word(slot, w); }, neg, P);
    if (k + 2 < count) copy_row(slot, table + next * PRE_WORDS);
    copy_commit();
    next = ahead;
    neg = neg_next;
  }
  store_pt(out + i * PT_WORDS, acc);
}

// te_full_add: replaces make_te_full_add (zprize_tpu/msm/accum_kernel.py),
// the adder of the bucket-sum trees and the bit-decomposed merge.  Bound:
// 9 mulmods per lane.  Design: one thread per lane; skip lanes pass p
// through.
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
// used for the final window combine and the merge-tail folds.  Bound:
// (n_steps - 1) * (8c + 9) mulmods per lane, sequential in the lane.
// Design: one thread per lane folds MSB-first (c doublings, then one full
// add per step) with the accumulator in registers; any number of lanes.
__global__ void __launch_bounds__(BLOCK)
    k_combine(const uint32_t* params, const uint32_t* ws, uint32_t* out,
              int n_steps, long long lanes, int c) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  Pt acc = load_pt(ws + ((long long)(n_steps - 1) * lanes + i) * PT_WORDS);
#pragma unroll 1
  for (int w = n_steps - 2; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < c; ++k) acc = dbl(acc, P);
    acc = full_add(acc, load_pt(ws + ((long long)w * lanes + i) * PT_WORDS),
                   P);
  }
  store_pt(out + i * PT_WORDS, acc);
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
  k_combine<<<grid_for(lanes), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)ws, (uint32_t*)out, n_steps,
      lanes, c);
  return (int)cudaGetLastError();
}

const char* msm_te_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
