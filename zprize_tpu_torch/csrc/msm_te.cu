// Twisted-Edwards (a = -1, extended coordinates) MSM kernels for Hopper.
//
// Five kernels, each with a plain C launcher that ctypes binds
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
// What bounds all five on an H100: 32-bit integer multiplies.  One field
// multiplication (mulmod) is 588 IMAD issue slots (csrc/fq.cuh); the
// kernels read and write a few hundred bytes per thousands of multiplies,
// so memory is far from the limit.  A mixed add costs 7
// mulmods, a full add 9 and a doubling 8.  The design answer is one thread
// per independent chain with the whole point state in registers, so every
// multiply feeds the next without a trip through memory, and 128-thread
// blocks, because a point with its temporaries needs 124-162 registers a
// thread (ptxas -v).  Speed (carry chains, shared-memory staging, load
// balance across buckets) is later work.

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
// sign.
__device__ __forceinline__ Pt madd(const Pt& p, const uint32_t* row, bool neg,
                                   const Params& P) {
  Fq yp = fq::load<NW>(row), ym = fq::load<NW>(row + NW);
  Fq kt = fq::load<NW>(row + 2 * NW);
  Fq a = fq::mul(fq::sub(p.y, p.x, P), neg ? yp : ym, P);
  Fq b = fq::mul(fq::add(p.y, p.x, P), neg ? ym : yp, P);
  Fq c = fq::mul(p.t, kt, P);
  if (neg) c = fq::neg(c, P);
  Fq d = fq::add(p.z, p.z, P);
  return finish(a, b, c, d, P);
}

// add-2008-hwcd-3 with k = 2d (9M).
__device__ __forceinline__ Pt full_add(const Pt& p, const Pt& q,
                                       const Params& P) {
  Fq a = fq::mul(fq::sub(p.y, p.x, P), fq::sub(q.y, q.x, P), P);
  Fq b = fq::mul(fq::add(p.y, p.x, P), fq::add(q.y, q.x, P), P);
  Fq c = fq::mul(fq::mul(p.t, q.t, P), fq::load<NW>(P.k), P);
  Fq zz = fq::mul(p.z, q.z, P);
  Fq d = fq::add(zz, zz, P);
  return finish(a, b, c, d, P);
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
  Pt acc = {fq::zero<NW>(), fq::load<NW>(P.one), fq::load<NW>(P.one),
            fq::zero<NW>()};
  long long r0 = starts[b], r1 = starts[b] + counts[b];
#pragma unroll 1
  for (long long r = r0; r < r1; ++r)
    acc = madd(acc, rows + r * PRE_WORDS, sign[r] != 0, P);
  store_pt(out + b * PT_WORDS, acc);
}

// Load one 144-byte operand row as nine 16-byte reads (rows start at
// multiples of 144 bytes from a 16-byte aligned table).
__device__ __forceinline__ void load_row(uint32_t (&w)[PRE_WORDS],
                                         const uint32_t* __restrict__ row) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < PRE_WORDS / 4; ++k) {
    uint4 v = __ldg(src + k);
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

// te_gather_accumulate: replaces make_te_mixed_add (and the rank loop of
// accumulate_te_pallas, zprize_tpu/msm/accum_kernel.py), the m = 1
// route's accumulate.  Lane i = w * nbe + b of W windows sums bucket b of
// window w: the rows table[perm[w, r]] for r in starts[i] .. starts[i] +
// counts[i], each negated where sign[w, r] != 0.  Bound: 7 mulmods per
// row; bytes are a 144-byte row, an 8-byte index and a 4-byte sign per
// row, far below the multiplies.  Design: as k_bucket_accumulate, one
// thread per bucket lane walks its whole run from the identity with the
// point in registers, but reads each row through the index straight from
// the point table, so no sorted copy of the table is written and read
// again.  The thread's walk takes the place of the TPU's tier loop and the
// sort by |digit| that of its tier schedule.  A bucket holding most rows
// (skewed scalars) makes one thread walk them all: right, but serial.
// Offsets are 64-bit: a 2^26-point table holds 2.4e9 words.
__global__ void __launch_bounds__(BLOCK)
    k_gather_accumulate(const uint32_t* params,
                        const uint32_t* __restrict__ table,
                        const long long* __restrict__ perm,
                        const int32_t* __restrict__ sign,
                        const long long* __restrict__ starts,
                        const long long* __restrict__ counts, uint32_t* out,
                        long long n, long long nbe, long long lanes) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  long long base = (i / nbe) * n;
  Pt acc = {fq::zero<NW>(), fq::load<NW>(P.one), fq::load<NW>(P.one),
            fq::zero<NW>()};
  long long r0 = base + starts[i], r1 = r0 + counts[i];
  uint32_t row[PRE_WORDS];
#pragma unroll 1
  for (long long r = r0; r < r1; ++r) {
    load_row(row, table + perm[r] * PRE_WORDS);
    acc = madd(acc, row, sign[r] != 0, P);
  }
  store_pt(out + i * PT_WORDS, acc);
}

// te_full_add: replaces make_te_full_add (zprize_tpu/msm/accum_kernel.py),
// the adder of the triangle and bit-decomposed bucket merges.  Bound: 9
// mulmods per lane.  Design: one thread per lane; skip lanes pass p
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
