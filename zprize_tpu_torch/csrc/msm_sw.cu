// Short-Weierstrass (y^2 = x^3 + b, a = 0) MSM kernels for Hopper: the
// bucket accumulate and the complete add of the SW route.
//
// Two kernels, each with a plain C launcher that ctypes binds
// (zprize_tpu_torch/msm/accum_kernel.py holds the wrappers and the plain
// PyTorch version of each).  A launcher takes device pointers, sizes and
// the stream, allocates nothing, launches on that stream without
// synchronising, and returns cudaGetLastError().
//
// Layouts (int32 words, contiguous, row-major):
//   point   (..., 3, 12): X, Y, Z in Montgomery form (csrc/fq.cuh), the
//                         identity (0 : 1 : 0)
//   affine  (n, 12) x and (n, 12) y planes, one 48-byte row a point
// The params tensor is fq.cuh's, with k = 3b in Montgomery form.
//
// The formulas are the Renes-Costello-Batina complete a = 0 sequences of
// zprize_tpu_torch/curve/sw.py (add_mixed, add): keep them in lockstep,
// since kernel and plain version must agree word for word.
//
// What bounds both on an H100: 32-bit integer multiplies.  One field
// multiplication (mulmod) is 588 IMAD slots (csrc/fq.cuh).  A
// mixed add is 11 mulmods and a full add 12, plus two products by the
// constant 3b, which run here as two more mulmods by k (additions could
// do them: later work).  The bytes per add (a 96-byte affine row, an
// index and a sign) are far below the multiplies.  The design answer is
// the one of csrc/msm_te.cu: one thread per independent chain with the
// whole point in registers, 128-thread blocks.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

// BLS12-377/381 base field: 12 words (csrc/fq.cuh)
constexpr int NW = 12;
using Fq = fq::Fe<NW>;
using Params = fq::Params<NW>;

namespace {

constexpr int BLOCK = 128;
constexpr int PT_WORDS = 3 * NW;

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

// One 48-byte coordinate row as three 16-byte reads (rows start at
// multiples of 48 bytes from a 16-byte aligned plane).
__device__ __forceinline__ Fq load_row(const uint32_t* __restrict__ row) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
  Fq r;
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    uint4 v = __ldg(src + k);
    r.v[4 * k] = v.x;
    r.v[4 * k + 1] = v.y;
    r.v[4 * k + 2] = v.z;
    r.v[4 * k + 3] = v.w;
  }
  return r;
}

// The shared tail of the RCB adds (sw.py: _add_tail).
__device__ __forceinline__ Pt add_tail(const Fq& t0, const Fq& t1,
                                       const Fq& t2, const Fq& m_xy,
                                       const Fq& m_yz, const Fq& m_xz,
                                       const Params& P) {
  Fq b3 = fq::load<NW>(P.k);
  Fq b3t2 = fq::mul(t2, b3, P);
  Fq u = fq::sub(t1, b3t2, P);
  Fq v = fq::add(t1, b3t2, P);
  Fq w = fq::mul(m_xz, b3, P);
  Fq t3 = fq::add(fq::add(t0, t0, P), t0, P);
  return {fq::sub(fq::mul(m_xy, u, P), fq::mul(m_yz, w, P), P),
          fq::add(fq::mul(v, u, P), fq::mul(t3, w, P), P),
          fq::add(fq::mul(m_yz, v, P), fq::mul(m_xy, t3, P), P)};
}

// Complete mixed add p + (ax, ay) (sw.py: add_mixed).
__device__ __forceinline__ Pt madd(const Pt& p, const Fq& ax, const Fq& ay,
                                   const Params& P) {
  Fq t0 = fq::mul(p.x, ax, P);
  Fq t1 = fq::mul(p.y, ay, P);
  Fq m_xy = fq::sub(fq::mul(fq::add(p.x, p.y, P), fq::add(ax, ay, P), P),
                    fq::add(t0, t1, P), P);
  Fq m_yz = fq::add(fq::mul(ay, p.z, P), p.y, P);
  Fq m_xz = fq::add(fq::mul(ax, p.z, P), p.x, P);
  return add_tail(t0, t1, p.z, m_xy, m_yz, m_xz, P);
}

// Complete projective add p + q (sw.py: add).
__device__ __forceinline__ Pt full_add(const Pt& p, const Pt& q,
                                       const Params& P) {
  Fq t0 = fq::mul(p.x, q.x, P);
  Fq t1 = fq::mul(p.y, q.y, P);
  Fq t2 = fq::mul(p.z, q.z, P);
  Fq m_xy = fq::sub(fq::mul(fq::add(p.x, p.y, P), fq::add(q.x, q.y, P), P),
                    fq::add(t0, t1, P), P);
  Fq m_yz = fq::sub(fq::mul(fq::add(p.y, p.z, P), fq::add(q.y, q.z, P), P),
                    fq::add(t1, t2, P), P);
  Fq m_xz = fq::sub(fq::mul(fq::add(p.x, p.z, P), fq::add(q.x, q.z, P), P),
                    fq::add(t0, t2, P), P);
  return add_tail(t0, t1, t2, m_xy, m_yz, m_xz, P);
}

// sw_gather_accumulate: replaces make_mixed_add, make_mixed_add_multi and
// make_mixed_add_rect (zprize_tpu/msm/accum_kernel.py) with the rank
// loops that drive them (accumulate_pass_pallas, accumulate_rect_pallas).
// Lane i = w * nbe + b of W windows sums bucket b of window w: the points
// perm[w, r] for r in starts[i] .. starts[i] + counts[i], each negated
// where sign[w, r] != 0.  Bound: 11 mulmods per point (13 as written);
// bytes are a 96-byte affine row, an 8-byte index and a 4-byte sign per
// point.  Design: one thread per bucket lane walks its whole run from the
// identity with the point in registers, reading x and y through the index
// straight from the coordinate planes.  The thread's walk takes the place
// of the TPU's fixed-depth rank loop, its tier schedule and its fallback
// passes; the three TPU kernels differ only in how many ranks one call
// walks and where the operands come from.  A bucket holding most points
// (skewed scalars) makes one thread walk them all: right, but serial.
// Offsets are 64-bit.
__global__ void __launch_bounds__(BLOCK)
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
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= lanes) return;
  long long base = (i / nbe) * n;
  Pt acc = {fq::zero<NW>(), fq::load<NW>(P.one), fq::zero<NW>()};
  long long r0 = base + starts[i], r1 = r0 + counts[i];
#pragma unroll 1
  for (long long r = r0; r < r1; ++r) {
    long long j = perm[r] * NW;
    Fq ax = load_row(px + j);
    Fq ay = load_row(py + j);
    if (sign[r] != 0) ay = fq::neg(ay, P);
    acc = madd(acc, ax, ay, P);
  }
  store_pt(out + i * PT_WORDS, acc);
}

// sw_full_add: replaces make_full_add (zprize_tpu/msm/accum_kernel.py),
// the adder of the bit-decomposed bucket merge, and serves the window
// combine (a doubling is p + p).  Bound: 12 mulmods per lane (14 as
// written).  Design: one thread per lane; the sum overwrites acc in place
// (acc and q may be the same tensor: each thread reads both before it
// writes), and skip lanes leave acc as it is.
__global__ void __launch_bounds__(BLOCK)
    k_sw_full_add(const uint32_t* params, uint32_t* acc, const uint32_t* q,
                  const int32_t* skip, long long n) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || skip[i] != 0) return;
  Pt a = load_pt(acc + i * PT_WORDS);
  Pt b = load_pt(q + i * PT_WORDS);
  store_pt(acc + i * PT_WORDS, full_add(a, b, P));
}

unsigned grid_for(long long n) { return (unsigned)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" {

int sw_gather_accumulate(const void* params, const void* px, const void* py,
                         const void* perm, const void* sign,
                         const void* starts, const void* counts, void* out,
                         long long n, long long nbe, long long lanes,
                         void* stream) {
  if (lanes <= 0) return 0;
  k_sw_gather_accumulate<<<grid_for(lanes), BLOCK, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)params, (const uint32_t*)px, (const uint32_t*)py,
      (const long long*)perm, (const int32_t*)sign, (const long long*)starts,
      (const long long*)counts, (uint32_t*)out, n, nbe, lanes);
  return (int)cudaGetLastError();
}

int sw_full_add(const void* params, void* acc, const void* q,
                const void* skip, long long n, void* stream) {
  if (n <= 0) return 0;
  k_sw_full_add<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)params, (uint32_t*)acc, (const uint32_t*)q,
      (const int32_t*)skip, n);
  return (int)cudaGetLastError();
}

const char* msm_sw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
