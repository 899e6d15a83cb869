// Device prime-field engine: Montgomery arithmetic on NW little-endian
// 32-bit words, R = 2^(32 NW), every result fully reduced to [0, p).  One
// header serves the 377/381-bit base fields (NW = 12, R = 2^384) and the
// 253/255-bit scalar fields (NW = 8, R = 2^256): every function is a
// template on the word count.
//
// Counterpart of the in-kernel field engine of the TPU package
// (zprize_tpu/field/fp_kernel.py: kmul, kadd, ksub, kneg), which works on
// redundant base-2^15 limbs.  Here an element is the same NW-word row
// that the plain engine (zprize_tpu_torch/field/fp.py) stores, and both
// engines return fully reduced values, so a kernel and its plain version
// agree bit for bit.
//
// Everything runs on PTX carry chains (csrc/ptx.cuh): a word's carry or
// borrow rides in the flag, so no 64-bit adds are spent on it.  mul is a
// CIOS Montgomery product whose accumulator is split in two (the even/odd
// scheme of sppark's mont_t): one part takes the products of a's even
// words, the other, one word up, those of its odd words, so each part
// adds whole 64-bit products over disjoint word pairs and a product's
// low and high halves are neighbours in one chain.  ptxas turns each
// such pair (madc.lo.cc, madc.hi.cc) into one IMAD.WIDE.U32.X with the
// carry in a predicate.  Each word b_i of b takes four such rows (a's
// even and odd words times b_i, then p's times m = t_0 * (-p^-1)), the
// division by 2^32 is a swap of the two parts' roles, and the parts are
// added once at the end.  A 12-word mulmod compiles to 472 SASS
// instructions on sm_90a, 241 of them IMAD.WIDE.U32.X, where the 64-bit
// C of the earlier engine took 1,064 (276 IMAD.WIDE.U32 and 419 IADD3*
// for the carries; PERF.md).  The multiplies are 2 NW^2 + NW
// 32x32 products, the 588 IMAD issue slots at NW = 12 (264 at NW = 8)
// that bound the kernels.  add, sub and reduce_once are one add.cc/addc
// or sub.cc/subc chain each, plus a select.
//
// Bounds: the engine needs p < 2^(32 NW - 1) (every field here has 253 to
// 381 bits).  With a, b < p and t < 2p on entry to a step,
// t + a*b_i + m*p < 2^33 p < 2^(32 NW + 32) fits NW + 1 words, so the
// carries the chains drop are zero, and the step leaves t < 2p; one
// conditional subtraction then makes the result < p.
//
// The field and curve constants come in through a small device tensor of
// int32 words (layout below, written by msm/accum_kernel.py and
// ntt/fr_kernel.py), which every kernel copies into shared memory first,
// so another field of the same width (BLS12-381) reuses a kernel without
// a rebuild.
#pragma once

#include <cstdint>

#include "ptx.cuh"

namespace fq {

// params layout, in 32-bit words:
//   [0, NW)     p              [NW, 2NW)   R mod p (Montgomery one)
//   [2NW, 3NW)  R^2 mod p      [3NW, 4NW)  curve constant k = 2d, Montgomery
//                                          form (zero for a scalar field)
//   [4NW]       -p^-1 mod 2^32
// (16-byte aligned, so the modulus loads as NW / 4 vector words)
template <int NW>
struct __align__(16) Params {
  uint32_t p[NW];
  uint32_t one[NW];
  uint32_t r2[NW];
  uint32_t k[NW];
  uint32_t n0;
};

template <int NW>
struct Fe {
  uint32_t v[NW];
};

// Every thread of the block must call this (it synchronises the block).
template <int NW>
__device__ __forceinline__ void load_params(Params<NW>& sp, const uint32_t* g) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(&sp);
  for (int i = threadIdx.x; i < 4 * NW + 1; i += blockDim.x) dst[i] = g[i];
  __syncthreads();
}

template <int NW>
__device__ __forceinline__ Fe<NW> load(const uint32_t* src) {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = src[j];
  return r;
}

// NW words from a 16-byte aligned address, as NW / 4 vector loads
template <int NW>
__device__ __forceinline__ Fe<NW> load16(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  Fe<NW> r;
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    const uint4 w = s[k];
    r.v[4 * k] = w.x;
    r.v[4 * k + 1] = w.y;
    r.v[4 * k + 2] = w.z;
    r.v[4 * k + 3] = w.w;
  }
  return r;
}

// NW words to a 16-byte aligned address, as NW / 4 vector stores
template <int NW>
__device__ __forceinline__ void store16(uint32_t* dst, const Fe<NW>& a) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < NW / 4; ++k)
    d[k] = make_uint4(a.v[4 * k], a.v[4 * k + 1], a.v[4 * k + 2],
                      a.v[4 * k + 3]);
}

template <int NW>
__device__ __forceinline__ void store(uint32_t* dst, const Fe<NW>& a) {
#pragma unroll
  for (int j = 0; j < NW; ++j) dst[j] = a.v[j];
}

template <int NW>
__device__ __forceinline__ Fe<NW> zero() {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = 0;
  return r;
}

// flag ? a : b, word by word (a select of whole arrays would go through
// local memory)
template <int NW>
__device__ __forceinline__ Fe<NW> select(bool flag, const Fe<NW>& a,
                                         const Fe<NW>& b) {
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = flag ? a.v[j] : b.v[j];
  return r;
}

// t (NW words) holds a value below 2p: subtract p once if it is >= p.
template <int NW>
__device__ __forceinline__ Fe<NW> reduce_once(const uint32_t* t,
                                              const Fe<NW>& p) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(t[0], p.v[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = ptx::subc_cc(t[j], p.v[j]);
  const uint32_t below = ptx::subc(0, 0);  // all ones if t < p
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = below ? t[j] : d[j];
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> add(const Fe<NW>& a, const Fe<NW>& b,
                                      const Params<NW>& P) {
  uint32_t t[NW];
  t[0] = ptx::add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) t[j] = ptx::addc_cc(a.v[j], b.v[j]);
  t[NW - 1] = ptx::addc(a.v[NW - 1], b.v[NW - 1]);  // a + b < 2^(32 NW)
  return reduce_once<NW>(t, load16<NW>(P.p));
}

template <int NW>
__device__ __forceinline__ Fe<NW> sub(const Fe<NW>& a, const Fe<NW>& b,
                                      const Params<NW>& P) {
  const Fe<NW> p = load16<NW>(P.p);
  uint32_t t[NW];
  t[0] = ptx::sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) t[j] = ptx::subc_cc(a.v[j], b.v[j]);
  // a - b < 0: add p back (the sum wraps to the right value mod 2^(32 NW))
  const uint32_t mask = ptx::subc(0, 0);
  Fe<NW> r;
  r.v[0] = ptx::add_cc(t[0], p.v[0] & mask);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r.v[j] = ptx::addc_cc(t[j], p.v[j] & mask);
  r.v[NW - 1] = ptx::addc(t[NW - 1], p.v[NW - 1] & mask);
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> neg(const Fe<NW>& a, const Params<NW>& P) {
  return sub<NW>(zero<NW>(), a, P);
}

// The rows of the split product: acc[2k], acc[2k+1] take the low and high
// halves of a[2k] * b (pass a + 1 for a's odd words), so each chain runs
// over disjoint word pairs.

// acc = a[0, 2, ..] * b over pairs (no carries: the pairs are disjoint)
template <int NW>
__device__ __forceinline__ void mul_row(uint32_t* acc, const uint32_t* a,
                                        uint32_t b) {
#pragma unroll
  for (int j = 0; j < NW; j += 2) {
    acc[j] = a[j] * b;
    acc[j + 1] = __umulhi(a[j], b);
  }
}

// acc += a[0, 2, ..] * b; leaves the carry out of acc[NW-1] in the flag
template <int NW>
__device__ __forceinline__ void mad_row(uint32_t* acc, const uint32_t* a,
                                        uint32_t b) {
  acc[0] = ptx::mad_lo_cc(a[0], b, acc[0]);
  acc[1] = ptx::madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    acc[j] = ptx::madc_lo_cc(a[j], b, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(a[j], b, acc[j + 1]);
  }
}

// acc = (acc >> 64) + a[0, 2, ..] * b + the carry in the flag
template <int NW>
__device__ __forceinline__ void mad_row_shift(uint32_t* acc,
                                              const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < NW - 2; j += 2) {
    acc[j] = ptx::madc_lo_cc(a[j], b, acc[j + 2]);
    acc[j + 1] = ptx::madc_hi_cc(a[j], b, acc[j + 3]);
  }
  acc[NW - 2] = ptx::madc_lo_cc(a[NW - 2], b, 0);
  acc[NW - 1] = ptx::madc_hi(a[NW - 2], b, 0);
}

// One CIOS step on the split accumulator t = ev + 2^32 * od: t += a * b_i,
// then t += m * p with m = t_0 * (-p^-1), which zeroes ev_0.  The next
// step reads t / 2^32 = od + ev_1 + 2^32 * (ev >> 64) with the roles
// swapped: it adds ev_1 into word 0 of od (its ev), and its od is ev
// shifted down two words (mad_row_shift), the carry of that first add
// riding in.
template <int NW>
__device__ __forceinline__ void mul_step(uint32_t* ev, uint32_t* od,
                                         const uint32_t* a, uint32_t bi,
                                         const uint32_t* p, uint32_t n0,
                                         bool first) {
  if (first) {
    mul_row<NW>(od, a + 1, bi);
    mul_row<NW>(ev, a, bi);
  } else {
    ev[0] = ptx::add_cc(ev[0], od[1]);
    mad_row_shift<NW>(od, a + 1, bi);
    mad_row<NW>(ev, a, bi);
    od[NW - 1] = ptx::addc(od[NW - 1], 0);
  }
  const uint32_t m = ev[0] * n0;
  mad_row<NW>(od, p + 1, m);
  mad_row<NW>(ev, p, m);
  od[NW - 1] = ptx::addc(od[NW - 1], 0);
}

// CIOS Montgomery product a*b/R mod p (a, b < p) on the split
// accumulator (header); the steps alternate the roles of x and y.
template <int NW>
__device__ __forceinline__ Fe<NW> mul(const Fe<NW>& a, const Fe<NW>& b,
                                      const Params<NW>& P) {
  const Fe<NW> p = load16<NW>(P.p);
  const uint32_t n0 = P.n0;
  uint32_t x[NW], y[NW];
#pragma unroll
  for (int i = 0; i < NW; i += 2) {
    mul_step<NW>(x, y, a.v, b.v[i], p.v, n0, i == 0);
    mul_step<NW>(y, x, a.v, b.v[i + 1], p.v, n0, false);
  }
  // t = x + (y >> 32): y_0 is zero
  uint32_t t[NW];
  t[0] = ptx::add_cc(x[0], y[1]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) t[j] = ptx::addc_cc(x[j], y[j + 1]);
  t[NW - 1] = ptx::addc(x[NW - 1], 0);
  return reduce_once<NW>(t, p);
}

template <int NW>
__device__ __forceinline__ Fe<NW> sqr(const Fe<NW>& a, const Params<NW>& P) {
  return mul<NW>(a, a, P);
}

}  // namespace fq
