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
// mul is a plain CIOS Montgomery product with 64-bit partial products:
// NW x NW 32x32->64 products for a*b and NW x NW for m*p (two IMAD issue
// slots each), and NW low-half products for m (one each): 588 IMAD slots
// at NW = 12, 264 at NW = 8.  Carry chains in PTX (add.cc / madc) are a
// later step.
//
// The field and curve constants come in through a small device tensor of
// int32 words (layout below, written by msm/accum_kernel.py and
// ntt/fr_kernel.py), which every kernel copies into shared memory first,
// so another field of the same width (BLS12-381) reuses a kernel without
// a rebuild.
#pragma once

#include <cstdint>

namespace fq {

// params layout, in 32-bit words:
//   [0, NW)     p              [NW, 2NW)   R mod p (Montgomery one)
//   [2NW, 3NW)  R^2 mod p      [3NW, 4NW)  curve constant k = 2d, Montgomery
//                                          form (zero for a scalar field)
//   [4NW]       -p^-1 mod 2^32
template <int NW>
struct Params {
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

// t (NW words, plus a carry word `hi`) holds a value below 2p: subtract p
// once if the value is >= p.
template <int NW>
__device__ __forceinline__ Fe<NW> reduce_once(const uint32_t* t, uint32_t hi,
                                              const Params<NW>& P) {
  uint32_t d[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - P.p[j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  bool take = (hi != 0) || (br == 0);
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = take ? d[j] : t[j];
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> add(const Fe<NW>& a, const Fe<NW>& b,
                                      const Params<NW>& P) {
  uint32_t t[NW];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.v[j] + b.v[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  return reduce_once<NW>(t, (uint32_t)c, P);
}

template <int NW>
__device__ __forceinline__ Fe<NW> sub(const Fe<NW>& a, const Fe<NW>& b,
                                      const Params<NW>& P) {
  uint32_t t[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.v[j] - b.v[j] - br;
    t[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  // a - b < 0: add p back (the sum wraps to the right value mod 2^(32 NW))
  uint32_t mask = 0u - br;
  uint64_t c = 0;
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] + (P.p[j] & mask) + c;
    r.v[j] = (uint32_t)s;
    c = s >> 32;
  }
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> neg(const Fe<NW>& a, const Params<NW>& P) {
  return sub<NW>(zero<NW>(), a, P);
}

// CIOS Montgomery product a*b/R mod p.
template <int NW>
__device__ __forceinline__ Fe<NW> mul(const Fe<NW>& a, const Fe<NW>& b,
                                      const Params<NW>& P) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * P.n0;
    s = (uint64_t)m * P.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * P.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  return reduce_once<NW>(t, t[NW], P);
}

template <int NW>
__device__ __forceinline__ Fe<NW> sqr(const Fe<NW>& a, const Params<NW>& P) {
  return mul<NW>(a, a, P);
}

}  // namespace fq
