// Device field engine for the 377/381-bit base fields: Montgomery
// arithmetic on 12 little-endian 32-bit words, R = 2^384, every result
// fully reduced to [0, p).
//
// Counterpart of the in-kernel field engine of the TPU package
// (zprize_tpu/field/fp_kernel.py: kmul, kadd, ksub, kneg), which works on
// 26 redundant base-2^15 limbs.  Here an element is the same 12-word row
// that the plain engine (zprize_tpu_torch/field/fp.py) stores, and both
// engines return fully reduced values, so a kernel and its plain version
// agree bit for bit.
//
// mul is a plain CIOS Montgomery product with 64-bit partial products:
// 12 x 12 32x32->64 products for a*b and 12 x 12 for m*p (two IMAD issue
// slots each), and 12 low-half products for m (one each), so 588 IMAD
// slots.  Carry chains in PTX (add.cc / madc) are a later step.
//
// The field and curve constants come in through a small device tensor of
// int32 words (layout below, written by msm/accum_kernel.py), which every
// kernel copies into shared memory first, so another 12-word field
// (BLS12-381 Fq) can reuse this header without a rebuild.
#pragma once

#include <cstdint>

namespace fq {

constexpr int NW = 12;

// params layout, in 32-bit words:
//   [0, 12)  p              [12, 24) R mod p (Montgomery one)
//   [24, 36) R^2 mod p      [36, 48) curve constant k = 2d, Montgomery form
//   [48]     -p^-1 mod 2^32
struct Params {
  uint32_t p[NW];
  uint32_t one[NW];
  uint32_t r2[NW];
  uint32_t k[NW];
  uint32_t n0;
};
constexpr int PARAM_WORDS = 4 * NW + 1;

struct Fq {
  uint32_t v[NW];
};

// Every thread of the block must call this (it synchronises the block).
__device__ __forceinline__ void load_params(Params& sp, const uint32_t* g) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(&sp);
  for (int i = threadIdx.x; i < PARAM_WORDS; i += blockDim.x) dst[i] = g[i];
  __syncthreads();
}

__device__ __forceinline__ Fq load(const uint32_t* src) {
  Fq r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = src[j];
  return r;
}

__device__ __forceinline__ void store(uint32_t* dst, const Fq& a) {
#pragma unroll
  for (int j = 0; j < NW; ++j) dst[j] = a.v[j];
}

__device__ __forceinline__ Fq zero() {
  Fq r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = 0;
  return r;
}

// t (NW words, plus a carry word `hi`) holds a value below 2p: subtract p
// once if the value is >= p.
__device__ __forceinline__ Fq reduce_once(const uint32_t* t, uint32_t hi,
                                          const Params& P) {
  uint32_t d[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - P.p[j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  bool take = (hi != 0) || (br == 0);
  Fq r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.v[j] = take ? d[j] : t[j];
  return r;
}

__device__ __forceinline__ Fq add(const Fq& a, const Fq& b, const Params& P) {
  uint32_t t[NW];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.v[j] + b.v[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  return reduce_once(t, (uint32_t)c, P);
}

__device__ __forceinline__ Fq sub(const Fq& a, const Fq& b, const Params& P) {
  uint32_t t[NW];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.v[j] - b.v[j] - br;
    t[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  // a - b < 0: add p back (the sum wraps to the right value mod 2^384)
  uint32_t mask = 0u - br;
  uint64_t c = 0;
  Fq r;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] + (P.p[j] & mask) + c;
    r.v[j] = (uint32_t)s;
    c = s >> 32;
  }
  return r;
}

__device__ __forceinline__ Fq neg(const Fq& a, const Params& P) {
  return sub(zero(), a, P);
}

// CIOS Montgomery product a*b/R mod p.
__device__ __forceinline__ Fq mul(const Fq& a, const Fq& b, const Params& P) {
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
  return reduce_once(t, t[NW], P);
}

__device__ __forceinline__ Fq sqr(const Fq& a, const Params& P) {
  return mul(a, a, P);
}

}  // namespace fq
