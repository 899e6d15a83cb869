// Carry-chain primitives of the device field engine (csrc/fq.cuh): one PTX
// instruction each on 32-bit words, with the carry (or borrow) flag CC.CF
// passed from one instruction to the next.
//
//   add_cc   a + b             -> CF      addc_cc  a + b + CF -> CF
//   addc     a + b + CF                   (the last link of a chain)
//   sub_cc   a - b             -> CF      subc_cc  a - b - CF -> CF
//   subc     a - b - CF
//   mad_lo_cc   lo(a*b) + c    -> CF      madc_lo_cc  lo(a*b) + c + CF -> CF
//   madc_hi_cc  hi(a*b) + c + CF -> CF    madc_hi     hi(a*b) + c + CF
//
// The flag is invisible to the C++ compiler, so every statement is
// `asm volatile`: volatile statements keep their order, and a chain
// written as consecutive calls stays a chain.  ptxas maps the flag onto
// predicate registers and schedules the chains' SASS from there.
#pragma once

#include <cstdint>

namespace ptx {

#define FQ_PTX2(fn, op)                                                     \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b) {          \
    uint32_t r;                                                             \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));             \
    return r;                                                               \
  }
#define FQ_PTX3(fn, op)                                                     \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b,            \
                                         uint32_t c) {                      \
    uint32_t r;                                                             \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                               \
  }

FQ_PTX2(add_cc, "add.cc.u32")
FQ_PTX2(addc_cc, "addc.cc.u32")
FQ_PTX2(addc, "addc.u32")
FQ_PTX2(sub_cc, "sub.cc.u32")
FQ_PTX2(subc_cc, "subc.cc.u32")
FQ_PTX2(subc, "subc.u32")
FQ_PTX3(mad_lo_cc, "mad.lo.cc.u32")
FQ_PTX3(madc_lo_cc, "madc.lo.cc.u32")
FQ_PTX3(madc_hi_cc, "madc.hi.cc.u32")
FQ_PTX3(madc_hi, "madc.hi.u32")

#undef FQ_PTX2
#undef FQ_PTX3

}  // namespace ptx
