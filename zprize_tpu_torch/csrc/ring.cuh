// The gather kernels' two-stage ring of rows in flight (csrc/msm_te.cu,
// csrc/msm_sw.cu): cp.async copies of 16-byte chunks into a thread's own
// slots of shared memory, and the reads of a field element back from them.
//
// A thread's row sits in its slot as chunks k = 0, 1, .. at slot[k * BLOCK]
// (BLOCK the threads of the block), so the lanes of a warp read one chunk
// back as one conflict-free 128-bit access.  A thread reads only its own
// slots, so no barrier is needed: the wait for its own copies orders them.
#pragma once

#include <cstdint>

#include "fq.cuh"

namespace ring {

// One 16-byte copy from global memory (16-byte aligned) into shared memory.
// cp.async.cg goes through L2 only: the rows are gathered at random and
// read once.
__device__ __forceinline__ void copy16(uint4* dst, const uint4* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `pending` of this thread's copy groups are in flight
template <int pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// Field element w of the row in a slot: NW / 4 chunks from chunk
// w * NW / 4 on.
template <int NW, int BLOCK>
__device__ __forceinline__ fq::Fe<NW> word(const uint4* slot, int w) {
  fq::Fe<NW> r;
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    const uint4 v = slot[(NW / 4 * w + k) * BLOCK];
    r.v[4 * k] = v.x;
    r.v[4 * k + 1] = v.y;
    r.v[4 * k + 2] = v.z;
    r.v[4 * k + 3] = v.w;
  }
  return r;
}

}  // namespace ring
