// Radix-2 NTT over Goldilocks, q = 2^64 - 2^32 + 1, for Hopper: the
// transform of every column of an (n, B) array, n = 2^log_n <= 2^12, with B
// contiguous.  Natural-order input and output, A[k] = sum_j a_j w^(jk),
// every value canonical (below q), so the result equals the plain version
// (zprize_tpu_torch/ntt/gl_kernel.py: gl_ntt_plain) bit for bit.
//
// Replaces both Goldilocks TPU kernels of zprize_tpu/ntt/gl_kernel.py:
// _make_ntt_call, which unrolls all stages of a 2^k <= 2^9 transform in one
// grid step, and _make_ntt_grid_call, which runs one stage per grid step
// for 2^10..2^12.  The two differ only in how the TPU compiler could hold
// the stages; here a 2^12-point column is 32 KB, so one block keeps C
// columns of any size up to 2^12 in shared memory through all its stages,
// in one launch.  Larger transforms are composed four-step by the caller,
// which asks the column pass for the step twiddle on the store.
//
// One block per C = min(B, 2^14 / n) adjacent columns (128 KB of u64):
//   load   element (i, c) into shared memory at bit-reversed position,
//          reading rows of C adjacent columns;
//   stages s = 1..log_n, one thread per butterfly, with __syncthreads()
//          between them; stage s takes w^j = pows[j * n / 2^s] from the
//          domain's power table, copied into shared memory (stage 1 has
//          w = 1 and no multiply);
//   store  optionally times the four-step step twiddle w_N^(k1 j2)
//          = A[k1, j2 >> split] * B[k1, j2 & (2^split - 1)] (the two-level
//          tables, j2 = column / inner) and times a scale (n^-1 on the
//          last pass of an inverse).
//
// Mulmod: the 128-bit product from a * b and __umul64hi(a, b), folded with
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod q), then one conditional subtraction.
//
// What bounds it on an H100: bytes.  A 2^12 x 4096 pass is about 1.3e8
// mulmods of 8 IMAD slots each (0.06 ms at 16.75 T IMAD/s) against 268 MB
// read and written once (0.08 ms at 3.35 TB/s).  The design makes one trip
// to device memory per pass for all 12 stages.  Speed (radix-4/8 stages in
// registers, conflict-free shared strides, more blocks per SM, the
// transpose of the four-step fused into the store) is later work.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr uint64_t Q = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod q
constexpr int MAX_LOG = 12;
constexpr int TILE_ELEMS = 1 << 14;      // u64 values a block holds
constexpr int THREADS = 512;

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;                   // 2^64 wrap: + (2^64 mod q)
  return s >= Q ? s - Q : s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return a < b ? d - EPS : d;            // borrow: + q - 2^64
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t hi_hi = hi >> 32, hi_lo = hi & EPS;
  uint64_t t = lo - hi_hi;               // lo - hi_hi * 2^96
  if (lo < hi_hi) t -= EPS;
  const uint64_t u = hi_lo * EPS;        // hi_lo * 2^64
  uint64_t r = t + u;
  if (r < t) r += EPS;
  return r >= Q ? r - Q : r;
}

struct Step {
  const uint64_t* tw_a;  // (n, 2^(step_log - split)) or null when 1 column
  const uint64_t* tw_b;  // (n, 2^split), or null: no step twiddle
  int step_log, split;
  long long inner;       // columns per j2
};

__global__ void __launch_bounds__(THREADS)
    k_gl_ntt(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
             const uint64_t* __restrict__ pows, Step step, uint64_t scale,
             long long batch, int log_n, int cols) {
  extern __shared__ uint64_t sh[];       // cols * n values, then n/2 pows
  const int n = 1 << log_n;
  const int half_n = n > 1 ? n / 2 : 1;
  uint64_t* tw = sh + (size_t)cols * n;
  const long long c0 = (long long)blockIdx.x * cols;
  const int c_here = (int)min((long long)cols, batch - c0);
  for (int k = threadIdx.x; k < half_n; k += blockDim.x) tw[k] = pows[k];
  for (int idx = threadIdx.x; idx < n * c_here; idx += blockDim.x) {
    const int i = idx / c_here, c = idx % c_here;
    const int r = log_n ? (int)(__brev((unsigned)i) >> (32 - log_n)) : 0;
    sh[c * n + r] = in[(long long)i * batch + c0 + c];
  }
  __syncthreads();
  for (int s = 1; s <= log_n; ++s) {
    const int half = 1 << (s - 1);
    for (int k = threadIdx.x; k < half_n * c_here; k += blockDim.x) {
      const int c = k >> (log_n - 1), kk = k & (half_n - 1);
      const int j = kk & (half - 1);
      uint64_t* col = sh + c * n;
      const int i0 = ((kk >> (s - 1)) << s) + j;
      const uint64_t u = col[i0];
      uint64_t v = col[i0 + half];
      if (s > 1) v = gl_mul(v, tw[j << (log_n - s)]);
      col[i0] = gl_add(u, v);
      col[i0 + half] = gl_sub(u, v);
    }
    __syncthreads();
  }
  const int nb = 1 << step.split;
  const int na = 1 << (step.step_log - step.split);
  for (int idx = threadIdx.x; idx < n * c_here; idx += blockDim.x) {
    const int i = idx / c_here, c = idx % c_here;
    uint64_t y = sh[c * n + i];
    if (step.tw_b != nullptr) {
      const long long j2 = (c0 + c) / step.inner;
      y = gl_mul(y, step.tw_b[(long long)i * nb + (j2 & (nb - 1))]);
      if (step.tw_a != nullptr)
        y = gl_mul(y, step.tw_a[(long long)i * na + (j2 >> step.split)]);
    }
    if (scale != 0) y = gl_mul(y, scale);
    out[(long long)i * batch + c0 + c] = y;
  }
}

}  // namespace

extern "C" {

// out = the NTT of each of the `batch` columns of `in` (both (2^log_n,
// batch) canonical u64 values, row-major, distinct buffers), with the
// domain's power table `pows` (2^(log_n - 1) values, one for log_n = 0).
// If tw_b is not null, element (k1, column) is then multiplied by
// tw_b[k1, j2 mod 2^split] and, if tw_a is not null, by
// tw_a[k1, j2 >> split], where j2 = column / inner < 2^step_log.  A
// nonzero `scale` multiplies every output.  0 <= log_n <= 12.  One launch
// on `stream`.
int gl_ntt(const void* in, void* out, const void* pows, const void* tw_a,
           const void* tw_b, int step_log, int split, long long inner,
           unsigned long long scale, long long batch, int log_n,
           void* stream) {
  if (batch <= 0) return 0;
  if (log_n < 0 || log_n > MAX_LOG || inner <= 0 || split < 0 ||
      split > step_log)
    return (int)cudaErrorInvalidValue;
  const int n = 1 << log_n;
  const long long cols = std::min((long long)(TILE_ELEMS / n), batch);
  const size_t smem = ((size_t)cols * n + (n > 1 ? n / 2 : 1)) *
                      sizeof(uint64_t);
  static size_t smem_set = 48 << 10;
  if (smem > smem_set) {
    int rc = (int)cudaFuncSetAttribute(
        k_gl_ntt, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
    smem_set = smem;
  }
  const long long blocks = (batch + cols - 1) / cols;
  const int threads = (int)std::min((long long)THREADS, cols * n);
  Step step{(const uint64_t*)tw_a, (const uint64_t*)tw_b, step_log, split,
            inner};
  k_gl_ntt<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)pows, step,
      (uint64_t)scale, batch, log_n, (int)cols);
  return (int)cudaGetLastError();
}

const char* ntt_gl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
