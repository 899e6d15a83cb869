// Radix-2 NTT over a 253/255-bit scalar field (BLS12-377/381 Fr) for
// Hopper: natural-order input and output, A[k] = sum_j a_j w^(jk), the
// inverse scaled by n^-1, every value fully reduced (csrc/fq.cuh, 8 words),
// so the result equals the plain version (zprize_tpu_torch/ntt/fr_kernel.py)
// bit for bit.
//
// Replaces _make_ntt_fn of zprize_tpu/ntt/fr_kernel.py, the TPU kernel
// that runs every stage of a 2^7..2^12 transform in VMEM, one invocation
// per batch column, with larger sizes composed four-step around it.  That
// structure answers the TPU's VMEM; here the layout is
//
//   data  (B, n, 8) int32 words, row-major: B independent transforms
//   pows  (n/2, 8) the domain's Montgomery powers w^0 .. w^(n/2 - 1) (or of
//         w^-1 for the inverse); stage s uses pows[j * n / 2^s]
//
// and the design is two kernels:
//
//   k_ntt_tile   one block per tile of T = min(n, 1024) consecutive output
//                positions of one row: loads the bit-reversed input into
//                shared memory (word-major, 32 KB at T = 1024), runs the
//                first log2(T) stages there, one thread per butterfly, and
//                writes the tile out;
//   k_ntt_stage  each later stage in place in global memory, one thread per
//                butterfly (n/2 per row).
//
// The last pass multiplies by n^-1 when the caller passes a scale.
//
// What bounds it on an H100: integer multiplies.  One 8-word mulmod is 264
// IMAD issue slots; a transform is (n/2) log2(n) butterfly mulmods (plus n
// for the inverse scale), about 132 log2(n) slots per element against 64
// bytes read and written once: far above the card's ratio of about 5 slots
// per byte (16.75 T IMAD/s over 3.35 TB/s).  The design keeps the tile
// pass there (10 stages per trip to memory, 20 slots per byte); each stage
// pass in global memory is one trip per stage (2 slots per byte), so above
// 2^10 those passes are bound by bytes.  Speed (carry chains in PTX,
// radix-4/8 butterflies, more stages fused per pass, conflict-free
// shared-memory strides) is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace {

constexpr int NW = 8;
using Fr = fq::Fe<NW>;
using Params = fq::Params<NW>;

constexpr int TILE_LOG = 10;
constexpr int TILE_THREADS = 1 << (TILE_LOG - 1);
constexpr int STAGE_BLOCK = 256;

__device__ __forceinline__ void butterfly(Fr& u, Fr& v, const Fr& w,
                                          const Params& P) {
  Fr t = fq::mul(v, w, P);
  Fr lo = fq::add(u, t, P);
  v = fq::sub(u, t, P);
  u = lo;
}

// Shared memory holds the tile word-major, sh[w * T + i], so that threads
// on neighbouring positions touch neighbouring banks.
__device__ __forceinline__ Fr load_sh(const uint32_t* sh, int i, int T) {
  Fr r;
#pragma unroll
  for (int w = 0; w < NW; ++w) r.v[w] = sh[w * T + i];
  return r;
}

__device__ __forceinline__ void store_sh(uint32_t* sh, int i, int T,
                                         const Fr& a) {
#pragma unroll
  for (int w = 0; w < NW; ++w) sh[w * T + i] = a.v[w];
}

__global__ void __launch_bounds__(TILE_THREADS)
    k_ntt_tile(const uint32_t* params, const uint32_t* pows,
               const uint32_t* scale, const uint32_t* in, uint32_t* out,
               int log_n, int tile_log) {
  extern __shared__ uint32_t sh[];
  __shared__ Params P;
  fq::load_params(P, params);
  const int T = 1 << tile_log;
  const long long tiles = 1LL << (log_n - tile_log);
  const long long row = blockIdx.x / tiles;
  const long long base = (blockIdx.x % tiles) << tile_log;
  const uint32_t* src = in + (row << log_n) * NW;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    unsigned g = (unsigned)(base + i);
    unsigned r = __brev(g) >> (32 - log_n);
    store_sh(sh, i, T, fq::load<NW>(src + (long long)r * NW));
  }
  __syncthreads();
  for (int s = 1; s <= tile_log; ++s) {
    const int half = 1 << (s - 1);
    const bool last = scale != nullptr && s == log_n;
    for (int k = threadIdx.x; k < T / 2; k += blockDim.x) {
      int j = k & (half - 1);
      int i0 = ((k >> (s - 1)) << s) + j;
      int i1 = i0 + half;
      Fr u = load_sh(sh, i0, T), v = load_sh(sh, i1, T);
      Fr w = fq::load<NW>(pows + ((long long)j << (log_n - s)) * NW);
      butterfly(u, v, w, P);
      if (last) {
        Fr sc = fq::load<NW>(scale);
        u = fq::mul(u, sc, P);
        v = fq::mul(v, sc, P);
      }
      store_sh(sh, i0, T, u);
      store_sh(sh, i1, T, v);
    }
    __syncthreads();
  }
  uint32_t* dst = out + ((row << log_n) + base) * NW;
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    fq::store(dst + (long long)i * NW, load_sh(sh, i, T));
}

__global__ void __launch_bounds__(STAGE_BLOCK)
    k_ntt_stage(const uint32_t* params, const uint32_t* pows,
                const uint32_t* scale, uint32_t* data, int log_n, int s,
                long long total) {
  __shared__ Params P;
  fq::load_params(P, params);
  long long t = (long long)blockIdx.x * STAGE_BLOCK + threadIdx.x;
  if (t >= total) return;
  const long long row = t >> (log_n - 1);
  const long long k = t & ((1LL << (log_n - 1)) - 1);
  const long long half = 1LL << (s - 1);
  const long long j = k & (half - 1);
  const long long i0 = ((k >> (s - 1)) << s) + j;
  uint32_t* a = data + (row << log_n) * NW;
  Fr u = fq::load<NW>(a + i0 * NW), v = fq::load<NW>(a + (i0 + half) * NW);
  butterfly(u, v, fq::load<NW>(pows + (j << (log_n - s)) * NW), P);
  if (scale != nullptr) {
    Fr sc = fq::load<NW>(scale);
    u = fq::mul(u, sc, P);
    v = fq::mul(v, sc, P);
  }
  fq::store(a + i0 * NW, u);
  fq::store(a + (i0 + half) * NW, v);
}

}  // namespace

extern "C" {

// out = NTT of each of the `rows` rows of `in` (both (rows, 2^log_n, 8)
// words, distinct buffers); `scale` (8 words) multiplies the result, or is
// null.  1 <= log_n <= 31.  Launches one tile pass and log_n - 10 stage
// passes (none below n = 2^11) on `stream`, in order.
int fr_ntt(const void* params, const void* pows, const void* scale,
           const void* in, void* out, long long rows, int log_n,
           void* stream) {
  if (rows <= 0) return 0;
  if (log_n < 1 || log_n > 31) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tile_log = log_n < TILE_LOG ? log_n : TILE_LOG;
  const uint32_t* sc_tile = log_n == tile_log ? (const uint32_t*)scale
                                              : nullptr;
  const long long blocks = rows << (log_n - tile_log);
  const int threads = 1 << (tile_log - 1);
  const size_t smem = (size_t)NW * sizeof(uint32_t) << tile_log;
  k_ntt_tile<<<(unsigned)blocks, threads, smem, st>>>(
      (const uint32_t*)params, (const uint32_t*)pows, sc_tile,
      (const uint32_t*)in, (uint32_t*)out, log_n, tile_log);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long total = rows << (log_n - 1);
  const unsigned grid = (unsigned)((total + STAGE_BLOCK - 1) / STAGE_BLOCK);
  for (int s = tile_log + 1; s <= log_n; ++s) {
    k_ntt_stage<<<grid, STAGE_BLOCK, 0, st>>>(
        (const uint32_t*)params, (const uint32_t*)pows,
        s == log_n ? (const uint32_t*)scale : nullptr, (uint32_t*)out,
        log_n, s, total);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

const char* ntt_fr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
