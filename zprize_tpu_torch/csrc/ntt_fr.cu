// NTT over a 253/255-bit scalar field (BLS12-377/381 Fr) for Hopper:
// natural-order input and output, A[k] = sum_j a_j w^(jk), the inverse
// scaled by n^-1, every value fully reduced (csrc/fq.cuh, 8 words), so the
// result equals the plain version (zprize_tpu_torch/ntt/fr_kernel.py) bit
// for bit, whatever the decomposition.
//
// Replaces _make_ntt_fn of zprize_tpu/ntt/fr_kernel.py, the TPU kernel
// that runs every stage of a 2^7..2^12 transform in VMEM, one invocation
// per batch column, with larger sizes composed four-step around it.  Here
// the layout is
//
//   data  (B, n, 8) int32 words, row-major: B independent transforms
//   pows  (n/2, 8) the domain's Montgomery powers w^0 .. w^(n/2 - 1) (or of
//         w^-1 for the inverse)
//
// What bounds it on an H100: integer multiplies.  One 8-word mulmod is 264
// IMAD issue slots; a transform is (n/2) log2(n) butterfly mulmods (plus n
// for the inverse scale), about 132 log2(n) slots per element against 64
// bytes read and written once: far above the card's ratio of about 5 slots
// per byte (16.75 T IMAD/s over 3.35 TB/s), as long as the data goes
// through device memory only a few times.
//
// Design: a transform of n = 2^log_n points takes one pass through device
// memory per factor of the caller's plan (fr_kernel.plan: log_n <= 10 one
// pass, <= 20 two, <= 30 three, factors of at most 2^10).  Four-step: with
// n = n1 n2, input j = j1 n2 + j2 and output k = k1 + n1 k2,
//   pass 1  for each column j2, the n1-point DFT over j1 (stride n2), each
//           output k1 times the step twiddle w^(j2 k1), stored in place of
//           the column (row k1 of the n1 x n2 layout), into `tmp`;
//   pass 2  for each row k1 (contiguous), the n2-point DFT over j2, output
//           k2 stored at k1 + n1 k2 of `out` (times n^-1 for the inverse).
// Three factors run pass 2 as a four-step of n2 x n3 on each row k1 (in
// place in `tmp`, step twiddle w^(n1 j3 k2)) and a third pass over the
// contiguous n3-point rows.  A block takes C adjacent columns of a pass,
// so each row of its reads and writes is C x 32 contiguous bytes (or a
// whole contiguous column), and every element is one 32-byte sector.
//
// Inside a pass (k_fr_pass<LM>, one instance per column length m = 2^LM):
// T = m / 8 threads a column each hold 8 values in registers, and the
// column is split into radix-8 digits from the top (decimation in
// frequency, a shorter last digit of radix 2^LAST when 3 does not divide
// LM): pass p reads the 8 values lo + S d + 8 S hi (S = m / 8^p; from
// device memory for p = 1), runs the 8-point DFT in registers (three
// radix-2 stages, 5 mulmods), multiplies output k by w_m^(8^(p-1) lo k),
// and writes them back to shared memory in place, one barrier a pass.
// The last pass reads 8 consecutive positions, runs its 2^LAST-point
// DFTs and stores element k, the base-8 digit reversal of the position,
// with the step twiddle and the scale, straight to device memory.  The
// column sits word-major in shared memory with one word of padding every
// 32 positions, so the first and last passes' accesses are free of bank
// conflicts.  The m/2 powers of w_m are copied from the domain's table
// into shared memory by each block; the step twiddles are read from the
// table in device memory (L2), one per element.  128 threads a block.
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "fq.cuh"

namespace {

constexpr int NW = 8;
using Fr = fq::Fe<NW>;
using Params = fq::Params<NW>;

constexpr int MAX_PASS_LOG = 10;
constexpr int MAX_PASSES = 3;
constexpr int TB = 128;  // threads a block

// the compile-time shape of a pass over columns of m = 2^LM points (the
// data's elements are 32-byte aligned: 16-byte vector loads and stores)
template <int LM>
struct Plan {
  static constexpr int M = 1 << LM;
  static constexpr int V = LM < 3 ? M : 8;          // values a thread holds
  static constexpr int T = M / V;                   // threads a column
  static constexpr int C = TB / T;                  // columns a block
  static constexpr int P = LM <= 3 ? 1 : (LM + 2) / 3;  // radix passes
  static constexpr int LAST = LM - 3 * (P - 1);     // log2 of the last radix
  static constexpr int RL = 1 << LAST;
  static constexpr int G = V / RL;                  // last-pass groups a thread
  static constexpr int HALF = M / 2;                // powers of w_m
  static constexpr int CS = P == 1 ? 0 : M + M / 32;  // padded column row
  static constexpr size_t SMEM =
      ((size_t)HALF * NW + (size_t)C * NW * CS) * sizeof(uint32_t);
};

// column i of a pass -> (i >> split) * hi + (i & (2^split - 1)) * lo
// elements from the transform's start; its element j at j * es more
struct Side {
  long long hi, lo;
  int split;
  long long es;
};

struct Pass {
  const uint32_t* in;
  uint32_t* out;
  const uint32_t* pows;   // w_n^0 .. w_n^(n/2 - 1)
  const uint32_t* scale;  // multiplies every output, or null
  Side src, dst;
  long long n;            // points a transform
  long long cols;         // columns a transform
  long long total;        // columns in all: rows * cols
  int tw_shift;           // w_m^i = pows[i << tw_shift]
  int step_split;         // -1: no step twiddle; else column i's output k
  long long step_mul;     // times w_n^((i & (2^step_split - 1)) k step_mul)
};

__device__ __forceinline__ long long offset(const Side& s, long long i) {
  return (i >> s.split) * s.hi + (i & ((1LL << s.split) - 1)) * s.lo;
}

// the shared-memory word of position pos of a padded column
__device__ __forceinline__ int phys(int pos) { return pos + (pos >> 5); }

template <int CS>
__device__ __forceinline__ Fr sload(const uint32_t* x, int pos) {
  Fr r;
#pragma unroll
  for (int w = 0; w < NW; ++w) r.v[w] = x[w * CS + phys(pos)];
  return r;
}

template <int CS>
__device__ __forceinline__ void sstore(uint32_t* x, int pos, const Fr& a) {
#pragma unroll
  for (int w = 0; w < NW; ++w) x[w * CS + phys(pos)] = a.v[w];
}

// w^e from a table of the first `half` powers of w (w^half = -1), e < 2 half
__device__ __forceinline__ Fr power(const uint32_t* tab, long long e,
                                    long long half, const Params& P) {
  if (e < half) return fq::load<NW>(tab + e * NW);
  return fq::neg(fq::load<NW>(tab + (e - half) * NW), P);
}

__host__ __device__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// Stage s..LR of the radix-2 DIT network on 2^LR registers (bit-reversed
// order in, natural out): butterflies at distance 2^(s-1), the upper
// input times w_m^(j m / 2^s) from the shared table tw.
template <int LM, int LR, int s>
__device__ __forceinline__ void stages(Fr* a, const uint32_t* tw,
                                       const Params& P) {
  if constexpr (s <= LR) {
    constexpr int half = 1 << (s - 1);
#pragma unroll
    for (int i0 = 0; i0 < (1 << LR); i0 += 2 * half) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const Fr u = a[i0 + j];
        Fr t = a[i0 + j + half];
        if (j != 0) t = fq::mul(t, fq::load<NW>(tw + (j << (LM - s)) * NW), P);
        a[i0 + j] = fq::add(u, t, P);
        a[i0 + j + half] = fq::sub(u, t, P);
      }
    }
    stages<LM, LR, s + 1>(a, tw, P);
  }
}

// a[brev(i)] = v[i] with every index a compile-time constant (a runtime
// index would put the array in local memory)
template <int LR, int i = 0>
__device__ __forceinline__ void bitrev_copy(Fr* a, const Fr* v) {
  if constexpr (i < (1 << LR)) {
    constexpr int r = brev(i, LR);
    a[r] = v[i];
    bitrev_copy<LR, i + 1>(a, v);
  }
}

// In place, natural order in and out: v[k] = sum_d v[d] w_m^(m d k / 2^LR)
// over 2^LR registers, on a compile-time bit-reversed copy.
template <int LM, int LR>
__device__ __forceinline__ void dft(Fr* v, const uint32_t* tw,
                                    const Params& P) {
  constexpr int R = 1 << LR;
  Fr a[R];
  bitrev_copy<LR>(a, v);
  stages<LM, LR, 1>(a, tw, P);
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = a[i];
}

// Radix-8 pass p < P on the digit of stride S = m / 8^p (header): the
// thread's values are positions lo + S d + 8 S hi of its column x, in
// registers on entry for p = 1, else read from shared memory; they leave
// times w_m^(8^(p-1) lo k) to the same positions, and the block meets at a
// barrier.
template <int LM, int p>
__device__ __forceinline__ void mid_pass(Fr* v, const uint32_t* tw,
                                         uint32_t* x, int u,
                                         const Params& P) {
  using K = Plan<LM>;
  constexpr int S = K::M >> (3 * p);
  constexpr int R = 1 << (3 * (p - 1));
  const int lo = u % S, hi = u / S;
  const int base = lo + 8 * S * hi;
  if constexpr (p > 1) {
#pragma unroll
    for (int d = 0; d < 8; ++d) v[d] = sload<K::CS>(x, base + S * d);
  }
  dft<LM, 3>(v, tw, P);
#pragma unroll
  for (int k = 1; k < 8; ++k)
    v[k] = fq::mul(v[k], power(tw, R * lo * k, K::HALF, P), P);
#pragma unroll
  for (int d = 0; d < 8; ++d) sstore<K::CS>(x, base + S * d, v[d]);
  __syncthreads();
}

// base-8 digit reversal of the nd low digits of x
template <int ND>
__device__ __forceinline__ int digitrev8(int x) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < ND; ++i) r |= ((x >> (3 * i)) & 7) << (3 * (ND - 1 - i));
  return r;
}

template <int LM>
__global__ void __launch_bounds__(TB)
    k_fr_pass(const uint32_t* params, Pass a) {
  using K = Plan<LM>;
  extern __shared__ uint32_t sh[];
  __shared__ Params P;
  uint32_t* const tw = sh;                   // HALF powers of w_m
  uint32_t* const xs = sh + K::HALF * NW;    // C columns, NW rows of CS
  for (int i = threadIdx.x; i < K::HALF * NW; i += TB)
    tw[i] = a.pows[((long long)(i / NW) << a.tw_shift) * NW + i % NW];
  fq::load_params(P, params);                // the block's barrier
  // a strided column (element stride above 1) puts the block's columns
  // side by side in a warp, so a row of them is one contiguous read; a
  // contiguous one puts a column's positions side by side
  const bool col_fast = a.src.es != 1;
  const int u = col_fast ? threadIdx.x / K::C : threadIdx.x % K::T;
  const int lc = col_fast ? threadIdx.x % K::C : threadIdx.x / K::T;
  const long long c = (long long)blockIdx.x * K::C + lc;
  const bool live = c < a.total;
  const long long b = live ? c / a.cols : 0, i = live ? c - b * a.cols : 0;
  const uint32_t* const src =
      a.in + (b * a.n + offset(a.src, i)) * NW;
  Fr v[K::V];
  // pass 1's values: positions u + T d
#pragma unroll
  for (int d = 0; d < K::V; ++d)
    v[d] = live ? fq::load16<NW>(src + (u + (long long)K::T * d) *
                                            a.src.es * NW)
                : fq::zero<NW>();
  if constexpr (K::P > 1) {
    uint32_t* const x = xs + lc * NW * K::CS;
    mid_pass<LM, 1>(v, tw, x, u, P);
    if constexpr (K::P > 2) mid_pass<LM, 2>(v, tw, x, u, P);
    if constexpr (K::P > 3) mid_pass<LM, 3>(v, tw, x, u, P);
#pragma unroll
    for (int d = 0; d < 8; ++d) v[d] = sload<K::CS>(x, 8 * u + d);
  }
#pragma unroll
  for (int g = 0; g < K::G; ++g) dft<LM, K::LAST>(v + g * K::RL, tw, P);
  if (!live) return;
  uint32_t* const dst = a.out + (b * a.n + offset(a.dst, i)) * NW;
  const long long step_i =
      a.step_split >= 0 ? (i & ((1LL << a.step_split) - 1)) * a.step_mul : 0;
#pragma unroll
  for (int g = 0; g < K::G; ++g) {
    const int q = (K::V * u + g * K::RL) >> K::LAST;
#pragma unroll
    for (int kl = 0; kl < K::RL; ++kl) {
      const int k = digitrev8<K::P - 1>(q) + (K::M >> K::LAST) * kl;
      Fr y = v[g * K::RL + kl];
      if (a.step_split >= 0)
        y = fq::mul(y, power(a.pows, (step_i * k) & (a.n - 1), a.n >> 1, P),
                    P);
      if (a.scale != nullptr) y = fq::mul(y, fq::load<NW>(a.scale), P);
      fq::store16(dst + (long long)k * a.dst.es * NW, y);
    }
  }
}

// devices whose attribute settings configure() remembers; a device past
// them gets its attributes set at every launch
constexpr int MAX_DEVICES = 64;

// lets the LM instance use its shared memory (above the default 48 KB) on
// the current device, once a device: a kernel's attributes are the
// device's, not the process's
template <int LM>
int configure() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  if (int rc = (int)cudaGetDevice(&dev)) return rc;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_relaxed))
    return 0;
  const int rc = (int)cudaFuncSetAttribute(
      k_fr_pass<LM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Plan<LM>::SMEM);
  if (rc == 0 && dev < MAX_DEVICES)
    done[dev].store(true, std::memory_order_relaxed);
  return rc;
}

template <int LM>
int launch(const uint32_t* params, const Pass& a, cudaStream_t stream) {
  using K = Plan<LM>;
  if (int rc = configure<LM>()) return rc;
  const long long blocks = (a.total + K::C - 1) / K::C;
  k_fr_pass<LM><<<(unsigned)blocks, TB, K::SMEM, stream>>>(params, a);
  return (int)cudaGetLastError();
}

// launch<LM> for the runtime lm (1..MAX_PASS_LOG)
template <int LM = 1>
int launch_log(int lm, const uint32_t* params, const Pass& a,
               cudaStream_t stream) {
  if constexpr (LM > MAX_PASS_LOG) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lm == LM) return launch<LM>(params, a, stream);
    return launch_log<LM + 1>(lm, params, a, stream);
  }
}

constexpr int ALL = 62;  // a split that keeps every column bit in `lo`

}  // namespace

extern "C" {

// out = NTT of each of the `rows` rows of `in` (both (rows, 2^log_n, 8)
// words, distinct buffers); `scale` (8 words) multiplies the result, or is
// null.  The plan (fr_kernel.plan) is log_n = l1 + l2 + l3 with each
// factor at most 2^10, the later ones 0 when unused: one launch a nonzero
// factor, in order, on `stream`; with two or three, `tmp` (the size of
// `in`) holds the data between them.
int fr_ntt(const void* params, const void* pows, const void* scale,
           const void* in, void* tmp, void* out, long long rows, int log_n,
           int l1, int l2, int l3, void* stream) {
  if (rows <= 0) return 0;
  const int ls[MAX_PASSES] = {l1, l2, l3};
  const int passes = l2 == 0 ? 1 : l3 == 0 ? 2 : 3;
  for (int p = 0; p < MAX_PASSES; ++p) {
    if (p < passes ? ls[p] < 1 || ls[p] > MAX_PASS_LOG : ls[p] != 0)
      return (int)cudaErrorInvalidValue;
  }
  if (l1 + l2 + l3 != log_n || (passes > 1 && tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n = 1LL << log_n;
  const auto* prm = (const uint32_t*)params;
  Pass a{};
  a.pows = (const uint32_t*)pows;
  a.n = n;
  a.step_split = -1;
  a.step_mul = 0;
  Pass list[MAX_PASSES];
  int lms[MAX_PASSES];
  if (passes == 1) {
    a.in = (const uint32_t*)in;
    a.out = (uint32_t*)out;
    a.src = a.dst = Side{0, 0, 0, 1};
    a.cols = 1;
    a.tw_shift = 0;
    a.scale = (const uint32_t*)scale;
    list[0] = a;
    lms[0] = log_n;
  } else if (passes == 2) {
    const long long n1 = 1LL << l1, n2 = 1LL << l2;
    Pass p1 = a, p2 = a;
    p1.in = (const uint32_t*)in;
    p1.out = (uint32_t*)tmp;
    p1.src = p1.dst = Side{0, 1, ALL, n2};
    p1.cols = n2;
    p1.tw_shift = l2;
    p1.step_split = ALL;
    p1.step_mul = 1;
    p1.scale = nullptr;
    p2.in = (const uint32_t*)tmp;
    p2.out = (uint32_t*)out;
    p2.src = Side{0, n2, ALL, 1};
    p2.dst = Side{0, 1, ALL, n1};
    p2.cols = n1;
    p2.tw_shift = l1;
    p2.scale = (const uint32_t*)scale;
    list[0] = p1;
    list[1] = p2;
    lms[0] = l1;
    lms[1] = l2;
  } else {
    const long long n1 = 1LL << l1, n2 = 1LL << l2, n3 = 1LL << l3;
    const long long n23 = n2 * n3;
    Pass p1 = a, p2 = a, p3 = a;
    p1.in = (const uint32_t*)in;
    p1.out = (uint32_t*)tmp;
    p1.src = p1.dst = Side{0, 1, ALL, n23};
    p1.cols = n23;
    p1.tw_shift = l2 + l3;
    p1.step_split = ALL;
    p1.step_mul = 1;
    p1.scale = nullptr;
    // column i = k1 n3 + j3, in place
    p2.in = (const uint32_t*)tmp;
    p2.out = (uint32_t*)tmp;
    p2.src = p2.dst = Side{n23, 1, l3, n3};
    p2.cols = n1 * n3;
    p2.tw_shift = l1 + l3;
    p2.step_split = l3;
    p2.step_mul = n1;
    p2.scale = nullptr;
    // column i = k2 n1 + k1: reads row (k1, k2), writes k1 + n1 k2 + n1 n2 k3
    p3.in = (const uint32_t*)tmp;
    p3.out = (uint32_t*)out;
    p3.src = Side{n3, n23, l1, 1};
    p3.dst = Side{0, 1, ALL, n1 * n2};
    p3.cols = n1 * n2;
    p3.tw_shift = l1 + l2;
    p3.scale = (const uint32_t*)scale;
    list[0] = p1;
    list[1] = p2;
    list[2] = p3;
    lms[0] = l1;
    lms[1] = l2;
    lms[2] = l3;
  }
  for (int p = 0; p < passes; ++p) {
    list[p].total = rows * list[p].cols;
    const int rc = launch_log(lms[p], prm, list[p], (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return 0;
}

const char* ntt_fr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
