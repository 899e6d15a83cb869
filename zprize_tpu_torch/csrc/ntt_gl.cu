// NTT over Goldilocks, q = 2^64 - 2^32 + 1, for Hopper: the transform of
// every column of an (n, B) array, n = 2^log_n <= 2^12, with B contiguous.
// Natural-order input and output, A[k] = sum_j a_j w^(jk), every value
// canonical (below q), so the result equals the plain version
// (zprize_tpu_torch/ntt/gl_kernel.py: gl_ntt_plain) bit for bit.
//
// Replaces both Goldilocks TPU kernels of zprize_tpu/ntt/gl_kernel.py:
// _make_ntt_call, which unrolls all stages of a 2^k <= 2^9 transform in one
// grid step, and _make_ntt_grid_call, which runs one stage per grid step
// for 2^10..2^12.  The two differ only in how the TPU compiler could hold
// the stages; here one launch takes any size up to 2^12, and larger
// transforms are composed four-step by the caller, which asks the column
// pass for the step twiddle and the transposed store.
//
// What bounds it on an H100: bytes, in principle.  A 2^12 x 4096 pass
// reads and writes 268 MB once, 0.08 ms at 3.35 TB/s; its 1.1e8 mulmods
// (a 64x64 -> 128 product and the fold) and 2e8 modular additions are
// about 430 SASS instructions an element, which take the 132 SMs
// roughly 0.25 ms, so the arithmetic is the larger cost, and the strided
// access (a block holds 2 or 4 columns, so a row of it is 16 or 32
// bytes) keeps the bytes to about 40 % of the card's rate.  Measured on
// an H100 (PERF.md): 0.35 ms a 2^12 x 4096 pass, 23-24 % of the bytes
// bound (0.20 ms of it the loads, exchanges and stores alone); 0.21 ms
// at 2^9 x 32768 (38 %).
//
// Design.  The 2^L-point column is split into radix-16 digits (a shorter
// last one when 4 does not divide L): j = j_P-1 + ... in base 16 from the
// top.  Each thread holds 16 values (n values when n < 16) and runs 4
// radix-2 stages on them in registers, a radix-16 pass; a 2^12 column is
// 3 passes (16 x 16 x 16) on 256 threads, a 2^9 column 16 x 16 x 2 on 32.
//   pass 1  the values come straight from device memory: the thread of
//           column c and offset lo < n/16 loads rows lo + (n/16) d, d <
//           16, and the threads of a warp take adjacent columns first, so
//           a warp reads rows of C adjacent columns (each load asks L2
//           for the whole 256-byte block, which the blocks of the next
//           columns read next);
//   pass p  (radix 16 on the digit of stride s = n / 16^p) the 16
//           values lo + s d + 16 s hi; after its stages each output k
//           times w^(16^(p-1) lo k) (the mixed-radix twiddle), back to
//           shared memory in place, one barrier;
//   last    (radix 2^LAST on the lowest digit) the thread reads its
//           groups from shared memory, runs their stages, and stores
//           element k = k_lo + 16^(P-1) d, times the step twiddle and the
//           scale if asked, either to row k of its column (columns
//           fastest in a warp) or, with the transposed store, to row
//           column / inner of an (B / inner, n * inner) output, at k *
//           inner + column % inner (rows fastest in a warp: a 2^12
//           column is 32 KB written in order); evict-first stores.
// A block of 512 threads holds C = 512 / (n / 16) columns (2 at 2^12, 16
// at 2^9, 512 a thread each below 2^5) in registers and, for the two
// exchanges, in shared memory: n + n/256 u64 a column (each 256th
// position padded out, and the column stride odd or 16/C mod 16 banks),
// which makes every exchange's reads and writes free of bank conflicts
// at 2^12 and 2^9.  2 such blocks share an SM (64 registers a thread;
// 82,560 bytes of shared memory each at 2^12).  A 2^12 launch without
// the transposed store (the row pass) takes blocks of 1024 threads and 4
// columns instead (1 a SM, 148,608 bytes): each 32-byte sector of its
// strided store is then written whole by one block, where two half
// writes cost 0.1 ms a pass more.  Indices are shifts and masks of
// compile-time radices: one instance of the kernel per log_n (two at
// 2^12).  The butterfly twiddles w^(j n / 2^s) and the pass twiddles
// (w^(n/2) = -1 folds the table to n/2 entries) come from the domain's
// power table in shared memory.  The four-step step twiddle w_N^(k j2)
// (j2 = column / inner) of element k = k_lo + R d is w_N^(k_lo j2) (one
// read of each two-level table, a thread) times w_N^(R d j2) (a table of
// 16 entries a column, built by the block), so no element gathers from
// the tables.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr uint64_t Q = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod q
constexpr int MAX_LOG = 12;
// threads a block: 512 (2 blocks a SM at 64 registers a thread), or 1024
// (1 block) where 512 would hold fewer than 4 columns and the store is
// strided: a row's 32-byte sector is then written whole by one block
constexpr int THREADS = 512, WIDE_THREADS = 1024;
constexpr int SM_THREADS = 1024;         // 64 registers a thread

// The arithmetic runs on 32-bit halves through the carry chains of
// csrc/ptx.cuh (q = 2^64 - EPS, EPS = 2^32 - 1, so adding EPS to the low
// word and the carry to the high word subtracts q mod 2^64): a modular add
// is 6 chained instructions and a select, a subtract 5, where the 64-bit
// C compares took twice as many.
__device__ __forceinline__ uint32_t lo32(uint64_t a) { return (uint32_t)a; }
__device__ __forceinline__ uint32_t hi32(uint64_t a) {
  return (uint32_t)(a >> 32);
}
__device__ __forceinline__ uint64_t join(uint32_t hi, uint32_t lo) {
  return ((uint64_t)hi << 32) | lo;
}

// a + b mod q, a and b canonical: s = a + b (65 bits), then s - q when
// s + EPS reaches 2^65's carry or 2^64's
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  const uint32_t s0 = ptx::add_cc(lo32(a), lo32(b));
  const uint32_t s1 = ptx::addc_cc(hi32(a), hi32(b));
  const uint32_t c1 = ptx::addc(0, 0);
  const uint32_t u0 = ptx::add_cc(s0, 0xFFFFFFFFu);
  const uint32_t u1 = ptx::addc_cc(s1, 0);
  const uint32_t c = ptx::addc(c1, 0);   // 1 iff a + b >= q
  return c ? join(u1, u0) : join(s1, s0);
}

// a - b mod q: on a borrow, + q - 2^64 = - EPS
__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint32_t d0 = ptx::sub_cc(lo32(a), lo32(b));
  uint32_t d1 = ptx::subc_cc(hi32(a), hi32(b));
  const uint32_t m = ptx::subc(0, 0);    // all ones on a borrow
  d0 = ptx::sub_cc(d0, m);
  d1 = ptx::subc(d1, 0);
  return join(d1, d0);
}

__device__ __forceinline__ uint64_t gl_neg(uint64_t a) {
  return a ? Q - a : 0;
}

// a * b mod q: the 128-bit product as 32-bit words p0..p3, folded with
// 2^64 = EPS and 2^96 = -1 (mod q): r = [p1:p0] - p3 + p2 * EPS, each
// wrap of 2^64 corrected by EPS, then one conditional subtraction of q.
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  const uint32_t a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  uint32_t p0 = a0 * b0, p1 = __umulhi(a0, b0);
  uint32_t p2 = a1 * b1, p3 = __umulhi(a1, b1);
  p1 = ptx::mad_lo_cc(a0, b1, p1);
  p2 = ptx::madc_hi_cc(a0, b1, p2);
  p3 = ptx::addc(p3, 0);
  p1 = ptx::mad_lo_cc(a1, b0, p1);
  p2 = ptx::madc_hi_cc(a1, b0, p2);
  p3 = ptx::addc(p3, 0);
  // t = [p1:p0] - p3, and - EPS on a borrow (t >= 2^64 - 2^32 then)
  uint32_t t0 = ptx::sub_cc(p0, p3);
  uint32_t t1 = ptx::subc_cc(p1, 0);
  const uint32_t m = ptx::subc(0, 0);
  t0 = ptx::sub_cc(t0, m);
  t1 = ptx::subc(t1, 0);
  // + p2 * EPS = [p2 : 0] - p2, and + EPS on a carry
  const uint32_t u0 = ptx::sub_cc(0, p2);
  const uint32_t u1 = ptx::subc(p2, 0);
  t0 = ptx::add_cc(t0, u0);
  t1 = ptx::addc_cc(t1, u1);
  const uint32_t c = ptx::addc(0, 0);
  t0 = ptx::add_cc(t0, 0u - c);
  t1 = ptx::addc(t1, 0);
  // t < 2^64: t - q when t + EPS carries
  const uint32_t v0 = ptx::add_cc(t0, 0xFFFFFFFFu);
  const uint32_t v1 = ptx::addc_cc(t1, 0);
  const uint32_t ge = ptx::addc(0, 0);
  return ge ? join(v1, v0) : join(t1, t0);
}

struct Step {
  const uint64_t* tw_a;  // (n, 2^(step_log - split)) or null when 1 column
  const uint64_t* tw_b;  // (n, 2^split), or null: no step twiddle
  int step_log, split;
  long long inner;       // columns per j2
};

// w_N^(k j2) from the two-level tables
__device__ __forceinline__ uint64_t step_power(const Step& s, int k,
                                               long long j2) {
  const long long lo = j2 & ((1 << s.split) - 1);
  uint64_t y = s.tw_b[((long long)k << s.split) + lo];
  if (s.tw_a != nullptr)
    y = gl_mul(y, s.tw_a[((long long)k << (s.step_log - s.split)) +
                         (j2 >> s.split)]);
  return y;
}

__host__ __device__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

// One u64 of a column read, asking L2 to fetch its whole 256-byte block:
// the blocks of the neighbouring columns read the rest of it next.
__device__ __forceinline__ uint64_t load_l2(const uint64_t* p) {
  uint64_t v;
  asm("ld.global.L2::256B.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// an output, stored evict-first: nothing of this launch reads it again
__device__ __forceinline__ void store_cs(uint64_t* p, uint64_t v) {
  __stcs(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
}

// the compile-time shape of a 2^L-point launch of TB threads (header)
template <int L, int TB>
struct Plan {
  static constexpr int N = 1 << L;
  static constexpr int V = L < 4 ? N : 16;          // values a thread holds
  static constexpr int T = N / V;                   // threads a column
  static constexpr int C = TB / T;                  // columns a block
  static constexpr int P = L <= 4 ? 1 : (L + 3) / 4;  // passes
  static constexpr int LAST = L - 4 * (P - 1);      // log2 of the last radix
  static constexpr int G = V >> LAST;               // last-pass groups a thread
  static constexpr int HALF = N > 1 ? N / 2 : 1;    // power-table entries
  static constexpr int ROW = N + (N >> 8);          // swizzled column length
  static constexpr int M = C >= 16 ? 1 : 16 / C;    // column stride mod 16
  static constexpr int CS = P == 1 ? 0 : ROW + (M - ROW % 16 + 16) % 16;
  static constexpr int BT = P == 1 ? 0 : C << LAST; // step-twiddle table
  static constexpr size_t SMEM = ((size_t)HALF + BT + (size_t)C * CS) * 8;
};

// the shared-memory slot of position pos of a column: each 256th padded
__device__ __forceinline__ int phys(int pos) { return pos + (pos >> 8); }

// base-16 digit reversal of the nd low digits of x
template <int ND>
__device__ __forceinline__ int digitrev16(int x) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < ND; ++i)
    r |= ((x >> (4 * i)) & 15) << (4 * (ND - 1 - i));
  return r;
}

// Stage s..LR of the radix-2 DIT network on 2^LR registers (bit-reversed
// order in, natural out): butterflies at distance 2^(s-1), the upper
// input times w^(j n / 2^s) (w the 2^L-th root).
template <int L, int LR, int s>
__device__ __forceinline__ void stages(uint64_t* a, const uint64_t* tw) {
  if constexpr (s <= LR) {
    constexpr int half = 1 << (s - 1);
#pragma unroll
    for (int i0 = 0; i0 < (1 << LR); i0 += 2 * half) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const uint64_t u = a[i0 + j];
        uint64_t t = a[i0 + j + half];
        if (j != 0) t = gl_mul(t, tw[j << (L - s)]);
        a[i0 + j] = gl_add(u, t);
        a[i0 + j + half] = gl_sub(u, t);
      }
    }
    stages<L, LR, s + 1>(a, tw);
  }
}

// In place, natural order in and out: v[k] = sum_d v[d] w^(n d k / 2^LR)
// over 2^LR registers, on a compile-time bit-reversed copy.
template <int LR, int i = 0>
__device__ __forceinline__ void bitrev_copy(uint64_t* a, const uint64_t* v) {
  if constexpr (i < (1 << LR)) {
    constexpr int r = brev(i, LR);
    a[r] = v[i];
    bitrev_copy<LR, i + 1>(a, v);
  }
}

template <int L, int LR>
__device__ __forceinline__ void dft(uint64_t* v, const uint64_t* tw) {
  constexpr int R = 1 << LR;
  uint64_t a[R];
  bitrev_copy<LR>(a, v);
  stages<L, LR, 1>(a, tw);
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = a[i];
}

// Radix-16 pass p < P on the digit of stride S = n / 16^p (header): the
// thread's values are positions lo + S d + 16 S hi of column col, in
// registers on entry for p = 1, else read from shared memory; they leave
// twiddled by w^(16^(p-1) lo k) to the same positions, and the block
// meets at a barrier.
template <int L, int TB, int p>
__device__ __forceinline__ void mid_pass(uint64_t* v, const uint64_t* tw,
                                         uint64_t* xs, int tid) {
  using K = Plan<L, TB>;
  constexpr int S = K::N >> (4 * p);
  constexpr int R = 1 << (4 * (p - 1));
  const int col = tid % K::C, u = tid / K::C;
  const int lo = u % S, hi = u / S;
  uint64_t* const x = xs + col * K::CS;
  const int base = lo + 16 * S * hi;
  if constexpr (p > 1) {
#pragma unroll
    for (int d = 0; d < 16; ++d) v[d] = x[phys(base + S * d)];
  }
  dft<L, 4>(v, tw);
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    const int e = R * lo * k;            // < n
    v[k] = gl_mul(v[k], tw[e & (K::HALF - 1)]);
    if (e & K::HALF) v[k] = gl_neg(v[k]);
  }
#pragma unroll
  for (int d = 0; d < 16; ++d) x[phys(base + S * d)] = v[d];
  __syncthreads();
}

template <int L, int TB>
__global__ void __launch_bounds__(TB, SM_THREADS / TB)
    k_gl_ntt(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
             const uint64_t* __restrict__ pows, Step step, uint64_t scale,
             long long batch, int transpose_out) {
  using K = Plan<L, TB>;
  constexpr int RL = 1 << K::LAST;       // the last pass's radix
  constexpr int RP = K::N >> K::LAST;    // weight of its digit in k
  extern __shared__ uint64_t sh[];
  uint64_t* const tw = sh;               // HALF powers of w
  uint64_t* const bt = sh + K::HALF;     // w_N^(RP d j2), C x RL
  uint64_t* const xs = bt + K::BT;       // C columns of CS
  const long long c0 = (long long)blockIdx.x * K::C;
  const int tid = threadIdx.x;
  uint64_t v[K::V];
  {
    // pass 1's values: column tid % C (adjacent columns in a warp),
    // rows lo + T d
    const int col = tid % K::C, lo = tid / K::C;
    const bool live = c0 + col < batch;
    const uint64_t* src = in + (long long)lo * batch + c0 + col;
    const long long stride = (long long)K::T * batch;
#pragma unroll
    for (int d = 0; d < K::V; ++d) v[d] = live ? load_l2(src + d * stride) : 0;
  }
  for (int i = tid; i < K::HALF; i += TB) tw[i] = pows[i];
  if constexpr (K::P > 1) {
    if (step.tw_b != nullptr) {
      for (int i = tid; i < K::BT; i += TB) {
        const long long col = c0 + (i >> K::LAST);
        if (col < batch)
          bt[i] = step_power(step, (i & (RL - 1)) * RP, col / step.inner);
      }
    }
  }
  __syncthreads();
  if constexpr (K::P >= 2) mid_pass<L, TB, 1>(v, tw, xs, tid);
  if constexpr (K::P >= 3) mid_pass<L, TB, 2>(v, tw, xs, tid);

  // the last pass: G groups of RL values, k_lo = t + T g
  const int col = transpose_out ? tid / K::T : tid % K::C;
  const int t = transpose_out ? tid % K::T : tid / K::C;
  if constexpr (K::P > 1) {
    const uint64_t* const x = xs + col * K::CS;
#pragma unroll
    for (int g = 0; g < K::G; ++g) {
      const int base = digitrev16<K::P - 1>(t + K::T * g) << K::LAST;
#pragma unroll
      for (int d = 0; d < RL; ++d) v[g * RL + d] = x[phys(base + d)];
    }
  }
#pragma unroll
  for (int g = 0; g < K::G; ++g) dft<L, K::LAST>(v + g * RL, tw);
  const long long cg = c0 + col;
  if (cg >= batch) return;
  const long long j2 = cg / step.inner, bb = cg - j2 * step.inner;
#pragma unroll
  for (int g = 0; g < K::G; ++g) {
    const int k_lo = t + K::T * g;
    uint64_t a = 1;
    if (K::P > 1 && step.tw_b != nullptr) a = step_power(step, k_lo, j2);
#pragma unroll
    for (int d = 0; d < RL; ++d) {
      const int k = k_lo + RP * d;
      uint64_t y = v[g * RL + d];
      if (step.tw_b != nullptr) {
        if constexpr (K::P > 1) {
          y = gl_mul(gl_mul(y, a), bt[(col << K::LAST) + d]);
        } else {
          y = gl_mul(y, step_power(step, k, j2));
        }
      }
      if (scale != 0) y = gl_mul(y, scale);
      store_cs(out + (transpose_out ? (j2 * K::N + k) * step.inner + bb
                                    : (long long)k * batch + cg), y);
    }
  }
}

// devices whose attribute settings configure() remembers; a device past
// them gets its attributes set at every launch
constexpr int MAX_DEVICES = 64;

// lets the <L, TB> instance use its shared memory (above the default
// 48 KB) and asks for the largest shared-memory carveout on the current
// device, once a device: a kernel's attributes are the device's, not the
// process's
template <int L, int TB>
int configure() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  if (int rc = (int)cudaGetDevice(&dev)) return rc;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_relaxed))
    return 0;
  int rc = (int)cudaFuncSetAttribute(
      k_gl_ntt<L, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Plan<L, TB>::SMEM);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(
        k_gl_ntt<L, TB>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (rc == 0 && dev < MAX_DEVICES)
    done[dev].store(true, std::memory_order_relaxed);
  return rc;
}

template <int L, int TB>
int launch_tb(const uint64_t* in, uint64_t* out, const uint64_t* pows,
              const Step& step, uint64_t scale, long long batch,
              int transpose_out, cudaStream_t stream) {
  using K = Plan<L, TB>;
  if (int rc = configure<L, TB>()) return rc;
  const long long blocks = (batch + K::C - 1) / K::C;
  k_gl_ntt<L, TB><<<(unsigned)blocks, TB, K::SMEM, stream>>>(
      in, out, pows, step, scale, batch, transpose_out);
  return (int)cudaGetLastError();
}

// The wide block where 512 threads would hold fewer than 4 columns (2^12)
// and the store is strided (no transposed store).
template <int L>
int launch(const uint64_t* in, uint64_t* out, const uint64_t* pows,
           const Step& step, uint64_t scale, long long batch,
           int transpose_out, cudaStream_t stream) {
  if constexpr (Plan<L, THREADS>::C < 4) {
    if (!transpose_out)
      return launch_tb<L, WIDE_THREADS>(in, out, pows, step, scale, batch,
                                        transpose_out, stream);
  }
  return launch_tb<L, THREADS>(in, out, pows, step, scale, batch,
                               transpose_out, stream);
}

// f(std::integral_constant<int, L>()) for the runtime log_n (0..MAX_LOG)
template <int L = 0, class F>
int with_log(int log_n, F f) {
  if constexpr (L > MAX_LOG) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (log_n == L) return f(std::integral_constant<int, L>());
    return with_log<L + 1>(log_n, f);
  }
}

}  // namespace

extern "C" {

// out = the NTT of each of the `batch` columns of `in` ((2^log_n, batch)
// canonical u64 values, row-major; distinct buffers), with the domain's
// power table `pows` (2^(log_n - 1) values, one for log_n = 0).  If tw_b
// is not null, element (k, column) is then multiplied by w_N^(k j2) =
// tw_b[k, j2 mod 2^split] * tw_a[k, j2 >> split] (tw_a null: 1 column),
// where j2 = column / inner < 2^step_log.  A nonzero `scale` multiplies
// every output.  out is (2^log_n, batch) or, if transpose_out, (batch /
// inner, 2^log_n * inner) with element (k, column) at [j2, k * inner +
// column % inner].  0 <= log_n <= 12.  One launch on `stream`.
int gl_ntt(const void* in, void* out, const void* pows, const void* tw_a,
           const void* tw_b, int step_log, int split, long long inner,
           unsigned long long scale, long long batch, int log_n,
           int transpose_out, void* stream) {
  if (batch <= 0) return 0;
  if (log_n < 0 || log_n > MAX_LOG || inner <= 0 || split < 0 ||
      split > step_log || (transpose_out && batch % inner != 0))
    return (int)cudaErrorInvalidValue;
  const Step step{(const uint64_t*)tw_a, (const uint64_t*)tw_b, step_log,
                  split, inner};
  return with_log(log_n, [&](auto l) {
    return launch<decltype(l)::value>(
        (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)pows, step,
        (uint64_t)scale, batch, transpose_out, (cudaStream_t)stream);
  });
}

const char* ntt_gl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
