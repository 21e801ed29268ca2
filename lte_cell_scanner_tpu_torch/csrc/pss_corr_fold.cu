// Fused PSS correlation + k_factor fold kernels for Hopper (sm_90a), on the
// tensor cores (warp-level mma.sync).
//
// Replaces the TPU package's Pallas kernels _corr_kernel_v4 (bf16) and
// _corr_kernel_v4_int8 (lte_cell_scanner_tpu/ops/corr_pallas.py:774-808,
// driven by corr_fold_core_v4 :811-904), the batched band scan's front
// end: for carrier c, template t = p * n_f + f (PSS p, hypothesis f) and
// fold-output lag l in [0, 9600),
//
//     out[c, t, l] = sum_m |sum_k tap[t, k] * x[c, s[f, m] + l + k]|^2,
//
// m = 0 .. n_comb-1, k = 0 .. 136, where s is ONE [n_f, n_comb] fold-start
// table shared by every carrier of the launch (the band's middle carrier,
// as on the TPU) and x reads as zero outside [0, n_cap).  The output is
// the RAW f32 fold sum; the caller multiplies by f32(1 / n_comb) (times the
// int8 power scale).
//
// Quantization contract (what the TPU kernels compute, not their blocking):
//   bf16 kernel: capture planes and template planes rounded to bf16,
//     products summed in f32 per period.
//   int8 kernel: capture codes clip(round_half_even(128 x), -127, 127),
//     taps round(t * s_g) with s_g = 127 / max(|Re|, |Im|) over the
//     templates; period sums in int32 (|sum| < 2^23, so the conversion to
//     f32 is exact), cast to f32 BEFORE squaring.
//   Both: each period's power is fma(re, re, im * im) -- re^2 + im^2 with
//   one rounding for the sum, as the TPU package's kernel computes it in
//   the Pallas interpreter (a contracted re*re + im*im) -- and is added to
//   the f32 fold accumulator in period order, all with explicit
//   round-to-nearest intrinsics.  The int8 products and sums are exact in
//   the tensor cores, so the int8 kernel is bit-equal to its plain PyTorch
//   version and to the interpreted TPU kernel.
//
// What bounds it on this card: at C = 64 carriers, T = 93 templates and
// n_comb = 15 the useful work is 4 * 64 * 93 * 9600 * 15 * 137 = 4.7e11
// real multiply-adds (9.4e11 operations) against 0.23 GB of f32 output:
// operation-bound, 0.95 ms at the bf16 tensor-core peak (0.47 ms int8).
// So the products must run on the tensor cores, and shared-memory loads
// must not set the pace.  This design issues warp-level mma.sync (below
// the wgmma rate of the data sheet) and 29% of its tensor-core work is
// padding, so it cannot reach that bound; PERF.md has the measured times.
//
// Design: the correlation of one hypothesis is a real matrix product whose
// M axis is the lag, whose K axis interleaves the real and imaginary parts
// of each tap, and whose N axis holds the three PSS of that hypothesis:
//
//   A[r, 2k] = Re x[s + l0 + r + k],  A[r, 2k + 1] = Im x[s + l0 + r + k],
//   B[2k, 2p] = tr[p, k],  B[2k + 1, 2p] = -ti[p, k],
//   B[2k, 2p + 1] = ti[p, k],  B[2k + 1, 2p + 1] = tr[p, k],
//
// so column 2p of A B is Re and column 2p + 1 is Im of PSS p.  Taps 137-143
// and columns 6-7 are zero: K = 288 (18 bf16 k-steps of 8 taps, 9 int8
// k-steps of 16 taps), N = 8.  Padding leaves 6/8 * 137/144 = 71% of the
// tensor-core work useful.  In the m16n8 accumulator lane (g = lane / 4,
// q = lane % 4) holds (Re, Im) of PSS q at lags g and g + 8, so the power
// and the fold stay in that lane's registers; lanes with q = 3 hold the
// zero columns and write nothing.
//
// A is a Hankel matrix: A(lag tile i, k-step j) depends only on 16 i + 8 j
// (bf16) or 16 i + 16 j (int8), and no im2col matrix exists.  Each
// period's capture span (the block's 256 lags + 143 taps + the start
// spread of its 4 hypotheses) is staged in shared memory as one 32-bit
// word per sample: (Re, Im) in bf16, or for int8 the pair of consecutive
// samples (Re, Im, Re', Im') that an m16n8k32 A register holds, so every A
// register is one aligned shared load.  The wrapper builds these words
// (`capture_words` in ops/corr_fold_cuda.py) with 4 zero words before
// sample 0 and zeros past the capture.  Each warp owns one hypothesis and
// 16 lag tiles (256 lags) whose accumulators stay in registers, walks the
// distinct fragment offsets once, and issues every mma that uses each:
// about 0.35 shared loads per mma instead of 4.  The hypothesis's B
// fragments (36 registers bf16, 18 int8) are loaded once per block and the
// f32 fold accumulators stay in registers across the periods; the output
// is written once.  Period m + 1's span is copied with cp.async into a
// second buffer while period m computes.  One block = 4 warps = (carrier,
// 4 hypotheses x 3 PSS, 256 fold-output lags); the ragged last lag tile,
// hypotheses past n_f and samples outside the capture are masked.  The TPU
// kernel's band matrices (the fold offsets baked into kv = 256/384
// weight windows, 1.87-2.8x the operations and ~118 MB per band) are not
// carried over: the kernel reads the start table directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTapsPad = 144;      // 137 taps + 7 zero taps
constexpr int kK = 2 * kTapsPad;  // K: Re and Im of each tap
constexpr int kHalfFrame = 9600;
constexpr int kWarps = 4;          // hypotheses per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 16;         // 16-lag m-tiles per warp
constexpr int kTileLags = 16 * kTiles;   // 256 fold-output lags per block
constexpr int kGuard = 4;          // staged words before sample 0

// bf16: m16n8k16, one word = (Re, Im) of one sample.  A(i, j) reads words
// 8u + g + q + {0, 8, 4, 12} for u = 2i + j: with V[v] = W[4v + g + q],
// a = {V[2u], V[2u + 2], V[2u + 1], V[2u + 3]}.
struct Bf16 {
  using Acc = float;
  static constexpr int kSteps = 18;
  static constexpr int kTileU = 2;
  static constexpr int kVStride = 4;
  static constexpr int kLaneQ = 1;
  static constexpr int kRowWords = kK * 2 / 4;    // bf16 B column in words

  static __device__ __forceinline__ void pick(uint32_t (&a)[4], uint32_t v0,
                                              uint32_t v1, uint32_t v2,
                                              uint32_t v3) {
    a[0] = v0;
    a[1] = v2;
    a[2] = v1;
    a[3] = v3;
  }

  static __device__ __forceinline__ void mma(Acc (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  static __device__ __forceinline__ float to_f32(float x) { return x; }
};

// int8: m16n8k32, one word = (Re, Im) of samples n and n + 1.  A(i, j)
// reads words 16u + g + 2q + {0, 8, 8, 16} for u = i + j: with V[v] =
// W[8v + g + 2q], a = {V[2u], V[2u + 1], V[2u + 1], V[2u + 2]}.
struct Int8 {
  using Acc = int;
  static constexpr int kSteps = 9;
  static constexpr int kTileU = 1;
  static constexpr int kVStride = 8;
  static constexpr int kLaneQ = 2;
  static constexpr int kRowWords = kK / 4;        // int8 B column in words

  static __device__ __forceinline__ void pick(uint32_t (&a)[4], uint32_t v0,
                                              uint32_t v1, uint32_t v2,
                                              uint32_t) {
    a[0] = v0;
    a[1] = v1;
    a[2] = v1;
    a[3] = v2;
  }

  static __device__ __forceinline__ void mma(Acc (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  static __device__ __forceinline__ float to_f32(int x) {
    return __int2float_rn(x);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The smallest start of the block's hypotheses in period m.
__device__ __forceinline__ int block_lo(const int* __restrict__ starts,
                                        int f0, int n_hyp, int n_comb,
                                        int m) {
  int lo = starts[f0 * n_comb + m];
  for (int h = 1; h < n_hyp; ++h) lo = min(lo, starts[(f0 + h) * n_comb + m]);
  return lo;
}

// Copies span_cap words from the aligned word index ga (a multiple of 4)
// in 16-byte chunks; chunks outside [0, n_words) are filled with zeros.
__device__ __forceinline__ void stage(uint32_t* dst,
                                      const uint32_t* __restrict__ src,
                                      int ga, int n_words, int span_cap) {
  for (int i = threadIdx.x; i < span_cap / 4; i += kThreads) {
    const int gi = ga + 4 * i;
    const bool ok = gi >= 0 && gi + 4 <= n_words;
    cp_async16(dst + 4 * i, ok ? src + gi : src, ok ? 16 : 0);
  }
}

// One period of one warp: the 16 lag tiles' Re/Im of its hypothesis's
// three PSS.  w points at the warp's first lag plus the lane's offset.
template <class Tr>
__device__ __forceinline__ void correlate(
    const uint32_t* w, const uint32_t (&b)[Tr::kSteps][2],
    typename Tr::Acc (&acc)[kTiles][4]) {
  constexpr int kU = Tr::kTileU * (kTiles - 1) + Tr::kSteps;
  uint32_t v0 = w[0];
  uint32_t v1 = w[Tr::kVStride];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const uint32_t v2 = w[(2 * u + 2) * Tr::kVStride];
    uint32_t v3 = 0;
    if constexpr (Tr::kTileU == 2) v3 = w[(2 * u + 3) * Tr::kVStride];
    uint32_t a[4];
    Tr::pick(a, v0, v1, v2, v3);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int j = u - Tr::kTileU * i;
      if (j >= 0 && j < Tr::kSteps) Tr::mma(acc[i], a, b[j][0], b[j][1]);
    }
    v0 = v2;
    if constexpr (Tr::kTileU == 2) {
      v1 = v3;
    } else if (u + 1 < kU) {
      v1 = w[(2 * u + 3) * Tr::kVStride];
    }
  }
}

// words: [C, n_words] staged capture words (wrapper's capture_words);
// taps: [n_f, 8, 288] packed B columns (pack_fold_taps) as 32-bit words;
// starts: [n_f, n_comb]; out: [C, 3 * n_f, 9600].  Dynamic shared memory:
// two spans of span_cap words, span_cap a multiple of 4 and >= 402 + the
// largest start spread of any 4 consecutive hypotheses in any period.
template <class Tr>
__global__ void __launch_bounds__(kThreads)
pss_corr_fold_kernel(const uint32_t* __restrict__ words,
                     const uint32_t* __restrict__ taps,
                     const int* __restrict__ starts, float* __restrict__ out,
                     int n_words, int n_f, int n_comb, int span_cap) {
  using Acc = typename Tr::Acc;
  extern __shared__ __align__(16) uint32_t smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int l0 = blockIdx.x * kTileLags;
  const int f0 = blockIdx.y * kWarps;
  const int c = blockIdx.z;
  const int n_hyp = min(kWarps, n_f - f0);
  const int f = f0 + warp;
  const bool active = warp < n_hyp;   // warp-uniform
  const uint32_t* src = words + static_cast<size_t>(c) * n_words;

  // the hypothesis's B fragments, resident for all periods
  uint32_t b[Tr::kSteps][2];
  {
    const uint32_t* col = taps + (static_cast<size_t>(active ? f : f0) * 8
                                  + g) * Tr::kRowWords;
#pragma unroll
    for (int j = 0; j < Tr::kSteps; ++j) {
      b[j][0] = col[8 * j + q];
      b[j][1] = col[8 * j + 4 + q];
    }
  }

  float fold[kTiles][2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    fold[i][0] = 0.0f;
    fold[i][1] = 0.0f;
  }

  // word index of the staged span's first chunk (aligned down to 16 bytes)
  int ga = (block_lo(starts, f0, n_hyp, n_comb, 0) + l0 + kGuard) & ~3;
  stage(smem, src, ga, n_words, span_cap);
  cp_async_commit();

  for (int m = 0; m < n_comb; ++m) {
    int ga_next = 0;
    if (m + 1 < n_comb) {
      ga_next = (block_lo(starts, f0, n_hyp, n_comb, m + 1) + l0 + kGuard)
                & ~3;
      stage(smem + ((m + 1) & 1) * span_cap, src, ga_next, n_words,
            span_cap);
    }
    cp_async_commit();
    cp_async_wait_prev();       // period m's span has landed (this thread)
    __syncthreads();            // ... and every thread's

    if (active) {
      const int off = starts[f * n_comb + m] + l0 + kGuard - ga;
      const uint32_t* w = smem + (m & 1) * span_cap + off + g
                          + Tr::kLaneQ * q;
      Acc acc[kTiles][4];
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = Acc(0);
      }
      correlate<Tr>(w, b, acc);
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = Tr::to_f32(acc[i][2 * h]);
          const float im = Tr::to_f32(acc[i][2 * h + 1]);
          fold[i][h] = __fadd_rn(fold[i][h],
                                 __fmaf_rn(re, re, __fmul_rn(im, im)));
        }
      }
    }
    __syncthreads();            // reads of this buffer end before its refill
    ga = ga_next;
  }

  if (!active || q == 3) return;
  const int n_t = 3 * n_f;
  float* o = out + (static_cast<size_t>(c) * n_t + q * n_f + f) * kHalfFrame
             + l0 + g;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    if (l0 + 16 * i < kHalfFrame) {    // 9600 is a whole number of tiles
      o[16 * i] = fold[i][0];
      o[16 * i + 8] = fold[i][1];
    }
  }
}

template <class Tr>
int launch(const void* words, const void* taps, const void* starts,
           void* out, int n_c, int n_words, int n_f, int n_comb,
           int span_cap, void* stream) {
  const dim3 grid((kHalfFrame + kTileLags - 1) / kTileLags,
                  (n_f + kWarps - 1) / kWarps, n_c);
  const size_t smem = 2 * static_cast<size_t>(span_cap) * sizeof(uint32_t);
  pss_corr_fold_kernel<Tr><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(taps),
      static_cast<const int*>(starts), static_cast<float*>(out), n_words,
      n_f, n_comb, span_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pss_corr_fold_bf16(const void* words, const void* taps,
                                  const void* starts, void* out, int n_c,
                                  int n_words, int n_f, int n_comb,
                                  int span_cap, void* stream) {
  return launch<Bf16>(words, taps, starts, out, n_c, n_words, n_f, n_comb,
                      span_cap, stream);
}

extern "C" int pss_corr_fold_int8(const void* words, const void* taps,
                                  const void* starts, void* out, int n_c,
                                  int n_words, int n_f, int n_comb,
                                  int span_cap, void* stream) {
  return launch<Int8>(words, taps, starts, out, n_c, n_words, n_f, n_comb,
                      span_cap, stream);
}
