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
// Design: the correlation of one hypothesis is the Hankel product of
// hankel_mma.cuh, whose N axis holds the three PSS of that hypothesis
// (B packed by `pack_fold_taps` in ops/corr_fold_cuda.py).  Columns 6-7
// are zero, so padding leaves 6/8 * 137/144 = 71% of the tensor-core work
// useful; lanes with q = 3 hold the zero columns and write nothing, and
// the power and the fold stay in each lane's registers.  Each period's
// capture span (the block's 256 lags + 143 taps + the start spread of its
// 4 hypotheses) is staged in shared memory as the words of
// `capture_words` (ops/corr_cuda.py).  Each warp owns one hypothesis and
// 16 lag tiles (256 lags).  The hypothesis's B fragments (36 registers
// bf16, 18 int8) are loaded once per block and the f32 fold accumulators
// stay in registers across the periods; the output is written once.
// Period m + 1's span is copied with cp.async into a second buffer while
// period m computes.  One block = 4 warps = (carrier, 4 hypotheses x 3
// PSS, 256 fold-output lags); the ragged last lag tile, hypotheses past
// n_f and samples outside the capture are masked.  The TPU kernel's band
// matrices (the fold offsets baked into kv = 256/384 weight windows,
// 1.87-2.8x the operations and ~118 MB per band) are not carried over:
// the kernel reads the start table directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hankel_mma.cuh"

namespace {

using namespace hankel;

constexpr int kHalfFrame = 9600;
constexpr int kWarps = 4;          // hypotheses per block, one per warp
constexpr int kThreads = 32 * kWarps;

// The smallest start of the block's hypotheses in period m.
__device__ __forceinline__ int block_lo(const int* __restrict__ starts,
                                        int f0, int n_hyp, int n_comb,
                                        int m) {
  int lo = starts[f0 * n_comb + m];
  for (int h = 1; h < n_hyp; ++h) lo = min(lo, starts[(f0 + h) * n_comb + m]);
  return lo;
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
  load_b<Tr>(taps, active ? f : f0, g, q, b);

  float fold[kTiles][2];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    fold[i][0] = 0.0f;
    fold[i][1] = 0.0f;
  }

  // word index of the staged span's first chunk (aligned down to 16 bytes)
  int ga = (block_lo(starts, f0, n_hyp, n_comb, 0) + l0 + kGuard) & ~3;
  stage<kThreads>(smem, src, ga, n_words, span_cap);
  cp_async_commit();

  for (int m = 0; m < n_comb; ++m) {
    int ga_next = 0;
    if (m + 1 < n_comb) {
      ga_next = (block_lo(starts, f0, n_hyp, n_comb, m + 1) + l0 + kGuard)
                & ~3;
      stage<kThreads>(smem + ((m + 1) & 1) * span_cap, src, ga_next,
                      n_words, span_cap);
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
