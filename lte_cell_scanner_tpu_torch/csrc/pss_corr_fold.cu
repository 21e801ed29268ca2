// Fused PSS correlation + k_factor fold kernels for Hopper (sm_90a).
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
//   round-to-nearest intrinsics, so the int8 kernel is bit-equal to its
//   plain PyTorch version and to the interpreted TPU kernel.
//
// What bounds it on this card: at C = 64 carriers, T = 93 templates and
// n_comb = 15 the useful work is 4 * 64 * 93 * 9600 * 15 * 137 = 4.7e11
// real multiply-adds (9.4e11 operations) against 0.23 GB of f32 output:
// operation-bound, 0.95 ms at the bf16 tensor-core peak (0.47 ms int8).
// This first design runs on the CUDA cores, where each tap costs a thread
// 8 shared capture loads and 6 broadcast tap loads for 48 multiply-adds,
// so shared-memory issue bounds it (14 ms at the 67 TF f32 FMA peak, in
// practice about twice that; PERF.md has the measured times).
//
// Design: the TPU kernel's per-period band matrices (W = 80 lags x K = 256
// or 384 samples per row, ~118 MB of int8 per band) exist only to feed a
// 128-lane matrix unit and to bake the fold offsets into the weights.
// Here one block owns (carrier, 4 hypotheses x 3 PSS = 12 templates, 256
// fold-output lags).  Its taps stay in shared memory for all periods; for
// each period the capture span of the tile, widened by the 4 hypotheses'
// start spread, is staged in shared memory, and each thread computes a
// 3-template x 4-lag register tile of Re/Im for its hypothesis (the three
// PSS of one hypothesis share its fold start, so each capture load feeds
// three templates), squares it and adds it to f32 fold accumulators kept
// in registers across the periods.  One write of [C, T, 9600] at the end:
// neither the ~28 MB-per-carrier lag map of the v2 route nor its fold
// gathers exist.  Reading the start table directly covers any delta
// window (the TPU's K = 256 and K = 384 variants alike).  The ragged last
// lag tile, the hypotheses past n_f, and samples outside the capture are
// masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 137;
constexpr int kHalfFrame = 9600;
constexpr int kPss = 3;
constexpr int kThreadsX = 64;                  // threads along lags
constexpr int kThreadsY = 4;                   // threads along hypotheses
constexpr int kLagsPerThread = 4;
constexpr int kTileLags = kThreadsX * kLagsPerThread;        // 256
constexpr int kThreads = kThreadsX * kThreadsY;

__device__ __forceinline__ float load_elem(const __nv_bfloat16* p,
                                           size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ int load_elem(const int8_t* p, size_t i) {
  return static_cast<int>(p[i]);
}

__device__ __forceinline__ float mac(float acc, float a, float b) {
  return fmaf(a, b, acc);
}

__device__ __forceinline__ int mac(int acc, int a, int b) {
  return acc + a * b;
}

__device__ __forceinline__ float as_float(float x) { return x; }

__device__ __forceinline__ float as_float(int x) { return __int2float_rn(x); }

// cap: [C, 2, n_cap] planes (re, im); taps: [2, 3 * n_f, 137];
// starts: [n_f, n_comb]; out: [C, 3 * n_f, 9600].  Dynamic shared memory:
// two capture planes of span_cap elements each, span_cap >= 392 + the
// largest start spread of any 4 consecutive hypotheses in any period.
template <typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
pss_corr_fold_kernel(const In* __restrict__ cap, const In* __restrict__ taps,
                     const int* __restrict__ starts,
                     float* __restrict__ out, int n_cap, int n_f, int n_comb,
                     int span_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* s_re = reinterpret_cast<Acc*>(smem);
  Acc* s_im = s_re + span_cap;
  __shared__ Acc t_re[kPss][kThreadsY][kTaps];
  __shared__ Acc t_im[kPss][kThreadsY][kTaps];
  __shared__ int s_start[kThreadsY];

  const int l0 = blockIdx.x * kTileLags;
  const int f0 = blockIdx.y * kThreadsY;
  const int c = blockIdx.z;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int n_t = kPss * n_f;
  const int n_hyp = min(kThreadsY, n_f - f0);
  const In* cap_re = cap + static_cast<size_t>(c) * 2 * n_cap;
  const In* cap_im = cap_re + n_cap;

  for (int i = tid; i < kPss * kThreadsY * kTaps; i += kThreads) {
    const int p = i / (kThreadsY * kTaps);
    const int r = i - p * (kThreadsY * kTaps);
    const int fl = r / kTaps;
    const int k = r - fl * kTaps;
    const bool ok = fl < n_hyp;
    const size_t off = static_cast<size_t>(p * n_f + f0 + fl) * kTaps + k;
    t_re[p][fl][k] = ok ? load_elem(taps, off) : Acc(0);
    t_im[p][fl][k] = ok ? load_elem(taps, static_cast<size_t>(n_t) * kTaps
                                              + off)
                        : Acc(0);
  }

  const int lx = threadIdx.x;
  const int fy = threadIdx.y;
  float fold[kPss][kLagsPerThread];
#pragma unroll
  for (int p = 0; p < kPss; ++p) {
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) fold[p][j] = 0.0f;
  }

  for (int m = 0; m < n_comb; ++m) {
    __syncthreads();            // the previous period's span reads are done
    if (tid < n_hyp) s_start[tid] = starts[(f0 + tid) * n_comb + m];
    __syncthreads();
    int lo = s_start[0];
    for (int i = 1; i < n_hyp; ++i) lo = min(lo, s_start[i]);
    const int base = lo + l0;
    for (int i = tid; i < span_cap; i += kThreads) {
      const int g = base + i;
      const bool ok = g >= 0 && g < n_cap;
      s_re[i] = ok ? load_elem(cap_re, g) : Acc(0);
      s_im[i] = ok ? load_elem(cap_im, g) : Acc(0);
    }
    __syncthreads();

    // padded hypotheses (fy >= n_hyp) compute on zero taps and never write
    const int off = (fy < n_hyp ? s_start[fy] - lo : 0) + lx;
    Acc acc_re[kPss][kLagsPerThread];
    Acc acc_im[kPss][kLagsPerThread];
#pragma unroll
    for (int p = 0; p < kPss; ++p) {
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) {
        acc_re[p][j] = Acc(0);
        acc_im[p][j] = Acc(0);
      }
    }
#pragma unroll 4
    for (int k = 0; k < kTaps; ++k) {
      Acc xr[kLagsPerThread];
      Acc xi[kLagsPerThread];
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) {
        xr[j] = s_re[off + j * kThreadsX + k];
        xi[j] = s_im[off + j * kThreadsX + k];
      }
#pragma unroll
      for (int p = 0; p < kPss; ++p) {
        const Acc tr = t_re[p][fy][k];
        const Acc ti = t_im[p][fy][k];
#pragma unroll
        for (int j = 0; j < kLagsPerThread; ++j) {
          // re += xr*tr - xi*ti ; im += xr*ti + xi*tr
          acc_re[p][j] = mac(acc_re[p][j], xr[j], tr);
          acc_re[p][j] = mac(acc_re[p][j], -xi[j], ti);
          acc_im[p][j] = mac(acc_im[p][j], xr[j], ti);
          acc_im[p][j] = mac(acc_im[p][j], xi[j], tr);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPss; ++p) {
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) {
        const float fr = as_float(acc_re[p][j]);
        const float fi = as_float(acc_im[p][j]);
        fold[p][j] = __fadd_rn(fold[p][j],
                               __fmaf_rn(fr, fr, __fmul_rn(fi, fi)));
      }
    }
  }

  if (fy >= n_hyp) return;
#pragma unroll
  for (int p = 0; p < kPss; ++p) {
    const size_t row = static_cast<size_t>(c) * n_t + p * n_f + f0 + fy;
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      const int l = l0 + lx + j * kThreadsX;
      if (l < kHalfFrame) out[row * kHalfFrame + l] = fold[p][j];
    }
  }
}

template <typename In, typename Acc>
int launch(const void* cap, const void* taps, const void* starts, void* out,
           int n_c, int n_cap, int n_f, int n_comb, int span_cap,
           void* stream) {
  const dim3 grid((kHalfFrame + kTileLags - 1) / kTileLags,
                  (n_f + kThreadsY - 1) / kThreadsY, n_c);
  const dim3 block(kThreadsX, kThreadsY);
  const size_t smem = 2 * static_cast<size_t>(span_cap) * sizeof(Acc);
  pss_corr_fold_kernel<In, Acc><<<grid, block, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(cap), static_cast<const In*>(taps),
      static_cast<const int*>(starts), static_cast<float*>(out), n_cap, n_f,
      n_comb, span_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pss_corr_fold_bf16(const void* cap, const void* taps,
                                  const void* starts, void* out, int n_c,
                                  int n_cap, int n_f, int n_comb,
                                  int span_cap, void* stream) {
  return launch<__nv_bfloat16, float>(cap, taps, starts, out, n_c, n_cap,
                                      n_f, n_comb, span_cap, stream);
}

extern "C" int pss_corr_fold_int8(const void* cap, const void* taps,
                                  const void* starts, void* out, int n_c,
                                  int n_cap, int n_f, int n_comb,
                                  int span_cap, void* stream) {
  return launch<int8_t, int>(cap, taps, starts, out, n_c, n_cap, n_f, n_comb,
                             span_cap, stream);
}
