// PSS correlation-power kernels for Hopper (sm_90a).
//
// Replaces the TPU package's Pallas kernels _corr_kernel_v2 (bf16) and
// _corr_kernel_v2_int8 (lte_cell_scanner_tpu/ops/corr_pallas.py:407-426,
// driven by corr_pow_core_v2 with post="xla"): for every template t and
// lag l,
//
//     p[t, l] = |sum_m tmpl[t, m] * cap[l + m]|^2,   m = 0 .. 136,
//
// written as bf16 in the [T, n_lags] layout the fold reads.
//
// Quantization contract (what the TPU kernels compute, not their blocking):
//   bf16 kernel: capture planes and template planes rounded to bf16 (RNE),
//     products accumulated in f32, p = re^2 + im^2 stored as bf16 (RNE).
//   int8 kernel: capture k = clip(round_half_even(128 x), -127, 127),
//     templates round(t * s_g) with s_g = 127 / max(|Re|, |Im|) over all
//     templates; int32 accumulation (|sum| <= 137*127*127*2 < 2^24, so the
//     conversion to f32 is exact), squares and sum in f32 with explicit
//     round-to-nearest intrinsics (no FMA contraction, so the plain PyTorch
//     version agrees bit for bit), stored UNSCALED as bf16; the caller
//     multiplies the folded map by (1 / (s_g * 128))^2.
//
// What bounds it on this card: at T = 93, n_lags = 153464 the useful work
// is 93 * 153464 * 137 * 4 = 7.8 G real multiply-adds (15.6 GFLOP) against
// 28.5 MB of bf16 output.  On the tensor cores (989 TF bf16, 1979 TOPS
// int8) the bound is ~16 us (bf16, operations) and ~8.5 us (int8, output
// bytes at 3.35 TB/s).  This first design runs on the CUDA cores (67 TF
// f32), so it is operation-bound near 15.6 GFLOP / 67 TF = 0.23 ms.
//
// Design: the TPU kernel's im2col band matrix (W = 120 lags x K = 256
// samples per row, 23 MB of mostly-zero bands) only exists to feed a
// 128-lane matrix unit; here each block stages the capture span of its
// 256-lag tile plus its 16 templates' 137 taps in shared memory and every
// thread keeps a 4-lag x 4-template register tile, so each tap step does
// 8 shared loads for 64 multiply-adds.  Warps share one template row
// (broadcast loads) and walk consecutive lags (conflict-free loads).  The
// |.|^2 epilogue writes [T, n_lags] directly, so no transpose follows.
// The ragged last lag tile and the padded template rows are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 137;
constexpr int kThreadsX = 64;                  // threads along lags
constexpr int kThreadsY = 4;                   // threads along templates
constexpr int kLagsPerThread = 4;
constexpr int kTmplPerThread = 4;
constexpr int kTileLags = kThreadsX * kLagsPerThread;        // 256
constexpr int kTileTmpl = kThreadsY * kTmplPerThread;        // 16
constexpr int kSpan = kTileLags + kTaps - 1;                 // 392
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

// cap: [2, n_cap] planes (re, im); taps: [2, n_t, 137]; out: [n_t, n_lags]
template <typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
pss_corr_kernel(const In* __restrict__ cap, const In* __restrict__ taps,
                __nv_bfloat16* __restrict__ out, int n_cap, int n_t,
                int n_lags) {
  __shared__ Acc s_re[kSpan];
  __shared__ Acc s_im[kSpan];
  __shared__ Acc t_re[kTileTmpl][kTaps];
  __shared__ Acc t_im[kTileTmpl][kTaps];

  const int l0 = blockIdx.x * kTileLags;
  const int tb = blockIdx.y * kTileTmpl;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  for (int i = tid; i < kSpan; i += kThreads) {
    const int g = l0 + i;
    const bool ok = g < n_cap;
    s_re[i] = ok ? load_elem(cap, g) : Acc(0);
    s_im[i] = ok ? load_elem(cap, static_cast<size_t>(n_cap) + g) : Acc(0);
  }
  for (int i = tid; i < kTileTmpl * kTaps; i += kThreads) {
    const int t = i / kTaps;
    const int m = i - t * kTaps;
    const bool ok = tb + t < n_t;
    const size_t off = static_cast<size_t>(tb + t) * kTaps + m;
    t_re[t][m] = ok ? load_elem(taps, off) : Acc(0);
    t_im[t][m] = ok ? load_elem(taps, static_cast<size_t>(n_t) * kTaps + off)
                    : Acc(0);
  }
  __syncthreads();

  Acc acc_re[kTmplPerThread][kLagsPerThread];
  Acc acc_im[kTmplPerThread][kLagsPerThread];
#pragma unroll
  for (int i = 0; i < kTmplPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      acc_re[i][j] = Acc(0);
      acc_im[i][j] = Acc(0);
    }
  }

  const int lx = threadIdx.x;
  const int ty = threadIdx.y * kTmplPerThread;
#pragma unroll 4
  for (int m = 0; m < kTaps; ++m) {
    Acc xr[kLagsPerThread];
    Acc xi[kLagsPerThread];
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      xr[j] = s_re[lx + j * kThreadsX + m];
      xi[j] = s_im[lx + j * kThreadsX + m];
    }
#pragma unroll
    for (int i = 0; i < kTmplPerThread; ++i) {
      const Acc tr = t_re[ty + i][m];
      const Acc ti = t_im[ty + i][m];
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) {
        // re += xr*tr - xi*ti ; im += xr*ti + xi*tr
        acc_re[i][j] = mac(acc_re[i][j], xr[j], tr);
        acc_re[i][j] = mac(acc_re[i][j], -xi[j], ti);
        acc_im[i][j] = mac(acc_im[i][j], xr[j], ti);
        acc_im[i][j] = mac(acc_im[i][j], xi[j], tr);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTmplPerThread; ++i) {
    const int t = tb + ty + i;
    if (t >= n_t) continue;
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      const int l = l0 + lx + j * kThreadsX;
      if (l >= n_lags) continue;
      const float fr = as_float(acc_re[i][j]);
      const float fi = as_float(acc_im[i][j]);
      const float p = __fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi));
      out[static_cast<size_t>(t) * n_lags + l] = __float2bfloat16_rn(p);
    }
  }
}

template <typename In, typename Acc>
int launch(const void* cap, const void* taps, void* out, int n_cap, int n_t,
           int n_lags, void* stream) {
  const dim3 grid((n_lags + kTileLags - 1) / kTileLags,
                  (n_t + kTileTmpl - 1) / kTileTmpl);
  const dim3 block(kThreadsX, kThreadsY);
  pss_corr_kernel<In, Acc><<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(cap), static_cast<const In*>(taps),
      static_cast<__nv_bfloat16*>(out), n_cap, n_t, n_lags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pss_corr_bf16(const void* cap, const void* taps, void* out,
                             int n_cap, int n_t, int n_lags, void* stream) {
  return launch<__nv_bfloat16, float>(cap, taps, out, n_cap, n_t, n_lags,
                                      stream);
}

extern "C" int pss_corr_int8(const void* cap, const void* taps, void* out,
                             int n_cap, int n_t, int n_lags, void* stream) {
  return launch<int8_t, int>(cap, taps, out, n_cap, n_t, n_lags, stream);
}
