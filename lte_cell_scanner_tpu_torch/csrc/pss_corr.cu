// PSS correlation-power kernels for Hopper (sm_90a).
//
// Replaces the TPU package's correlation Pallas kernels that produce the
// [template, lag] power map (lte_cell_scanner_tpu/ops/corr_pallas.py and
// the probes of tools/bench_corr_v2.py): for every template t and lag l,
//
//     p[t, l] = |sum_m tmpl[t, m] * cap[l + m]|^2,   m = 0 .. 136.
//
// Entry points (what each TPU kernel computes, not its blocking):
//   pss_corr_bf16          _corr_kernel_v2 (:407) and _corr_kernel_v3
//                          (:429) with bf16 output: bf16 planes, f32
//                          accumulation, p stored as bf16 (RNE).
//   pss_corr_int8          _corr_kernel_v2_int8 (:416): int8 planes,
//                          int32 accumulation, p stored UNSCALED as bf16.
//   pss_corr_f32           _corr_kernel (v1, :67) with f32 bands, and v2
//                          with f32 bands: f32 planes, f32 FMA, f32 out.
//   pss_corr_bf16_f32out   v1 with bf16 bands and v3 with f32 output:
//                          bf16 planes, f32 accumulation, f32 out.
//   pss_corr_int8_scaled   tools/bench_corr_v2.py::_kern_i8 (:355): the
//                          int8 sums, p = (re*re + im*im) * inv in f32
//                          with inv = (1 / (128 s_g))^2, stored as bf16.
//   pss_corr_sum_bf16      tools/bench_corr_v2.py::_sum_kernel (:205): the
//                          bf16 correlation with the |.|^2 epilogue summed
//                          in the kernel; no power map is written (see
//                          sum_kernel below for the sums it keeps).
//
// Quantization contract: bf16 operands are the capture and template planes
// rounded to bf16 (RNE); int8 operands are k = clip(round_half_even(128 x),
// -127, 127) and taps round(t * s_g) with s_g = 127 / max(|Re|, |Im|) over
// all templates.  int32 sums satisfy |sum| <= 137*127*127*2 < 2^24, so the
// conversion to f32 is exact.  Every epilogue squares and sums in f32 with
// explicit round-to-nearest intrinsics (no FMA contraction), so the plain
// PyTorch versions, which fix the rounding order, agree bit for bit on the
// int8 routes.
//
// What bounds them on this card: at T = 93, n_lags = 153464 the useful work
// is 93 * 153464 * 137 * 4 = 7.8 G real multiply-adds (15.6 GFLOP).  On the
// tensor cores (989 TF bf16, 1979 TOPS int8) the bound is ~16 us (bf16,
// operations), ~8.5 us (int8, 28.5 MB of bf16 output over 3.35 TB/s) and
// ~17 us (f32 output: 57 MB of stores).  pss_corr_f32 computes in f32
// (a TF32 tensor-core path would compute another function), so its bound is
// 15.6 GFLOP over the 67 TF of the CUDA cores, 0.23 ms.  This first design
// runs every route on the CUDA cores, so all are operation-bound near that
// 0.23 ms.
//
// Design: the TPU kernels' band matrices only exist to feed a 128-lane
// matrix unit -- v2/v3's im2col matrix (W = 120 lags x K = 256 samples per
// row, 23 MB of mostly-zero bands), v1's three 128 x 128 Toeplitz planes
// per template (12 real dots), and v3's in-kernel transpose, which only
// produces the [template, lag] layout that this kernel writes directly.
// Here each block stages the capture span of its 256-lag tile plus its 16
// templates' 137 taps in shared memory and every thread keeps a 4-lag x
// 4-template register tile, so each tap step does 8 shared loads for 64
// multiply-adds.  Warps share one template row (broadcast loads) and walk
// consecutive lags (conflict-free loads).  The ragged last lag tile and the
// padded template rows are masked.  One loop serves every route; only the
// operand type and the epilogue differ.

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

// The sum probe's TPU geometry: rows of W = 120 lags, row blocks of 128
// rows, and the first 8 lags of each row in its (8, 128) output tile.
constexpr int kRowLags = 120;
constexpr int kRowBlockLags = 128 * kRowLags;                // 15360
constexpr int kSumCols = 8;

__device__ __forceinline__ float load_elem(const float* p, size_t i) {
  return p[i];
}

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

__device__ __forceinline__ float power(float fr, float fi) {
  return __fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi));
}

// Re and Im of the correlation for this thread's 4 templates x 4 lags of
// the block's tile: lags l0 + threadIdx.x + 64 j, templates tb +
// 4 threadIdx.y + i.  cap: [2, n_cap] planes (re, im), zero past n_cap;
// taps: [2, n_t, 137], zero past n_t.
template <typename In, typename Acc>
__device__ __forceinline__ void correlate_tile(
    const In* __restrict__ cap, const In* __restrict__ taps, int n_cap,
    int n_t, int l0, int tb, Acc (&acc_re)[kTmplPerThread][kLagsPerThread],
    Acc (&acc_im)[kTmplPerThread][kLagsPerThread]) {
  __shared__ Acc s_re[kSpan];
  __shared__ Acc s_im[kSpan];
  __shared__ Acc t_re[kTileTmpl][kTaps];
  __shared__ Acc t_im[kTileTmpl][kTaps];

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
}

// Epilogues: store one entry of the [n_t, n_lags] map from Re and Im.
struct PowBf16 {
  __nv_bfloat16* out;
  __device__ void operator()(size_t i, float fr, float fi) const {
    out[i] = __float2bfloat16_rn(power(fr, fi));
  }
};

struct PowF32 {
  float* out;
  __device__ void operator()(size_t i, float fr, float fi) const {
    out[i] = power(fr, fi);
  }
};

struct ScaledPowBf16 {
  __nv_bfloat16* out;
  float inv;
  __device__ void operator()(size_t i, float fr, float fi) const {
    out[i] = __float2bfloat16_rn(__fmul_rn(power(fr, fi), inv));
  }
};

template <typename In, typename Acc, typename Store>
__global__ void __launch_bounds__(kThreads)
map_kernel(const In* __restrict__ cap, const In* __restrict__ taps,
           Store store, int n_cap, int n_t, int n_lags) {
  const int l0 = blockIdx.x * kTileLags;
  const int tb = blockIdx.y * kTileTmpl;
  Acc acc_re[kTmplPerThread][kLagsPerThread];
  Acc acc_im[kTmplPerThread][kLagsPerThread];
  correlate_tile<In, Acc>(cap, taps, n_cap, n_t, l0, tb, acc_re, acc_im);

  const int lx = threadIdx.x;
  const int ty = threadIdx.y * kTmplPerThread;
#pragma unroll
  for (int i = 0; i < kTmplPerThread; ++i) {
    const int t = tb + ty + i;
    if (t >= n_t) continue;
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      const int l = l0 + lx + j * kThreadsX;
      if (l >= n_lags) continue;
      store(static_cast<size_t>(t) * n_lags + l, as_float(acc_re[i][j]),
            as_float(acc_im[i][j]));
    }
  }
}

// The sum probe: sums[rb, j, c, tc] += p[16 j + tc, 15360 rb + 120 r + c]
// over the rows r < 128 of row block rb, for c < 8; n_lags covers whole
// row blocks (the capture is zero past n_cap, templates past n_t are zero
// taps).  Every lag of the map is computed, as on the TPU; a block first
// reduces its tile's share in shared memory (its 256 lags touch at most two
// row blocks), then adds it to sums [n_rb, n_tc, 8, 16] with one atomic per
// entry.  sums must be zero on entry.
__global__ void __launch_bounds__(kThreads)
sum_kernel(const __nv_bfloat16* __restrict__ cap,
           const __nv_bfloat16* __restrict__ taps, float* __restrict__ sums,
           int n_cap, int n_t, int n_lags) {
  __shared__ float red[2][kSumCols][kTileTmpl];
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int e = tid; e < 2 * kSumCols * kTileTmpl; e += kThreads) {
    (&red[0][0][0])[e] = 0.0f;
  }
  const int l0 = blockIdx.x * kTileLags;
  const int tb = blockIdx.y * kTileTmpl;
  float acc_re[kTmplPerThread][kLagsPerThread];
  float acc_im[kTmplPerThread][kLagsPerThread];
  // correlate_tile synchronises the block after staging, so red is zero
  // before any thread adds to it
  correlate_tile<__nv_bfloat16, float>(cap, taps, n_cap, n_t, l0, tb, acc_re,
                                       acc_im);

  const int rb0 = l0 / kRowBlockLags;
  const int lx = threadIdx.x;
  const int ty = threadIdx.y * kTmplPerThread;
#pragma unroll
  for (int j = 0; j < kLagsPerThread; ++j) {
    const int l = l0 + lx + j * kThreadsX;
    const int c = l % kRowLags;
    if (l >= n_lags || c >= kSumCols) continue;
    const int k = l / kRowBlockLags - rb0;
#pragma unroll
    for (int i = 0; i < kTmplPerThread; ++i) {
      atomicAdd(&red[k][c][ty + i], power(acc_re[i][j], acc_im[i][j]));
    }
  }
  __syncthreads();

  const int n_rb = n_lags / kRowBlockLags;
  for (int e = tid; e < 2 * kSumCols * kTileTmpl; e += kThreads) {
    const int k = e / (kSumCols * kTileTmpl);
    const int c = (e / kTileTmpl) % kSumCols;
    const int tc = e % kTileTmpl;
    const int rb = rb0 + k;
    if (rb >= n_rb || rb * kRowBlockLags >= l0 + kTileLags) continue;
    atomicAdd(&sums[((static_cast<size_t>(rb) * gridDim.y + blockIdx.y)
                     * kSumCols + c) * kTileTmpl + tc],
              red[k][c][tc]);
  }
}

dim3 grid_for(int n_t, int n_lags) {
  return dim3((n_lags + kTileLags - 1) / kTileLags,
              (n_t + kTileTmpl - 1) / kTileTmpl);
}

template <typename In, typename Acc, typename Store>
int launch(const void* cap, const void* taps, Store store, int n_cap,
           int n_t, int n_lags, void* stream) {
  map_kernel<In, Acc, Store><<<grid_for(n_t, n_lags),
                               dim3(kThreadsX, kThreadsY), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(cap), static_cast<const In*>(taps), store,
      n_cap, n_t, n_lags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pss_corr_bf16(const void* cap, const void* taps, void* out,
                             int n_cap, int n_t, int n_lags, void* stream) {
  return launch<__nv_bfloat16, float>(
      cap, taps, PowBf16{static_cast<__nv_bfloat16*>(out)}, n_cap, n_t,
      n_lags, stream);
}

extern "C" int pss_corr_int8(const void* cap, const void* taps, void* out,
                             int n_cap, int n_t, int n_lags, void* stream) {
  return launch<int8_t, int>(
      cap, taps, PowBf16{static_cast<__nv_bfloat16*>(out)}, n_cap, n_t,
      n_lags, stream);
}

extern "C" int pss_corr_f32(const void* cap, const void* taps, void* out,
                            int n_cap, int n_t, int n_lags, void* stream) {
  return launch<float, float>(cap, taps, PowF32{static_cast<float*>(out)},
                              n_cap, n_t, n_lags, stream);
}

extern "C" int pss_corr_bf16_f32out(const void* cap, const void* taps,
                                    void* out, int n_cap, int n_t,
                                    int n_lags, void* stream) {
  return launch<__nv_bfloat16, float>(
      cap, taps, PowF32{static_cast<float*>(out)}, n_cap, n_t, n_lags,
      stream);
}

extern "C" int pss_corr_int8_scaled(const void* cap, const void* taps,
                                    void* out, int n_cap, int n_t,
                                    int n_lags, float inv, void* stream) {
  return launch<int8_t, int>(
      cap, taps, ScaledPowBf16{static_cast<__nv_bfloat16*>(out), inv}, n_cap,
      n_t, n_lags, stream);
}

// n_lags: whole row blocks (a multiple of 15360); sums: zeroed
// [n_lags / 15360, ceil(n_t / 16), 8, 16] f32
extern "C" int pss_corr_sum_bf16(const void* cap, const void* taps,
                                 void* sums, int n_cap, int n_t, int n_lags,
                                 void* stream) {
  sum_kernel<<<grid_for(n_t, n_lags), dim3(kThreadsX, kThreadsY), 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(cap),
      static_cast<const __nv_bfloat16*>(taps), static_cast<float*>(sums),
      n_cap, n_t, n_lags);
  return static_cast<int>(cudaGetLastError());
}
