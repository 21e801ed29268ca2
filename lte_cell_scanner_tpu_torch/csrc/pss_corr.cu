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
//                          (:429) with bf16 output: bf16 operands, f32
//                          accumulation, p stored as bf16 (RNE).
//   pss_corr_bf16_f32out   v1 with bf16 bands and v3 with f32 output:
//                          bf16 operands, f32 accumulation, f32 out.
//   pss_corr_int8          _corr_kernel_v2_int8 (:416): int8 operands,
//                          int32 accumulation, p stored UNSCALED as bf16.
//   pss_corr_int8_scaled   tools/bench_corr_v2.py::_kern_i8 (:355): the
//                          int8 sums, p = (re*re + im*im) * inv in f32
//                          with inv = (1 / (128 s_g))^2, stored as bf16.
//   pss_corr_sum_bf16      tools/bench_corr_v2.py::_sum_kernel (:205): the
//                          bf16 correlation's f32 power summed in the
//                          kernel, no map written: S[rb, j, c, tc] = the
//                          sum over the rows r < 128 of p[16 j + tc,
//                          15360 rb + 120 r + c], c < 8.
//                          These five run on the tensor cores and take
//                          the capture words and packed taps (below).
//   pss_corr_f32           _corr_kernel (v1, :67) with f32 bands, and v2
//                          with f32 bands: f32 planes, f32 FMA, f32 out,
//                          on the CUDA cores.
//
// Quantization contract: bf16 operands are the capture and template planes
// rounded to bf16 (RNE); int8 operands are k = clip(round_half_even(128 x),
// -127, 127) and taps round(t * s_g) with s_g = 127 / max(|Re|, |Im|) over
// all templates.  int32 sums satisfy |sum| <= 137*127*127*2 < 2^24, so the
// conversion to f32 is exact.  Every epilogue squares, sums and scales in
// f32 with explicit round-to-nearest intrinsics (no FMA contraction), so
// the plain PyTorch versions, which fix the rounding order, agree bit for
// bit on the int8 routes.
//
// What bounds them on this card: at T = 93, n_lags = 153464 the useful work
// is 93 * 153464 * 137 * 4 = 7.8 G real multiply-adds (15.6 GFLOP).  On the
// tensor cores (989 TF bf16, 1979 TOPS int8) the bound is ~16 us (bf16,
// operations; the sum probe too, whose output is 30 KB), ~8.5 us (int8,
// 28.5 MB of bf16 output over 3.35 TB/s) and ~17 us (f32 output: 57 MB of
// stores).  pss_corr_f32 computes in f32 (a TF32 tensor-core path would
// compute another function), so its bound is 15.6 GFLOP over the 67 TF of
// the CUDA cores, 0.23 ms.
//
// The five tensor-core entry points run one kernel template
// (map_tc_kernel<trait, sink>): the Hankel product of hankel_mma.cuh
// (mma.sync m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32) with FOUR templates
// in each n8 column group, column 2q Re and 2q + 1 Im of template 4n + q
// (B packed by `pack_map_taps` in ops/corr_cuda.py, zero only past T).  At
// T = 93 that is 24 groups, and 93/96 * 137/144 = 92% of the padded
// tensor-core work is useful.  A block of 8 warps holds 8 groups' B
// fragments (32 templates) in registers and walks lag tiles of 256 (16
// m-tiles per warp, every warp on the same lags): each tile's capture span
// (256 lags + 143 taps, 400 words of `capture_words`) is copied with
// cp.async into one of two buffers while the other tile computes, with one
// block barrier per tile.  The grid holds as many blocks as the card keeps
// resident, and each walks one contiguous run of the lag tiles (the tiles
// split evenly over gridDim.x).  The sink is what a warp does with a
// tile's accumulators; in lane (g, q) they are template 4 group + q at
// lags l0 + 16 i + g and l0 + 16 i + 8 + g.
//
// MapStore<epilogue> (the four maps): the epilogue (bf16 power, f32 power,
// or bf16 power times inv) runs in the lane's registers (the int8 sums are
// exact, so the int8 maps are bit-equal to their plain versions), writes
// the entries into the warp's 4 rows of a [32 template][256 lag] shared
// tile of the output type, and the warp stores them with 16-byte coalesced
// stores (the 28.5 MB bf16 map bounds int8, the 57 MB f32 map bounds the
// f32 output) while other warps compute.  The tile's pitch, 264 entries,
// keeps the lanes' stores conflict-free: 264 f32 words are 8 banks mod 32,
// so lane (g, q) hits bank 8q + g.  The f32 tile is 33.8 KB, plus 3.2 KB
// of spans, under the 48 KB of static shared memory.  Ragged lag tiles and
// templates past T are masked.
//
// RowBlockSums (the sum probe): every lag's product is computed, as the
// TPU probe computes every lag, and only the power of the lags that S
// keeps is summed, in registers.  15360 = 60 * 256, so a lag tile lies in
// one row block, and l0 and 120 are multiples of 8, so lane (g, q) holds
// only lags = g (mod 8): those of them with l % 120 < 8 all have c = g.
// Each lane therefore owns one entry, S[rb, t / 16, g, t % 16] for t =
// 4 group + q, adds the f32 power of its 2-3 kept lags per tile into one
// register and flushes it with one atomicAdd at the end of each row block
// and of its run: no shared output tile, no reduction across lanes, and 8
// atomics per template for each row block that a run touches.  S must be
// zero on entry; the order of the atomics varies from run to run.
//
// pss_corr_f32 runs on the CUDA cores (map_kernel).  The TPU kernels' band
// matrices only exist to feed a 128-lane matrix unit -- v2/v3's im2col
// matrix (W = 120 lags x K = 256 samples per row, 23 MB of mostly-zero
// bands), v1's three 128 x 128 Toeplitz planes per template (12 real
// dots), and v3's in-kernel transpose, which only produces the [template,
// lag] layout that these kernels write directly.  There each block stages
// the capture span of its 256-lag tile plus its 16 templates' 137 taps in
// shared memory and every thread keeps a 4-lag x 4-template register tile,
// so each tap step does 8 shared loads for 64 multiply-adds.  Warps share
// one template row (broadcast loads) and walk consecutive lags
// (conflict-free loads).  The ragged last lag tile and the padded template
// rows are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hankel_mma.cuh"

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

__device__ __forceinline__ float power(float fr, float fi) {
  return __fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi));
}

// Re and Im of the correlation for this thread's 4 templates x 4 lags of
// the block's tile: lags l0 + threadIdx.x + 64 j, templates tb +
// 4 threadIdx.y + i.  cap: [2, n_cap] f32 planes (re, im), zero past n_cap;
// taps: [2, n_t, 137], zero past n_t.
__device__ __forceinline__ void correlate_tile(
    const float* __restrict__ cap, const float* __restrict__ taps, int n_cap,
    int n_t, int l0, int tb, float (&acc_re)[kTmplPerThread][kLagsPerThread],
    float (&acc_im)[kTmplPerThread][kLagsPerThread]) {
  __shared__ float s_re[kSpan];
  __shared__ float s_im[kSpan];
  __shared__ float t_re[kTileTmpl][kTaps];
  __shared__ float t_im[kTileTmpl][kTaps];

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int i = tid; i < kSpan; i += kThreads) {
    const int g = l0 + i;
    const bool ok = g < n_cap;
    s_re[i] = ok ? cap[g] : 0.0f;
    s_im[i] = ok ? cap[static_cast<size_t>(n_cap) + g] : 0.0f;
  }
  for (int i = tid; i < kTileTmpl * kTaps; i += kThreads) {
    const int t = i / kTaps;
    const int m = i - t * kTaps;
    const bool ok = tb + t < n_t;
    const size_t off = static_cast<size_t>(tb + t) * kTaps + m;
    t_re[t][m] = ok ? taps[off] : 0.0f;
    t_im[t][m] = ok ? taps[static_cast<size_t>(n_t) * kTaps + off] : 0.0f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kTmplPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      acc_re[i][j] = 0.0f;
      acc_im[i][j] = 0.0f;
    }
  }

  const int lx = threadIdx.x;
  const int ty = threadIdx.y * kTmplPerThread;
#pragma unroll 4
  for (int m = 0; m < kTaps; ++m) {
    float xr[kLagsPerThread];
    float xi[kLagsPerThread];
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      xr[j] = s_re[lx + j * kThreadsX + m];
      xi[j] = s_im[lx + j * kThreadsX + m];
    }
#pragma unroll
    for (int i = 0; i < kTmplPerThread; ++i) {
      const float tr = t_re[ty + i][m];
      const float ti = t_im[ty + i][m];
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) {
        // re += xr*tr - xi*ti ; im += xr*ti + xi*tr
        acc_re[i][j] = fmaf(xr[j], tr, acc_re[i][j]);
        acc_re[i][j] = fmaf(-xi[j], ti, acc_re[i][j]);
        acc_im[i][j] = fmaf(xr[j], ti, acc_im[i][j]);
        acc_im[i][j] = fmaf(xi[j], tr, acc_im[i][j]);
      }
    }
  }
}

// pss_corr_f32's map: out [n_t, n_lags] f32.
__global__ void __launch_bounds__(kThreads)
map_kernel(const float* __restrict__ cap, const float* __restrict__ taps,
           float* __restrict__ out, int n_cap, int n_t, int n_lags) {
  const int l0 = blockIdx.x * kTileLags;
  const int tb = blockIdx.y * kTileTmpl;
  float acc_re[kTmplPerThread][kLagsPerThread];
  float acc_im[kTmplPerThread][kLagsPerThread];
  correlate_tile(cap, taps, n_cap, n_t, l0, tb, acc_re, acc_im);

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
      out[static_cast<size_t>(t) * n_lags + l] =
          power(acc_re[i][j], acc_im[i][j]);
    }
  }
}

dim3 grid_for(int n_t, int n_lags) {
  return dim3((n_lags + kTileLags - 1) / kTileLags,
              (n_t + kTileTmpl - 1) / kTileTmpl);
}


// ---------------------------------------------------------------------------
// The tensor-core loop: the bf16 map, the f32 map, the UNSCALED int8 map,
// the scaled int8 map and the sum probe.

constexpr int kTcWarps = 8;                    // column groups per block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcTmpl = 4 * kTcWarps;          // 32 templates per block
constexpr int kTcLags = hankel::kTileLags;     // 256 lags per tile
// words per staged span: 256 lags + 143 taps in whole 16-byte chunks (the
// span starts at word l0 + 4, a multiple of 4)
constexpr int kTcSpan = (kTcLags + hankel::kTapsPad - 1 + 3) / 4 * 4;
constexpr int kTcPitch = kTcLags + 8;          // entries per staged output
                                               // row: conflict-free stores

// Epilogues: one map entry of type Out from the f32 Re and Im.
struct PowBf16 {
  using Out = __nv_bfloat16;
  __device__ __forceinline__ Out operator()(float fr, float fi) const {
    return __float2bfloat16_rn(power(fr, fi));
  }
};

struct PowF32 {
  using Out = float;
  __device__ __forceinline__ Out operator()(float fr, float fi) const {
    return power(fr, fi);
  }
};

struct ScaledPowBf16 {
  using Out = __nv_bfloat16;
  float inv;
  __device__ __forceinline__ Out operator()(float fr, float fi) const {
    return __float2bfloat16_rn(__fmul_rn(power(fr, fi), inv));
  }
};

// Sinks: tile<Tr>(acc, k, last, group, n_t, n_lags) takes one warp's
// accumulators of lag tile k (lags 256 k ..) for column group `group`;
// last is true on the block's last tile.

// The four maps: out [n_t, n_lags] of Ep::Out.
template <class Ep>
struct MapStore {
  using Out = typename Ep::Out;
  static constexpr int kChunk = 16 / sizeof(Out);   // entries per 16-byte
                                                    // store
  Out* out;
  Ep ep;
  bool wide;    // every row start 16-byte aligned: whole rows go out as
                // 16-byte stores

  template <class Tr>
  __device__ __forceinline__ void tile(
      const typename Tr::Acc (&acc)[hankel::kTiles][4], int k, bool,
      int group, int n_t, int n_lags) const {
    __shared__ __align__(16) Out staged[kTcTmpl][kTcPitch];
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int q = lane & 3;
    // the warp's 4 rows of the staged tile (templates 4 group + r)
    Out(*rows)[kTcPitch] = staged + 4 * (threadIdx.x >> 5);
    // lane (g, q): template 4 group + q at lags l0 + 16 i + g (+ 8)
#pragma unroll
    for (int i = 0; i < hankel::kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[q][16 * i + 8 * h + g] =
            ep(Tr::to_f32(acc[i][2 * h]), Tr::to_f32(acc[i][2 * h + 1]));
      }
    }
    __syncwarp();
    // the warp's rows, masked past n_t and n_lags
    const int l0 = k * kTcLags;
    const int n_rows = min(4, n_t - 4 * group);
    const int cols = min(kTcLags, n_lags - l0);
    Out* o = out + static_cast<size_t>(4 * group) * n_lags + l0;
    if (wide && cols == kTcLags) {
      constexpr int kChunks = kTcLags / kChunk;     // 16-byte chunks per row
      for (int e = lane; e < n_rows * kChunks; e += 32) {
        const int r = e / kChunks;
        const int c = kChunk * (e % kChunks);
        *reinterpret_cast<uint4*>(o + static_cast<size_t>(r) * n_lags + c)
            = *reinterpret_cast<const uint4*>(&rows[r][c]);
      }
    } else {
      for (int e = lane; e < n_rows * kTcLags; e += 32) {
        const int r = e / kTcLags;
        const int c = e % kTcLags;
        if (c < cols) o[static_cast<size_t>(r) * n_lags + c] = rows[r][c];
      }
    }
  }
};

template <class Ep>
MapStore<Ep> map_store(void* out, Ep ep, int n_lags) {
  using Out = typename Ep::Out;
  return {static_cast<Out*>(out), ep,
          n_lags % MapStore<Ep>::kChunk == 0
              && (reinterpret_cast<uintptr_t>(out) & 15) == 0};
}

// The sum probe's TPU geometry (tools/bench_corr_v2.py:205-239): rows of
// 120 lags, row blocks of 128 rows, the first 8 lags of each row (the
// sublanes of its (8, 128) output tile), chunks of 16 templates.
constexpr int kSumRowLags = 120;
constexpr int kSumBlockLags = 128 * kSumRowLags;             // 15360
constexpr int kSumBlockTiles = kSumBlockLags / kTcLags;      // 60
constexpr int kSumCols = 8;
constexpr int kSumChunk = 16;
static_assert(kSumBlockLags % kTcLags == 0,
              "a lag tile lies in one row block");
static_assert(kTcLags % 8 == 0 && kSumRowLags % 8 == 0 && kSumCols == 8,
              "lane (g, q) holds lags = g (mod 8), so its kept lags have "
              "c = g");

// sums: [n_lags / 15360, ceil(n_t / 16), 8, 16] f32, zero on entry.
struct RowBlockSums {
  float* sums;
  float s;      // the lane's sum over its kept lags since its last flush

  template <class Tr>
  __device__ __forceinline__ void tile(
      const typename Tr::Acc (&acc)[hankel::kTiles][4], int k, bool last,
      int group, int n_t, int) {
    // lag 256 k + 8 u + g (u = 2 i + h) is kept when 256 k + 8 u = 0
    // (mod 120), i.e. u = -2 k (mod 15): u0, u0 + 15 and, if u0 < 2,
    // u0 + 30
    const int u0 = (15 - 2 * k % 15) % 15;
    const unsigned keep = 1u << u0 | 1u << (u0 + 15)
                          | (u0 < 2 ? 1u << (u0 + 30) : 0u);
#pragma unroll
    for (int i = 0; i < hankel::kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (keep >> (2 * i + h) & 1u) {
          s = __fadd_rn(s, power(Tr::to_f32(acc[i][2 * h]),
                                 Tr::to_f32(acc[i][2 * h + 1])));
        }
      }
    }
    if (last || (k + 1) % kSumBlockTiles == 0) {
      const int lane = threadIdx.x & 31;
      const int t = 4 * group + (lane & 3);
      if (t < n_t) {
        const int n_tc = (n_t + kSumChunk - 1) / kSumChunk;
        const size_t rb = k / kSumBlockTiles;
        atomicAdd(&sums[((rb * n_tc + t / kSumChunk) * kSumCols + (lane >> 2))
                        * kSumChunk + t % kSumChunk], s);
      }
      s = 0.0f;
    }
  }
};

// words: [n_words] capture words (capture_words: sample s at word s + 4,
// zero past the capture); taps: [ceil(n_t / 4), 8, 288] packed B columns
// (pack_map_taps) as 32-bit words.
template <class Tr, class Sink>
__global__ void __launch_bounds__(kTcThreads)
map_tc_kernel(const uint32_t* __restrict__ words,
              const uint32_t* __restrict__ taps, Sink sink, int n_words,
              int n_t, int n_lags) {
  using Acc = typename Tr::Acc;
  __shared__ __align__(16) uint32_t span[2][kTcSpan];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int group = blockIdx.y * kTcWarps + warp;
  const bool active = group < (n_t + 3) / 4;   // warp-uniform

  // the group's B fragments, resident for every tile
  uint32_t b[Tr::kSteps][2];
  hankel::load_b<Tr>(taps, active ? group : 0, g, q, b);

  // the block's run of lag tiles [k, k_end): the tiles split evenly over
  // gridDim.x (at most the number of tiles)
  const int n_tiles = (n_lags + kTcLags - 1) / kTcLags;
  int k = static_cast<int>(static_cast<long long>(n_tiles) * blockIdx.x
                           / gridDim.x);
  const int k_end = static_cast<int>(
      static_cast<long long>(n_tiles) * (blockIdx.x + 1) / gridDim.x);
  hankel::stage<kTcThreads>(span[0], words, k * kTcLags + hankel::kGuard,
                            n_words, kTcSpan);
  hankel::cp_async_commit();
  for (int it = 0; k < k_end; ++it, ++k) {
    hankel::cp_async_wait_all();    // this tile's span has landed (this
    __syncthreads();                // thread's copies, then every thread's);
                                    // the other buffer's reads are done
    if (k + 1 < k_end) {
      hankel::stage<kTcThreads>(span[(it + 1) & 1], words,
                                (k + 1) * kTcLags + hankel::kGuard, n_words,
                                kTcSpan);
      hankel::cp_async_commit();
    }
    if (active) {
      Acc acc[hankel::kTiles][4];
#pragma unroll
      for (int i = 0; i < hankel::kTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = Acc(0);
      }
      hankel::correlate<Tr>(span[it & 1] + g + Tr::kLaneQ * q, b, acc);
      sink.template tile<Tr>(acc, k, k + 1 == k_end, group, n_t, n_lags);
    }
  }
}

template <class Tr, class Sink>
cudaError_t tc_blocks_per_sm(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, map_tc_kernel<Tr, Sink>, kTcThreads, 0);
}

// As many blocks as the card keeps resident (no more than the lag tiles),
// each walking one run of lag tiles for its 32 templates.
template <class Tr, class Sink>
int launch_tc(const void* words, const void* taps, Sink sink, int n_words,
              int n_t, int n_lags, void* stream) {
  static int slots = 0;             // resident blocks on the card, per
                                    // instance
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) err = tc_blocks_per_sm<Tr, Sink>(&per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = max(1, sms * per_sm);
  }
  const int n_tiles = (n_lags + kTcLags - 1) / kTcLags;
  const int n_groups = (n_t + 3) / 4;
  const int gy = (n_groups + kTcWarps - 1) / kTcWarps;
  const dim3 grid(max(1, min(n_tiles, slots / gy)), gy);
  map_tc_kernel<Tr, Sink><<<grid, kTcThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(taps),
      sink, n_words, n_t, n_lags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: capture_words of one capture, [n_words] 32-bit words; taps:
// pack_map_taps of the n_t templates; out: [n_t, n_lags] bf16 (f32 for
// pss_corr_bf16_f32out).
extern "C" int pss_corr_bf16(const void* words, const void* taps, void* out,
                             int n_words, int n_t, int n_lags, void* stream) {
  return launch_tc<hankel::Bf16>(words, taps,
                                 map_store(out, PowBf16{}, n_lags), n_words,
                                 n_t, n_lags, stream);
}

extern "C" int pss_corr_int8(const void* words, const void* taps, void* out,
                             int n_words, int n_t, int n_lags, void* stream) {
  return launch_tc<hankel::Int8>(words, taps,
                                 map_store(out, PowBf16{}, n_lags), n_words,
                                 n_t, n_lags, stream);
}

extern "C" int pss_corr_bf16_f32out(const void* words, const void* taps,
                                    void* out, int n_words, int n_t,
                                    int n_lags, void* stream) {
  return launch_tc<hankel::Bf16>(words, taps,
                                 map_store(out, PowF32{}, n_lags), n_words,
                                 n_t, n_lags, stream);
}

extern "C" int pss_corr_int8_scaled(const void* words, const void* taps,
                                    void* out, int n_words, int n_t,
                                    int n_lags, float inv, void* stream) {
  return launch_tc<hankel::Int8>(words, taps,
                                 map_store(out, ScaledPowBf16{inv}, n_lags),
                                 n_words, n_t, n_lags, stream);
}

// The same operands as pss_corr_bf16; n_lags: whole row blocks (a multiple
// of 15360); sums: zeroed [n_lags / 15360, ceil(n_t / 16), 8, 16] f32.
extern "C" int pss_corr_sum_bf16(const void* words, const void* taps,
                                 void* sums, int n_words, int n_t,
                                 int n_lags, void* stream) {
  if (n_lags % kSumBlockLags != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tc<hankel::Bf16>(
      words, taps, RowBlockSums{static_cast<float*>(sums), 0.0f}, n_words,
      n_t, n_lags, stream);
}

// The resident blocks per SM of the five tensor-core instances, in the
// order pss_corr_bf16, pss_corr_int8, pss_corr_bf16_f32out,
// pss_corr_int8_scaled, pss_corr_sum_bf16 (what launch_tc sizes its grid
// from).
extern "C" int pss_corr_map_tc_occupancy(int* per_sm) {
  cudaError_t err = tc_blocks_per_sm<hankel::Bf16, MapStore<PowBf16>>(per_sm);
  if (err == cudaSuccess) {
    err = tc_blocks_per_sm<hankel::Int8, MapStore<PowBf16>>(per_sm + 1);
  }
  if (err == cudaSuccess) {
    err = tc_blocks_per_sm<hankel::Bf16, MapStore<PowF32>>(per_sm + 2);
  }
  if (err == cudaSuccess) {
    err = tc_blocks_per_sm<hankel::Int8, MapStore<ScaledPowBf16>>(per_sm + 3);
  }
  if (err == cudaSuccess) {
    err = tc_blocks_per_sm<hankel::Bf16, RowBlockSums>(per_sm + 4);
  }
  return static_cast<int>(err);
}

extern "C" int pss_corr_f32(const void* cap, const void* taps, void* out,
                            int n_cap, int n_t, int n_lags, void* stream) {
  map_kernel<<<grid_for(n_t, n_lags), dim3(kThreadsX, kThreadsY), 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cap), static_cast<const float*>(taps),
      static_cast<float*>(out), n_cap, n_t, n_lags);
  return static_cast<int>(cudaGetLastError());
}
