// Tensor-core PSS correlation on a Hankel tile of the capture, shared by
// the map kernels (pss_corr.cu: pss_corr_bf16, pss_corr_bf16_f32out,
// pss_corr_int8, pss_corr_int8_scaled) and the fused fold kernels
// (pss_corr_fold.cu).
//
// The correlation of one lag tile with one group of templates is a real
// matrix product on warp-level mma.sync.  M is the lag, K interleaves the
// real and imaginary parts of each tap, N holds (Re, Im) column pairs:
//
//   A[r, 2k] = Re x[l0 + r + k],  A[r, 2k + 1] = Im x[l0 + r + k],
//   B[2k, 2p] = tr[p, k],  B[2k + 1, 2p] = -ti[p, k],
//   B[2k, 2p + 1] = ti[p, k],  B[2k + 1, 2p + 1] = tr[p, k],
//
// so column 2p of A B is Re and column 2p + 1 is Im of template p of the
// group.  Taps 137-143 are zero: K = 288 (18 bf16 k-steps of 8 taps, 9 int8
// k-steps of 16 taps), N = 8.  In the m16n8 accumulator lane (g = lane / 4,
// q = lane % 4) holds (Re, Im) of the group's template q at lags g and
// g + 8, so the epilogue stays in that lane's registers.
//
// A is a Hankel matrix: A(lag tile i, k-step j) depends only on 16 i + 8 j
// (bf16) or 16 i + 16 j (int8), and no im2col matrix exists.  The capture
// is staged in shared memory as one 32-bit word per sample: (Re, Im) in
// bf16, or for int8 the pair of consecutive samples (Re, Im, Re', Im') that
// an m16n8k32 A register holds, so every A register is one aligned shared
// load.  The wrappers build these words (`capture_words` in
// ops/corr_cuda.py) with kGuard zero words before sample 0 and zeros past
// the capture.  Each warp keeps 16 lag tiles' accumulators in registers,
// walks the distinct fragment offsets once with a rolling window of
// fragment registers, and issues every mma that uses each: about 0.35
// shared loads per mma instead of 4.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hankel {

constexpr int kTapsPad = 144;      // 137 taps + 7 zero taps
constexpr int kK = 2 * kTapsPad;   // K: Re and Im of each tap
constexpr int kTiles = 16;         // 16-lag m-tiles per warp
constexpr int kTileLags = 16 * kTiles;   // 256 lags per warp
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies span_cap words from the aligned word index ga (a multiple of 4)
// in 16-byte chunks, one per thread of a block of kThreads; chunks outside
// [0, n_words) are filled with zeros.
template <int kThreads>
__device__ __forceinline__ void stage(uint32_t* dst,
                                      const uint32_t* __restrict__ src,
                                      int ga, int n_words, int span_cap) {
  for (int i = threadIdx.x; i < span_cap / 4; i += kThreads) {
    const int gi = ga + 4 * i;
    const bool ok = gi >= 0 && gi + 4 <= n_words;
    cp_async16(dst + 4 * i, ok ? src + gi : src, ok ? 16 : 0);
  }
}

// The B fragments of packed column group n (taps: [groups, 8, 288] as
// 32-bit words, each column contiguous), for every k-step.
template <class Tr>
__device__ __forceinline__ void load_b(const uint32_t* __restrict__ taps,
                                       int n, int g, int q,
                                       uint32_t (&b)[Tr::kSteps][2]) {
  const uint32_t* col = taps + (static_cast<size_t>(n) * 8 + g)
                               * Tr::kRowWords;
#pragma unroll
  for (int j = 0; j < Tr::kSteps; ++j) {
    b[j][0] = col[8 * j + q];
    b[j][1] = col[8 * j + 4 + q];
  }
}

// One warp's 16 lag tiles of A B, added to acc.  w points at the staged
// word of the warp's first lag plus the lane's offset g + kLaneQ q.
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

}  // namespace hankel
