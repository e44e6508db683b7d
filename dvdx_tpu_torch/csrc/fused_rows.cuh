// Row-tile building blocks of the fused spatial tail and temporal block
// (spatial_tail.cu, temporal_block.cu): a block of FUSED_THREADS (8 warps)
// owns FUSED_ROWS token rows held in shared memory as bf16, multiplies them
// by weights streamed from global memory (L2-resident; a weight set of a few
// MB does not fit the 227 KB of shared memory), and normalises whole rows,
// each of which the block holds in full.
#pragma once

#include "common.cuh"

namespace dvdx {

constexpr int FUSED_THREADS = 256;  // 8 warps
constexpr int FUSED_ROWS = 32;      // two m-tiles of 16

// The FUSED_ROWS x N product of A (shared memory, row stride lda, K columns)
// and W^T, W (N, K) row-major in global memory (nn.Linear's layout), on the
// tensor cores (mma.sync m16n8k16, f32 accumulate). For every row r and even
// column c, epi(r, c, sum(r, c), sum(r, c + 1)) runs once, in the thread that
// owns the pair. Warp w computes the n-tiles w, w + 8, ...; each sum runs
// over k in a fixed order. K % 16 == 0, N % 8 == 0, lda even.
template <typename Epi>
__device__ __forceinline__ void rows_gemm(const bf16* A, int lda,
                                          const bf16* __restrict__ W, int N,
                                          int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int nt = warp; nt < N / 8; nt += FUSED_THREADS / 32) {
    float acc[2][4] = {};
    const bf16* wr = W + (long long)(nt * 8 + g) * K + 2 * t;
    for (int kk = 0; kk < K; kk += 16) {
      const uint32_t b0 = ld32(wr + kk), b1 = ld32(wr + kk + 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ar = A + (mt * 16 + g) * lda + kk + 2 * t;
        const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * lda), ld32(ar + 8),
                               ld32(ar + 8 * lda + 8)};
        mma_16816(acc[mt], a, b0, b1);
      }
    }
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      epi(mt * 16 + g, col, acc[mt][0], acc[mt][1]);
      epi(mt * 16 + g + 8, col, acc[mt][2], acc[mt][3]);
    }
  }
}

// LayerNorm of the first `rows` rows of src into dst (shared memory, row
// strides lds and ldd, C columns), flax's math: f32 moments with the fast variance
// E[x^2] - mean^2, (x - mean) / sqrt(var + eps) * scale + bias, rounded to
// bf16. One warp per row, lanes over columns, sums in a fixed order.
__device__ __forceinline__ void rows_layernorm(const bf16* src, int lds,
                                               bf16* dst, int ldd, int C,
                                               int rows,
                                               const bf16* __restrict__ scale,
                                               const bf16* __restrict__ bias,
                                               float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += FUSED_THREADS / 32) {
    const bf16* s = src + r * lds;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = __bfloat162float(s[c]);
      sum += v;
      sq += v * v;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mean = sum / C;
    const float inv = 1.f / sqrtf(sq / C - mean * mean + eps);
    for (int c = lane; c < C; c += 32) {
      const float y = (__bfloat162float(s[c]) - mean) * inv;
      dst[r * ldd + c] = __float2bfloat16(y * __bfloat162float(scale[c]) +
                                         __bfloat162float(bias[c]));
    }
  }
}

// Copy `rows` rows of C bf16 between global memory (row pointer from
// row_ptr(r), 16-byte aligned) and shared memory (stride ld); rows past
// `rows` are zero-filled on the way in. C % 8 == 0.
template <typename RowPtr>
__device__ __forceinline__ void rows_load(bf16* dst, int ld, int C, int rows,
                                          RowPtr row_ptr) {
  for (int i = threadIdx.x; i < FUSED_ROWS * (C / 8); i += FUSED_THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(row_ptr(r) + c8);
    *reinterpret_cast<uint4*>(&dst[r * ld + c8]) = v;
  }
}

template <typename RowPtr>
__device__ __forceinline__ void rows_store(const bf16* src, int ld, int C,
                                           int rows, RowPtr row_ptr) {
  for (int i = threadIdx.x; i < rows * (C / 8); i += FUSED_THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(row_ptr(r) + c8) =
        *reinterpret_cast<const uint4*>(&src[r * ld + c8]);
  }
}

// The residual-add epilogue of an attention's out-projection, as the fused
// kernels round it: (x + bf16(sum)) + b for the spatial tail, x + (bf16(sum)
// + b) for the temporal block.
__device__ __forceinline__ float resid_then_bias(float x, float sum, float b) {
  return bf16_round(bf16_round(x + bf16_round(sum)) + b);
}

__device__ __forceinline__ float bias_then_resid(float x, float sum, float b) {
  return bf16_round(x + bf16_round(bf16_round(sum) + b));
}

}  // namespace dvdx
