// Attention over float32 inputs: out = softmax(q k^T * scale) v per head, on
// the CUDA cores in f32, with no tensor-core rounding of its operands (TF32
// would round them to 10 mantissa bits). One kernel for every float32
// attention of the port: flash and frame-axis attention (attention_f32.cu),
// and the cross-attention and frame-axis attention inside the float32 forms
// of the fused tail and block (spatial_tail_f32.cu, temporal_block_f32.cu).
//
// Layout: an element (b, n, s, h, d) of q, k, v or out lies at
// b * sb + n * sn + s * ss + h * sh + d, strides per tensor, so one kernel
// takes flash's (B, S, H, D) (N = 1), frame-axis attention's frame-major
// (B, F, N, H*D) and position-major (B, N, F, H*D) layouts, and the tail's
// token rows against its (N, T, H*D) context.
//
// Design: a block of 8 warps takes 8 query rows of one (b, n, h); each
// warp holds its row in shared memory. Keys come in tiles of 32, K and V
// staged in shared memory by the whole block (K rows padded to MAX_D + 1
// floats, so the 32 lanes reading 32 keys' d-th values hit 32 banks). Lane
// j takes key j of the tile: its logit is one f32 dot product over d in
// order; the tile's max and the denominator's increment are fixed
// butterflies across the warp; the probabilities go through shared memory
// and each lane adds P.V for its own d = lane, lane + 32, ... over the
// tile's keys in order. Every sum has a fixed order, so a rerun is
// bit-identical. Two instantiations: MAX_D = 128 (37.1 KB of shared memory)
// and MAX_D = 384 (109.1 KB; the fused block's one-head widths). One grid
// axis holds every block, the row tiles of one (b, n, h) adjacent, then the
// heads, then (b, n), so the blocks that read one head's K and V run
// together. Bound on the H100 by f32 operations at long sequences (4 S T D
// flops), else by bytes.
//
// ``Site`` only names the kernel for profilers (its demangled name carries
// the calling kernel's name).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace dvdx {
namespace f32 {

struct Strides {
  long long b, n, s, h;
};

constexpr int ATT_WARPS = 8;  // query rows per block
constexpr int ATT_KT = 32;    // keys per tile: one per lane
constexpr int ATT_MAX_D = 384;

template <int MAX_D>
constexpr size_t att_smem_bytes() {
  return sizeof(float) * (ATT_KT * (2 * MAX_D + 1) + ATT_WARPS * (MAX_D + ATT_KT));
}

template <class Site, int MAX_D>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_f32_rows(const float* q, const float* k, const float* v, float* out, int N, int H,
                   int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale) {
  extern __shared__ float smem[];
  auto k_tile = reinterpret_cast<float (*)[MAX_D + 1]>(smem);                   // [ATT_KT]
  auto v_tile = reinterpret_cast<float (*)[MAX_D]>(smem + ATT_KT * (MAX_D + 1));  // [ATT_KT]
  auto q_rows = reinterpret_cast<float (*)[MAX_D]>(smem + ATT_KT * (2 * MAX_D + 1));
  auto p_rows = reinterpret_cast<float (*)[ATT_KT]>(smem + ATT_KT * (2 * MAX_D + 1) +
                                                    ATT_WARPS * MAX_D);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tiles = (Sq + ATT_WARPS - 1) / ATT_WARPS;
  const int bnh = blockIdx.x / tiles;
  const int s = (blockIdx.x - bnh * tiles) * ATT_WARPS + w;
  const bool live = s < Sq;  // a warp past Sq still helps stage the tiles
  const int h = bnh % H, b = bnh / H / N, n = bnh / H % N;
  const float* kp = k + b * ks.b + n * ks.n + h * ks.h;
  const float* vp = v + b * vs.b + n * vs.n + h * vs.h;
  if (live) {
    const float* qp = q + b * qs.b + n * qs.n + s * qs.s + h * qs.h;
    for (int d = lane; d < D; d += 32) q_rows[w][d] = qp[d];
  }
  float acc[MAX_D / 32] = {};
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < Sk; t0 += ATT_KT) {
    __syncthreads();  // the last tile is consumed (and q_rows written)
    for (int e = threadIdx.x; e < ATT_KT * D; e += ATT_WARPS * 32) {
      const int j = e / D, d = e - j * D, t = t0 + j;
      k_tile[j][d] = t < Sk ? __ldg(kp + t * ks.s + d) : 0.f;
      v_tile[j][d] = t < Sk ? __ldg(vp + t * vs.s + d) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(q_rows[w][d], k_tile[lane][d], dot);
    const float logit = t0 + lane < Sk ? dot * scale : -INFINITY;
    const float m_new = fmaxf(m, warp_max(logit));
    const float c = expf(m - m_new), p = expf(logit - m_new);
    l = fmaf(l, c, warp_sum(p));
    p_rows[w][lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int d = lane + 32 * i;
      if (d >= D) continue;
      float a = acc[i] * c;
#pragma unroll 8
      for (int j = 0; j < ATT_KT; ++j) a = fmaf(p_rows[w][j], v_tile[j][d], a);
      acc[i] = a;
    }
    __syncwarp();  // p_rows is rewritten by the next tile
    m = m_new;
  }
  if (!live) return;
  float* op = out + b * os.b + n * os.n + s * os.s + h * os.h;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < D) op[d] = acc[i] * inv;
  }
}

template <class Site, int MAX_D>
int attention_f32_run(unsigned blocks, const float* q, const float* k, const float* v,
                      float* out, int N, int H, int Sq, int Sk, int D, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale, cudaStream_t stream) {
  constexpr size_t smem = att_smem_bytes<MAX_D>();
  auto kernel = attention_f32_rows<Site, MAX_D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, ATT_WARPS * 32, smem, stream>>>(q, k, v, out, N, H, Sq, Sk, D, qs, ks, vs,
                                                   os, scale);
  return static_cast<int>(cudaGetLastError());
}

// q, out: Sq rows, k, v: Sk rows, of B x N x H heads of width D, float32,
// unit stride along d; each tensor's b / n / s / h strides in elements.
// D <= 384, ceil(Sq / 8) * H * B * N < 2^31.
template <class Site>
int attention_f32_launch(const float* q, const float* k, const float* v, float* out, int B,
                         int N, int H, int Sq, int Sk, int D, Strides qs, Strides ks,
                         Strides vs, Strides os, float scale, cudaStream_t stream) {
  if (B < 1 || N < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > ATT_MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)((Sq + ATT_WARPS - 1) / ATT_WARPS) * H * B * N;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  return D <= 128 ? attention_f32_run<Site, 128>(nb, q, k, v, out, N, H, Sq, Sk, D, qs, ks,
                                                 vs, os, scale, stream)
                  : attention_f32_run<Site, ATT_MAX_D>(nb, q, k, v, out, N, H, Sq, Sk, D, qs,
                                                       ks, vs, os, scale, stream);
}

}  // namespace f32
}  // namespace dvdx
