// Row-wise float32 pieces of the port's float32 kernels: a tiled product on
// the CUDA cores with the fused kernels' epilogues, LayerNorm over rows, and
// the one float32 GEGLU feed-forward (geglu_ff.cu's float32 route and the FF
// of spatial_tail_f32.cu / temporal_block_f32.cu).
//
// The float32 forms compute what the TPU kernels compute for float32
// activations: every nn.Dense product accumulates in float32 and "rounds"
// to float32 (no rounding), so only the order of the sums differs from the
// plain PyTorch versions. No tensor core runs here: TF32 would round the
// operands to 10 mantissa bits.
//
// f32_gemm<Site, EPI>: out (M, N) = epilogue(A (M, K) B^T), B in nn.Linear's
// (N, K) layout, all row-major float32 with row strides lda / ldb / ldr /
// ldo, any M, N, K and alignment. Tiles of 128 x 64 outputs, 256 threads,
// each thread 8 rows x 4 columns; K in slices of 8 staged in shared memory
// (A transposed, so a thread reads its rows as two float4), double-buffered,
// the next slice loaded into registers while the current one is multiplied.
// Every output sums its K products in K order with fmaf, so a rerun gives
// the same bits. Epilogues (the fused kernels' residual orders):
//   EPI_NONE        out = acc
//   EPI_BIAS        out = acc + bias             (geglu_ff's output product)
//   EPI_RESID_BIAS  out = (resid + acc) + bias   (the spatial tail's o1 / o2)
//   EPI_BIAS_RESID  out = resid + (acc + bias)   (the temporal block's o1 /
//                                                 o2, and the fused FF outputs)
//   EPI_GEGLU       B holds 2N rows, value rows first, bias 2N values:
//                   out = (acc_v + bv) * gelu_erf(acc_g + bg), exact erf
// ``Site`` only names the kernel for profilers (its demangled name carries
// the calling kernel's name).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace dvdx {
namespace f32 {

constexpr int BM = 128, BN = 64, BK = 8, THREADS = 256;
enum { EPI_NONE = 0, EPI_BIAS = 1, EPI_RESID_BIAS = 2, EPI_BIAS_RESID = 3, EPI_GEGLU = 4 };

struct Gemm {
  const float* a;
  long long lda;
  const float* b;
  long long ldb;
  const float* bias;
  const float* resid;
  long long ldr;
  float* out;
  long long ldo;
  int M, N, K;
};

template <class Site, int EPI>
__global__ void __launch_bounds__(THREADS) f32_gemm(const Gemm g) {
  constexpr int NB = EPI == EPI_GEGLU ? 2 : 1;  // B operands: value (and gate)
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][NB][BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // loaders: A row ar, k ak..ak+3; B row br, k bk..bk+1
  const int ar = tid / 2, ak = (tid % 2) * 4, br = tid / 4, bk = (tid % 4) * 2;
  const bool a_live = m0 + ar < g.M, b_live = n0 + br < g.N;
  const float* ap = g.a + (m0 + ar) * g.lda;
  float ra[4], rb[NB][2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ak + i;
      ra[i] = a_live && k < g.K ? __ldg(ap + k) : 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + bk + i;
        rb[nb][i] = b_live && k < g.K
                        ? __ldg(g.b + ((long long)nb * g.N + n0 + br) * g.ldb + k)
                        : 0.f;
      }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) as[buf][ak + i][ar] = ra[i];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 2; ++i) bs[buf][nb][bk + i][br] = rb[nb][i];
  };

  float acc[NB][8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nb][i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < g.K; k0 += BK) {
    const bool more = k0 + BK < g.K;
    if (more) load(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][k][64 + ty * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][nb][k][tx * 4]);
        const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[nb][i][j] = fmaf(av[i], bv[j], acc[nb][i][j]);
      }
    }
    // the other buffer was last read before the previous barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      const float a = acc[0][i][j];
      float o = a;
      if (EPI == EPI_GEGLU) {
        o = (a + __ldg(g.bias + n)) * gelu_erf(acc[NB - 1][i][j] + __ldg(g.bias + g.N + n));
      } else if (EPI == EPI_BIAS) {
        o = a + __ldg(g.bias + n);
      } else if (EPI != EPI_NONE) {
        const float res = g.resid[r * g.ldr + n], b = __ldg(g.bias + n);
        o = EPI == EPI_RESID_BIAS ? (res + a) + b : res + (a + b);
      }
      g.out[r * g.ldo + n] = o;
    }
  }
}

// M row tiles in gridDim.x, N column tiles in gridDim.y.
template <class Site, int EPI>
int gemm_launch(const Gemm& g, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || g.K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((g.M + BM - 1) / BM), (g.N + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  f32_gemm<Site, EPI><<<grid, THREADS, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// flax LayerNorm over the C values of each row: mean and E[x^2] - mean^2
// (the fast variance) summed by one warp, lane l taking columns l, l + 32,
// ... in order and the lanes combined by a fixed butterfly; y = (x - mean)
// * rsqrt(var + eps) * scale + bias. x and y (rows, C) contiguous.
constexpr int LN_WARPS = 8;

template <class Site>
__global__ void __launch_bounds__(LN_WARPS * 32)
f32_layer_norm(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ y, long long rows, int C,
               float eps) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* xr = x + r * C;
  float s = 0.f, sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = xr[c];
    s += v;
    sq = fmaf(v, v, sq);
  }
  s = warp_sum(s);
  sq = warp_sum(sq);
  const float mean = s / C;
  const float inv = rsqrtf(sq / C - mean * mean + eps);
  float* yr = y + r * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = (xr[c] - mean) * inv * __ldg(scale + c) + __ldg(bias + c);
}

template <class Site>
int layer_norm_launch(const float* x, const float* scale, const float* bias, float* y,
                      long long rows, int C, float eps, cudaStream_t stream) {
  const long long blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  if (rows < 1 || C < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  f32_layer_norm<Site><<<static_cast<unsigned>(blocks), LN_WARPS * 32, 0, stream>>>(
      x, scale, bias, y, rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// The GEGLU feed-forward as two products: inner (rows, I) = GEGLU(h Win^T +
// b_in), then out = inner Wout^T + b_out, or resid + (inner Wout^T + b_out)
// where resid is given. h, resid, out (rows, C), w_in (2I, C) value rows
// first, w_out (C, I), contiguous.
template <class Site>
int geglu_launch(const float* h, const float* w_in, const float* b_in, const float* w_out,
                 const float* b_out, const float* resid, float* inner, float* out,
                 long long rows, int C, int I, cudaStream_t stream) {
  const int M = static_cast<int>(rows);
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int rc = gemm_launch<Site, EPI_GEGLU>(
      Gemm{h, C, w_in, C, b_in, nullptr, 0, inner, I, M, I, C}, stream);
  if (rc) return rc;
  const Gemm o{inner, I, w_out, I, b_out, resid, C, out, C, M, C, I};
  return resid ? gemm_launch<Site, EPI_BIAS_RESID>(o, stream)
               : gemm_launch<Site, EPI_BIAS>(o, stream);
}

}  // namespace f32
}  // namespace dvdx
