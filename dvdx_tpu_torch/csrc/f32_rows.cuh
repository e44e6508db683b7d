// Row-wise float32 pieces of the port's float32 kernels: a tiled product on
// the tensor cores with the fused kernels' epilogues, LayerNorm over rows,
// and the one float32 GEGLU feed-forward (geglu_ff.cu's float32 route and
// the FF of spatial_tail_f32.cu / temporal_block_f32.cu).
//
// The float32 forms compute what the TPU kernels compute for float32
// activations: every nn.Dense product accumulates in float32 and "rounds"
// to float32 (no rounding), so only the order of the sums differs from the
// plain PyTorch versions. The products run in three TF32 passes on the
// tensor cores (tf32_mma.cuh: the split x = big + small, what it drops,
// near float32's own rounding, and its 165 TFLOP/s peak on the H100).
//
// f32_gemm<Site, EPI, VEC>: out (M, N) = epilogue(A (M, K) B^T), B in
// nn.Linear's (N, K) layout, all row-major float32 with row strides lda /
// ldb / ldr / ldo, any M, N, K and alignment. A block of 8 warps takes 128
// rows against 128 rows of B (128 output columns, or 64 value and the same
// 64 gate columns for GEGLU), a warp 32 x 64 (two m16 by eight n8
// mma.sync.m16n8k8 tiles). K comes in slices of 32 through a 3-stage
// cp.async ring in shared memory (rows padded to 36 floats, so every
// fragment load hits 32 banks; 110.6 KB, one block an SM with up to 255
// registers a thread): 16-byte copies where A's and B's bases and row
// strides are 16-byte aligned (VEC), 4-byte copies otherwise (C = 30), the
// ragged edges zero-filled. Each warp splits its A and B fragments in
// registers (the weights are split in the kernel, not ahead of time: a
// stored small part would add a second copy of a float32 model's 7 GB of
// weights) and issues three mma.sync for each, chained over the slice's
// four k-steps into a slice accumulator that is then added to the running
// sum in f32 (tf32_mma.cuh: the tensor core truncates its sums). Every
// output sums its K slices in K order, the passes in a fixed order, with no
// split over K and no atomics, so a rerun gives the same bits. Bound on the H100 by operations at the UNet's
// widths: 2 M N K flops, three TF32 passes, at 495 TFLOP/s. Epilogues (the
// fused kernels' residual orders):
//   EPI_NONE        out = acc
//   EPI_BIAS        out = acc + bias             (geglu_ff's output product)
//   EPI_RESID_BIAS  out = (resid + acc) + bias   (the spatial tail's o1 / o2)
//   EPI_BIAS_RESID  out = resid + (acc + bias)   (the temporal block's o1 /
//                                                 o2, and the fused FF outputs)
//   EPI_GEGLU       B holds 2N rows, value rows first, bias 2N values:
//                   out = (acc_v + bv) * gelu_erf(acc_g + bg), exact erf,
//                   value and gate of one column in one thread
// ``Site`` only names the kernel for profilers (its demangled name carries
// the calling kernel's name).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace dvdx {
namespace f32 {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int LDS = BK + 4;  // padded shared row, floats
constexpr size_t GEMM_SMEM = sizeof(float) * STAGES * (BM + BN) * LDS;
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

template <class Site, int EPI, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) f32_gemm(const Gemm g) {
  constexpr bool GEGLU = EPI == EPI_GEGLU;
  constexpr int BN_OUT = GEGLU ? BN / 2 : BN;  // output columns of a block
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // [STAGES][BM + BN][LDS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 4 warps along M, 2 along N
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN_OUT;
  // shared row r of the B tile: row n0 + r of B, or for GEGLU value row
  // n0 + r (r < 64) and gate row N + n0 + r - 64
  auto b_row = [&](int r) -> long long {
    return GEGLU ? (r < BN_OUT ? n0 + r : (long long)g.N + n0 + r - BN_OUT) : n0 + r;
  };
  auto b_live = [&](int r) { return n0 + (GEGLU ? r % BN_OUT : r) < g.N; };

  // K slice kt into stage st: A rows m0.., B rows by b_row, columns kt*BK..
  auto load = [&](int st, int kt) {
    float* as = smem + st * (BM + BN) * LDS;
    float* bs = as + BM * LDS;
    const int k0 = kt * BK;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
        const int c = tid + i * THREADS, r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
        const int left = g.K - (k0 + kc);
        const int bytes = left <= 0 ? 0 : left >= 4 ? 16 : 4 * left;
        const bool a_in = m0 + r < g.M && bytes > 0;
        cp_async16(as + r * LDS + kc, a_in ? g.a + (m0 + r) * g.lda + k0 + kc : g.a,
                   a_in ? bytes : 0);
        const bool b_in = b_live(r) && bytes > 0;
        cp_async16(bs + r * LDS + kc, b_in ? g.b + b_row(r) * g.ldb + k0 + kc : g.b,
                   b_in ? bytes : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BM * BK / THREADS; ++i) {
        const int c = tid + i * THREADS, r = c / BK, kc = c % BK;
        const bool k_in = k0 + kc < g.K;
        const bool a_in = m0 + r < g.M && k_in;
        cp_async4(as + r * LDS + kc, a_in ? g.a + (m0 + r) * g.lda + k0 + kc : g.a,
                  a_in ? 4 : 0);
        const bool b_in = b_live(r) && k_in;
        cp_async4(bs + r * LDS + kc, b_in ? g.b + b_row(r) * g.ldb + k0 + kc : g.b,
                  b_in ? 4 : 0);
      }
    }
  };

  float acc[2][8][4], part[2][8][4];  // the running sums, one slice's chains
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = part[mi][ni][c] = 0.f;
  // the warp's n8 tiles: rows of the B tile (GEGLU: four value tiles, then
  // the same columns' four gate tiles)
  auto b_tile_row = [&](int ni) {
    return GEGLU ? (ni < 4 ? wn * 32 + ni * 8 : BN_OUT + wn * 32 + (ni - 4) * 8)
                 : wn * 64 + ni * 8;
  };

  const int KT = (g.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt is in; slice kt - 1's stage is consumed
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* as = smem + (kt % STAGES) * (BM + BN) * LDS;
    const float* bs = as + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t ab[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tf32_split(as[(wm * 32 + mi * 16 + gq + (i & 1) * 8) * LDS + kk * 8 + t +
                        (i >> 1) * 4],
                     ab[mi][i], al[mi][i]);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t b0, b1, b0l, b1l;
        b_frag(bs + (b_tile_row(ni) + gq) * LDS + kk * 8 + t, 4, b0, b1, b0l, b1l);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_3xtf32(part[mi][ni], ab[mi], al[mi], b0, b1, b0l, b1l);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[mi][ni][c] += part[mi][ni][c];
          part[mi][ni][c] = 0.f;
        }
  }

  // acc[mi][ni][c]: row wm*32 + mi*16 + gq + 8*(c >= 2), column of n8 tile
  // ni at 2t + (c & 1)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long r = m0 + wm * 32 + mi * 16 + gq + (c >> 1) * 8;
      if (r >= g.M) continue;
#pragma unroll
      for (int ni = 0; ni < (GEGLU ? 4 : 8); ++ni) {
        const int n = n0 + b_tile_row(ni) + 2 * t + (c & 1);
        if (n >= g.N) continue;
        const float a = acc[mi][ni][c];
        float o = a;
        if (EPI == EPI_GEGLU) {
          o = (a + __ldg(g.bias + n)) * gelu_erf(acc[mi][ni + 4][c] + __ldg(g.bias + g.N + n));
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

template <class Site, int EPI, bool VEC>
int gemm_run(const Gemm& g, dim3 grid, cudaStream_t stream) {
  auto kernel = f32_gemm<Site, EPI, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(GEMM_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, THREADS, GEMM_SMEM, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// M row tiles in gridDim.x, N column tiles in gridDim.y; 16-byte copies
// where A's and B's bases and row strides allow them.
template <class Site, int EPI>
int gemm_launch(const Gemm& g, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || g.K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bn_out = EPI == EPI_GEGLU ? BN / 2 : BN;
  const dim3 grid(static_cast<unsigned>((g.M + BM - 1) / BM), (g.N + bn_out - 1) / bn_out);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = g.lda % 4 == 0 && g.ldb % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.a) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(g.b) & 15) == 0;
  return vec ? gemm_run<Site, EPI, true>(g, grid, stream)
             : gemm_run<Site, EPI, false>(g, grid, stream);
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
