// The fused GEGLU feed-forward of one token tile, shared by geglu_ff.cu and
// the second launch of spatial_tail.cu and temporal_block.cu:
//   y = ((x Wv + bv) * gelu(x Wg + bg)) Wo + bo
// and, with RESID, out = resid + bf16(y) (the fused kernels' residual
// epilogue: the FF output bias is added in f32 before the one rounding).
//
// A block of GEGLU_THREADS (8 warps) owns BT = MT * 16 tokens and walks the
// inner dimension in chunks of GEGLU_BI. For each chunk the 8 warps compute
// the chunk's value and gate columns on the tensor cores (mma.sync m16n8k16,
// f32 accumulate), add the biases in f32, round value and gate to bf16
// (where the reference materialised them), apply the exact-erf GELU with
// CUDA's erff in f32, round the product to bf16 into shared memory, and
// multiply it into the output accumulator. The (BT x C) f32 accumulator
// lives in registers (MT * NT * 4 a thread) and is summed over the whole
// inner dimension inside the block: no cross-block reduction, no atomics, a
// fixed summation order.
//
// Weights use nn.Linear's layout: w_in (2I, C) with the value rows first,
// w_out (C, I); these are exactly the "col" B operands of mma.sync, read from
// global memory (L2-resident) as 32-bit pairs.
#pragma once

#include "common.cuh"

namespace dvdx {

constexpr int GEGLU_THREADS = 256;    // 8 warps
constexpr int GEGLU_BI = 64;          // inner columns per chunk
constexpr int GEGLU_HS = GEGLU_BI + 8;  // smem row stride of the gated tile

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// Token tile (MT m-tiles of 16) of a fused kernel's FF launch at C = NT * 64:
// the f32 accumulator is MT * NT * 4 registers a thread.
constexpr int geglu_fused_mt(int nt) { return nt <= 5 ? 4 : (nt <= 10 ? 2 : 1); }

// Dynamic shared memory of one block, in bytes.
template <int NT, int MT>
constexpr int geglu_smem_bytes() {
  return (MT * 16 * (NT * 64 + 8) + MT * 16 * GEGLU_HS) *
         static_cast<int>(sizeof(bf16));
}

// C = NT * 64 output columns (each warp owns NT n-tiles of 8), BT = MT * 16
// tokens from row blockIdx.x * BT. resid is read only when RESID.
template <int NT, int MT, bool RESID>
__device__ __forceinline__ void geglu_ff_tile(
    const bf16* __restrict__ x, const bf16* __restrict__ w_in,
    const bf16* __restrict__ b_in, const bf16* __restrict__ w_out,
    const bf16* __restrict__ b_out, const bf16* __restrict__ resid,
    bf16* __restrict__ out, int T, int I, unsigned char* smem_raw) {
  constexpr int C = NT * 64, BT = MT * 16, XS = C + 8;
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* h_s = x_s + BT * XS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = blockIdx.x * BT;

  for (int i = tid; i < BT * (C / 8); i += GEGLU_THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t0 + r < T)
      val = *reinterpret_cast<const uint4*>(x + (long long)(t0 + r) * C + c8);
    *reinterpret_cast<uint4*>(&x_s[r * XS + c8]) = val;
  }
  __syncthreads();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  for (int i0 = 0; i0 < I; i0 += GEGLU_BI) {
    // value/gate columns i0 + warp*8 .. +7 for all BT rows
    float va[MT][4], ga[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      va[mt][0] = va[mt][1] = va[mt][2] = va[mt][3] = 0.f;
      ga[mt][0] = ga[mt][1] = ga[mt][2] = ga[mt][3] = 0.f;
    }
    const int ic = i0 + warp * 8 + g;
    const bf16* wv = w_in + (long long)ic * C + 2 * t;
    const bf16* wg = w_in + (long long)(I + ic) * C + 2 * t;
#pragma unroll 4
    for (int kk = 0; kk < C; kk += 16) {
      const uint32_t bv0 = ld32(wv + kk), bv1 = ld32(wv + kk + 8);
      const uint32_t bg0 = ld32(wg + kk), bg1 = ld32(wg + kk + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* xr = &x_s[(mt * 16 + g) * XS + kk + 2 * t];
        uint32_t a[4] = {ld32(xr), ld32(xr + 8 * XS), ld32(xr + 8),
                         ld32(xr + 8 * XS + 8)};
        mma_16816(va[mt], a, bv0, bv1);
        mma_16816(ga[mt], a, bg0, bg1);
      }
    }
    const int col = i0 + warp * 8 + 2 * t;
    const float bv[2] = {__bfloat162float(b_in[col]),
                         __bfloat162float(b_in[col + 1])};
    const float bg[2] = {__bfloat162float(b_in[I + col]),
                         __bfloat162float(b_in[I + col + 1])};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float vv = bf16_round(va[mt][e] + bv[e & 1]);
        const float gg = bf16_round(ga[mt][e] + bg[e & 1]);
        hv[e] = vv * gelu_erf(gg);
      }
      bf16* hr = &h_s[(mt * 16 + g) * GEGLU_HS + warp * 8 + 2 * t];
      *reinterpret_cast<uint32_t*>(hr) = pack_bf16(hv[0], hv[1]);
      *reinterpret_cast<uint32_t*>(hr + 8 * GEGLU_HS) = pack_bf16(hv[2], hv[3]);
    }
    __syncthreads();

    // acc[:, warp's columns] += h (BT x 64) . Wo[:, i0:i0+64]^T
#pragma unroll
    for (int ks = 0; ks < GEGLU_BI / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* hr = &h_s[(mt * 16 + g) * GEGLU_HS + ks * 16 + 2 * t];
        a[mt][0] = ld32(hr);
        a[mt][1] = ld32(hr + 8 * GEGLU_HS);
        a[mt][2] = ld32(hr + 8);
        a[mt][3] = ld32(hr + 8 * GEGLU_HS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = (warp * NT + j) * 8 + g;
        const bf16* wo = w_out + (long long)c * I + i0 + ks * 16 + 2 * t;
        const uint32_t b0 = ld32(wo), b1 = ld32(wo + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][j], a[mt], b0, b1);
      }
    }
    __syncthreads();  // h_s is rewritten by the next chunk
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = (warp * NT + j) * 8 + 2 * t;
    const float bo0 = __bfloat162float(b_out[col]);
    const float bo1 = __bfloat162float(b_out[col + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = t0 + mt * 16 + g + 8 * half;
        if (row >= T) continue;
        const long long off = (long long)row * C + col;
        float y0 = acc[mt][j][2 * half] + bo0, y1 = acc[mt][j][2 * half + 1] + bo1;
        if (RESID) {
          y0 = __bfloat162float(resid[off]) + bf16_round(y0);
          y1 = __bfloat162float(resid[off + 1]) + bf16_round(y1);
        }
        *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(y0, y1);
      }
    }
  }
}

typedef void (*GegluKernelFn)(const bf16*, const bf16*, const bf16*,
                              const bf16*, const bf16*, const bf16*, bf16*,
                              int, int);

// Launch a kernel that runs geglu_ff_tile<NT, MT, ...> over T tokens, one
// block per BT-token tile. Returns the CUDA error code of the launch.
template <int NT, int MT>
int geglu_launch(GegluKernelFn kernel, const void* x, const void* w_in,
                 const void* b_in, const void* w_out, const void* b_out,
                 const void* resid, void* out, int T, int I,
                 cudaStream_t stream) {
  const int smem = geglu_smem_bytes<NT, MT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (T + MT * 16 - 1) / (MT * 16);
  kernel<<<grid, GEGLU_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
      static_cast<const bf16*>(b_in), static_cast<const bf16*>(w_out),
      static_cast<const bf16*>(b_out), static_cast<const bf16*>(resid),
      static_cast<bf16*>(out), T, I);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dvdx
