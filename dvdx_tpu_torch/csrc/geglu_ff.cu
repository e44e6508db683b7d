// GEGLU feed-forward: y = ((x Wv + bv) * gelu(x Wg + bg)) Wo + bo.
//
// Replaces dvdx_tpu/ops/pallas/geglu_ff.py:geglu_ff (_geglu_kernel). The
// TPU kernel keeps the 8x-width inner tensor in VMEM; here it goes through
// device memory between two wgmma products with fused epilogues
// (geglu_gemm.cuh: geglu_in writes h = GEGLU(x), geglu_out reads it back),
// because on the H100 those bytes cost a fraction of the products' bound and
// the split lets both products run 128-row tiles at every width.
//
// Bound on the H100: 6*T*C*I flops against (2*T*C + 3*C*I)*2 bytes; at the
// UNet's token counts (>= 1440 tokens) the operations dominate, so the work
// is bounded by tensor-core operations.
//
// The wgmma products take bf16 with C % 64 == 0 and I % 128 == 0. Every other
// input the Pallas kernel takes runs on the CUDA cores, bound there by f32
// operations: float32 (the float32 models) through the port's one float32
// GEGLU, f32_rows.cuh's two tiled products (dvdx_geglu_f32); bf16 at any
// other width (zeroscope-tiny's C = 32) through a second pair below
// (geglu_ff_simt_in / _out), 64 x 64 output tiles of 256 threads, 4 x 4
// outputs a thread, K in slices of 16 through shared memory, f32
// accumulation in K order, the wgmma pair's epilogues and bf16 rounding
// points.
#include "f32_rows.cuh"
#include "geglu_gemm.cuh"

using namespace dvdx;

namespace {
struct geglu_ff_site {};

constexpr int SIMT_TILE = 64, SIMT_K = 16, SIMT_THREADS = 256;

// rows [r0, r0 + 64) x K slice [k0, k0 + 16) of a (rows, K) row-major
// matrix into dst[k][row] as f32, zeros past the edges
__device__ __forceinline__ void simt_tile(float (*dst)[SIMT_TILE + 4], const bf16* src,
                                          int rows, int K, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < SIMT_TILE * SIMT_K / SIMT_THREADS; ++i) {
    const int e = threadIdx.x + i * SIMT_THREADS;
    const int r = e / SIMT_K, k = e % SIMT_K;
    dst[k][r] = (r0 + r < rows && k0 + k < K)
                    ? __bfloat162float(src[(long long)(r0 + r) * K + k0 + k])
                    : 0.f;
  }
}

// h (T, I) = bf16(bf16(x Wv + bv) * gelu(bf16(x Wg + bg))): x (T, C),
// w_in (2I, C) value rows first, b_in (2I). Block (column tile, row tile).
__global__ void __launch_bounds__(SIMT_THREADS)
geglu_ff_simt_in(const bf16* x, const bf16* w_in, const bf16* b_in, bf16* h, int rows, int C,
                 int I) {
  __shared__ float xs[SIMT_K][SIMT_TILE + 4], vs[SIMT_K][SIMT_TILE + 4],
      gs[SIMT_K][SIMT_TILE + 4];
  const int r0 = blockIdx.y * SIMT_TILE, n0 = blockIdx.x * SIMT_TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float av[4][4] = {}, ag[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += SIMT_K) {
    simt_tile(xs, x, rows, C, r0, k0);
    simt_tile(vs, w_in, I, C, n0, k0);
    simt_tile(gs, w_in + (long long)I * C, I, C, n0, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SIMT_K; ++k) {
      float a[4], bv[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[k][ty * 4 + i];
        bv[i] = vs[k][tx * 4 + i];
        bg[i] = gs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          av[i][j] = fmaf(a[i], bv[j], av[i][j]);
          ag[i][j] = fmaf(a[i], bg[j], ag[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= I) continue;
    const float bv = __bfloat162float(b_in[n]), bg = __bfloat162float(b_in[I + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r >= rows) continue;
      const float v = bf16_round(av[i][j] + bv), g = bf16_round(ag[i][j] + bg);
      h[(long long)r * I + n] = __float2bfloat16(v * gelu_erf(g));
    }
  }
}

// out (T, C) = bf16(h Wo^T + bo): h (T, I), w_out (C, I), b_out (C).
__global__ void __launch_bounds__(SIMT_THREADS)
geglu_ff_simt_out(const bf16* h, const bf16* w_out, const bf16* b_out, bf16* out, int rows,
                  int C, int I) {
  __shared__ float hs[SIMT_K][SIMT_TILE + 4], ws[SIMT_K][SIMT_TILE + 4];
  const int r0 = blockIdx.y * SIMT_TILE, n0 = blockIdx.x * SIMT_TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < I; k0 += SIMT_K) {
    simt_tile(hs, h, rows, I, r0, k0);
    simt_tile(ws, w_out, C, I, n0, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SIMT_K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = hs[k][ty * 4 + i];
        b[i] = ws[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= C) continue;
    const float bo = __bfloat162float(b_out[n]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r < rows) out[(long long)r * C + n] = __float2bfloat16(acc[i][j] + bo);
    }
  }
}
}  // namespace

// x (T, C), w_in (2I, C), b_in (2I), h (T, I); all contiguous bf16.
// C % 64 == 0, I % 128 == 0.
extern "C" int dvdx_geglu_in(const void* x, const void* w_in, const void* b_in,
                             void* h, int T, int C, int I, void* stream) {
  return geglu_in_launch<geglu_ff_site>(x, w_in, b_in, h, T, C, I,
                                        static_cast<cudaStream_t>(stream));
}

// h (T, I), w_out (C, I), b_out (C), resid (T, C) or null, out (T, C); all
// contiguous bf16. C % 64 == 0, I % 64 == 0.
extern "C" int dvdx_geglu_out(const void* h, const void* w_out, const void* b_out,
                              const void* resid, void* out, int T, int C, int I,
                              void* stream) {
  return geglu_out_launch<geglu_ff_site>(h, w_out, b_out, resid, out, T, C, I,
                                         static_cast<cudaStream_t>(stream));
}

// The CUDA-core pair at bf16: x (T, C), w_in (2I, C), b_in (2I), h (T, I)
// scratch, w_out (C, I), b_out (C), out (T, C); all contiguous bf16. Any T,
// C, I >= 1; row tiles in gridDim.y (T < 2^22).
extern "C" int dvdx_geglu_simt(const void* x, const void* w_in, const void* b_in, void* h,
                               const void* w_out, const void* b_out, void* out, int T,
                               int C, int I, void* stream) {
  if (T < 1 || C < 1 || I < 1 || (T + SIMT_TILE - 1) / SIMT_TILE > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(SIMT_THREADS);
  const int row_tiles = (T + SIMT_TILE - 1) / SIMT_TILE;
  geglu_ff_simt_in<<<dim3((I + SIMT_TILE - 1) / SIMT_TILE, row_tiles), block, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_in),
      static_cast<const bf16*>(b_in), static_cast<bf16*>(h), T, C, I);
  geglu_ff_simt_out<<<dim3((C + SIMT_TILE - 1) / SIMT_TILE, row_tiles), block, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w_out),
      static_cast<const bf16*>(b_out), static_cast<bf16*>(out), T, C, I);
  return static_cast<int>(cudaGetLastError());
}

// The float32 route: the same operands in float32 through f32_rows.cuh's
// GEGLU (two tiled products, the bias epilogue on the second). Any T, C, I
// >= 1 with I / 64 <= 65535.
extern "C" int dvdx_geglu_f32(const void* x, const void* w_in, const void* b_in, void* h,
                              const void* w_out, const void* b_out, void* out, int T, int C,
                              int I, void* stream) {
  if (T < 1 || C < 1 || I < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return dvdx::f32::geglu_launch<geglu_ff_site>(
      f(x), f(w_in), f(b_in), f(w_out), f(b_out), nullptr, static_cast<float*>(h),
      static_cast<float*>(out), T, C, I, static_cast<cudaStream_t>(stream));
}
