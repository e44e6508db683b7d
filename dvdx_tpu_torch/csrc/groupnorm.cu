// GroupNorm (+ per-sample channel pre-bias) (+ SiLU) over (N, L, C) bf16.
//
// Replaces dvdx_tpu/ops/groupnorm.py:group_norm_act (_gn_pallas / _gn_kernel).
// The TPU kernel holds one whole (L, C) row in VMEM; the H100 has 227 KB of
// shared memory per block and the UNet's rows reach 29 MB ((2, 46080, 320)
// in the temporal transformer's norm), so statistics are reduced in a
// deterministic two-phase form instead:
//   1. gn_partial: one block per (sample, chunk of 64 rows) sums x + bias and
//      (x + bias)^2 per channel in f32 (threads on consecutive channels,
//      rows in order), then per group (channels in order) -> partials.
//   2. gn_finalize: one thread per (sample, group) adds the chunk partials in
//      chunk order -> mean, rstd (one-pass moments, variance clamped at 0).
//   3. gn_apply: one block per (sample, chunk) normalises, applies the
//      affine and the optional SiLU, and writes bf16.
// Every sum has a fixed order and there are no atomics, so reruns are
// bit-identical. Bound on the H100: ~2 f32 ops per element read against 2+2
// bytes, so the kernel is bounded by bytes; the input is read twice (once per
// phase) and written once.
#include "common.cuh"

using namespace dvdx;

namespace {

constexpr int ROWS = 64;  // rows per chunk
constexpr int THREADS = 256;
constexpr int MAXC = 2560;  // widest GN input: the UNet's 1280+1280 skip concat

__global__ void __launch_bounds__(THREADS)
gn_partial(const bf16* __restrict__ x, const bf16* __restrict__ bias,
           float* __restrict__ part, int L, int C, int G, int nchunks) {
  __shared__ float csum[MAXC];
  __shared__ float csq[MAXC];
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int l0 = chunk * ROWS, l1 = min(L, l0 + ROWS);
  const bf16* xn = x + (long long)n * L * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float bc = bias ? __bfloat162float(bias[(long long)n * C + c]) : 0.f;
    float s = 0.f, s2 = 0.f;
    for (int l = l0; l < l1; ++l) {
      const float xv = __bfloat162float(xn[(long long)l * C + c]) + bc;
      s += xv;
      s2 = fmaf(xv, xv, s2);
    }
    csum[c] = s;
    csq[c] = s2;
  }
  __syncthreads();
  const int cpg = C / G;
  for (int gi = threadIdx.x; gi < G; gi += THREADS) {
    float s = 0.f, s2 = 0.f;
    for (int c = gi * cpg; c < (gi + 1) * cpg; ++c) {
      s += csum[c];
      s2 += csq[c];
    }
    float* p = part + (((long long)n * nchunks + chunk) * G + gi) * 2;
    p[0] = s;
    p[1] = s2;
  }
}

__global__ void gn_finalize(const float* __restrict__ part,
                            float* __restrict__ stats, int G, int nchunks,
                            float count, float eps) {
  const int n = blockIdx.x;
  for (int gi = threadIdx.x; gi < G; gi += blockDim.x) {
    float s = 0.f, s2 = 0.f;
    for (int ch = 0; ch < nchunks; ++ch) {
      const float* p = part + (((long long)n * nchunks + ch) * G + gi) * 2;
      s += p[0];
      s2 += p[1];
    }
    const float mean = s / count;
    const float var = fmaxf(s2 / count - mean * mean, 0.f);
    stats[(n * G + gi) * 2] = mean;
    stats[(n * G + gi) * 2 + 1] = rsqrtf(var + eps);
  }
}

__global__ void __launch_bounds__(THREADS)
gn_apply(const bf16* __restrict__ x, const bf16* __restrict__ bias,
         const float* __restrict__ gamma, const float* __restrict__ beta,
         const float* __restrict__ stats, bf16* __restrict__ y, int L, int C,
         int G, int silu) {
  __shared__ float scale_c[MAXC];
  __shared__ float shift_c[MAXC];
  __shared__ float bias_c[MAXC];
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int cpg = C / G;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const int gi = c / cpg;
    const float mean = stats[(n * G + gi) * 2];
    const float rstd = stats[(n * G + gi) * 2 + 1];
    const float sc = rstd * gamma[c];
    scale_c[c] = sc;
    shift_c[c] = beta[c] - mean * sc;
    bias_c[c] = bias ? __bfloat162float(bias[(long long)n * C + c]) : 0.f;
  }
  __syncthreads();
  const int l0 = chunk * ROWS, l1 = min(L, l0 + ROWS);
  const long long e0 = ((long long)n * L + l0) * C;
  const int count = (l1 - l0) * C;
  for (int i = threadIdx.x; i < count; i += THREADS) {
    const int c = i % C;
    const float xi = __bfloat162float(x[e0 + i]) + bias_c[c];
    float v = xi * scale_c[c] + shift_c[c];
    if (silu) v = v * (1.f / (1.f + expf(-v)));
    y[e0 + i] = __float2bfloat16(v);
  }
}

}  // namespace

// x, y: (N, L, C) contiguous bf16; bias: (N, C) bf16 or null; gamma, beta:
// (C) f32; part: (N, ceil(L/64), G, 2) f32 scratch; stats: (N, G, 2) f32
// scratch. C <= 2560 and C % G == 0 (checked by the wrapper).
extern "C" int dvdx_group_norm(const void* x, const void* bias,
                               const void* gamma, const void* beta, void* y,
                               void* part, void* stats, int N, int L, int C,
                               int G, float eps, int silu, void* stream) {
  if (C > MAXC || C % G != 0 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (L + ROWS - 1) / ROWS;
  dim3 grid(nchunks, N);
  gn_partial<<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(bias),
      static_cast<float*>(part), L, C, G, nchunks);
  gn_finalize<<<N, 128, 0, st>>>(static_cast<const float*>(part),
                                  static_cast<float*>(stats), G, nchunks,
                                  static_cast<float>(L) * (C / G), eps);
  gn_apply<<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(stats), static_cast<bf16*>(y), L, C, G, silu);
  return static_cast<int>(cudaGetLastError());
}
