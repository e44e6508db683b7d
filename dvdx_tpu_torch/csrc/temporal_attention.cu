// Frame-axis (temporal) multi-head attention: for every (batch, spatial
// position, head) an F x F softmax attention over the frames.
//
// Replaces dvdx_tpu/ops/pallas/temporal_attention.py:
// temporal_attention_posmajor (_temporal_kernel_pm), temporal_attention_fm
// (_temporal_kernel_fm) and temporal_attention (_temporal_kernel). The TPU
// kernels pack W positions block-diagonally into 128-row MXU tiles; here a
// block simply owns one (position, head) unit, so no packing masks exist.
// Layout is given by strides: element (b, f, n, h*D + d) lives at
// b*sb + f*sf + n*sn + h*D + d, which covers the position-major
// (B, N, F, H*D) and frame-major (B, F, N, H*D) entry points alike.
//
// Numerics follow temporal_attention_reference: f32 logits (fixed-order dot
// products), f32 softmax (exp(x - max) / sum), probabilities rounded to bf16,
// f32 P.V, bf16 output. No atomics, fixed launch shape.
//
// Bound on the H100: 4*F^2*D flops per unit against 4*F*D*2 bytes, i.e.
// ~F/2 flops per byte -- far below the card's ~295 flop/byte balance, so the
// kernel is bounded by bytes; the design keeps every logit in shared memory
// and reads each input once.
#include "common.cuh"

using namespace dvdx;

namespace {

constexpr int FMAX = 32;
constexpr int DMAX = 128;
constexpr int DS = DMAX + 8;  // smem row stride (bf16)
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
temporal_attn(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int F, int D,
              long long sb, long long sf, long long sn, long long osb,
              long long osf, long long osn, float scale) {
  __shared__ __align__(16) bf16 q_s[FMAX * DS];
  __shared__ __align__(16) bf16 k_s[FMAX * DS];
  __shared__ __align__(16) bf16 v_s[FMAX * DS];
  __shared__ float p_s[FMAX][FMAX + 1];

  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long base = b * sb + n * sn + (long long)h * D;
  const int chunks = D / 8;
  for (int i = tid; i < F * chunks; i += THREADS) {
    const int f = i / chunks, c8 = (i % chunks) * 8;
    const long long off = base + f * sf + c8;
    *reinterpret_cast<uint4*>(&q_s[f * DS + c8]) =
        *reinterpret_cast<const uint4*>(q + off);
    *reinterpret_cast<uint4*>(&k_s[f * DS + c8]) =
        *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(&v_s[f * DS + c8]) =
        *reinterpret_cast<const uint4*>(v + off);
  }
  __syncthreads();

  for (int i = tid; i < F * F; i += THREADS) {
    const int fi = i / F, fj = i % F;
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(__bfloat162float(q_s[fi * DS + d]),
                 __bfloat162float(k_s[fj * DS + d]), acc);
    p_s[fi][fj] = acc * scale;
  }
  __syncthreads();

  if (tid < F) {
    float m = -INFINITY;
    for (int j = 0; j < F; ++j) m = fmaxf(m, p_s[tid][j]);
    float sum = 0.f;
    for (int j = 0; j < F; ++j) {
      const float e = expf(p_s[tid][j] - m);
      p_s[tid][j] = e;
      sum += e;
    }
    for (int j = 0; j < F; ++j) p_s[tid][j] = bf16_round(p_s[tid][j] / sum);
  }
  __syncthreads();

  const long long obase = b * osb + n * osn + (long long)h * D;
  for (int i = tid; i < F * D; i += THREADS) {
    const int fi = i / D, d = i % D;
    float acc = 0.f;
    for (int j = 0; j < F; ++j)
      acc = fmaf(p_s[fi][j], __bfloat162float(v_s[j * DS + d]), acc);
    o[obase + fi * osf + d] = __float2bfloat16(acc);
  }
}

}  // namespace

// q/k/v share the strides (sb, sf, sn); the output has (osb, osf, osn).
// Requires F <= 32, D <= 128, D % 8 == 0 and 16-byte aligned rows
// (checked by the wrapper).
extern "C" int dvdx_temporal_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int F,
                                       int N, int H, int D, long long sb,
                                       long long sf, long long sn,
                                       long long osb, long long osf,
                                       long long osn, float scale,
                                       void* stream) {
  if (F > FMAX || D > DMAX || D % 8 != 0 || N > 2147483647 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(N, H, B);
  temporal_attn<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), F, D, sb, sf, sn,
      osb, osf, osn, scale);
  return static_cast<int>(cudaGetLastError());
}
