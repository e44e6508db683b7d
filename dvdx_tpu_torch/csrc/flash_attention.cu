// Non-causal flash attention over (B, S, H, D) bf16, f32 online softmax.
//
// Replaces dvdx_tpu/ops/pallas/flash_attention.py:flash_attention
// (_onepass_kernel / _flash_kernel) and flash_attention_mh
// (_onepass_mh_kernel / _flash_mh_kernel): the key length Sk may differ from
// the query length (cross-attention), every operand and the output are
// addressed by strides (the mh entry point passes the first head_dim lanes of
// each 128-lane head strip), and q may be scaled and rounded to bf16 before
// QK^T (q_scale; the mh kernels' order) instead of scaling the logits.
// One block per (query tile of 64 rows,
// batch*head); 4 warps own 16 query rows each. Q/K/V are read straight from
// the (B, S, H, D) layout by strides (no head-major copies). K and V^T tiles
// of 64 keys are staged in shared memory; QK^T and P.V run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate). Logits are scaled in
// f32, the ragged key tail is masked at -1e30, the running max / row sum are
// f32, and P is rounded to bf16 before P.V (the reference's cast of the
// probabilities to V's dtype). Fixed launch shape, no atomics: bit-exact
// re-execution.
//
// Bound on the H100: at the UNet's spatial shapes (S=2880/720, D=64) the
// 4*S^2*D flops per head dominate the 4*S*D*2 bytes moved, so the kernel is
// bounded by tensor-core operations; this first version uses mma.sync with
// synchronous tile loads (no wgmma/TMA pipeline).
#include "common.cuh"

using namespace dvdx;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;

template <int DP>  // head dim rounded up to a multiple of 16
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int H, int S,
          int Sk, int D, long long qsb, long long qss, long long qsh,
          long long ksb, long long kss, long long ksh, long long vsb,
          long long vss, long long vsh, long long osb, long long oss,
          long long osh, float q_scale, float scale) {
  constexpr int KSTR = DP + 8;  // smem row strides (bf16), conflict-free
  constexpr int VSTR = BK + 8;
  __shared__ __align__(16) bf16 k_s[BK * KSTR];
  __shared__ __align__(16) bf16 vt_s[DP * VSTR];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j & 1) ? r1 : r0;
      const int col = ks * 16 + 2 * t + ((j & 2) ? 8 : 0);
      qa[ks][j] = (row < S && col < D)
                      ? scale_bf16x2(ld32(qb + row * qss + col), q_scale)
                      : 0u;
    }
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * (DP / 8); i += THREADS) {
      const int r = i / (DP / 8), c8 = (i % (DP / 8)) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < Sk && c8 < D) {
        kv = *reinterpret_cast<const uint4*>(kb + key * kss + c8);
        vv = *reinterpret_cast<const uint4*>(vb + key * vss + c8);
      }
      *reinterpret_cast<uint4*>(&k_s[r * KSTR + c8]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(c8 + j) * VSTR + r] = ve[j];
    }
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const bf16* kr = &k_s[(nt * 8 + g) * KSTR + ks * 16 + 2 * t];
        mma_16816(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = key < Sk ? s[nt][e] * scale : -1e30f;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_run[e >> 1]);
        rowsum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const bf16* vr = &vt_s[(dt * 8 + g) * VSTR + kk * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (col >= D) continue;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
          pack_bf16(acc[dt][0] / l_run[0], acc[dt][1] / l_run[0]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * oss + col) =
          pack_bf16(acc[dt][2] / l_run[1], acc[dt][3] / l_run[1]);
  }
}

template <int DP>
void launch(const void* q, const void* k, const void* v, void* o, int B, int H,
            int S, int Sk, int D, const long long* qs, const long long* ks,
            const long long* vs, const long long* os, float q_scale,
            float scale, cudaStream_t stream) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd<DP><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, S, Sk, D, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os[0], os[1],
      os[2], q_scale, scale);
}

}  // namespace

// Strides are in elements for the (b, s, h) axes of q, k, v and the output;
// the d axis is contiguous. q has S rows, k and v have Sk. D must be a
// multiple of 8 and at most 128 (checked by the wrapper). q_scale == 1 leaves
// q as it is.
extern "C" int dvdx_flash_attention(const void* q, const void* k, const void* v,
                                    void* o, int B, int H, int S, int Sk, int D,
                                    long long qsb, long long qss, long long qsh,
                                    long long ksb, long long kss, long long ksh,
                                    long long vsb, long long vss, long long vsh,
                                    long long osb, long long oss, long long osh,
                                    float q_scale, float scale, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh}, os[3] = {osb, oss, osh};
  if (B * H > 65535 || Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DVDX_FLASH_CASE(n, dp)                                                 \
  case n:                                                                      \
    launch<dp>(q, k, v, o, B, H, S, Sk, D, qs, ks, vs, os, q_scale, scale, st); \
    break;
  switch ((D + 15) / 16) {
    DVDX_FLASH_CASE(1, 16)
    DVDX_FLASH_CASE(2, 32)
    DVDX_FLASH_CASE(3, 48)
    DVDX_FLASH_CASE(4, 64)
    DVDX_FLASH_CASE(5, 80)
    DVDX_FLASH_CASE(6, 96)
    DVDX_FLASH_CASE(7, 112)
    DVDX_FLASH_CASE(8, 128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DVDX_FLASH_CASE
  return static_cast<int>(cudaGetLastError());
}
