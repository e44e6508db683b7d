// Fused spatial transformer tail: everything of a BasicTransformerBlock after
// attn1's P.V output, per token row:
//   x1  = (x + bf16(o1 Wo1^T)) + b_o1
//   h   = LN2(x1);  q = bf16(h Wq2^T)
//   ao  = bf16(bf16(softmax_T(q k^T * scale)) v)   per head, over T context
//         tokens whose K/V projections (ctx_k, ctx_v) are computed outside
//   x2  = (x1 + bf16(ao Wo2^T)) + b_o2
//   out = x2 + bf16(GEGLU(LN3(x2)) + b_ffo)   (FF output bias added in f32)
//
// Replaces dvdx_tpu/ops/pallas/spatial_tail.py:fused_spatial_tail (both
// bodies: _tail_kernel, weights VMEM-resident at C <= 384, and
// _tail_kernel_streamed, the GEGLU pair streamed at C <= 768), with the TPU
// kernel's rounding order: the residual is added before the bias, unlike the
// unfused branch's x + (mm + b).
//
// Bound on the H100: 2*rows*(3*HD*C + 2*T*HD + 12*C^2) flops against reading
// x, o1, the weights and the context K/V once and writing out once; at the
// UNet's level 0 (92160 rows, C = 320) the GEGLU pair's products dominate,
// so the work is bounded by tensor-core operations.
//
// Design (simple and right first). The weights (about 2.9 MB at C = 320) do
// not fit the 227 KB of shared memory, so they are streamed from L2 as
// mma.sync B fragments, as in geglu_ff. Two launches, nothing between them:
//  (a) spatial_tail_chain: a block owns 32 rows, holds x, the LN outputs and
//      q / the attention output in shared memory as bf16, and runs the chain
//      up to LN3 on the tensor cores (the out-projections and q as row-tile
//      products; the T-token cross-attention one warp per (head, 16 rows),
//      two sweeps over 64-token chunks, see cross_attention), then writes x2
//      and h = LN3(x2) in bf16;
//  (b) spatial_tail_ff: geglu_body.cuh's GEGLU tile with the residual
//      epilogue, reading h and x2. The (rows x C) f32 FF accumulator would
//      not fit the chain kernel's registers next to its tiles, which is why
//      the TPU kernel's own streamed variant splits at the same place.
// Fixed launch shapes, fixed summation orders, no atomics: bit-exact
// re-execution.
#include "fused_rows.cuh"
#include "geglu_body.cuh"

using namespace dvdx;

namespace {

constexpr int MAX_DIM = 768;
constexpr int MAX_CTX = 512;

constexpr int XCHUNK = 64;  // context tokens per sweep step (8 n-tiles)

// Logits of a warp's 16 query rows (A fragments qa) against context tokens
// t0 .. t0 + 63 of one head (kb: token rows of stride HD), scaled in f32;
// tokens past T are -inf.
template <int D>
__device__ __forceinline__ void chunk_logits(float (&s)[8][4],
                                             const uint32_t (&qa)[D / 16][4],
                                             const bf16* kb, int t0, int T,
                                             int HD, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int tok = t0 + nt * 8 + g;
    const bf16* kr = kb + (long long)tok * HD + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t b0 = tok < T ? ld32(kr + ks * 16) : 0u;
      const uint32_t b1 = tok < T ? ld32(kr + ks * 16 + 8) : 0u;
      mma_16816(s[nt], qa[ks], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = t0 + nt * 8 + 2 * tq + (e & 1) < T ? s[nt][e] * scale : -INFINITY;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_pair(const bf16* p, long long stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

// softmax(q k^T * scale) v over the T context tokens for the tile's rows:
// one warp per (head, 16-row m-tile), mma.sync for Q K^T and P V. A first
// sweep over 64-token chunks finds each row's max and sum of exp(s - max)
// in f32; a second forms P = bf16(exp(s - max) / sum) (the probabilities
// normalised, then rounded, as the reference does) and accumulates P V in
// f32. Rows of an m-tile that belong to different images (S % 16 != 0) are
// run once per image against that image's K / V, each row kept from its
// own. The result, rounded to bf16, overwrites the head's q columns.
template <int D>
__device__ void cross_attention(bf16* qs, int ldq, const bf16* __restrict__ ctx_k,
                                const bf16* __restrict__ ctx_v, long long r0,
                                int n_rows, int S, int T, int HD, int heads,
                                float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  for (int item = warp; item < 2 * heads; item += FUSED_THREADS / 32) {
    const int h = item >> 1, rb = (item & 1) * 16;
    if (rb >= n_rows) continue;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* qr = qs + (rb + g) * ldq + h * D + ks * 16 + 2 * tq;
      qa[ks][0] = ld32(qr);
      qa[ks][1] = ld32(qr + 8 * ldq);
      qa[ks][2] = ld32(qr + 8);
      qa[ks][3] = ld32(qr + 8 * ldq + 8);
    }
    const long long n_lo = (r0 + rb) / S;
    const long long n_hi = (r0 + min(rb + 15, n_rows - 1)) / S;
    for (long long n = n_lo; n <= n_hi; ++n) {
      const bf16* kb = ctx_k + n * T * HD + h * D;
      const bf16* vb = ctx_v + n * T * HD + h * D;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float s[8][4];
      for (int t0 = 0; t0 < T; t0 += XCHUNK) {
        chunk_logits<D>(s, qa, kb, t0, T, HD, scale);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
          const float m_new = fmaxf(m[r], quad_max(mx));
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            sum += expf(s[nt][2 * r] - m_new) + expf(s[nt][2 * r + 1] - m_new);
          l[r] = l[r] * expf(m[r] - m_new) + quad_sum(sum);
          m[r] = m_new;
        }
      }
      float acc[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
      for (int t0 = 0; t0 < T; t0 += XCHUNK) {
        chunk_logits<D>(s, qa, kb, t0, T, HD, scale);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = expf(s[nt][e] - m[e >> 1]) / l[e >> 1];
#pragma unroll
        for (int kk = 0; kk < XCHUNK / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const int tok = t0 + kk * 16 + 2 * tq;
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            const bf16* vr = vb + (long long)tok * HD + dt * 8 + g;
            const uint32_t b0 = tok + 1 < T ? pack_pair(vr, HD)
                                : (tok < T ? pack_pair(vr, 0) & 0xffffu : 0u);
            const uint32_t b1 = tok + 9 < T ? pack_pair(vr + 8 * HD, HD)
                                : (tok + 8 < T ? pack_pair(vr + 8 * HD, 0) & 0xffffu : 0u);
            mma_16816(acc[dt], pa, b0, b1);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rb + g + 8 * half;
        if (row >= n_rows || (r0 + row) / S != n) continue;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(qs + row * ldq + h * D + dt * 8 + 2 * tq) =
              pack_bf16(acc[dt][2 * half], acc[dt][2 * half + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(FUSED_THREADS)
spatial_tail_chain(const bf16* __restrict__ x, const bf16* __restrict__ o1,
                   const bf16* __restrict__ ctx_k,
                   const bf16* __restrict__ ctx_v,
                   const bf16* __restrict__ o1_w, const bf16* __restrict__ o1_b,
                   const bf16* __restrict__ ln2_s,
                   const bf16* __restrict__ ln2_b,
                   const bf16* __restrict__ q2_w, const bf16* __restrict__ o2_w,
                   const bf16* __restrict__ o2_b,
                   const bf16* __restrict__ ln3_s,
                   const bf16* __restrict__ ln3_b, bf16* __restrict__ x2_out,
                   bf16* __restrict__ h_out, int rows, int S, int C, int HD1,
                   int HD, int T, int heads, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = C + 8, ldh = max(C, HD1) + 8, ldq = HD + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + FUSED_ROWS * ldx;
  bf16* qs = hs + FUSED_ROWS * ldh;

  const long long r0 = (long long)blockIdx.x * FUSED_ROWS;
  const int n_rows = (int)min((long long)FUSED_ROWS, rows - r0);

  rows_load(xs, ldx, C, n_rows, [&](int r) { return x + (r0 + r) * C; });
  rows_load(hs, ldh, HD1, n_rows, [&](int r) { return o1 + (r0 + r) * HD1; });
  __syncthreads();

  // x1 = (x + bf16(o1 Wo1^T)) + b_o1
  rows_gemm(hs, ldh, o1_w, C, HD1, [&](int r, int c, float v0, float v1) {
    bf16* p = xs + r * ldx + c;
    p[0] = __float2bfloat16(resid_then_bias(__bfloat162float(p[0]), v0,
                                            __bfloat162float(o1_b[c])));
    p[1] = __float2bfloat16(resid_then_bias(__bfloat162float(p[1]), v1,
                                            __bfloat162float(o1_b[c + 1])));
  });
  __syncthreads();
  rows_layernorm(xs, ldx, hs, ldh, C, FUSED_ROWS, ln2_s, ln2_b, eps);
  __syncthreads();
  // q = bf16(h Wq2^T)
  rows_gemm(hs, ldh, q2_w, HD, C, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(qs + r * ldq + c) = pack_bf16(v0, v1);
  });
  __syncthreads();

  // cross-attention on the tensor cores; the output overwrites q
  const int d = HD / heads;
#define DVDX_XATTN_CASE(dd)                                                  \
  case dd:                                                                   \
    cross_attention<dd>(qs, ldq, ctx_k, ctx_v, r0, n_rows, S, T, HD, heads, \
                        scale);                                              \
    break;
  switch (d) {
    DVDX_XATTN_CASE(16) DVDX_XATTN_CASE(32) DVDX_XATTN_CASE(48)
    DVDX_XATTN_CASE(64) DVDX_XATTN_CASE(80) DVDX_XATTN_CASE(96)
    DVDX_XATTN_CASE(112) DVDX_XATTN_CASE(128)
  }
#undef DVDX_XATTN_CASE
  __syncthreads();

  // x2 = (x1 + bf16(ao Wo2^T)) + b_o2
  rows_gemm(qs, ldq, o2_w, C, HD, [&](int r, int c, float v0, float v1) {
    bf16* p = xs + r * ldx + c;
    p[0] = __float2bfloat16(resid_then_bias(__bfloat162float(p[0]), v0,
                                            __bfloat162float(o2_b[c])));
    p[1] = __float2bfloat16(resid_then_bias(__bfloat162float(p[1]), v1,
                                            __bfloat162float(o2_b[c + 1])));
  });
  __syncthreads();
  rows_layernorm(xs, ldx, hs, ldh, C, FUSED_ROWS, ln3_s, ln3_b, eps);
  __syncthreads();
  rows_store(xs, ldx, C, n_rows, [&](int r) { return x2_out + (r0 + r) * C; });
  rows_store(hs, ldh, C, n_rows, [&](int r) { return h_out + (r0 + r) * C; });
}

template <int NT, int MT>
__global__ void __launch_bounds__(GEGLU_THREADS)
spatial_tail_ff(const bf16* __restrict__ h, const bf16* __restrict__ w_in,
                const bf16* __restrict__ b_in, const bf16* __restrict__ w_out,
                const bf16* __restrict__ b_out, const bf16* __restrict__ x2,
                bf16* __restrict__ out, int T, int I) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  geglu_ff_tile<NT, MT, true>(h, w_in, b_in, w_out, b_out, x2, out, T, I,
                              smem_raw);
}

template <int NT>
int launch_ff(const void* h, const void* w_in, const void* b_in,
              const void* w_out, const void* b_out, const void* x2, void* out,
              int T, int I, cudaStream_t st) {
  constexpr int MT = geglu_fused_mt(NT);
  return geglu_launch<NT, MT>(spatial_tail_ff<NT, MT>, h, w_in, b_in, w_out,
                              b_out, x2, out, T, I, st);
}

}  // namespace

// x (rows, C) with rows = N * S, o1 (rows, HD1), ctx_k / ctx_v (N, T, HD);
// weights in nn.Linear's (out, in) layout: o1_w (C, HD1), q2_w (HD, C),
// o2_w (C, HD), ffi_w (2I, C) value rows first, ffo_w (C, I); vectors of C
// (2I for ffi_b); x2 and h are (rows, C) scratch; out (rows, C). All
// contiguous bf16. C % 64 == 0 and C <= 768; HD1, HD multiples of 16 up to
// 768 with heads dividing HD into head dims that are multiples of 16 up to
// 128; 1 <= T <= 512; I % 64 == 0.
extern "C" int dvdx_spatial_tail(
    const void* x, const void* o1, const void* ctx_k, const void* ctx_v,
    const void* o1_w, const void* o1_b, const void* ln2_s, const void* ln2_b,
    const void* q2_w, const void* o2_w, const void* o2_b, const void* ln3_s,
    const void* ln3_b, const void* ffi_w, const void* ffi_b,
    const void* ffo_w, const void* ffo_b, void* x2, void* h, void* out,
    int rows, int S, int C, int HD1, int HD, int T, int heads, int I,
    float scale, float eps, void* stream) {
  if (C % 64 || C > MAX_DIM || HD1 % 16 || HD1 > MAX_DIM || HD % 16 ||
      HD > MAX_DIM || heads < 1 || HD % heads || (HD / heads) % 16 ||
      HD / heads > 128 || T < 1 || T > MAX_CTX ||
      I % GEGLU_BI || rows < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ldx = C + 8, ldh = (C > HD1 ? C : HD1) + 8, ldq = HD + 8;
  const int smem = FUSED_ROWS * (ldx + ldh + ldq) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      spatial_tail_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + FUSED_ROWS - 1) / FUSED_ROWS;
  spatial_tail_chain<<<grid, FUSED_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o1),
      static_cast<const bf16*>(ctx_k), static_cast<const bf16*>(ctx_v),
      static_cast<const bf16*>(o1_w), static_cast<const bf16*>(o1_b),
      static_cast<const bf16*>(ln2_s), static_cast<const bf16*>(ln2_b),
      static_cast<const bf16*>(q2_w), static_cast<const bf16*>(o2_w),
      static_cast<const bf16*>(o2_b), static_cast<const bf16*>(ln3_s),
      static_cast<const bf16*>(ln3_b), static_cast<bf16*>(x2),
      static_cast<bf16*>(h), rows, S, C, HD1, HD, T, heads, scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define DVDX_FF_CASE(nt)                                                     \
  case nt:                                                                   \
    return launch_ff<nt>(h, ffi_w, ffi_b, ffo_w, ffo_b, x2, out, rows, I, st);
  switch (C / 64) {
    DVDX_FF_CASE(1) DVDX_FF_CASE(2) DVDX_FF_CASE(3) DVDX_FF_CASE(4)
    DVDX_FF_CASE(5) DVDX_FF_CASE(6) DVDX_FF_CASE(7) DVDX_FF_CASE(8)
    DVDX_FF_CASE(9) DVDX_FF_CASE(10) DVDX_FF_CASE(11) DVDX_FF_CASE(12)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DVDX_FF_CASE
}
