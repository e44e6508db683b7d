// Fused temporal transformer block: the whole _TemporalBlock on frame-major
// x (B, F, N, C), attention over the F frames at every spatial position:
//   x = x + (bf16(Attn1(LN1(x)) Wo1^T) + b_o1)
//   x = x + (bf16(Attn2(LN2(x)) Wo2^T) + b_o2)    (diffusers
//                                                   double_self_attention)
//   out = x + bf16(GEGLU(LN3(x)) + b_ffo)          (FF output bias in f32)
// where Attn(h) projects q, k, v = bf16(h W^T) and, per (position, head),
// takes p = bf16(exp(s - max s)) of the f32 logits s = q k^T * scale and
// returns bf16((p v) / sum exp(s - max s)).
//
// Replaces dvdx_tpu/ops/pallas/temporal_block.py:fused_temporal_block
// (_block_kernel), with its rounding order. The TPU kernel packs 8 positions
// into 128-row MXU tiles with a checkerboard mask (_checkerboard_bias,
// _packed_heads_attend); that packing exists only for the MXU. Here a block
// owns P = 32 / F positions x F frames, gathered from the frame-major layout
// by the frame stride, and the F x F attention runs per position, as
// temporal_attention.cu does. Positions past N are neither read nor written.
//
// Bound on the H100: 2*rows*(8*C^2 + 2*F*C + 12*C^2) flops against reading x
// and the 20*C^2 weights once and writing out once; at level 0 (92160 rows,
// C = 320) that is tensor-core operations.
//
// Design, as spatial_tail.cu: the weights (4.1 MB at C = 320) stream from
// L2 as mma.sync B fragments; (a) temporal_block_chain runs both attention
// sub-blocks and LN3 on a 32-row tile held in shared memory and writes x and
// h = LN3(x) in bf16; (b), (c) the GEGLU feed-forward as geglu_gemm.cuh's
// two wgmma products, geglu_in into the (rows, I) inner tensor and
// geglu_out with the residual epilogue. Nothing runs between the launches.
// Fixed launch shapes and summation orders, no atomics.
#include "fused_rows.cuh"
#include "geglu_gemm.cuh"

using namespace dvdx;

namespace {

constexpr int MAX_DIM = 384;
constexpr int MAX_FRAMES = 32;

struct AttnWeights {
  const bf16 *ln_s, *ln_b, *wq, *wk, *wv, *wo, *bo;
};

// One attention sub-block on the tile: x += (bf16(Attn(LN(x)) Wo^T) + bo).
__device__ __forceinline__ void attention_sub_block(
    const AttnWeights& w, bf16* xs, bf16* hs, bf16* qs, bf16* ks, bf16* vs,
    float* pw, int ld, int C, int F, int P, int heads, float scale,
    float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  rows_layernorm(xs, ld, hs, ld, C, FUSED_ROWS, w.ln_s, w.ln_b, eps);
  __syncthreads();
  rows_gemm(hs, ld, w.wq, C, C, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(qs + r * ld + c) = pack_bf16(v0, v1);
  });
  rows_gemm(hs, ld, w.wk, C, C, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(ks + r * ld + c) = pack_bf16(v0, v1);
  });
  rows_gemm(hs, ld, w.wv, C, C, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(vs + r * ld + c) = pack_bf16(v0, v1);
  });
  __syncthreads();

  // one warp per (position, head, query frame), lanes over key frames; the
  // output goes to hs, free once the projections are done
  const int d = C / heads;
  float* p = pw + warp * MAX_FRAMES;
  for (int item = warp; item < P * heads * F; item += FUSED_THREADS / 32) {
    const int fi = item % F, h = (item / F) % heads, pos = item / (F * heads);
    const bf16* qr = qs + (pos * F + fi) * ld + h * d;
    float s = -INFINITY;
    if (lane < F) {
      const bf16* kr = ks + (pos * F + lane) * ld + h * d;
      float acc = 0.f;
      for (int i = 0; i < d; ++i)
        acc = fmaf(__bfloat162float(qr[i]), __bfloat162float(kr[i]), acc);
      s = acc * scale;
    }
    const float m = warp_max(s);
    const float e = lane < F ? expf(s - m) : 0.f;
    const float l = warp_sum(e);
    p[lane] = bf16_round(e);
    __syncwarp();
    for (int i = lane; i < d; i += 32) {
      float acc = 0.f;
      for (int j = 0; j < F; ++j)
        acc = fmaf(p[j], __bfloat162float(vs[(pos * F + j) * ld + h * d + i]),
                   acc);
      hs[(pos * F + fi) * ld + h * d + i] = __float2bfloat16(acc / l);
    }
    __syncwarp();  // p is rewritten by the warp's next item
  }
  __syncthreads();
  rows_gemm(hs, ld, w.wo, C, C, [&](int r, int c, float v0, float v1) {
    bf16* x = xs + r * ld + c;
    x[0] = __float2bfloat16(bias_then_resid(__bfloat162float(x[0]), v0,
                                            __bfloat162float(w.bo[c])));
    x[1] = __float2bfloat16(bias_then_resid(__bfloat162float(x[1]), v1,
                                            __bfloat162float(w.bo[c + 1])));
  });
  __syncthreads();
}

// Tile row r = pos * F + f is (b, f, n0 + pos); rows past P * F and
// positions past N stay zero and are never written.
__global__ void __launch_bounds__(FUSED_THREADS)
temporal_block_chain(const bf16* __restrict__ x, AttnWeights a1,
                     AttnWeights a2, const bf16* __restrict__ ln3_s,
                     const bf16* __restrict__ ln3_b, bf16* __restrict__ x_out,
                     bf16* __restrict__ h_out, int F, int N, int C, int heads,
                     float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + FUSED_ROWS * ld;
  bf16* qs = hs + FUSED_ROWS * ld;
  bf16* ks = qs + FUSED_ROWS * ld;
  bf16* vs = ks + FUSED_ROWS * ld;
  float* pw = reinterpret_cast<float*>(vs + FUSED_ROWS * ld);  // 8 x 32

  const int P = FUSED_ROWS / F;
  const int n0 = blockIdx.x * P, b = blockIdx.y;
  const int valid_pos = min(P, N - n0);
  auto row_off = [&](int r) {
    return ((long long)(b * F + r % F) * N + n0 + r / F) * C;
  };
  // valid rows are not contiguous in r when positions run out mid-tile, so
  // load row by row through the position check
  for (int i = threadIdx.x; i < FUSED_ROWS * (C / 8); i += FUSED_THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < P * F && r / F < valid_pos)
      v = *reinterpret_cast<const uint4*>(x + row_off(r) + c8);
    *reinterpret_cast<uint4*>(&xs[r * ld + c8]) = v;
  }
  __syncthreads();

  attention_sub_block(a1, xs, hs, qs, ks, vs, pw, ld, C, F, valid_pos, heads,
                      scale, eps);
  attention_sub_block(a2, xs, hs, qs, ks, vs, pw, ld, C, F, valid_pos, heads,
                      scale, eps);
  rows_layernorm(xs, ld, hs, ld, C, FUSED_ROWS, ln3_s, ln3_b, eps);
  __syncthreads();
  for (int i = threadIdx.x; i < valid_pos * F * (C / 8); i += FUSED_THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(x_out + row_off(r) + c8) =
        *reinterpret_cast<const uint4*>(&xs[r * ld + c8]);
    *reinterpret_cast<uint4*>(h_out + row_off(r) + c8) =
        *reinterpret_cast<const uint4*>(&hs[r * ld + c8]);
  }
}

struct temporal_block_ff {};  // names the FF launches in profiles

}  // namespace

// x, out (B, F, N, C) contiguous; x_mid and h (B, F, N, C) scratch, inner
// (B * F * N, I) scratch. Weights in nn.Linear's (out, in) layout: q/k/v/o
// (C, C) for both attentions, ffi_w (2I, C) value rows first, ffo_w (C, I);
// vectors of C (2I for ffi_b). All bf16. C % 64 == 0, C <= 384, heads
// dividing C, F <= 32, I % 128 == 0.
extern "C" int dvdx_temporal_block(
    const void* x, const void* ln1_s, const void* ln1_b, const void* q1,
    const void* k1, const void* v1, const void* o1_w, const void* o1_b,
    const void* ln2_s, const void* ln2_b, const void* q2, const void* k2,
    const void* v2, const void* o2_w, const void* o2_b, const void* ln3_s,
    const void* ln3_b, const void* ffi_w, const void* ffi_b,
    const void* ffo_w, const void* ffo_b, void* x_mid, void* h, void* inner,
    void* out, int B, int F, int N, int C, int heads, int I, float scale, float eps,
    void* stream) {
  if (C % 64 || C > MAX_DIM || heads < 1 || C % heads || F < 1 ||
      F > MAX_FRAMES || N < 1 || B < 1 || B > 65535 || I % FF_IN_BN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  const AttnWeights a1 = {bf(ln1_s), bf(ln1_b), bf(q1), bf(k1), bf(v1),
                          bf(o1_w), bf(o1_b)};
  const AttnWeights a2 = {bf(ln2_s), bf(ln2_b), bf(q2), bf(k2), bf(v2),
                          bf(o2_w), bf(o2_b)};
  const int smem = 5 * FUSED_ROWS * (C + 8) * 2 +
                   (FUSED_THREADS / 32) * MAX_FRAMES * 4;
  cudaError_t err = cudaFuncSetAttribute(
      temporal_block_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = FUSED_ROWS / F;
  dim3 grid((N + P - 1) / P, B);
  temporal_block_chain<<<grid, FUSED_THREADS, smem, st>>>(
      bf(x), a1, a2, bf(ln3_s), bf(ln3_b), static_cast<bf16*>(x_mid),
      static_cast<bf16*>(h), F, N, C, heads, scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * F * N;
  const int rc = geglu_in_launch<temporal_block_ff>(h, ffi_w, ffi_b, inner, rows, C, I, st);
  if (rc != 0) return rc;
  return geglu_out_launch<temporal_block_ff>(inner, ffo_w, ffo_b, x_mid, out, rows, C, I, st);
}
