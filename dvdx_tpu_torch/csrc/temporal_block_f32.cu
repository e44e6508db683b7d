// Fused temporal transformer block, float32: the whole _TemporalBlock on
// frame-major x (B, F, N, C), in float32:
//   x1  = x  + ((Attn_F(LN1(x))  Wo1^T) + b_o1)
//   x2  = x1 + ((Attn_F(LN2(x1)) Wo2^T) + b_o2)   (diffusers double_self_attention)
//   out = x2 + ((GEGLU(LN3(x2)) Wff_o^T) + b_ffo)
// where Attn_F is multi-head self-attention over the F frames of each
// position, q / k / v = LN(.) W^T without biases.
//
// The float32 form of dvdx_tpu/ops/pallas/temporal_block.py:
// fused_temporal_block, which computes in x's dtype with float32
// accumulation (so in float32 its bf16 roundings are identity), with its
// order: the unnormalised probabilities exp(s - max) times V, the sum
// divided after; the bias added to the out-projection before the residual.
// The bf16 form is temporal_block.cu.
//
// Fifteen launches: per attention sub-block LN (on the CUDA cores), the q,
// k and v products (f32_rows.cuh's f32_gemm: three TF32 passes on the
// tensor cores), the frame-axis attention (attention_f32.cuh, the port's
// one float32 attention, over the F frames of each position: on the body
// the caller's shape gate picks, the short-sequence body's tensor cores at
// the UNet's 16 frames and XL's 24, the 64-row tensor-core body at F = 64,
// the CUDA-core rows at odd widths) and the out-projection with its
// residual;
// then LN3 and the one float32 GEGLU pair. The intermediate rows go through
// device memory.
//
// Bound on the H100 by operations: 2*rows*(8*C^2 + 4*F*C + 12*C^2) flops,
// the products' in three TF32 passes at 495 TFLOP/s.
#include "attention_f32.cuh"
#include "f32_rows.cuh"

using namespace dvdx::f32;

namespace {
struct temporal_block_f32 {};

constexpr int MAX_F = 64;

// One attention sub-block: h = LN(x); q, k, v = h W^T; a = Attn_F(q, k, v);
// x_out = x + (a Wo^T + bo).
int attention_sub_block(const float* x, const float* ln_s, const float* ln_b, const float* wq,
                        const float* wk, const float* wv, const float* wo, const float* bo,
                        float* h, float* q, float* k, float* v, float* a, float* x_out, int B,
                        int F, int N, int C, int heads, float scale, float eps, int att_body,
                        cudaStream_t st) {
  const int rows = B * F * N;
  int rc = layer_norm_launch<temporal_block_f32>(x, ln_s, ln_b, h, rows, C, eps, st);
  const float* ws[3] = {wq, wk, wv};
  float* outs[3] = {q, k, v};
  for (int i = 0; i < 3 && !rc; ++i)
    rc = gemm_launch<temporal_block_f32, EPI_NONE>(
        Gemm{h, C, ws[i], C, nullptr, nullptr, 0, outs[i], C, rows, C, C}, st);
  // q, k, v, a (B, F, N, heads, D): frame f of position n is query / key row f
  const Strides fm{(long long)F * N * C, C, (long long)N * C, C / heads};
  if (!rc) rc = attention_f32_launch<temporal_block_f32>(q, k, v, a, B, N, heads, F, F,
                                                         C / heads, fm, fm, fm, fm, scale,
                                                         att_body, st);
  if (rc) return rc;
  return gemm_launch<temporal_block_f32, EPI_BIAS_RESID>(
      Gemm{a, C, wo, C, bo, x, C, x_out, C, rows, C, C}, st);
}
}  // namespace

// x (B, F, N, C) frame-major; weights in nn.Linear's (out, in) layout: q1,
// k1, v1, o1_w, q2, k2, v2, o2_w (C, C), ffi_w (2I, C) value rows first,
// ffo_w (C, I); vectors ln{1,2,3}_{s,b}, o1_b, o2_b, ffo_b (C), ffi_b (2I).
// Scratch: h, q, k, v, a, x1, x2 (B*F*N, C), inner (B*F*N, I); out like x.
// All float32, contiguous; C / heads <= 384, F <= 64. att_body: the body of
// the frame-axis attention (attention_f32.cuh's Body: 1 the 64-row
// tensor-core body at F = 64, 2 the short-sequence body at F < 64, both
// for C / heads <= 128 and a multiple of 4; 0 the CUDA-core rows).
extern "C" int dvdx_temporal_block_f32(
    const void* x, const void* ln1_s, const void* ln1_b, const void* q1, const void* k1,
    const void* v1, const void* o1_w, const void* o1_b, const void* ln2_s,
    const void* ln2_b, const void* q2, const void* k2, const void* v2, const void* o2_w,
    const void* o2_b, const void* ln3_s, const void* ln3_b, const void* ffi_w,
    const void* ffi_b, const void* ffo_w, const void* ffo_b, void* h, void* q, void* k,
    void* v, void* a, void* x1, void* x2, void* inner, void* out, int B, int F, int N, int C,
    int heads, int I, float scale, float eps, int att_body, void* stream) {
  if (B < 1 || F < 1 || F > MAX_F || N < 1 || C < 1 || I < 1 || heads < 1 || C % heads ||
      C / heads > ATT_MAX_D || (long long)B * F * N > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  int rc = attention_sub_block(f(x), f(ln1_s), f(ln1_b), f(q1), f(k1), f(v1), f(o1_w),
                               f(o1_b), w(h), w(q), w(k), w(v), w(a), w(x1), B, F, N, C,
                               heads, scale, eps, att_body, st);
  if (!rc) rc = attention_sub_block(f(x1), f(ln2_s), f(ln2_b), f(q2), f(k2), f(v2), f(o2_w),
                                    f(o2_b), w(h), w(q), w(k), w(v), w(a), w(x2), B, F, N, C,
                                    heads, scale, eps, att_body, st);
  if (!rc) rc = layer_norm_launch<temporal_block_f32>(f(x2), f(ln3_s), f(ln3_b), w(h),
                                                      (long long)B * F * N, C, eps, st);
  if (!rc) rc = geglu_launch<temporal_block_f32>(
      f(h), f(ffi_w), f(ffi_b), f(ffo_w), f(ffo_b), f(x2), w(inner), w(out),
      (long long)B * F * N, C, I, st);
  return rc;
}
