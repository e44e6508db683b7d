// Fused spatial transformer tail, float32: everything of a BasicTransformerBlock
// after attn1's P.V output, per token row, in float32:
//   x1  = (x + o1 Wo1^T) + b_o1
//   h   = LN2(x1);  q = h Wq2^T
//   ao  = softmax_T(q k^T * scale) v   per head, over the T context tokens
//         whose K/V projections (ctx_k, ctx_v) are computed outside
//   x2  = (x1 + ao Wo2^T) + b_o2
//   out = x2 + ((GEGLU(LN3(x2)) Wff_o^T) + b_ffo)
//
// The float32 form of dvdx_tpu/ops/pallas/spatial_tail.py:fused_spatial_tail,
// which computes in x's dtype with float32 accumulation (so in float32 its
// bf16 roundings are identity), with its rounding order: the residual is
// added before the bias in the two attention out-projections. The bf16 form
// is spatial_tail.cu.
//
// Eight launches, each a simple kernel on the CUDA cores: the o1 product
// with its residual, LN2, the q product (f32_rows.cuh), the cross-attention
// (attention_f32.cuh, the port's one float32 attention, over the image's T
// context rows), the o2 product with its residual, LN3, and the GEGLU pair
// (the second with the residual epilogue). The intermediate rows go through
// device memory. The attention divides by the softmax's sum after P.V where
// the TPU kernel normalises the probabilities before it: in float32 the two
// differ by rounding alone.
//
// Bound on the H100 by f32 operations: 2*rows*(3*HD*C + 2*T*HD + 12*C^2)
// flops at 67 TFLOP/s.
#include "attention_f32.cuh"
#include "f32_rows.cuh"

using namespace dvdx::f32;

namespace {
struct spatial_tail_f32 {};
constexpr int MAX_T = 512;
}  // namespace

// x (rows, C), o1 (rows, HD1), ctx_k / ctx_v (N, T, HD) with rows = N * S;
// weights in nn.Linear's (out, in) layout: o1_w (C, HD1), q2_w (HD, C), o2_w
// (C, HD), ffi_w (2I, C) value rows first, ffo_w (C, I); vectors o1_b, ln2_*,
// o2_b, ln3_*, ffo_b (C), ffi_b (2I). Scratch: x1, h, x2 (rows, C), q, ao
// (rows, HD), inner (rows, I); out (rows, C). All float32, contiguous;
// HD / heads <= 384, T <= 512.
extern "C" int dvdx_spatial_tail_f32(
    const void* x, const void* o1, const void* ctx_k, const void* ctx_v, const void* o1_w,
    const void* o1_b, const void* ln2_s, const void* ln2_b, const void* q2_w,
    const void* o2_w, const void* o2_b, const void* ln3_s, const void* ln3_b,
    const void* ffi_w, const void* ffi_b, const void* ffo_w, const void* ffo_b, void* x1,
    void* h, void* q, void* ao, void* x2, void* inner, void* out, int rows, int S, int C,
    int HD1, int HD, int T, int heads, int I, float scale, float eps, void* stream) {
  if (rows < 1 || S < 1 || rows % S || C < 1 || HD1 < 1 || I < 1 || heads < 1 ||
      HD % heads || HD / heads < 1 || HD / heads > ATT_MAX_D || T < 1 || T > MAX_T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  int rc = gemm_launch<spatial_tail_f32, EPI_RESID_BIAS>(
      Gemm{f(o1), HD1, f(o1_w), HD1, f(o1_b), f(x), C, w(x1), C, rows, C, HD1}, st);
  if (!rc) rc = layer_norm_launch<spatial_tail_f32>(f(x1), f(ln2_s), f(ln2_b), w(h), rows, C,
                                                    eps, st);
  if (!rc) rc = gemm_launch<spatial_tail_f32, EPI_NONE>(
      Gemm{f(h), C, f(q2_w), C, nullptr, nullptr, 0, w(q), HD, rows, HD, C}, st);
  // q, ao (N, S, heads, D) against ctx_k, ctx_v (N, T, heads, D)
  const int D = HD / heads;
  const Strides qs{(long long)S * HD, 0, HD, D}, cs{(long long)T * HD, 0, HD, D};
  if (!rc) rc = attention_f32_launch<spatial_tail_f32>(f(q), f(ctx_k), f(ctx_v), w(ao),
                                                       rows / S, 1, heads, S, T, D, qs, cs,
                                                       cs, qs, scale, st);
  if (!rc) rc = gemm_launch<spatial_tail_f32, EPI_RESID_BIAS>(
      Gemm{f(ao), HD, f(o2_w), HD, f(o2_b), f(x1), C, w(x2), C, rows, C, HD}, st);
  if (!rc) rc = layer_norm_launch<spatial_tail_f32>(f(x2), f(ln3_s), f(ln3_b), w(h), rows, C,
                                                    eps, st);
  if (!rc) rc = geglu_launch<spatial_tail_f32>(f(h), f(ffi_w), f(ffi_b), f(ffo_w), f(ffo_b),
                                               f(x2), w(inner), w(out), rows, C, I, st);
  return rc;
}
