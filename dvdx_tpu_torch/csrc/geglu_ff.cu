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
#include "geglu_gemm.cuh"

using namespace dvdx;

namespace {
struct geglu_ff_site {};
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
