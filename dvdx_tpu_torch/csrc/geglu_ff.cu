// Fused GEGLU feed-forward: y = ((x Wv + bv) * gelu(x Wg + bg)) Wo + bo.
//
// Replaces dvdx_tpu/ops/pallas/geglu_ff.py:geglu_ff (_geglu_kernel). The
// 8x-width inner tensor never reaches device memory: a block owns BT tokens
// and walks the inner dimension in chunks of 64 (geglu_body.cuh, which the
// fused spatial tail and temporal block reuse with a residual epilogue).
//
// The (BT x C) f32 output accumulator lives in the block's registers, split
// over its 8 warps (BT*C = 20480 elements, 80 per thread at every supported
// width: BT=64 at C=320, 32 at C=640, 16 at C=1280).
//
// Bound on the H100: 6*T*C*I flops against (2*T*C + 3*C*I)*2 bytes; at the
// UNet's token counts (>= 1440 tokens) the operations dominate, so the kernel
// is bounded by tensor-core operations. This first version re-reads the
// weights once per token tile from L2 and uses synchronous loads.
#include "geglu_body.cuh"

using namespace dvdx;

namespace {

template <int NT, int MT>
__global__ void __launch_bounds__(GEGLU_THREADS)
geglu_ff_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
                const bf16* __restrict__ b_in, const bf16* __restrict__ w_out,
                const bf16* __restrict__ b_out, const bf16* __restrict__ resid,
                bf16* __restrict__ out, int T, int I) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  geglu_ff_tile<NT, MT, false>(x, w_in, b_in, w_out, b_out, resid, out, T, I,
                               smem_raw);
}

template <int NT, int MT>
int launch(const void* x, const void* w_in, const void* b_in, const void* w_out,
           const void* b_out, void* out, int T, int I, cudaStream_t stream) {
  return geglu_launch<NT, MT>(geglu_ff_kernel<NT, MT>, x, w_in, b_in, w_out,
                              b_out, nullptr, out, T, I, stream);
}

}  // namespace

// x (T, C), w_in (2I, C), b_in (2I), w_out (C, I), b_out (C), out (T, C);
// all contiguous bf16. C must be one of 64, 128, 320, 640, 1280 and I a
// multiple of 64 (checked by the wrapper).
extern "C" int dvdx_geglu_ff(const void* x, const void* w_in, const void* b_in,
                             const void* w_out, const void* b_out, void* out,
                             int T, int C, int I, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (I % GEGLU_BI != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 64: return launch<1, 4>(x, w_in, b_in, w_out, b_out, out, T, I, st);
    case 128: return launch<2, 4>(x, w_in, b_in, w_out, b_out, out, T, I, st);
    case 320: return launch<5, 4>(x, w_in, b_in, w_out, b_out, out, T, I, st);
    case 640: return launch<10, 2>(x, w_in, b_in, w_out, b_out, out, T, I, st);
    case 1280: return launch<20, 1>(x, w_in, b_in, w_out, b_out, out, T, I, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
