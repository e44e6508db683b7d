// Attention over float32 inputs: out = softmax(q k^T * scale) v per head.
//
// The float32 form of two TPU kernels, which take float32 as they take bf16:
// dvdx_tpu/ops/pallas/flash_attention.py:flash_attention (_flash_bh /
// _onepass_bh) and dvdx_tpu/ops/pallas/temporal_attention.py:
// temporal_attention_fm / _posmajor (frame-axis attention). The bf16 kernels
// (flash_attention.cu, temporal_attention.cu) run on the tensor cores; this
// is the plain online-softmax form on the CUDA cores (attention_f32.cuh,
// which also holds its design and bound).
#include "attention_f32.cuh"

using namespace dvdx::f32;

namespace {
struct attention_f32_site {};
}  // namespace

// q, out: Sq rows, k, v: Sk rows, of B x N x H heads of width D, float32,
// unit stride along d; each tensor's b / n / s / h strides in elements.
// D <= 384, ceil(Sq / 8) * H * B * N < 2^31 (the wrapper takes D <= 128).
extern "C" int dvdx_attention_f32(const void* q, const void* k, const void* v, void* out,
                                  int B, int N, int H, int Sq, int Sk, int D,
                                  long long qsb, long long qsn, long long qss, long long qsh,
                                  long long ksb, long long ksn, long long kss, long long ksh,
                                  long long vsb, long long vsn, long long vss, long long vsh,
                                  long long osb, long long osn, long long oss, long long osh,
                                  float scale, void* stream) {
  return attention_f32_launch<attention_f32_site>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), B, N, H, Sq, Sk, D, Strides{qsb, qsn, qss, qsh},
      Strides{ksb, ksn, kss, ksh}, Strides{vsb, vsn, vss, vsh}, Strides{osb, osn, oss, osh},
      scale, static_cast<cudaStream_t>(stream));
}
