// QK-LayerNorm and rotary embedding of a joint text-video attention's queries
// and keys (the published CogVideoX block), bf16, in one pass:
//   y = (x - mean) * rsqrt(var + eps) * w + b   over each head's 64 lanes
//   out = y                                      at the text positions (s < n_text)
//   out[2i]   = y[2i] cos[2i]     - y[2i+1] sin[2i]     at the video positions,
//   out[2i+1] = y[2i+1] cos[2i+1] + y[2i] sin[2i+1]     the table's row s - n_text
// with the statistics and the rotation in float32 and one rounding to bf16.
//
// Replaces no TPU kernel: the JAX package has no model with QK-norm. Plain
// PyTorch takes some ten passes over q and k here (a contiguous copy of the
// strided projection view, the norm, a float32 copy, the pair swap, two
// products, a sum, the cast back, the scatter into the joint sequence).
//
// Bound on the H100: bytes. Per (token, head) row 128 bytes read and 128
// written, about ten float operations per value; the float32 tables (one row
// per video position) are shared by every head and batch row and stay in L2.
//
// Design: eight lanes a (token, head) row of 64 values, four rows a warp;
// lane l of a row holds values 8l..8l+7 as one 16-byte word, so the rotary
// pairs (2i, 2i+1) lie in one lane and need no shuffle, and the mean and the
// variance (of the centred values, exact two-pass) are two sums over the
// row's eight lanes. Rows are read through the caller's strides (the fused
// q/k/v projection's view) and written contiguous (B, S, H, 64), the layout
// the flash kernel reads. blockIdx.y picks q or k.
#include "common.cuh"

namespace dvdx {
namespace {

constexpr int HEAD_DIM = 64;
constexpr int LANES = 8;                    // lanes a row
constexpr int ROWS = 32 * 8 / LANES;        // rows a block of 8 warps

struct QkArgs {
  const bf16* x[2];  // q, k: (B, S, H, 64) views, unit-stride rows
  bf16* out[2];      // (B, S, H, 64) contiguous
  const bf16* w[2];
  const bf16* b[2];
  const float* cos;  // (S - n_text, 64)
  const float* sin;
  long long sb[2], ss[2], sh[2];  // element strides of x
  long long rows;                 // B * S * H
  int seq, heads, n_text;
  float eps;
};

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__global__ void __launch_bounds__(ROWS * LANES) qk_norm_rope_rows(const QkArgs a) {
  const int which = blockIdx.y;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS + threadIdx.x / LANES;
  // every lane of a warp takes part in the shuffles; a row past the end reads row 0
  const bool live = row < a.rows;
  const long long r = live ? row : 0;
  const int lane = threadIdx.x % LANES;
  const int h = static_cast<int>(r % a.heads);
  const long long bs = r / a.heads;
  const int s = static_cast<int>(bs % a.seq);
  const long long bi = bs / a.seq;
  const bf16* src = a.x[which] + bi * a.sb[which] + s * a.ss[which] + h * a.sh[which];
  float v[8], w[8], b[8];
  unpack8(*reinterpret_cast<const uint4*>(src + 8 * lane), v);
  unpack8(__ldg(reinterpret_cast<const uint4*>(a.w[which]) + lane), w);
  unpack8(__ldg(reinterpret_cast<const uint4*>(a.b[which]) + lane), b);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += v[j];
  const float mean = row_sum(sum) * (1.f / HEAD_DIM);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] -= mean;
    sq += v[j] * v[j];
  }
  const float rs = rsqrtf(row_sum(sq) * (1.f / HEAD_DIM) + a.eps);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = v[j] * rs * w[j] + b[j];
  if (s >= a.n_text) {
    const long long p = static_cast<long long>(s - a.n_text) * HEAD_DIM + 8 * lane;
    const float4* c4 = reinterpret_cast<const float4*>(a.cos + p);
    const float4* s4 = reinterpret_cast<const float4*>(a.sin + p);
    const float4 c0 = c4[0], c1 = c4[1], s0 = s4[0], s1 = s4[1];
    const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float y0 = v[j], y1 = v[j + 1];
      v[j] = y0 * c[j] - y1 * sn[j];
      v[j + 1] = y1 * c[j + 1] + y0 * sn[j + 1];
    }
  }
  if (!live) return;
  uint4 o;
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) ow[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(a.out[which] + row * HEAD_DIM + 8 * lane) = o;
}

}  // namespace
}  // namespace dvdx

// q, k: (batch, seq, heads, 64) bf16 views with element strides (b, s, h),
// each a multiple of 8 and the rows 16-byte aligned;
// q_out, k_out contiguous; w, b the two norms' bf16 affine vectors; cos, sin
// float32 (seq - n_text, 64).
extern "C" int dvdx_qk_norm_rope(const void* q, const void* k, void* q_out, void* k_out,
                                 const void* qw, const void* qb, const void* kw,
                                 const void* kb, const void* cos, const void* sin,
                                 long long qsb, long long qss, long long qsh, long long ksb,
                                 long long kss, long long ksh, int batch, int seq, int heads,
                                 int n_text, float eps, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || n_text < 0 || n_text > seq)
    return static_cast<int>(cudaErrorInvalidValue);
  dvdx::QkArgs a;
  a.x[0] = static_cast<const bf16*>(q);
  a.x[1] = static_cast<const bf16*>(k);
  a.out[0] = static_cast<bf16*>(q_out);
  a.out[1] = static_cast<bf16*>(k_out);
  a.w[0] = static_cast<const bf16*>(qw);
  a.b[0] = static_cast<const bf16*>(qb);
  a.w[1] = static_cast<const bf16*>(kw);
  a.b[1] = static_cast<const bf16*>(kb);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.sb[0] = qsb;
  a.ss[0] = qss;
  a.sh[0] = qsh;
  a.sb[1] = ksb;
  a.ss[1] = kss;
  a.sh[1] = ksh;
  a.rows = static_cast<long long>(batch) * seq * heads;
  a.seq = seq;
  a.heads = heads;
  a.n_text = n_text;
  a.eps = eps;
  const long long blocks = (a.rows + dvdx::ROWS - 1) / dvdx::ROWS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dvdx::qk_norm_rope_rows<<<dim3(static_cast<unsigned>(blocks), 2), dvdx::ROWS * dvdx::LANES,
                            0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
