// Epilogues of the published CogVideoX block's dense layers, bf16, one
// bytes-bound pass each over the layer's product y (rows, C), C % 8 == 0:
//   bias_gelu:       y = gelu_tanh(y + b)                   in place (ff.proj_in)
//   gated_residual:  x = x + g * (y + b)                    into the residual stream x
//                    (to_out and ff.proj_out), g the row's gate: gate[batch] at the
//                    video rows, enc_gate[batch] at the first n_text (text) rows
// each in float32 with one rounding to bf16.
//
// Replaces no TPU kernel (the JAX package has no such block). ATen takes
// three passes for the first (the bias add, GELU's read and write) and four
// for the second (the bias add, then addcmul's reads of x and y and its write),
// at 12288 and 3072 channels over 17,776 joint tokens a batch row.
//
// Bound on the H100: bytes (about 20 float operations a value for the tanh
// GELU, 3 for the gate, against 4 or 6 bytes): y read and written, or x and y
// read and x written, in bf16.
//
// Design: one block walks whole rows (blockIdx.x, +gridDim.x, ...), so the row's
// batch index and segment, and so its gate vector, are found once a row; each
// thread owns channel octets t, t + THREADS, ... of the row: 16-byte loads and
// stores, its bias and gate octets from L1. Loads of y in gated_residual are
// streaming (dead after this pass).
#include "common.cuh"

namespace dvdx {
namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.f + tanhf(k0 * (x + k1 * x * x * x)));
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

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16(f[2 * j], f[2 * j + 1]);
  return v;
}

__global__ void __launch_bounds__(THREADS)
bias_gelu_rows(bf16* __restrict__ y, const bf16* __restrict__ b, long long rows, int c8) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    uint4* row = reinterpret_cast<uint4*>(y) + r * c8;
    for (int c = threadIdx.x; c < c8; c += THREADS) {
      float f[8], g[8];
      unpack8(row[c], f);
      unpack8(__ldg(reinterpret_cast<const uint4*>(b) + c), g);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = gelu_tanh(f[j] + g[j]);
      row[c] = pack8(f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gated_residual_rows(bf16* __restrict__ x, const bf16* __restrict__ y,
                    const bf16* __restrict__ b, const bf16* __restrict__ gate,
                    const bf16* __restrict__ enc_gate, long long gate_stride, long long rows,
                    int c8, int seq, int n_text) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long bi = r / seq;
    const int s = static_cast<int>(r - bi * seq);
    const uint4* g8 = reinterpret_cast<const uint4*>((s < n_text ? enc_gate : gate) +
                                                     bi * gate_stride);
    uint4* xr = reinterpret_cast<uint4*>(x) + r * c8;
    const uint4* yr = reinterpret_cast<const uint4*>(y) + r * c8;
    for (int c = threadIdx.x; c < c8; c += THREADS) {
      float fx[8], fy[8], fb[8], fg[8];
      unpack8(xr[c], fx);
      unpack8(__ldcs(yr + c), fy);
      unpack8(__ldg(reinterpret_cast<const uint4*>(b) + c), fb);
      unpack8(__ldg(g8 + c), fg);
#pragma unroll
      for (int j = 0; j < 8; ++j) fx[j] = fmaf(fg[j], fy[j] + fb[j], fx[j]);
      xr[c] = pack8(fx);
    }
  }
}

int grid_for(long long rows) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = static_cast<long long>(sms) * 16;
  return static_cast<int>(rows < cap ? rows : cap);
}

}  // namespace
}  // namespace dvdx

// y (rows, C) bf16 in place; b (C,) bf16.
extern "C" int dvdx_bias_gelu(void* y, const void* b, long long rows, int C, void* stream) {
  if (rows < 1 || C < 8 || C % 8) return static_cast<int>(cudaErrorInvalidValue);
  dvdx::bias_gelu_rows<<<dvdx::grid_for(rows), dvdx::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(y), static_cast<const bf16*>(b), rows, C / 8);
  return static_cast<int>(cudaGetLastError());
}

// x, y (batch * seq, C) bf16, x updated; b (C,); gate, enc_gate (C,) vectors
// of batch row 0, the next batch row's gate_stride elements on.
extern "C" int dvdx_gated_residual(void* x, const void* y, const void* b, const void* gate,
                                   const void* enc_gate, long long gate_stride, int batch,
                                   int seq, int n_text, int C, void* stream) {
  if (batch < 1 || seq < 1 || n_text < 0 || n_text > seq || C < 8 || C % 8 ||
      gate_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(batch) * seq;
  dvdx::gated_residual_rows<<<dvdx::grid_for(rows), dvdx::THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<bf16*>(x), static_cast<const bf16*>(y), static_cast<const bf16*>(b),
      static_cast<const bf16*>(gate), static_cast<const bf16*>(enc_gate), gate_stride, rows,
      C / 8, seq, n_text);
  return static_cast<int>(cudaGetLastError());
}
