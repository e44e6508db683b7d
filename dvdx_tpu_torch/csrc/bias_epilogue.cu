// Bias (+ residual) epilogue of the port's convolutions and dense layers, bf16
// or float32 (one template), in place over the product:
//   y = round(y + b)                  (Dense / Conv: the product, then + bias)
//   y = round(r + round(y + b))       (where a residual add follows the layer)
// with round() to y's type; each sum in float32, as ATen's add computes it
// (alpha 1, float opmath), so each output is bit for bit ATen's `y + b` and
// `r + (y + b)`.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias add into the
// convolution's or product's output. On the card the product comes from cuDNN
// or cuBLAS, and ATen's add with a bias broadcast over the rows (stride 0) has
// no vectorised path: it falls back to its strided elementwise kernel, which
// computes an offset per element, and the residual add that follows reads the
// whole output back once more.
//
// Bound on the H100: one float add (two with the residual) per element against
// 2 bytes read and 2 written (4 and 4 in float32), plus 2 (4) read of the
// residual: bytes, at 3.35 TB/s.
//
// Design: y as (rows, C), C % 8 == 0. Each thread owns one fixed octet of 8
// channels: its 8 bias values are loaded and converted to float once and stay
// in registers, and the thread walks the rows of its octet, UNROLL rows in
// flight, whole 16-byte loads and stores (two a float32 octet) with no
// per-element modulus or offset arithmetic. A block holds `rows_per_block`
// row lanes of `seg` octets (seg = C / 8 up to 256 octets; wider rows split
// over blockIdx.y in segments of 256); the grid is persistent, as many blocks
// as are co-resident on the card and no more than the rows need, and walks
// the rows blockIdx.x, +gridDim.x, ... Loads of y and of the residual are
// streaming (ld.global.cs, evict-first): both are dead after this pass; the
// stores are plain, since the next layer reads the result.
#include "common.cuh"

namespace dvdx {
namespace {

constexpr int THREADS = 256;  // threads a block at most
constexpr int UNROLL = 4;     // rows a thread has in flight

template <typename T> struct Octet;

template <> struct Octet<bf16> {
  uint4 v;
  __device__ __forceinline__ static Octet load(const bf16* p) {
    return {__ldcs(reinterpret_cast<const uint4*>(p))};
  }
  __device__ __forceinline__ void unpack(float (&f)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(h[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  // f rounded to bf16 (round to nearest even), then written
  __device__ __forceinline__ static Octet pack(const float (&f)[8]) {
    Octet o;
    uint32_t* w = reinterpret_cast<uint32_t*>(&o.v);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = pack_bf16(f[2 * j], f[2 * j + 1]);
    return o;
  }
  __device__ __forceinline__ void store(bf16* p) const { *reinterpret_cast<uint4*>(p) = v; }
};

template <> struct Octet<float> {
  float4 a, b;
  __device__ __forceinline__ static Octet load(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return {__ldcs(q), __ldcs(q + 1)};
  }
  __device__ __forceinline__ void unpack(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ static Octet pack(const float (&f)[8]) {
    return {make_float4(f[0], f[1], f[2], f[3]), make_float4(f[4], f[5], f[6], f[7])};
  }
  __device__ __forceinline__ void store(float* p) const {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = a;
    q[1] = b;
  }
};

// y (rows, C) in place, bias (C), resid (rows, C) when kResid.
template <typename T, bool kResid>
__global__ void __launch_bounds__(THREADS)
bias_epilogue_rows(T* __restrict__ y, const T* __restrict__ bias, const T* __restrict__ resid,
                   long long rows, int C, int seg, int rows_per_block) {
  const int lane = threadIdx.x % seg, r0 = threadIdx.x / seg;
  const int c0 = (blockIdx.y * seg + lane) * 8;
  if (r0 >= rows_per_block || c0 >= C) return;
  float b[8];
  // the bias is read by every block: a plain (cached) load
  Octet<T> bo;
  if constexpr (sizeof(T) == 2) {
    bo.v = *reinterpret_cast<const uint4*>(bias + c0);
  } else {
    const float4* q = reinterpret_cast<const float4*>(bias + c0);
    bo.a = q[0];
    bo.b = q[1];
  }
  bo.unpack(b);
  const long long step = (long long)gridDim.x * rows_per_block;  // rows between a thread's
  long long row = (long long)blockIdx.x * rows_per_block + r0;
  T* yp = y + row * C + c0;
  const T* rp = kResid ? resid + row * C + c0 : nullptr;
  const long long stride = step * C;  // elements between a thread's rows
  for (; row < rows; row += UNROLL * step) {
    Octet<T> v[UNROLL], r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (row + u * step < rows) {
        v[u] = Octet<T>::load(yp + u * stride);
        if constexpr (kResid) r[u] = Octet<T>::load(rp + u * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (row + u * step < rows) {
        float f[8];
        v[u].unpack(f);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = __fadd_rn(f[j], b[j]);
        Octet<T> o = Octet<T>::pack(f);
        if constexpr (kResid) {
          float g[8];
          o.unpack(f);  // the rounded y + b
          r[u].unpack(g);
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] = __fadd_rn(g[j], f[j]);
          o = Octet<T>::pack(f);
        }
        o.store(yp + u * stride);
      }
    }
    yp += UNROLL * stride;
    if constexpr (kResid) rp += UNROLL * stride;
  }
}

template <typename T, bool kResid>
int launch(void* y, const void* bias, const void* resid, long long rows, int C,
           cudaStream_t stream) {
  const int octets = C / 8;
  const int seg = octets < THREADS ? octets : THREADS;
  const int segments = (octets + seg - 1) / seg;
  const int rows_per_block = THREADS / seg;
  const int threads = rows_per_block * seg;
  // co-resident blocks of this instance at each block size (threads / 32 + 1
  // warps at most), found once
  static int per_sm[THREADS / 32 + 1] = {0};
  static int sms = 0;
  const int warps = (threads + 31) / 32;
  if (per_sm[warps] == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && sms == 0)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bias_epilogue_rows<T, kResid>,
                                                        threads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm[warps] = n;
  }
  const long long capacity = (long long)sms * per_sm[warps] / segments;
  const long long need = (rows + rows_per_block - 1) / rows_per_block;
  long long gx = need < capacity ? need : capacity;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), segments);
  bias_epilogue_rows<T, kResid><<<grid, threads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(bias), static_cast<const T*>(resid), rows, C,
      seg, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dvdx

// y: (rows, C) contiguous, overwritten with y + bias (+ resid); bias: (C);
// resid: (rows, C) contiguous or null; all bf16 (f32 == 0) or all float32
// (f32 == 1), 16-byte aligned; C % 8 == 0, rows >= 1.
extern "C" int dvdx_bias_epilogue(void* y, const void* bias, const void* resid, long long rows,
                                  int C, int f32, void* stream) {
  if (rows < 1 || C < 8 || C % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return resid ? dvdx::launch<float, true>(y, bias, resid, rows, C, s)
                 : dvdx::launch<float, false>(y, bias, resid, rows, C, s);
  return resid ? dvdx::launch<bf16, true>(y, bias, resid, rows, C, s)
               : dvdx::launch<bf16, false>(y, bias, resid, rows, C, s);
}
