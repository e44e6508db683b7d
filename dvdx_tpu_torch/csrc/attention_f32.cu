// Attention over float32 inputs: out = softmax(q k^T * scale) v per head.
//
// The float32 form of two TPU kernels, which take float32 as they take bf16:
// dvdx_tpu/ops/pallas/flash_attention.py:flash_attention (_flash_bh /
// _onepass_bh) and dvdx_tpu/ops/pallas/temporal_attention.py:
// temporal_attention_fm / _posmajor (frame-axis attention). The bf16 kernels
// (flash_attention.cu, temporal_attention.cu) run on the tensor cores; the
// float32 test models reach these shapes at most at a small size, so this is
// the plain online-softmax form on the CUDA cores, with no tensor-core
// rounding of its operands (TF32 would round them to 10 mantissa bits).
//
// Layout: an element (b, n, s, h, d) of q, k, v or out lies at
// b * sb + n * sn + s * ss + h * sh + d, strides per tensor, so one kernel
// takes flash's (B, S, H, D) (N = 1) and frame-axis attention's frame-major
// (B, F, N, H*D) and position-major (B, N, F, H*D) layouts.
//
// Design: a block of 8 warps takes 8 query rows of one (b, n, h); each
// warp holds its row in shared memory. Keys come in tiles of 32, K and V
// staged in shared memory by the whole block (K rows padded to 129 floats,
// so the 32 lanes reading 32 keys' d-th values hit 32 banks). Lane j takes
// key j of the tile: its logit is one f32 dot product over d in order; the
// tile's max and the denominator's increment are fixed butterflies across
// the warp; the probabilities go through shared memory and each lane adds
// P.V for its own d = lane, lane + 32, ... over the tile's keys in order.
// Every sum has a fixed order, so a rerun is bit-identical. Bound on the
// H100 by f32 operations at long sequences (4 S T D flops), else by bytes.
#include "common.cuh"

using namespace dvdx;

namespace {

constexpr int WARPS = 8;   // query rows per block
constexpr int KT = 32;     // keys per tile: one per lane
constexpr int MAX_D = 128;

struct Strides {
  long long b, n, s, h;
};

__global__ void __launch_bounds__(WARPS * 32)
attention_f32_rows(const float* q, const float* k, const float* v, float* out, int N,
                   int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale) {
  __shared__ float k_tile[KT][MAX_D + 1];
  __shared__ float v_tile[KT][MAX_D];
  __shared__ float q_rows[WARPS][MAX_D];
  __shared__ float p_rows[WARPS][KT];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s = blockIdx.x * WARPS + w;
  const bool live = s < Sq;  // a warp past Sq still helps stage the tiles
  const int h = blockIdx.y, b = blockIdx.z / N, n = blockIdx.z % N;
  const float* kp = k + b * ks.b + n * ks.n + h * ks.h;
  const float* vp = v + b * vs.b + n * vs.n + h * vs.h;
  if (live) {
    const float* qp = q + b * qs.b + n * qs.n + s * qs.s + h * qs.h;
    for (int d = lane; d < D; d += 32) q_rows[w][d] = qp[d];
  }
  float acc[MAX_D / 32] = {};
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < Sk; t0 += KT) {
    __syncthreads();  // the last tile is consumed (and q_rows written)
    for (int e = threadIdx.x; e < KT * D; e += WARPS * 32) {
      const int j = e / D, d = e - j * D, t = t0 + j;
      k_tile[j][d] = t < Sk ? __ldg(kp + t * ks.s + d) : 0.f;
      v_tile[j][d] = t < Sk ? __ldg(vp + t * vs.s + d) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(q_rows[w][d], k_tile[lane][d], dot);
    const float logit = t0 + lane < Sk ? dot * scale : -INFINITY;
    const float m_new = fmaxf(m, warp_max(logit));
    const float c = expf(m - m_new), p = expf(logit - m_new);
    l = fmaf(l, c, warp_sum(p));
    p_rows[w][lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int d = lane + 32 * i;
      if (d >= D) continue;
      float a = acc[i] * c;
#pragma unroll 8
      for (int j = 0; j < KT; ++j) a = fmaf(p_rows[w][j], v_tile[j][d], a);
      acc[i] = a;
    }
    __syncwarp();  // p_rows is rewritten by the next tile
    m = m_new;
  }
  if (!live) return;
  float* op = out + b * os.b + n * os.n + s * os.s + h * os.h;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < MAX_D / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < D) op[d] = acc[i] * inv;
  }
}

}  // namespace

// q, out: Sq rows, k, v: Sk rows, of B x N x H heads of width D, float32,
// unit stride along d; each tensor's b / n / s / h strides in elements.
// D <= 128, B * N <= 65535, H <= 65535.
extern "C" int dvdx_attention_f32(const void* q, const void* k, const void* v, void* out,
                                  int B, int N, int H, int Sq, int Sk, int D,
                                  long long qsb, long long qsn, long long qss, long long qsh,
                                  long long ksb, long long ksn, long long kss, long long ksh,
                                  long long vsb, long long vsn, long long vss, long long vsh,
                                  long long osb, long long osn, long long oss, long long osh,
                                  float scale, void* stream) {
  if (B < 1 || N < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > MAX_D ||
      (long long)B * N > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + WARPS - 1) / WARPS, H, B * N);
  attention_f32_rows<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), N, Sq, Sk, D, Strides{qsb, qsn, qss, qsh},
      Strides{ksb, ksn, kss, ksh}, Strides{vsb, vsn, vss, vsh}, Strides{osb, osn, oss, osh},
      scale);
  return static_cast<int>(cudaGetLastError());
}
