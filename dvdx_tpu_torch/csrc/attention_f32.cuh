// Attention over float32 inputs: out = softmax(q k^T * scale) v per head,
// float32-accurate. One kernel for every float32 attention of the port:
// flash and frame-axis attention (attention_f32.cu), and the cross-attention
// and frame-axis attention inside the float32 forms of the fused tail and
// block (spatial_tail_f32.cu, temporal_block_f32.cu). Three bodies; the
// caller picks one by shape (ops/kernels/attention_f32.py: body, which
// reads shapes, strides and offsets only and is tested on the CPU):
//
// attention_f32_mma, the tensor-core body (Sq >= 64 query rows, D <= 128,
// D and every row stride a multiple of 4 floats, 16-byte aligned bases):
// both products in three TF32 passes (tf32_mma.cuh: the split, its error
// budget and its 165 TFLOP/s peak). A block of 4 warps takes 64 query rows
// of one (b, n, h), each warp 16 rows. Keys come in tiles of 64, K and V
// copied raw by cp.async into a double-buffered ring in shared memory (rows
// padded to D + 4 floats, so each fragment load hits 32 banks; rows past Sk
// and lanes past D are zero-filled). Q's fragments are split once and kept
// in registers (D <= 64) or re-read from shared memory (D <= 128). S = Q K^T
// on mma.sync.m16n8k8 with K split in registers, one chain of 3 D / 8
// steps a tile; the online softmax in f32 on the accumulators (ex2.approx,
// a few ulp, of logits times scale * log2(e), the running max
// and the per-thread partial sums rescaled as they move, keys past Sk
// masked); P split in registers and fed back as the A fragment of P.V: the
// accumulator of key columns (2t, 2t + 1) is the A fragment of the keys
// taken in the order 2t <-> t, 2t + 1 <-> t + 4, so V's rows 8j + 2t and 8j
// + 2t + 1 are read as b0 and b1 (no shuffle); V split in registers. Each
// tile's P.V is one chain of 24 steps into a tile accumulator, and O =
// alpha O + tile in f32 (the tensor core truncates its sums: tf32_mma.cuh;
// one chain over all 2880 keys missed 1e-5). Two blocks an SM, up to 255
// registers a thread. The output is divided by the row sum at the end. Bound on the H100 by
// operations at the UNet's spatial shapes: 4 Sq Sk D flops a head, three
// TF32 passes, at 495 TFLOP/s: 3 * 4 Sq Sk D / 495e12 s.
//
// attention_f32_frames, the short-sequence body (self-attention over a few
// rows, 1 <= Sq = Sk < 64: the frame-axis sites' 16 frames and XL's 24; D
// <= 128 and the 16-byte rows the tensor-core body takes). It replaces the
// float32 form of dvdx_tpu/ops/pallas/temporal_attention.py:
// temporal_attention_fm (and _posmajor), and the fused block's two
// frame-axis attentions. Bound on the H100 by bytes: q, k and v read once
// and out written once, 16 Sq D bytes a (b, n, h), at 3.35 TB/s (the
// arithmetic, 4 Sq^2 D flops a head, is about F / 4 flops a byte: at 16
// frames 14 us of 70 at level 1 on the CUDA cores, 6 us as three TF32
// passes). So the design streams each byte once, with many in flight, and
// keeps the arithmetic out of the way:
//   - work items are the (b, n, h) in order, h fastest, so in both layouts
//     R adjacent items of one frame lie in one run of R * D floats; a
//     persistent grid (as many blocks as are co-resident) walks runs of R
//     items, R * ceil(Sq / 16) = 4 warps' worth (R = 4 at 16 frames);
//   - a run's q, k and v rows, for every frame, go by 16-byte cp.async
//     into a two-stage ring in shared memory (rows padded to DK + 4 floats,
//     so fragment loads hit 32 banks), the next run's copies in flight
//     while this run computes; each copying thread keeps one item and one
//     16-byte column and walks the frames, so it divides once a run; rows
//     past Sq and lanes past D stay zero from the start;
//   - a warp takes one item and 16 query rows (one m16 tile: the 16 frames
//     exactly), keys in chunks of 16: S = Q K^T is 2 n8-tiles over D / 8
//     k-steps on mma.sync.m16n8k8 in three TF32 passes (one chain of 3 D / 8
//     steps a chunk), the online softmax of the tensor-core body on the
//     accumulators (keys past Sq masked), and P.V 2 k-steps a chunk over D /
//     8 n8-tiles chained into O after O = alpha O (at most 4 chunks: a
//     chain of at most 24 steps, which the truncated sums hold within 1e-5,
//     tests/test_torch_tf32_split.py); the row sums quad-reduced, the rows
//     divided, float2 stores of whole 32-byte sectors;
//   - register-blocked CUDA-core arithmetic was not chosen: the warp-per-
//     row body it would replace spent most of its time on D serial FMAs a
//     logit with both operands from shared memory, and the tensor cores
//     take each fragment once.
//
// attention_f32_rows, the CUDA-core body (every other shape: odd strides, D
// up to 384, Sq != Sk below 64 rows): a block of 8 warps takes 8
// query rows; keys in tiles of 32 staged in shared memory (K rows padded to
// MAX_D + 1 floats), lane j takes key j of the tile: its logit is one f32
// dot product over d in order; the tile's max and the denominator's
// increment are fixed butterflies across the warp; the probabilities go
// through shared memory and each lane adds P.V for its own d = lane, lane +
// 32, ... over the tile's keys in order. Two instantiations: MAX_D = 128
// (37.1 KB of shared memory) and MAX_D = 384 (109.1 KB; the fused block's
// one-head widths). Bound on the H100 by f32 operations at long sequences
// (4 S T D flops at 67 TFLOP/s), else by bytes.
//
// Layout: an element (b, n, s, h, d) of q, k, v or out lies at
// b * sb + n * sn + s * ss + h * sh + d, strides per tensor, so one kernel
// takes flash's (B, S, H, D) (N = 1), frame-axis attention's frame-major
// (B, F, N, H*D) and position-major (B, N, F, H*D) layouts, and the tail's
// token rows against its (N, T, H*D) context. The mma and rows bodies run
// one grid axis, the row tiles of one (b, n, h) adjacent, then the heads,
// then (b, n), so the blocks that read one head's K and V run together.
// Every sum has a fixed order and there are no atomics, so a rerun is
// bit-identical.
//
// ``Site`` only names the kernel for profilers (its demangled name carries
// the calling kernel's name).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace dvdx {
namespace f32 {

struct Strides {
  long long b, n, s, h;
};

constexpr int ATT_WARPS = 8;  // query rows per block
constexpr int ATT_KT = 32;    // keys per tile: one per lane
constexpr int ATT_MAX_D = 384;

template <int MAX_D>
constexpr size_t att_smem_bytes() {
  return sizeof(float) * (ATT_KT * (2 * MAX_D + 1) + ATT_WARPS * (MAX_D + ATT_KT));
}

template <class Site, int MAX_D>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_f32_rows(const float* q, const float* k, const float* v, float* out, int N, int H,
                   int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale) {
  extern __shared__ float smem[];
  auto k_tile = reinterpret_cast<float (*)[MAX_D + 1]>(smem);                   // [ATT_KT]
  auto v_tile = reinterpret_cast<float (*)[MAX_D]>(smem + ATT_KT * (MAX_D + 1));  // [ATT_KT]
  auto q_rows = reinterpret_cast<float (*)[MAX_D]>(smem + ATT_KT * (2 * MAX_D + 1));
  auto p_rows = reinterpret_cast<float (*)[ATT_KT]>(smem + ATT_KT * (2 * MAX_D + 1) +
                                                    ATT_WARPS * MAX_D);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int tiles = (Sq + ATT_WARPS - 1) / ATT_WARPS;
  const int bnh = blockIdx.x / tiles;
  const int s = (blockIdx.x - bnh * tiles) * ATT_WARPS + w;
  const bool live = s < Sq;  // a warp past Sq still helps stage the tiles
  const int h = bnh % H, b = bnh / H / N, n = bnh / H % N;
  const float* kp = k + b * ks.b + n * ks.n + h * ks.h;
  const float* vp = v + b * vs.b + n * vs.n + h * vs.h;
  if (live) {
    const float* qp = q + b * qs.b + n * qs.n + s * qs.s + h * qs.h;
    for (int d = lane; d < D; d += 32) q_rows[w][d] = qp[d];
  }
  float acc[MAX_D / 32] = {};
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < Sk; t0 += ATT_KT) {
    __syncthreads();  // the last tile is consumed (and q_rows written)
    for (int e = threadIdx.x; e < ATT_KT * D; e += ATT_WARPS * 32) {
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
      for (int j = 0; j < ATT_KT; ++j) a = fmaf(p_rows[w][j], v_tile[j][d], a);
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

template <class Site, int MAX_D>
int attention_f32_run(unsigned blocks, const float* q, const float* k, const float* v,
                      float* out, int N, int H, int Sq, int Sk, int D, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale, cudaStream_t stream) {
  constexpr size_t smem = att_smem_bytes<MAX_D>();
  auto kernel = attention_f32_rows<Site, MAX_D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, ATT_WARPS * 32, smem, stream>>>(q, k, v, out, N, H, Sq, Sk, D, qs, ks, vs,
                                                   os, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the tensor-core body ---------------------------------------------------

// 2^x on the special-function unit (a few ulp); results below 2^-126 flush
// to zero, probabilities that add nothing to an f32 row sum
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int MMA_WARPS = 4;
constexpr int MMA_BQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_BK = 64;              // keys per tile
constexpr int MMA_MAX_D = 128;

template <int DK>  // head width padded to 32, 64 or 128 lanes
struct MmaCfg {
  static constexpr int LD = DK + 4;                // padded shared row, floats
  static constexpr int TILE = MMA_BK * LD;         // floats of one K or V tile
  static constexpr bool Q_REGS = DK <= 64;         // Q's split fragments in registers
  static constexpr size_t SMEM =
      sizeof(float) * (4 * TILE + (Q_REGS ? 0 : MMA_BQ * LD));  // 2 stages of K and V
};

template <class Site, int DK>
__global__ void __launch_bounds__(MMA_WARPS * 32, DK <= 64 ? 2 : 1)
attention_f32_mma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int N, int H, int Sq,
                  int Sk, int D, Strides qs, Strides ks, Strides vs, Strides os,
                  float scale_log2) {
  using Cf = MmaCfg<DK>;
  constexpr int LD = Cf::LD, KD = DK / 8;  // KD: k-steps over d, and 8-lane column tiles
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [2][MMA_BK][LD]
  float* v_s = k_s + 2 * Cf::TILE;               // [2][MMA_BK][LD]
  float* q_s = v_s + 2 * Cf::TILE;               // [MMA_BQ][LD] where !Q_REGS
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (Sq + MMA_BQ - 1) / MMA_BQ;
  const int bnh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bnh * tiles) * MMA_BQ;
  const int h = bnh % H, b = bnh / H / N, n = bnh / H % N;
  const float* qp = q + b * qs.b + n * qs.n + h * qs.h;
  const float* kp = k + b * ks.b + n * ks.n + h * ks.h;
  const float* vp = v + b * vs.b + n * vs.n + h * vs.h;
  const int n_tiles = (Sk + MMA_BK - 1) / MMA_BK;

  // rows r0 .. r0 + rows - 1 of a (len, D) matrix with row stride rs into
  // dst [rows][LD]: 16-byte copies, zero past len and past D
  auto load_rows = [&](float* dst, const float* src, long long rs, int r0, int rows,
                       int len) {
    constexpr int CH = DK / 4;
    for (int c = tid; c < rows * CH; c += MMA_WARPS * 32) {
      const int r = c / CH, d = (c - r * CH) * 4;
      const bool in = r0 + r < len && d < D;
      cp_async16(dst + r * LD + d, in ? src + (long long)(r0 + r) * rs + d : src, in ? 16 : 0);
    }
  };

  uint32_t qb[Cf::Q_REGS ? KD : 1][4], ql[Cf::Q_REGS ? KD : 1][4];  // Q's big / small parts
  if constexpr (Cf::Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + warp * 16 + g + (i & 1) * 8, d = kk * 8 + t + (i >> 1) * 4;
        tf32_split(r < Sq && d < D ? __ldg(qp + (long long)r * qs.s + d) : 0.f, qb[kk][i],
                   ql[kk][i]);
      }
  } else {
    load_rows(q_s, qp, qs.s, q0, MMA_BQ, Sq);
  }
  load_rows(k_s, kp, ks.s, 0, MMA_BK, Sk);
  load_rows(v_s, vp, vs.s, 0, MMA_BK, Sk);
  cp_async_commit();

  float o[KD][4];
#pragma unroll
  for (int i = 0; i < KD; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {  // the other stage was consumed before the last barrier
      load_rows(k_s + (st ^ 1) * Cf::TILE, kp, ks.s, (j + 1) * MMA_BK, MMA_BK, Sk);
      load_rows(v_s + (st ^ 1) * Cf::TILE, vp, vs.s, (j + 1) * MMA_BK, MMA_BK, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = k_s + st * Cf::TILE;
    const float* vt = v_s + st * Cf::TILE;

    // S = Q K^T: 16 rows x 64 keys a warp, s[nj] the keys 8 nj .. 8 nj + 7
    float s[8][4];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) s[nj][0] = s[nj][1] = s[nj][2] = s[nj][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ab[4], al[4];
      if constexpr (Cf::Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ab[i] = qb[kk][i], al[i] = ql[kk][i];
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tf32_split(q_s[(warp * 16 + g + (i & 1) * 8) * LD + kk * 8 + t + (i >> 1) * 4], ab[i],
                     al[i]);
      }
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        uint32_t b0, b1, b0l, b1l;
        b_frag(kt + (nj * 8 + g) * LD + kk * 8 + t, 4, b0, b1, b0l, b1l);
        mma_3xtf32(s[nj], ab, al, b0, b1, b0l, b1l);
      }
    }
    if ((j + 1) * MMA_BK > Sk) {  // the ragged key tail adds nothing
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j * MMA_BK + nj * 8 + 2 * t + (c & 1) >= Sk) s[nj][c] = -INFINITY;
    }

    // the online softmax of rows g (c = 0, 1) and g + 8 (c = 2, 3)
    float alpha[2], ms[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) mx = fmaxf(mx, fmaxf(s[nj][2 * r], s[nj][2 * r + 1]));
      mx = quad_max(mx);
      alpha[r] = fast_exp2((m_run[r] - mx) * scale_log2);
      m_run[r] = mx;
      ms[r] = mx * scale_log2;
    }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nj][c] = fast_exp2(fmaf(s[nj][c], scale_log2, -ms[c >> 1]));
        rowsum[c >> 1] += s[nj][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], rowsum[r]);
    float ot[KD][4];  // this tile's P.V
#pragma unroll
    for (int i = 0; i < KD; ++i) ot[i][0] = ot[i][1] = ot[i][2] = ot[i][3] = 0.f;

    // O += P V over the keys 8 kj .. 8 kj + 7, taken in the order of P's
    // accumulator columns (A column t <-> key 2t, t + 4 <-> key 2t + 1)
#pragma unroll
    for (int kj = 0; kj < 8; ++kj) {
      uint32_t pb[4], pl[4];
      tf32_split(s[kj][0], pb[0], pl[0]);
      tf32_split(s[kj][2], pb[1], pl[1]);
      tf32_split(s[kj][1], pb[2], pl[2]);
      tf32_split(s[kj][3], pb[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        uint32_t b0, b1, b0l, b1l;
        b_frag(vt + (kj * 8 + 2 * t) * LD + dn * 8 + g, LD, b0, b1, b0l, b1l);
        mma_3xtf32(ot[dn], pb, pl, b0, b1, b0l, b1l);
      }
    }
#pragma unroll
    for (int i = 0; i < KD; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] = fmaf(o[i][c], alpha[c >> 1], ot[i][c]);
    __syncthreads();  // stage st is refilled by the next iteration's copies
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l_run[r]);
  const int row = q0 + warp * 16 + g;
  float* ob = out + b * os.b + n * os.n + h * os.h;
#pragma unroll
  for (int dn = 0; dn < KD; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (col >= D) continue;  // D % 4 == 0: a column pair is in or out
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < Sq)
        *reinterpret_cast<float2*>(ob + (long long)(row + 8 * r) * os.s + col) =
            make_float2(o[dn][2 * r] * inv[r], o[dn][2 * r + 1] * inv[r]);
  }
}

template <class Site, int DK>
int attention_mma_run(unsigned blocks, const float* q, const float* k, const float* v,
                      float* out, int N, int H, int Sq, int Sk, int D, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale, cudaStream_t stream) {
  constexpr size_t smem = MmaCfg<DK>::SMEM;
  auto kernel = attention_f32_mma<Site, DK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, MMA_WARPS * 32, smem, stream>>>(q, k, v, out, N, H, Sq, Sk, D, qs, ks, vs,
                                                   os, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ---- the short-sequence body ------------------------------------------------

constexpr int FR_WARPS = 4;   // warps of a block: one (item, 16-row m-tile) each
constexpr int FR_MAX_S = 63;  // rows it takes (Sq = Sk); 64 and more go to the mma body

// The stage of a run: R items x 3 tensors x FP rows (Sq padded to 16) of LD
// floats; R * FP / 16 = 4 units of work, R a power of two
struct FramesPlan {
  int fp, r, r_log2;
  size_t smem(int ld) const { return sizeof(float) * 2 * 3 * r * fp * ld; }
};

inline FramesPlan frames_plan(int Sq) {
  const int fp = (Sq + 15) & ~15, mt = fp / 16;
  const int r = mt == 1 ? 4 : mt == 2 ? 2 : 1;
  return {fp, r, r == 4 ? 2 : r == 2 ? 1 : 0};
}

template <class Site, int DK>  // head width padded to 32, 64 or 128 lanes
__global__ void __launch_bounds__(FR_WARPS * 32, 2)
attention_f32_frames(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int N, int H, int S,
                     int D, Strides qs, Strides ks, Strides vs, Strides os, float scale_log2,
                     int items, int fp, int r_log2) {
  constexpr int LD = DK + 4, CH = DK / 4, KD = DK / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int R = 1 << r_log2, mt = fp >> 4;
  const int item_rows = fp * LD;              // floats of one item's rows of one tensor
  const int tensor = R * item_rows;           // floats of one tensor's rows in a stage
  const int stage = 3 * tensor;
  const int runs = (items + R - 1) >> r_log2;
  const int ks_n = (D + 7) >> 3;              // k-steps over d, and 8-lane column tiles

  // rows past S and lanes past D stay zero: the copies never write them
  for (int i = tid; i < 2 * stage / 4; i += FR_WARPS * 32) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the copy role of this thread: item ci of a run, 16-byte column cc, frames
  // cf, cf + cstep, ...
  const int cc = (tid & (CH - 1)) * 4, ci = (tid / CH) & (R - 1);
  const int cf = tid / (CH * R), cstep = FR_WARPS * 32 / (CH * R);
  auto load_run = [&](int run, int st) {
    const int item = (run << r_log2) + ci;
    if (item >= items || cc >= D) return;
    const int h = item % H, bn = item / H, n = bn % N, b = bn / N;
    const float* qp = q + b * qs.b + n * qs.n + h * qs.h + cc;
    const float* kp = k + b * ks.b + n * ks.n + h * ks.h + cc;
    const float* vp = v + b * vs.b + n * vs.n + h * vs.h + cc;
    float* dst = smem + st * stage + ci * item_rows + cc;
    for (int f = cf; f < S; f += cstep) {
      cp_async16(dst + f * LD, qp + f * qs.s, 16);
      cp_async16(dst + tensor + f * LD, kp + f * ks.s, 16);
      cp_async16(dst + 2 * tensor + f * LD, vp + f * vs.s, 16);
    }
  };

  int run = blockIdx.x;
  if (run < runs) load_run(run, 0);
  cp_async_commit();
  for (int j = 0; run < runs; ++j, run += gridDim.x) {
    const int st = j & 1;
    if (run + gridDim.x < runs) load_run(run + gridDim.x, st ^ 1);  // consumed before the last barrier
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int unit = warp, ui = unit / mt, m0 = (unit - ui * mt) * 16;
    const int item = (run << r_log2) + ui;
    if (ui < R && item < items) {
      const float* qt = smem + st * stage + ui * item_rows + m0 * LD;
      const float* kt = smem + st * stage + tensor + ui * item_rows;
      const float* vt = kt + tensor;
      float o[KD][4];
#pragma unroll
      for (int i = 0; i < KD; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
      for (int kc = 0; kc < S; kc += 16) {  // chunks of 16 keys, each with a key below S
        // S = Q K^T: the warp's 16 rows x the chunk's 16 keys, one chain
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (kk >= ks_n) break;
          uint32_t ab[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tf32_split(qt[(g + (i & 1) * 8) * LD + kk * 8 + t + (i >> 1) * 4], ab[i], al[i]);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            uint32_t b0, b1, b0l, b1l;
            b_frag(kt + (kc + nj * 8 + g) * LD + kk * 8 + t, 4, b0, b1, b0l, b1l);
            mma_3xtf32(s[nj], ab, al, b0, b1, b0l, b1l);
          }
        }
        if (kc + 16 > S) {  // keys past S add nothing
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (kc + nj * 8 + 2 * t + (c & 1) >= S) s[nj][c] = -INFINITY;
        }
        // the online softmax of rows g (c = 0, 1) and g + 8 (c = 2, 3)
        float alpha[2], ms[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx = quad_max(fmaxf(m_run[r], fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                                          fmaxf(s[1][2 * r], s[1][2 * r + 1]))));
          alpha[r] = fast_exp2((m_run[r] - mx) * scale_log2);
          m_run[r] = mx;
          ms[r] = mx * scale_log2;
        }
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[nj][c] = fast_exp2(fmaf(s[nj][c], scale_log2, -ms[c >> 1]));
            rowsum[c >> 1] += s[nj][c];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = fmaf(l_run[r], alpha[r], rowsum[r]);
#pragma unroll
        for (int i = 0; i < KD; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[i][c] *= alpha[c >> 1];
        // O += P V over the chunk's keys 8 kj .. 8 kj + 7, in the order of
        // P's accumulator columns (as the tensor-core body)
#pragma unroll
        for (int kj = 0; kj < 2; ++kj) {
          uint32_t pb[4], pl[4];
          tf32_split(s[kj][0], pb[0], pl[0]);
          tf32_split(s[kj][2], pb[1], pl[1]);
          tf32_split(s[kj][1], pb[2], pl[2]);
          tf32_split(s[kj][3], pb[3], pl[3]);
#pragma unroll
          for (int dn = 0; dn < KD; ++dn) {
            if (dn >= ks_n) break;
            uint32_t b0, b1, b0l, b1l;
            b_frag(vt + (kc + kj * 8 + 2 * t) * LD + dn * 8 + g, LD, b0, b1, b0l, b1l);
            mma_3xtf32(o[dn], pb, pl, b0, b1, b0l, b1l);
          }
        }
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l_run[r]);
      const int h = item % H, bn = item / H, n = bn % N, b = bn / N;
      float* ob = out + b * os.b + n * os.n + h * os.h;
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        const int col = dn * 8 + 2 * t;
        if (col >= D) continue;  // D % 4 == 0: a column pair is in or out
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + g + 8 * r;
          if (row < S)
            *reinterpret_cast<float2*>(ob + (long long)row * os.s + col) =
                make_float2(o[dn][2 * r] * inv[r], o[dn][2 * r + 1] * inv[r]);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's copies
  }
}

template <class Site, int DK>
int attention_frames_run(int items, const float* q, const float* k, const float* v, float* out,
                         int N, int H, int S, int D, Strides qs, Strides ks, Strides vs,
                         Strides os, float scale, cudaStream_t stream) {
  const FramesPlan pl = frames_plan(S);
  const size_t smem = pl.smem(DK + 4);
  auto kernel = attention_f32_frames<Site, DK>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  // co-resident blocks on the card, by stage size (R * FP is 64 rows, or 48 at
  // 33-48 rows)
  static int capacity[2] = {0, 0};
  int& cap = capacity[pl.r * pl.fp == 64];
  if (e == cudaSuccess && cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FR_WARPS * 32, smem);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) cap = sms * per_sm;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int runs = (items + pl.r - 1) >> pl.r_log2;
  const int grid = runs < cap ? runs : cap;
  kernel<<<grid, FR_WARPS * 32, smem, stream>>>(q, k, v, out, N, H, S, D, qs, ks, vs, os,
                                                scale * 1.4426950408889634f, items, pl.fp,
                                                pl.r_log2);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline bool rows_of_16_bytes(const Strides& s) {
  return s.b % 4 == 0 && s.n % 4 == 0 && s.s % 4 == 0 && s.h % 4 == 0;
}

// The bodies, as ops/kernels/attention_f32.py names them
enum Body { BODY_ROWS = 0, BODY_MMA = 1, BODY_FRAMES = 2 };

// q, out: Sq rows, k, v: Sk rows, of B x N x H heads of width D, float32,
// unit stride along d; each tensor's b / n / s / h strides in elements.
// body: BODY_MMA, which takes Sq >= 64, D <= 128, D and every stride a
// multiple of 4 and 16-byte aligned bases, and ceil(Sq / 64) * H * B * N <
// 2^31; BODY_FRAMES, which takes 1 <= Sq = Sk < 64, the same widths,
// strides and bases, and H * B * N < 2^31; else the CUDA-core rows, D <=
// 384, ceil(Sq / 8) * H * B * N < 2^31. A body asked for a shape it does not
// take returns cudaErrorInvalidValue.
template <class Site>
int attention_f32_launch(const float* q, const float* k, const float* v, float* out, int B,
                         int N, int H, int Sq, int Sk, int D, Strides qs, Strides ks,
                         Strides vs, Strides os, float scale, int body, cudaStream_t stream) {
  if (B < 1 || N < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > ATT_MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool packed = D <= MMA_MAX_D && D % 4 == 0 && rows_of_16_bytes(qs) &&
                      rows_of_16_bytes(ks) && rows_of_16_bytes(vs) && rows_of_16_bytes(os) &&
                      aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  if (body == BODY_MMA) {
    const long long blocks = (long long)((Sq + MMA_BQ - 1) / MMA_BQ) * H * B * N;
    if (Sq < MMA_BQ || !packed || blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned nb = static_cast<unsigned>(blocks);
    if (D <= 32)
      return attention_mma_run<Site, 32>(nb, q, k, v, out, N, H, Sq, Sk, D, qs, ks, vs, os,
                                         scale, stream);
    if (D <= 64)
      return attention_mma_run<Site, 64>(nb, q, k, v, out, N, H, Sq, Sk, D, qs, ks, vs, os,
                                         scale, stream);
    return attention_mma_run<Site, 128>(nb, q, k, v, out, N, H, Sq, Sk, D, qs, ks, vs, os,
                                        scale, stream);
  }
  if (body == BODY_FRAMES) {
    const long long items = (long long)H * B * N;
    if (Sq != Sk || Sq > FR_MAX_S || !packed || items > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const int it = static_cast<int>(items);
    if (D <= 32)
      return attention_frames_run<Site, 32>(it, q, k, v, out, N, H, Sq, D, qs, ks, vs, os,
                                            scale, stream);
    if (D <= 64)
      return attention_frames_run<Site, 64>(it, q, k, v, out, N, H, Sq, D, qs, ks, vs, os,
                                            scale, stream);
    return attention_frames_run<Site, 128>(it, q, k, v, out, N, H, Sq, D, qs, ks, vs, os,
                                           scale, stream);
  }
  if (body != BODY_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)((Sq + ATT_WARPS - 1) / ATT_WARPS) * H * B * N;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  return D <= 128 ? attention_f32_run<Site, 128>(nb, q, k, v, out, N, H, Sq, Sk, D, qs, ks,
                                                 vs, os, scale, stream)
                  : attention_f32_run<Site, ATT_MAX_D>(nb, q, k, v, out, N, H, Sq, Sk, D, qs,
                                                       ks, vs, os, scale, stream);
}

}  // namespace f32
}  // namespace dvdx
