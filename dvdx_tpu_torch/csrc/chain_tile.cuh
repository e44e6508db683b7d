// The 64-row tile chain shared by the fused kernels' chains
// (temporal_block.cu: temporal_block_chain, spatial_tail.cu:
// spatial_tail_chain): one CTA per 64-row tile, two consumer warpgroups
// and a producer warp (288 threads, one CTA per SM).
//   * x lives in registers for the whole chain, in the wgmma accumulator
//     layout of an m64 n(C/2) product: warpgroup w (of 2) holds columns
//     [w C/2, (w+1) C/2) of all 64 rows, so each residual add is register
//     local. LayerNorm (chain_layernorm) reduces a row over the 4 lanes of a
//     quad and the two warpgroups (one exchange through shared memory).
//   * each C x C product (ring_product) runs on wgmma m64 n(C/2) k16: A, a
//     64 x C bf16 buffer in shared memory in TMA's 128-byte swizzled layout;
//     B, the weight in nn.Linear's (out, in) layout, streamed by the producer
//     warp's one thread (produce_weight) through a ring of half-width
//     64-deep slices (C/2 x 64, 20 KB at C = 320) with TMA. The stage count
//     is even and every fill alternates between the warpgroups (fill g goes
//     to stage g % stages and to warpgroup g % 2), so each stage always
//     feeds one warpgroup, which consumes its fills in order, as a parity
//     wait needs. A chain may put fills of its own between products (the
//     spatial tail's context K / V) as long as it keeps that alternation.
#pragma once

#include "fused_rows.cuh"
#include "hopper.cuh"

namespace dvdx {
namespace chain {

constexpr int TILE = 64;             // rows per tile: one wgmma m64
constexpr int THREADS = 288;         // warpgroups 0-1 consume, warp 8 loads
constexpr int CONSUMERS = 256;
constexpr int PRODUCER = 256;        // the producer thread
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may use
constexpr int BAR_CONSUMERS = 1;     // named barrier of the two consumer warpgroups

// one half-width 64-deep slice of a C x C weight
__host__ __device__ constexpr int slice_bytes(int C) { return C / 2 * 128; }

// Byte offset of (row r, column c) in a 64 x C buffer laid out as TMA's
// 128-byte swizzle writes it: 64-column boxes of 64 rows x 128 bytes, the
// 16-byte chunk j of row r at j ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * (TILE * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// What a consumer thread knows of its place: warpgroup wg owns columns
// [wg C/2, (wg+1) C/2); the thread holds rows r0 and r0 + 8 at columns
// cb + 8 j, cb + 8 j + 1. hs is the A operand buffer of the products.
struct Tile {
  int wg, warp, lane, r0, cb;
  unsigned char *hs, *ring;
  uint64_t *full, *empty;
  float* red;
  int stages, stage_bytes;
};

__device__ __forceinline__ void consumers_sync() { named_bar_sync(BAR_CONSUMERS, CONSUMERS); }

// Shared-memory layout of the ring's barriers: full[MAX_STAGES], then
// empty[MAX_STAGES]. Thread 0 initialises them before the block's
// __syncthreads.
__device__ __forceinline__ void ring_init(const Tile& t) {
  for (int s = 0; s < t.stages; ++s) {
    mbar_init(&t.full[s], 1);
    mbar_init(&t.empty[s], 4);  // the consuming warpgroup's warps
  }
}

// Stage and parity of fill g.
__device__ __forceinline__ void fill_slot(const Tile& t, int g, int& st, uint32_t& parity) {
  st = g % t.stages;
  parity = (g / t.stages) & 1;
}

// A warp is done with the stage: its lane 0 arrives (4 arrivals free it).
__device__ __forceinline__ void release_stage(const Tile& t, int st) {
  __syncwarp();
  if (t.lane == 0) mbar_arrive(&t.empty[st]);
}

// The producer's place in the ring: the next stage to fill and its phase.
struct RingCursor {
  int st = 0;
  uint32_t ph = 0;

  // Wait for the stage to be free and announce `bytes` of TMA into it;
  // returns the stage's address (the loads signal full[st]).
  __device__ __forceinline__ unsigned char* acquire(const Tile& t, uint32_t bytes) {
    mbar_wait(&t.empty[st], ph ^ 1);
    mbar_expect_tx(&t.full[st], bytes);
    return t.ring + st * t.stage_bytes;
  }

  // A fill with nothing to load (it keeps the warpgroups' alternation).
  __device__ __forceinline__ void skip(const Tile& t) {
    mbar_wait(&t.empty[st], ph ^ 1);
    mbar_arrive(&t.full[st]);
  }

  __device__ __forceinline__ uint64_t* bar(const Tile& t) { return &t.full[st]; }

  __device__ __forceinline__ void advance(const Tile& t) {
    if (++st == t.stages) {
      st = 0;
      ph ^= 1;
    }
  }
};

// Producer: the 2 * C/64 fills of one C x C weight in the order ring_product
// consumes them, slice (kb, half) for warpgroup `half`.
template <int C>
__device__ __forceinline__ void produce_weight(const Tile& t, RingCursor& cur,
                                               const CUtensorMap* map) {
  constexpr int NH = C / 2;
  constexpr int STAGE = slice_bytes(C);
  for (int kb = 0; kb < C / 64; ++kb)
    for (int half = 0; half < 2; ++half) {
      unsigned char* sp = cur.acquire(t, STAGE);
      tma_load_2d(sp, map, cur.bar(t), kb * 64, half * NH);
      tma_load_2d(sp + STAGE / 2, map, cur.bar(t), kb * 64, half * NH + NH / 2);
      cur.advance(t);
    }
}

// acc = A (hs, 64 x C) * W^T for this warpgroup's columns, W's slices the
// fills fill0 + 2 kb + wg of the ring. A slice is released once the next
// slice's products are started and its own are done, so two products are in
// flight (releasing each slice as soon as its products were done measured
// slower, utils/kernel_probe); with one stage per warpgroup it must be
// released before its refill is awaited.
template <int C>
__device__ __forceinline__ void ring_product(const Tile& t, int fill0, float (&acc)[C / 4]) {
  constexpr int KS = C / 64;
#pragma unroll
  for (int i = 0; i < C / 4; ++i) acc[i] = 0.f;
  const uint32_t a0 = smem_u32(t.hs);
  const bool one_stage = t.stages == 2;
  int prev = -1;
  for (int kb = 0; kb < KS; ++kb) {
    int st;
    uint32_t parity;
    fill_slot(t, fill0 + 2 * kb + t.wg, st, parity);
    mbar_wait(&t.full[st], parity);
    const uint32_t a = a0 + kb * (TILE * 128);
    const uint32_t b = smem_u32(t.ring + st * t.stage_bytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, sw128_desc(a + kk * 32, 16, 1024), sw128_desc(b + kk * 32, 16, 1024), 1);
    wgmma_commit();
    if (one_stage) {
      wgmma_wait<0>();
      release_stage(t, st);
      continue;
    }
    wgmma_wait<1>();  // the previous slice's products are done
    if (prev >= 0) release_stage(t, prev);
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0) release_stage(t, prev);
}

// bf16(acc) into a 64 x C buffer at this thread's places
template <int C>
__device__ __forceinline__ void store_acc(const Tile& t, unsigned char* buf,
                                          const float (&acc)[C / 4]) {
#pragma unroll
  for (int j = 0; j < C / 16; ++j) {
    const int c = t.cb + 8 * j;
    *reinterpret_cast<uint32_t*>(buf + swz(t.r0, c)) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(buf + swz(t.r0 + 8, c)) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// x (registers) from a 64 x C swizzled buffer, and back
template <int C>
__device__ __forceinline__ void load_x(const Tile& t, const unsigned char* buf,
                                       uint32_t (&xr)[C / 16][2]) {
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xr[j][h] = *reinterpret_cast<const uint32_t*>(buf + swz(t.r0 + 8 * h, t.cb + 8 * j));
}

template <int C>
__device__ __forceinline__ void store_x(const Tile& t, unsigned char* buf,
                                        const uint32_t (&xr)[C / 16][2]) {
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(buf + swz(t.r0 + 8 * h, t.cb + 8 * j)) = xr[j][h];
}

// x = epi(x, acc, bias) at every place of this thread: the out-projection's
// residual epilogue (resid_then_bias or bias_then_resid, fused_rows.cuh)
template <int C, typename Epi>
__device__ __forceinline__ void residual(const Tile& t, uint32_t (&xr)[C / 16][2],
                                         const float (&acc)[C / 4],
                                         const bf16* __restrict__ bias, Epi epi) {
  uint32_t bo[C / 16];
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
    bo[j] = __ldg(reinterpret_cast<const unsigned int*>(bias + t.cb + 8 * j));
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xr[j][h] = pack_bf16(epi(bf_lo(xr[j][h]), acc[4 * j + 2 * h], bf_lo(bo[j])),
                           epi(bf_hi(xr[j][h]), acc[4 * j + 2 * h + 1], bf_hi(bo[j])));
}

// LayerNorm of x (registers) with flax's math: f32 moments with the fast
// variance, (x - mean) / sqrt(var + eps) * scale + bias, rounded to bf16.
// Writes pairs through put(row index 0/1, column, packed pair), after a
// barrier of both warpgroups (so a put may overwrite the A buffer of a
// product both just finished).
template <int C, typename Put>
__device__ __forceinline__ void chain_layernorm(const Tile& t, const uint32_t (&xr)[C / 16][2],
                                                const bf16* __restrict__ scale,
                                                const bf16* __restrict__ bias, float eps,
                                                Put put) {
  float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = bf_lo(xr[j][h]), b = bf_hi(xr[j][h]);
      s[h] += a + b;
      q[h] += a * a + b * b;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] = quad_sum(s[h]);
    q[h] = quad_sum(q[h]);
    if ((t.lane & 3) == 0) {
      t.red[(t.wg * TILE + t.r0 + 8 * h) * 2] = s[h];
      t.red[(t.wg * TILE + t.r0 + 8 * h) * 2 + 1] = q[h];
    }
  }
  consumers_sync();
  float mean[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t.r0 + 8 * h;
    const float sum = t.red[r * 2] + t.red[(TILE + r) * 2];
    const float sq = t.red[r * 2 + 1] + t.red[(TILE + r) * 2 + 1];
    mean[h] = sum / C;
    inv[h] = 1.f / sqrtf(sq / C - mean[h] * mean[h] + eps);
  }
  uint32_t sc[C / 16], bi[C / 16];  // this thread's column pairs, all loads in flight
#pragma unroll
  for (int j = 0; j < C / 16; ++j) {
    sc[j] = __ldg(reinterpret_cast<const unsigned int*>(scale + t.cb + 8 * j));
    bi[j] = __ldg(reinterpret_cast<const unsigned int*>(bias + t.cb + 8 * j));
  }
#pragma unroll
  for (int j = 0; j < C / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y0 = (bf_lo(xr[j][h]) - mean[h]) * inv[h] * bf_lo(sc[j]) + bf_lo(bi[j]);
      const float y1 = (bf_hi(xr[j][h]) - mean[h]) * inv[h] * bf_hi(sc[j]) + bf_hi(bi[j]);
      put(h, t.cb + 8 * j, pack_bf16(y0, y1));
    }
}


}  // namespace chain
}  // namespace dvdx
