// The GEGLU feed-forward as two wgmma products with fused epilogues, shared
// by geglu_ff.cu and the FF launches of spatial_tail.cu and temporal_block.cu:
//   geglu_in:  h   = bf16(bf16(x Wv + bv) * gelu_erf(bf16(x Wg + bg)))  (T, I)
//   geglu_out: y   = h Wo^T + bo                                         (T, C)
//              out = bf16(y), or with a residual out = resid + bf16(y)
// (the fused kernels' epilogue: the FF output bias is added in f32 before
// the one rounding). Value and gate are rounded to bf16 where the reference
// materialises them, GELU is the exact-erf form with CUDA's erff.
//
// Replaces the feed-forward of dvdx_tpu/ops/pallas/geglu_ff.py:geglu_ff
// (_geglu_kernel) and the GEGLU part of spatial_tail.py:fused_spatial_tail
// and temporal_block.py:fused_temporal_block.
//
// Why two launches: on this card the inner tensor h costs little to write
// and read back. At level 2 (T = 5760, I = 5120) it is 2*T*I*2 = 118 MB of
// traffic, 35 us at 3.35 TB/s, against a 229 us operation bound; at level 0
// in the fused kernels (T = 92160, I = 1280) 472 MB, 141 us against 229 us.
// Keeping h on chip instead (one launch) forces the whole (tile x C) f32
// output accumulator into registers, so the token tile shrinks as C grows
// (16 rows at C = 1280) and every tile re-reads all weights from L2. Two
// plain GEMMs take 128-row tiles at every width.
//
// Bound on the H100: both products are bounded by tensor-core operations at
// the UNet's token counts, but a 128 x 256 tile needs 48 KB of operands per
// 64-deep K slice, about 11 TB/s from L2 across the card at the tensor
// cores' rate: operand traffic from L2 and shared memory, not the products,
// is what the design has to cut.
//
// Design: a persistent kernel per product, launched in clusters of two CTAs
// (one per SM; cluster c walks tile pairs c, c + clusters, ...). A tile is
// 128 rows x BN columns; the two CTAs of a cluster take adjacent row tiles
// of one column tile, and the column tiles of a row pair are adjacent in the
// walk, so A rows are read from L2 while still there. Warpgroup 2 is the
// producer: one thread streams 64-wide K slices of A (128 x 64, its own
// rows) and of B into a 4-stage ring with TMA and mbarriers, running ahead
// into the next tile while the consumers finish the last. B is shared: each
// CTA loads one half (geglu_in: rank 0 the value rows [n0, n0+BN), rank 1
// the gate rows [I+n0, I+n0+BN) of w_in; geglu_out: BN/2 rows of w_out each)
// and multicasts it into both CTAs' rings, so a CTA reads 32 KB from L2 per
// slice instead of 48. Warpgroups 0 and 1 own 64 rows each and run one
// m64nNk16 wgmma per 16-deep step from shared memory (N = 256 for geglu_in:
// the value and gate tiles lie one after the other; nn.Linear's (out, in)
// weights are wgmma's K-major B as they lie), keeping one K slice in flight,
// and release a stage in both CTAs once its products are done. Rows past T
// arrive as zeros and are not stored.
//
// Determinism (Proof of Inference re-executes steps bit for bit): the tile
// shape is a pure function of (T, C, I), each tile sums its whole K range
// in one fixed order inside one block; no split-K, no atomics.
#pragma once

#include "hopper.cuh"

namespace dvdx {

constexpr int FF_BM = 128;       // rows per tile: 2 consumer warpgroups x 64
constexpr int FF_BK = 64;        // K values per stage (one 128-byte box)
constexpr int FF_STAGES = 4;
constexpr int FF_THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 loads
constexpr int FF_IN_BN = 128;    // inner columns of a geglu_in tile
constexpr int FF_CLUSTER = 2;    // CTAs per cluster: two row tiles share B
constexpr int FF_WIDE_ROWS = 4096;  // geglu_out takes 256-column tiles from here

struct FfEpilogue {
  const bf16* bias;   // geglu_in: b_in (2I, value then gate); geglu_out: b_out
  const bf16* resid;  // geglu_out: null, or the residual (rows, ldo)
  bf16* out;          // (rows, ldo)
  int ldo;
  int gate;           // geglu_in: I, the row of the first gate weight / bias
};

template <int BN, int NB>
__host__ __device__ constexpr int ff_stage_bytes() { return (FF_BM + NB * BN) * 128; }

template <int BN, int NB>
constexpr int ff_smem_bytes() {
  return 1024 + FF_STAGES * ff_stage_bytes<BN, NB>() + 2 * FF_STAGES * 8;
}

// NB == 2: geglu_in (value and gate products, GEGLU epilogue); NB == 1:
// geglu_out (bias and optional residual epilogue). The CTA of cluster rank
// r takes row tile 2 * (tp / col_tiles) + r and column tile tp % col_tiles
// of tile pair tp. A stage is refilled only when the consumers of both CTAs
// have released it. Site only names the kernel after the library that
// launches it, for profiles.
template <class Site, int BN, int NB>
__global__ void __launch_bounds__(FF_THREADS, 1)
geglu_stage(const __grid_constant__ CUtensorMap a_map,
            const __grid_constant__ CUtensorMap b_map, FfEpilogue ep, int rows,
            int kdim, int col_tiles, int pairs) {
  constexpr int A_BYTES = FF_BM * 128, B_BYTES = BN * 128;
  constexpr int B_PART = NB == 2 ? B_BYTES : B_BYTES / FF_CLUSTER;  // one CTA's load
  constexpr int STAGE_BYTES = ff_stage_bytes<BN, NB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + FF_STAGES * STAGE_BYTES);
  uint64_t* empty = full + FF_STAGES;
  const int wg = threadIdx.x >> 7;
  const int k_slices = kdim / FF_BK;
  const uint32_t rank = cluster_rank();
  const int cluster = blockIdx.x / FF_CLUSTER, clusters = gridDim.x / FF_CLUSTER;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FF_CLUSTER * 8);  // each consumer warp of the cluster
    }
    mbar_fence_init();
  }
  cluster_sync();

  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int tp = cluster; tp < pairs; tp += clusters) {
        int r0 = ((tp / col_tiles) * FF_CLUSTER + rank) * FF_BM;
        if (r0 >= rows) r0 = 0;  // no row tile here: compute a valid one, store nothing
        const int n0 = (tp % col_tiles) * BN;
        const int b_row = NB == 2 ? (rank == 0 ? n0 : ep.gate + n0)
                                  : n0 + rank * (BN / FF_CLUSTER);
        for (int kb = 0; kb < k_slices; ++kb) {
          mbar_wait(&empty[st], ph ^ 1);
          unsigned char* sp = base + st * STAGE_BYTES;
          mbar_expect_tx(&full[st], STAGE_BYTES);
          tma_load_2d(sp, &a_map, &full[st], kb * FF_BK, r0);
          tma_load_2d_multicast(sp + A_BYTES + rank * B_PART, &b_map, &full[st],
                                kb * FF_BK, b_row, (1u << FF_CLUSTER) - 1);
          if (++st == FF_STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
      // Stay until both CTAs' consumers have released every stage: after
      // that no arrival from the peer CTA targets this CTA's barriers.
      for (int i = 0; i < FF_STAGES; ++i) {
        mbar_wait(&empty[st], ph ^ 1);
        if (++st == FF_STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows r0 + 64*wg .. +63 of a tile ----
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const uint32_t smem0 = smem_u32(base);
    // one lane per warp releases a stage in both CTAs of the cluster
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0)
        for (uint32_t r = 0; r < FF_CLUSTER; ++r) mbar_arrive_cluster(&empty[stage], r);
    };
    int st = 0;
    uint32_t ph = 0;
    for (int tp = cluster; tp < pairs; tp += clusters) {
      const int r0 = ((tp / col_tiles) * FF_CLUSTER + rank) * FF_BM;
      const int n0 = (tp % col_tiles) * BN;
      // one m64n(NB*BN) accumulator: geglu_in's value columns, then its gate
      // columns (the two B parts lie one after the other in the stage)
      float acc[NB * BN / 2];
#pragma unroll
      for (int i = 0; i < NB * BN / 2; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kb = 0; kb < k_slices; ++kb) {
        mbar_wait(&full[st], ph);
        const uint32_t a = smem0 + st * STAGE_BYTES + wg * 64 * 128;
        const uint32_t bb = smem0 + st * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FF_BK / 16; ++kk)
          wgmma_ss(acc, sw128_desc(a + kk * 32, 16, 1024),
                   sw128_desc(bb + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done
        if (kb > 0) release(prev);
        prev = st;
        if (++st == FF_STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);

      const int row = r0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
        if constexpr (NB == 2) {
          const float bv0 = __bfloat162float(ep.bias[col]);
          const float bv1 = __bfloat162float(ep.bias[col + 1]);
          const float bg0 = __bfloat162float(ep.bias[ep.gate + col]);
          const float bg1 = __bfloat162float(ep.bias[ep.gate + col + 1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row + 8 * half, i = 4 * nt + 2 * half;
            if (r >= rows) continue;
            const float h0 = bf16_round(acc[i] + bv0) *
                             gelu_erf(bf16_round(acc[i + BN / 2] + bg0));
            const float h1 = bf16_round(acc[i + 1] + bv1) *
                             gelu_erf(bf16_round(acc[i + 1 + BN / 2] + bg1));
            *reinterpret_cast<uint32_t*>(ep.out + (long long)r * ep.ldo + col) =
                pack_bf16(h0, h1);
          }
        } else {
          const float b0 = __bfloat162float(ep.bias[col]);
          const float b1 = __bfloat162float(ep.bias[col + 1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = row + 8 * half, i = 4 * nt + 2 * half;
            if (r >= rows) continue;
            const long long off = (long long)r * ep.ldo + col;
            float y0 = acc[i] + b0, y1 = acc[i + 1] + b1;
            if (ep.resid != nullptr) {
              y0 = __bfloat162float(ep.resid[off]) + bf16_round(y0);
              y1 = __bfloat162float(ep.resid[off + 1]) + bf16_round(y1);
            }
            *reinterpret_cast<uint32_t*>(ep.out + off) = pack_bf16(y0, y1);
          }
        }
      }
    }
  }
}

template <class Site, int BN, int NB>
int ff_launch(const CUtensorMap& a_map, const CUtensorMap& b_map,
              const FfEpilogue& ep, int rows, int kdim, int col_tiles,
              cudaStream_t stream) {
  constexpr int smem = ff_smem_bytes<BN, NB>();
  auto kernel = geglu_stage<Site, BN, NB>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = FF_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.blockDim = dim3(FF_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int max_clusters = 0;  // per kernel: clusters the card holds at once
  if (max_clusters == 0) {
    cfg.gridDim = dim3(FF_CLUSTER);
    e = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
    if (e != cudaSuccess || max_clusters < 1) {
      max_clusters = 0;
      return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
  }
  const int row_tiles = (rows + FF_BM - 1) / FF_BM;
  const int pairs = (row_tiles + FF_CLUSTER - 1) / FF_CLUSTER * col_tiles;
  cfg.gridDim = dim3(FF_CLUSTER * (pairs < max_clusters ? pairs : max_clusters));
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, a_map, b_map, ep, rows, kdim, col_tiles, pairs));
}

// h (T, I) = GEGLU(x (T, C)) with w_in (2I, C), b_in (2I); contiguous bf16,
// 16-byte aligned. C % 64 == 0, I % 128 == 0.
template <class Site>
int geglu_in_launch(const void* x, const void* w_in, const void* b_in, void* h,
                    int T, int C, int I, cudaStream_t stream) {
  if (T < 1 || C < 64 || C % FF_BK || I < FF_IN_BN || I % FF_IN_BN)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, b_map;
  int err = make_matrix_map(&a_map, x, T, C, FF_BM);
  if (err == 0) err = make_matrix_map(&b_map, w_in, 2LL * I, C, FF_IN_BN);
  if (err != 0) return err;
  const FfEpilogue ep = {static_cast<const bf16*>(b_in), nullptr,
                         static_cast<bf16*>(h), I, I};
  return ff_launch<Site, FF_IN_BN, 2>(a_map, b_map, ep, T, C, I / FF_IN_BN, stream);
}

// out (T, C) = h (T, I) w_out^T + b_out, plus resid (T, C) when resid is not
// null; w_out (C, I). Contiguous bf16, 16-byte aligned. C % 64 == 0, I % 64
// == 0. The column tile is the widest of 256, 128, 160 (C = 320) and 64 that
// divides C, 256 only from FF_WIDE_ROWS rows on (fewer rows would leave too
// few tiles to fill the card).
template <class Site>
int geglu_out_launch(const void* h, const void* w_out, const void* b_out,
                     const void* resid, void* out, int T, int C, int I,
                     cudaStream_t stream) {
  if (T < 1 || C < 64 || C % 64 || I < FF_BK || I % FF_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = C % 256 == 0 && T >= FF_WIDE_ROWS ? 256
                 : C % 128 == 0                      ? 128
                 : C % 160 == 0                      ? 160
                                                     : 64;
  CUtensorMap a_map, b_map;
  int err = make_matrix_map(&a_map, h, T, I, FF_BM);
  if (err == 0) err = make_matrix_map(&b_map, w_out, C, I, bn / FF_CLUSTER);
  if (err != 0) return err;
  const FfEpilogue ep = {static_cast<const bf16*>(b_out),
                         static_cast<const bf16*>(resid), static_cast<bf16*>(out),
                         C, 0};
  if (bn == 256) return ff_launch<Site, 256, 1>(a_map, b_map, ep, T, I, C / 256, stream);
  if (bn == 128) return ff_launch<Site, 128, 1>(a_map, b_map, ep, T, I, C / 128, stream);
  if (bn == 160) return ff_launch<Site, 160, 1>(a_map, b_map, ep, T, I, C / 160, stream);
  return ff_launch<Site, 64, 1>(a_map, b_map, ep, T, I, C / 64, stream);
}

}  // namespace dvdx
