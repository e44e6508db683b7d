// Frame-axis (temporal) multi-head attention: for every (batch, spatial
// position, head) an F x F softmax attention over the frames.
//
// Replaces dvdx_tpu/ops/pallas/temporal_attention.py:
// temporal_attention_posmajor (_temporal_kernel_pm), temporal_attention_fm
// (_temporal_kernel_fm) and temporal_attention (_temporal_kernel). The TPU
// kernels pack W positions block-diagonally into 128-row MXU tiles; that
// packing exists only for the MXU. Layout is given by strides: element (b,
// f, n, h*D + d) lives at b*sb + f*sf + n*sn + h*D + d, which covers the
// position-major (B, N, F, H*D) and frame-major (B, F, N, H*D) entry points
// alike.
//
// Numerics follow temporal_attention_reference: f32 logits, f32 softmax
// (exp(s - max) / sum), probabilities rounded to bf16, f32 P.V, bf16 output.
//
// Bound on the H100: 4*F^2*D flops per (position, head) against 4*F*D*2
// bytes, ~F/2 flops per byte -- far below the card's ~295 flop/byte
// balance, so the kernel is bounded by bytes: it has to keep enough of them
// in flight.
//
// Design (temporal_attn_tma): persistent CTAs, one per SM, each walking
// over tiles of P positions x one head x all F frames (plan in
// ops/kernels/temporal_attention.py: P * F padded to 16 about 128 rows of
// 128 bytes). A producer warp fills a ring of 2-4 stages by TMA, q, k and v
// of a tile in one stage, through 5-D tensor maps built from the caller's
// strides ({D, H, N, F, B} for the frame-major layout, {D, H, F, N, B} for
// the position-major one, so each box follows memory order): lanes past D
// (D = 40), frames past F (padded to 16) and positions past N arrive as
// zeros. Eight consumer warps compute, one warp per (position, 16 query
// frames): S = q k^T on mma.sync m16n8k16 with fragments by ldmatrix (a
// position's frames are rows P apart, or consecutive, in the tile), keys
// past F at -inf, the softmax in registers, P straight from the S fragments
// into P.V. The output overwrites q in the stage (each warp reads its own
// query rows before writing them) and leaves by one TMA store per box,
// which writes nothing outside the tensor; a stage returns to the producer
// once the next tile's store is started and its own has been read. F <= 128
// (8 query tiles), D a multiple of 8 up to 128. No atomics; every sum's
// order is fixed by the shape, not the grid.
#include "hopper.cuh"

using namespace dvdx;

namespace {

constexpr int THREADS = 288;       // warps 0-7 compute, warp 8 loads
constexpr int CONSUMERS = 256;
constexpr int PRODUCER = 256;
constexpr int MAX_FRAMES = 128;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;
constexpr int BAR_CONSUMERS = 1;

struct Maps {
  CUtensorMap q, k, v, o;
};

struct Shape {
  int B, F, N, H, D;
  int P;          // positions per tile
  int fpad;       // F padded to 16
  int boxes;      // 64-lane boxes per row (D <= 64: 1, else 2)
  int pos_major;  // smem row of (frame f, position p): p fpad + f, else f P + p
  int tiles, stages;
  float scale;
};

__host__ __device__ constexpr int tile_rows(const Shape& s) { return s.P * s.fpad; }

// bytes of one of q, k, v in a stage
__host__ __device__ constexpr int operand_bytes(const Shape& s) {
  return s.boxes * tile_rows(s) * 128;
}

constexpr int smem_bytes(const Shape& s) {
  return 1024 + s.stages * 3 * operand_bytes(s) + 2 * MAX_STAGES * 8;
}

// Byte offset of (row, lane c) in an operand of `rows` rows: 64-lane boxes
// of rows x 128 bytes, 128-byte swizzled.
__device__ __forceinline__ uint32_t off(int row, int c, int rows) {
  return (c >> 6) * (rows * 128) + row * 128 + ((((c >> 3) & 7) ^ (row & 7)) << 4) + (c & 7) * 2;
}

// The tile's box coordinates {lane, head, n or f, f or n, b}
struct TileCoords {
  int h, n0, b;
};

__device__ __forceinline__ TileCoords tile_coords(const Shape& s, int tile) {
  const int per_b = (s.N + s.P - 1) / s.P * s.H;
  const int r = tile % per_b;
  return {r % s.H, r / s.H * s.P, tile / per_b};
}

// One warp: 16 query frames (qt) of position p against all of its frames.
// q, k, v: shared addresses of the stage's operands; the output overwrites
// q's rows of these frames.
template <int MT>
__device__ __forceinline__ void attend(const Shape& s, uint32_t q, uint32_t k, uint32_t v,
                                       unsigned char* qp, int p, int qt, int lane) {
  constexpr int NKT = 2 * MT;  // 8-key tiles
  const int rows = tile_rows(s);
  const int g = lane >> 2, q4 = lane & 3, lr = lane & 15, lhi = lane >> 4;
  const int dpad = (s.D + 15) & ~15;  // inside the zero-filled box lanes
  auto row = [&](int f) { return s.pos_major ? p * s.fpad + f : f * s.P + p; };
  float acc[NKT][4];
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int k0 = 0; k0 < dpad; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, q + off(row(qt * 16 + lr), k0 + 8 * lhi, rows));  // frames 0-7 / 8-15, lanes k0 / k0 + 8
#pragma unroll
    for (int np = 0; np < MT; ++np) {
      // matrices: keys 0-7 @ k0, keys 0-7 @ k0 + 8, keys 8-15 @ k0, @ k0 + 8
      uint32_t b[4];
      ldsm_x4(b, k + off(row(np * 16 + (lane & 7) + ((lane >> 4) << 3)),
                         k0 + 8 * ((lane >> 3) & 1), rows));
      mma_16816(acc[2 * np], a, b[0], b[1]);
      mma_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
  // softmax over the keys of query rows g (e = 0, 1) and g + 8 (e = 2, 3)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = nt * 8 + 2 * q4 + (e & 1) < s.F ? acc[nt][e] * s.scale : -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], acc[nt][e]);
    }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = expf(acc[nt][e] - m[e >> 1]);
      l[e >> 1] += acc[nt][e];
    }
  // p = bf16(exp(s - max) / sum) as the A fragments of P.V; the division as
  // a product with 1 / sum, within an f32 ulp of it, far below the bf16
  // rounding that follows
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  uint32_t pa[MT][4];
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    pa[kk][0] = pack_bf16(acc[2 * kk][0] * inv[0], acc[2 * kk][1] * inv[0]);
    pa[kk][1] = pack_bf16(acc[2 * kk][2] * inv[1], acc[2 * kk][3] * inv[1]);
    pa[kk][2] = pack_bf16(acc[2 * kk + 1][0] * inv[0], acc[2 * kk + 1][1] * inv[0]);
    pa[kk][3] = pack_bf16(acc[2 * kk + 1][2] * inv[1], acc[2 * kk + 1][3] * inv[1]);
  }
  __syncwarp();  // every lane has read its q rows
  for (int dn = 0; dn < dpad; dn += 16) {  // two 8-lane output tiles a pass
    float o[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      // matrices: keys 0-7 / 8-15 @ lanes dn, keys 0-7 / 8-15 @ dn + 8
      uint32_t b[4];
      ldsm_x4_trans(b, v + off(row(kk * 16 + lr), dn + 8 * lhi, rows));
      mma_16816(o[0], pa[kk], b[0], b[1]);
      mma_16816(o[1], pa[kk], b[2], b[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(qp + off(row(qt * 16 + g + 8 * r), dn + 8 * half + 2 * q4,
                                              rows)) =
            pack_bf16(o[half][2 * r], o[half][2 * r + 1]);
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
temporal_attn_tma(const __grid_constant__ Maps maps, const Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ob = operand_bytes(s), stage_bytes = 3 * ob;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + s.stages * stage_bytes);
  uint64_t* empty = full + MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);  // consumer thread 0, once the tile's output store has read it
    }
    mbar_fence_init();
  }
  __syncthreads();

  auto coords = [&](const TileCoords& c, int box, int (&x)[5]) {
    x[0] = 64 * box;
    x[1] = c.h;
    x[2] = s.pos_major ? 0 : c.n0;
    x[3] = s.pos_major ? c.n0 : 0;
    x[4] = c.b;
  };

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: q, k, v of each of this CTA's tiles ----
    if (threadIdx.x == PRODUCER) {
      int st = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], stage_bytes);
        unsigned char* sp = base + st * stage_bytes;
        const TileCoords c = tile_coords(s, tile);
        for (int box = 0; box < s.boxes; ++box) {
          int x[5];
          coords(c, box, x);
          const int o = box * tile_rows(s) * 128;
          tma_load_5d(sp + o, &maps.q, &full[st], x[0], x[1], x[2], x[3], x[4]);
          tma_load_5d(sp + ob + o, &maps.k, &full[st], x[0], x[1], x[2], x[3], x[4]);
          tma_load_5d(sp + 2 * ob + o, &maps.v, &full[st], x[0], x[1], x[2], x[3], x[4]);
        }
        if (++st == s.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int st = 0, stored = -1;  // stored: the stage whose output store is in flight
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    mbar_wait(&full[st], ph);
    unsigned char* sp = base + st * stage_bytes;
    const uint32_t q = smem_u32(sp);
    for (int item = warp; item < s.P * MT; item += CONSUMERS / 32)
      attend<MT>(s, q, q + ob, q + 2 * ob, sp, item / MT, item % MT, lane);
    fence_proxy_async();  // the output's generic writes, before the TMA store reads them
    named_bar_sync(BAR_CONSUMERS, CONSUMERS);
    if (threadIdx.x == 0) {
      const TileCoords c = tile_coords(s, tile);
      for (int box = 0; box < s.boxes; ++box) {
        int x[5];
        coords(c, box, x);
        tma_store_5d(&maps.o, sp + box * tile_rows(s) * 128, x[0], x[1], x[2], x[3], x[4]);
      }
      bulk_commit();
      // the previous tile's store has read its stage: free it (this tile's
      // stage is freed after the next store is started, so no warp waits
      // for a store to read)
      if (stored >= 0) {
        bulk_wait_read<1>();
        mbar_arrive(&empty[stored]);
      }
      stored = st;
    }
    if (++st == s.stages) {
      st = 0;
      ph ^= 1;
    }
  }
  if (threadIdx.x == 0 && stored >= 0) bulk_wait_read<0>();
}

// The 5-D map of q, k, v or the output: dims {D, H, N, F, B} (frame-major)
// or {D, H, F, N, B} (position-major), element strides (sb, sf, sn), boxes
// of 64 lanes x 1 head x P positions x fpad frames x 1.
int operand_map(CUtensorMap* map, const void* p, const Shape& s, long long sb, long long sf,
                long long sn) {
  const cuuint64_t d = s.D, h = s.H, n = s.N, f = s.F, b = s.B;
  const cuuint32_t P = s.P, fp = s.fpad;
  const cuuint64_t dims_fm[5] = {d, h, n, f, b}, dims_pm[5] = {d, h, f, n, b};
  const cuuint64_t str_fm[4] = {d * 2, static_cast<cuuint64_t>(sn) * 2,
                                static_cast<cuuint64_t>(sf) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint64_t str_pm[4] = {d * 2, static_cast<cuuint64_t>(sf) * 2,
                                static_cast<cuuint64_t>(sn) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box_fm[5] = {64, 1, P, fp, 1}, box_pm[5] = {64, 1, fp, P, 1};
  return s.pos_major ? make_tensor_map(map, p, 5, dims_pm, str_pm, box_pm)
                     : make_tensor_map(map, p, 5, dims_fm, str_fm, box_fm);
}

template <int MT>
int launch(const Maps& maps, const Shape& s, int grid, cudaStream_t stream) {
  const int smem = smem_bytes(s);
  const cudaError_t e = cudaFuncSetAttribute(temporal_attn_tma<MT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  temporal_attn_tma<MT><<<grid, THREADS, smem, stream>>>(maps, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v share the element strides (sb, sf, sn); the output has (osb, osf,
// osn), in the same layout (the frame stride above the position stride for
// the frame-major layout, below it for the position-major one). Every
// stride and base 16-byte aligned, the lane axis contiguous; F <= 128, D a
// multiple of 8 up to 128; P (positions per tile) and stages from the
// wrapper's plan.
extern "C" int dvdx_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                       int B, int F, int N, int H, int D, long long sb,
                                       long long sf, long long sn, long long osb,
                                       long long osf, long long osn, int P, int stages,
                                       float scale, void* stream) {
  Shape s;
  s.B = B;
  s.F = F;
  s.N = N;
  s.H = H;
  s.D = D;
  s.P = P;
  s.fpad = (F + 15) / 16 * 16;
  s.boxes = (D + 63) / 64;
  s.pos_major = sf < sn;
  s.stages = stages;
  s.scale = scale;
  const long long tiles = (long long)B * H * ((N + P - 1) / P);
  if (B < 1 || N < 1 || H < 1 || F < 1 || F > MAX_FRAMES || D < 8 || D > 128 || D % 8 ||
      P < 1 || P > 256 || stages < 2 || stages > MAX_STAGES || smem_bytes(s) > SMEM_LIMIT ||
      tiles > (1LL << 30) || (osf < osn) != (sf < sn))
    return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  Maps maps;
  int err = operand_map(&maps.q, q, s, sb, sf, sn);
  if (err == 0) err = operand_map(&maps.k, k, s, sb, sf, sn);
  if (err == 0) err = operand_map(&maps.v, v, s, sb, sf, sn);
  if (err == 0) err = operand_map(&maps.o, o, s, osb, osf, osn);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = s.tiles < sms ? s.tiles : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s.fpad / 16) {
    case 1: return launch<1>(maps, s, grid, st);
    case 2: return launch<2>(maps, s, grid, st);
    case 3: return launch<3>(maps, s, grid, st);
    case 4: return launch<4>(maps, s, grid, st);
    case 5: return launch<5>(maps, s, grid, st);
    case 6: return launch<6>(maps, s, grid, st);
    case 7: return launch<7>(maps, s, grid, st);
    default: return launch<8>(maps, s, grid, st);
  }
}
