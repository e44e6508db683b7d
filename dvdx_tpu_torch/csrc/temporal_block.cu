// Fused temporal transformer block: the whole _TemporalBlock on frame-major
// x (B, F, N, C), attention over the F frames at every spatial position:
//   x = x + (bf16(Attn1(LN1(x)) Wo1^T) + b_o1)
//   x = x + (bf16(Attn2(LN2(x)) Wo2^T) + b_o2)    (diffusers
//                                                   double_self_attention)
//   out = x + bf16(GEGLU(LN3(x)) + b_ffo)          (FF output bias in f32)
// where Attn(h) projects q, k, v = bf16(h W^T) and, per (position, head),
// takes p = bf16(exp(s - max s)) of the f32 logits s = q k^T * scale and
// returns bf16((p v) / sum exp(s - max s)).
//
// Replaces dvdx_tpu/ops/pallas/temporal_block.py:fused_temporal_block
// (_block_kernel), with its rounding order. The TPU kernel packs 8 positions
// into 128-row MXU tiles with a checkerboard mask; that packing exists only
// for the MXU.
//
// Bound on the H100: per row 2 * (8 C^2 + 4 F C) flops for the chain (eight
// C x C products, two attentions' S and P.V) and 2 * 12 C^2 for the FF,
// against reading x and the 20 C^2 weights once and writing out once; at
// level 0 (92160 rows, C = 320) that is tensor-core operations. Every
// 64-row tile multiplies by all eight C x C weights (1.6 MB at C = 320, 2.3
// GB from L2 per call), and its LayerNorms and attentions run between the
// products, so the chain is far from that bound: PERF.md gives where its
// time goes (utils/kernel_probe).
//
// Design of the chain, temporal_block_chain (one CTA per 64-row tile, 288
// threads -- two consumer warpgroups and a producer warp -- one CTA per SM;
// the register-resident x, the LayerNorm, the weight ring and the products
// are chain_tile.cuh's, shared with the spatial tail's chain):
//   * tile: P positions x F frames (ChainPlan in ops/kernels/temporal_block
//     .py: P = 64 / F, fewer where the last position's 16-row-padded frames
//     would pass row 64), gathered by the frame stride; tile row r is frame
//     r % F of position n0 + r / F. Rows past P * F and positions past N are
//     zero, computed and never stored.
//   * x lives in registers for the whole chain, in the wgmma accumulator
//     layout of the out-projection: warpgroup w (of 2) holds columns
//     [w C/2, (w+1) C/2) of all 64 rows, so each residual add is register
//     local. LayerNorm reduces a row over the 4 lanes of a quad and the two
//     warpgroups (one exchange through shared memory). x comes in, and x
//     and h go out, through the shared buffers by 16-byte accesses.
//   * the eight C x C products run on wgmma m64 n(C/2) k16: A, the LN output
//     (or the attention output), from a 128-byte-swizzled shared buffer;
//     B, the weight, streamed by the producer warp's one thread through a
//     ring of half-width 64-deep slices (C/2 x 64, 20 KB at C = 320) with
//     TMA, 1.6 MB from L2 per tile. (Sharing each slice between the two
//     CTAs of a cluster by TMA multicast halves that traffic but measured no
//     faster on an H100, 0.777 against 0.763 ms a call at level 0: the
//     slices come from L2, and the pair then waits for its slower CTA.) The
//     stage count is even, so each stage always feeds the same warpgroup
//     (slice s goes to stage s % stages and warpgroup s % 2), which then
//     consumes its fills in order, as a parity wait needs.
//     Products run in the order k, v, q, o of each sub-block, so q, the
//     last one reading the LN output, overwrites it, and k and v take two
//     more buffers: 3 x 40 KB plus 4 ring stages at C = 320.
//   * the F x F attention on the tensor cores (mma.sync m16n8k16, fragments
//     by ldmatrix): one warp per (position, head, 16 query rows); S = q k^T
//     with the head width (a multiple of 8) zero-padded to a multiple of 16
//     and the frames to a multiple of 16 (keys past F masked at -inf),
//     softmax in registers, P straight from the S fragments as the A
//     operand of P.V; the output overwrites q in place (each warp reads its
//     own query rows before writing them).
//   * LN3's h and the final x go to device memory for the two GEGLU
//     products of geglu_gemm.cuh (geglu_in into the (rows, I) inner tensor,
//     geglu_out with the residual epilogue). Nothing runs between launches.
// Determinism: launch shape and summation orders depend on the shapes only;
// no atomics, no sum across blocks.
#include "chain_tile.cuh"
#include "geglu_gemm.cuh"

using namespace dvdx;
using namespace dvdx::chain;

namespace {

constexpr int MAX_DIM = 384;
constexpr int MAX_FRAMES = 64;
constexpr int CHAIN_THREADS = THREADS;

// the eight C x C weights in the order the chain multiplies by them
struct ChainMaps {
  CUtensorMap w[8];  // k1 v1 q1 o1 k2 v2 q2 o2
};

struct ChainVecs {
  const bf16* ln_s[3];
  const bf16* ln_b[3];
  const bf16* bo[2];
};

struct ChainShape {
  int F, N, heads, P, tiles, stages;
  float scale, eps;
};

__host__ __device__ constexpr int chain_stage_bytes(int C) { return slice_bytes(C); }

constexpr int chain_smem_bytes(int C, int stages) {
  return 1024 + 3 * TILE * C * 2 + stages * chain_stage_bytes(C) + 2 * MAX_STAGES * 8 +
         2 * TILE * 2 * 4;
}

// chain_tile.cuh's thread with the k and v buffers of the attentions
struct Consumer : Tile {
  unsigned char *ks, *vs;
};

// the products in the order k, v, q, o of each sub-block: product m takes
// the ring's fills from 2 m (C / 64)
template <int C>
__device__ __forceinline__ void chain_product(const Consumer& t, int m, float (&acc)[C / 4]) {
  ring_product<C>(t, m * 2 * (C / 64), acc);
}

// The F x F attention of every (position, head) of the tile: q in hs, k in
// ks, v in vs; the output overwrites q in hs. MT = ceil(F / 16): 16-row
// query tiles and 16-key steps. Fragments come by ldmatrix from the
// swizzled buffers (head width d % 8 == 0, so every 8-column piece of a
// head is one 16-byte chunk); pieces past d (d = 40 pads to 48) are zeroed
// in q and k and not stored from the output, and their addresses are
// clamped to the head's first piece.
template <int C, int MT>
__device__ __forceinline__ void chain_attention(const Consumer& t, const ChainShape& sh) {
  const int F = sh.F, d = C / sh.heads;
  constexpr int NKT = 2 * MT;  // 8-key tiles
  const int g = t.lane >> 2, q4 = t.lane & 3;
  const int lr = t.lane & 15, lhi = t.lane >> 4;  // ldmatrix: row in 16, which half
  const uint32_t hs = smem_u32(t.hs), ks = smem_u32(t.ks), vs = smem_u32(t.vs);
  const int items = sh.P * sh.heads * MT;
  for (int item = t.warp + 4 * t.wg; item < items; item += CONSUMERS / 32) {
    const int qt = item % MT, h = (item / MT) % sh.heads, pos = item / (MT * sh.heads);
    const int rk = pos * F, rq = rk + qt * 16, c0 = h * d;
    float s[NKT][4];
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int k0 = 0; k0 < d; k0 += 16) {
      const bool hi_ok = k0 + 8 < d;  // the step's second 8 dims are in the head
      const int col = c0 + (lhi && hi_ok ? k0 + 8 : k0);
      uint32_t a[4];
      ldsm_x4(a, hs + swz(rq + lr, col));  // rows 0-7 / 8-15 x dims k0 / k0 + 8
      if (!hi_ok) a[2] = a[3] = 0u;
#pragma unroll
      for (int np = 0; np < MT; ++np) {  // two 8-key tiles a load
        // matrices: keys 0-7 @ k0, keys 0-7 @ k0 + 8, keys 8-15 @ k0, @ k0 + 8
        const int key = rk + np * 16 + (t.lane & 7) + ((t.lane >> 4) << 3);
        const int kc = c0 + (((t.lane >> 3) & 1) && hi_ok ? k0 + 8 : k0);
        uint32_t b[4];
        ldsm_x4(b, ks + swz(key, kc));
        if (!hi_ok) b[1] = b[3] = 0u;
        mma_16816(s[2 * np], a, b[0], b[1]);
        mma_16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // softmax over the keys of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = nt * 8 + 2 * q4 + (e & 1) < F ? s[nt][e] * sh.scale : -INFINITY;
        m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
      }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    // (p v) / l as (p v) * (1 / l): within an f32 ulp of the division, far
    // below the bf16 rounding that follows
    const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
    // unnormalised bf16 probabilities as the A fragments of P.V
    uint32_t pa[MT][4];
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    for (int dn = 0; dn < d; dn += 16) {  // two 8-dim output tiles a pass
      const bool hi_ok = dn + 8 < d;
      float o[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        // matrices: keys 0-7 / 8-15 @ dims dn, keys 0-7 / 8-15 @ dn + 8
        const int key = rk + kk * 16 + (t.lane & 15);
        const int vc = c0 + (lhi && hi_ok ? dn + 8 : dn);
        uint32_t b[4];
        ldsm_x4_trans(b, vs + swz(key, vc));
        mma_16816(o[0], pa[kk], b[0], b[1]);
        mma_16816(o[1], pa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 1 && !hi_ok) break;
        const int cc = c0 + dn + 8 * half + 2 * q4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int fq = qt * 16 + g + 8 * r;
          if (fq < F)
            *reinterpret_cast<uint32_t*>(t.hs + swz(rk + fq, cc)) =
                pack_bf16(o[half][2 * r] * inv_l[r], o[half][2 * r + 1] * inv_l[r]);
        }
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
temporal_block_chain(const __grid_constant__ ChainMaps maps, const ChainVecs vec,
                     const bf16* __restrict__ x, bf16* __restrict__ x_out,
                     bf16* __restrict__ h_out, const ChainShape sh) {
  constexpr int NH = C / 2;      // columns of one consumer warpgroup
  constexpr int NJ = C / 16;     // its 8-column tiles
  constexpr int STAGE = chain_stage_bytes(C);
  constexpr int BUF = TILE * C * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Consumer t;
  t.hs = base;
  t.ks = base + BUF;
  t.vs = base + 2 * BUF;
  t.ring = base + 3 * BUF;
  t.full = reinterpret_cast<uint64_t*>(t.ring + sh.stages * STAGE);
  t.empty = t.full + MAX_STAGES;
  t.red = reinterpret_cast<float*>(t.empty + MAX_STAGES);
  t.stages = sh.stages;
  t.stage_bytes = STAGE;
  t.wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    ring_init(t);
    mbar_fence_init();
  }
  __syncthreads();

  if (t.wg == 2) {
    // ---- producer: the eight weights' slices, in order ----
    if (threadIdx.x == PRODUCER) {
      RingCursor cur;
      for (int m = 0; m < 8; ++m) produce_weight<C>(t, cur, &maps.w[m]);
    }
    return;
  }

  // ---- consumers ----
  t.warp = (threadIdx.x >> 5) & 3;
  t.lane = threadIdx.x & 31;
  t.r0 = t.warp * 16 + (t.lane >> 2);
  t.cb = t.wg * NH + 2 * (t.lane & 3);
  const int F = sh.F;
  const int tiles_per_b = (sh.N + sh.P - 1) / sh.P;
  const int tile = blockIdx.x;
  const int b = tile / tiles_per_b, n0 = (tile % tiles_per_b) * sh.P;
  // element offset of tile row r, or -1: a row past P * F or a position past N
  auto row_off = [&](int r) -> long long {
    const int pos = r / F;
    return tile < sh.tiles && r < sh.P * F && n0 + pos < sh.N
               ? ((long long)(b * F + r % F) * sh.N + n0 + pos) * C
               : -1;
  };
  // x in by 16-byte loads through hs (all of a thread's loads in flight at
  // once), then into registers
  {
    constexpr int PER = TILE * (C / 8) / CONSUMERS;
    uint4 v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * CONSUMERS, r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      const long long o = row_off(r);
      v[u] = o >= 0 ? *reinterpret_cast<const uint4*>(x + o + c8) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * CONSUMERS;
      *reinterpret_cast<uint4*>(t.hs + swz(i / (C / 8), (i % (C / 8)) * 8)) = v[u];
    }
  }
  consumers_sync();
  uint32_t xr[NJ][2];  // x as bf16 pairs, rows r0 / r0 + 8, columns cb + 8 j
  load_x<C>(t, t.hs, xr);

  float acc[C / 4];
  auto to_hs = [&](int h, int c, uint32_t v) {
    *reinterpret_cast<uint32_t*>(t.hs + swz(t.r0 + 8 * h, c)) = v;
  };
#pragma unroll 1
  for (int sub = 0; sub < 2; ++sub) {
    chain_layernorm<C>(t, xr, vec.ln_s[sub], vec.ln_b[sub], sh.eps, to_hs);
    fence_proxy_async();
    consumers_sync();  // the LN output is whole before either warpgroup reads it
    chain_product<C>(t, 4 * sub + 0, acc);
    store_acc<C>(t, t.ks, acc);
    chain_product<C>(t, 4 * sub + 1, acc);
    store_acc<C>(t, t.vs, acc);
    chain_product<C>(t, 4 * sub + 2, acc);
    consumers_sync();  // both warpgroups are done reading the LN output
    store_acc<C>(t, t.hs, acc);
    consumers_sync();  // q, k, v are whole
    switch ((F + 15) / 16) {
      case 1: chain_attention<C, 1>(t, sh); break;
      case 2: chain_attention<C, 2>(t, sh); break;
      case 3: chain_attention<C, 3>(t, sh); break;
      default: chain_attention<C, 4>(t, sh); break;
    }
    fence_proxy_async();
    consumers_sync();  // the attention output is whole
    chain_product<C>(t, 4 * sub + 3, acc);
    residual<C>(t, xr, acc, vec.bo[sub],
                [](float x, float mm, float b) { return bias_then_resid(x, mm, b); });
  }
  // h = LN3(x) into ks and x into vs (both free now), then out by 16-byte
  // stores of the valid rows
  chain_layernorm<C>(t, xr, vec.ln_s[2], vec.ln_b[2], sh.eps, [&](int h, int c, uint32_t v) {
    *reinterpret_cast<uint32_t*>(t.ks + swz(t.r0 + 8 * h, c)) = v;
  });
  store_x<C>(t, t.vs, xr);
  consumers_sync();
  for (int i = threadIdx.x; i < TILE * (C / 8); i += CONSUMERS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const long long o = row_off(r);
    if (o < 0) continue;
    *reinterpret_cast<uint4*>(h_out + o + c8) = *reinterpret_cast<const uint4*>(t.ks + swz(r, c8));
    *reinterpret_cast<uint4*>(x_out + o + c8) = *reinterpret_cast<const uint4*>(t.vs + swz(r, c8));
  }
}

template <int C>
int chain_launch(const void* const* w, const ChainVecs& vec, const void* x, void* x_out,
                 void* h, const ChainShape& sh, cudaStream_t stream) {
  ChainMaps maps;
  for (int i = 0; i < 8; ++i) {
    const int err = make_matrix_map(&maps.w[i], w[i], C, C, C / 4);
    if (err != 0) return err;
  }
  const int smem = chain_smem_bytes(C, sh.stages);
  auto kernel = temporal_block_chain<C>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<sh.tiles, CHAIN_THREADS, smem, stream>>>(maps, vec, static_cast<const bf16*>(x),
                                                    static_cast<bf16*>(x_out),
                                                    static_cast<bf16*>(h), sh);
  return static_cast<int>(cudaGetLastError());
}

struct temporal_block_ff {};  // names the FF launches in profiles

}  // namespace

// x, out (B, F, N, C) contiguous; x_mid and h (B, F, N, C) scratch, inner
// (B * F * N, I) scratch. Weights in nn.Linear's (out, in) layout: q/k/v/o
// (C, C) for both attentions, ffi_w (2I, C) value rows first, ffo_w (C, I);
// vectors of C (2I for ffi_b). All bf16, 16-byte aligned. C % 64 == 0,
// C <= 384, heads dividing C with C / heads % 8 == 0, F <= 64, I % 128 == 0;
// P (positions per tile) and stages (weight ring) from the wrapper's plan.
extern "C" int dvdx_temporal_block(
    const void* x, const void* ln1_s, const void* ln1_b, const void* q1,
    const void* k1, const void* v1, const void* o1_w, const void* o1_b,
    const void* ln2_s, const void* ln2_b, const void* q2, const void* k2,
    const void* v2, const void* o2_w, const void* o2_b, const void* ln3_s,
    const void* ln3_b, const void* ffi_w, const void* ffi_b,
    const void* ffo_w, const void* ffo_b, void* x_mid, void* h, void* inner,
    void* out, int B, int F, int N, int C, int heads, int I, int P, int stages,
    float scale, float eps, void* stream) {
  const int fpad = (F + 15) / 16 * 16;
  if (C < 64 || C % 64 || C > MAX_DIM || heads < 1 || C % heads || (C / heads) % 8 || F < 1 ||
      F > MAX_FRAMES || N < 1 || B < 1 || I % FF_IN_BN || P < 1 || P * F > TILE ||
      (P - 1) * F + fpad > TILE || stages < 2 || stages > MAX_STAGES || stages % 2 ||
      chain_smem_bytes(C, stages) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)B * ((N + P - 1) / P);
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  const void* w[8] = {k1, v1, q1, o1_w, k2, v2, q2, o2_w};
  const ChainVecs vec = {{bf(ln1_s), bf(ln2_s), bf(ln3_s)},
                         {bf(ln1_b), bf(ln2_b), bf(ln3_b)},
                         {bf(o1_b), bf(o2_b)}};
  const ChainShape sh = {F, N, heads, P, static_cast<int>(tiles), stages, scale, eps};
  int rc;
  switch (C) {
    case 64: rc = chain_launch<64>(w, vec, x, x_mid, h, sh, st); break;
    case 128: rc = chain_launch<128>(w, vec, x, x_mid, h, sh, st); break;
    case 192: rc = chain_launch<192>(w, vec, x, x_mid, h, sh, st); break;
    case 256: rc = chain_launch<256>(w, vec, x, x_mid, h, sh, st); break;
    case 320: rc = chain_launch<320>(w, vec, x, x_mid, h, sh, st); break;
    default: rc = chain_launch<384>(w, vec, x, x_mid, h, sh, st); break;
  }
  if (rc != 0) return rc;
  const int rows = B * F * N;
  rc = geglu_in_launch<temporal_block_ff>(h, ffi_w, ffi_b, inner, rows, C, I, st);
  if (rc != 0) return rc;
  return geglu_out_launch<temporal_block_ff>(inner, ffo_w, ffo_b, x_mid, out, rows, C, I, st);
}
