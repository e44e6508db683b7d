// Fused spatial transformer tail: everything of a BasicTransformerBlock after
// attn1's P.V output, per token row:
//   x1  = (x + bf16(o1 Wo1^T)) + b_o1
//   h   = LN2(x1);  q = bf16(h Wq2^T)
//   ao  = bf16(bf16(softmax_T(q k^T * scale)) v)   per head, over T context
//         tokens whose K/V projections (ctx_k, ctx_v) are computed outside
//   x2  = (x1 + bf16(ao Wo2^T)) + b_o2
//   out = x2 + bf16(GEGLU(LN3(x2)) + b_ffo)   (FF output bias added in f32)
//
// Replaces dvdx_tpu/ops/pallas/spatial_tail.py:fused_spatial_tail (both
// bodies: _tail_kernel, weights VMEM-resident at C <= 384, and
// _tail_kernel_streamed, the GEGLU pair streamed at C <= 768), with the TPU
// kernel's rounding order: the residual is added before the bias, unlike the
// unfused branch's x + (mm + b).
//
// Bound on the H100: 2*rows*(3*HD*C + 2*T*HD + 12*C^2) flops against reading
// x, o1, the weights and the context K/V once and writing out once; at the
// UNet's level 0 (92160 rows, C = 320) that is tensor-core operations. The
// chain alone (everything before the FF) is 2*rows*(3*C^2 + 2*T*C) flops
// against reading x and o1 and writing x2 and h: at level 0 about as much
// time in bytes (0.070 ms) as in operations (0.066 ms).
//
// Three launches, nothing between them: the chain up to LN3, then the GEGLU
// feed-forward as geglu_gemm.cuh's two wgmma products, geglu_in (h -> the
// inner tensor, rows x I) and geglu_out with the residual epilogue (out =
// x2 + bf16(... + b_ffo)). The TPU kernel's own streamed variant splits the
// chain from the FF at the same place.
//
// The chain takes one of two hand-written kernels by width:
//  * spatial_tail_chain<C>, C % 64 == 0 and C <= 384 (the UNet's level 0):
//    chain_tile.cuh's 64-row tile design (one CTA per tile, two consumer
//    warpgroups and a producer warp). x and attn1's o1 tile come in by
//    TMA, x into registers in the products' accumulator layout; the three
//    C x C products (o1 Wo1^T, LN2(x1) Wq2^T, ao Wo2^T) run on wgmma m64
//    n(C/2) with the weights streamed through the even slice ring; the
//    residual adds and LN2 / LN3 are register-local.
//    The cross-attention over the T context tokens: warpgroup w takes heads
//    w, w + 2, ..., and the producer brings each head's K and V of one
//    image through the same ring, between the Wq2 and the Wo2 slices (a
//    4-D tensor map {d, heads, T, N}: lanes past the head width and tokens
//    past T arrive as zeros, T padded to 16; an odd head count adds one
//    empty fill, so the warpgroups keep alternating). At head width 64 the
//    head runs on wgmma: S = q K^T (m64 n(T padded), A the head's 64-column
//    box of the q buffer, B K-major in the fill), the softmax in registers,
//    P.V (m64 n64, A = P from registers, B = V MN-major in the fill); at
//    other widths on mma.sync with ldmatrix fragments, one warp per 16
//    rows. For T <= 128 the softmax is one pass: f32 logits, keys past T at
//    -inf, p = bf16(exp(s - max) / sum) -- normalised, then rounded,
//    fused_spatial_tail_plain's order (exp as __expf, the division as a
//    product with 1 / sum) -- and P straight from the logit registers into
//    P.V; for 128 < T <= 512, two sweeps over 128-token fills, the first
//    for each row's max and sum. The output overwrites q in place. A tile
//    whose rows span images (r0 / S != (r0 + 63) / S; none at S = 2880 = 45
//    * 64) runs once per image against that image's K / V and keeps each
//    row from its own image. x2 and h = LN3(x2) leave by TMA stores.
//  * spatial_tail_chain_wide (fused_rows.cuh's row tiles), 384 < C <= 768,
//    the JAX package's streamed C = 640 shape, off the UNet's fused path: a block
//    owns 32 rows in shared memory, streams the weights from L2 as mma.sync
//    B fragments (rows_gemm) and runs the cross-attention in two sweeps
//    over 64-token chunks.
// Fixed launch shapes, fixed summation orders, no atomics: bit-exact
// re-execution.
#include "chain_tile.cuh"
#include "geglu_gemm.cuh"

using namespace dvdx;
using namespace dvdx::chain;

namespace {

constexpr int MAX_DIM = 768;        // the wide chain's widths
constexpr int CHAIN_MAX_DIM = 384;  // spatial_tail_chain's
constexpr int MAX_CTX = 512;
constexpr int KV_CHUNK = 128;       // context tokens of one K / V fill at most

// ---- spatial_tail_chain (C <= 384) -------------------------------------------

struct TailMaps {
  CUtensorMap x, o1, x2, h;  // (rows, C): 64-row x 64-column boxes
  CUtensorMap w[3];   // o1_w, q2_w, o2_w, the order the chain multiplies by them
  CUtensorMap k, v;   // the context's {d, heads, T, N}
};

struct TailVecs {
  const bf16 *o1_b, *ln2_s, *ln2_b, *o2_b, *ln3_s, *ln3_b;
};

struct TailShape {
  int rows, S, T, heads, d;
  int tpad;    // keys of one K / V fill: T padded to 16, at most KV_CHUNK
  int chunks;  // fills per (head, image) sweep; 2 sweeps where chunks > 1
  int tiles, stages, stage_bytes;
  float scale, eps;
};

__host__ __device__ constexpr int kv_fill_bytes(int d, int tpad) {
  return 2 * ((d + 63) / 64) * tpad * 128;  // K then V, 64-lane boxes
}

constexpr int tail_smem_bytes(int C, int stages, int stage_bytes) {
  return 1024 + 2 * TILE * C * 2 + stages * stage_bytes + (2 * MAX_STAGES + 2) * 8 +
         2 * TILE * 2 * 4;
}

// Byte offset of (key, lane c) in a K or V fill of `tpad` keys: 64-lane
// boxes of tpad rows x 128 bytes, 128-byte swizzled.
__device__ __forceinline__ uint32_t kv_off(int key, int c, int tpad) {
  return (c >> 6) * (tpad * 128) + key * 128 + ((((c >> 3) & 7) ^ (key & 7)) << 4) + (c & 7) * 2;
}

// The images of a consumer thread's two rows (tile rows rq + g and rq + g +
// 8 of its warp's 16), and of its warp's first and last row: integer
// divisions done once per tile, not in the attention's loops.
struct RowImages {
  int own[2];       // the thread's rows
  int first, last;  // the warp's rows
};

__device__ __forceinline__ RowImages row_images(const Tile& t, int row0, int S) {
  const int rq = row0 + 16 * t.warp, g = t.lane >> 2;
  return {{(rq + g) / S, (rq + g + 8) / S}, rq / S, (rq + 15) / S};
}

// Scaled logits of a warp's 16 query rows (tile rows rq .., head columns
// from c0) against the 16 MT keys of a fill at kv (tokens t0 ..); keys past
// T are -inf. q pieces past the head width d are zeroed (their addresses
// clamped into the head); K's lanes past d arrive as zeros.
template <int MT>
__device__ __forceinline__ void fill_logits(const Tile& t, float (&s)[2 * MT][4], uint32_t kv,
                                            int rq, int c0, int d, int t0, const TailShape& sh) {
  const int lr = t.lane & 15, lhi = t.lane >> 4, q4 = t.lane & 3;
  const uint32_t hs = smem_u32(t.hs);
#pragma unroll
  for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  for (int k0 = 0; k0 < d; k0 += 16) {
    const bool hi_ok = k0 + 8 < d;
    uint32_t a[4];
    ldsm_x4(a, hs + swz(rq + lr, c0 + (lhi && hi_ok ? k0 + 8 : k0)));
    if (!hi_ok) a[2] = a[3] = 0u;
#pragma unroll
    for (int np = 0; np < MT; ++np) {
      // matrices: keys 0-7 @ k0, keys 0-7 @ k0 + 8, keys 8-15 @ k0, @ k0 + 8
      const int key = np * 16 + (t.lane & 7) + ((t.lane >> 4) << 3);
      uint32_t b[4];
      ldsm_x4(b, kv + kv_off(key, k0 + 8 * ((t.lane >> 3) & 1), 16 * MT));
      mma_16816(s[2 * np], a, b[0], b[1]);
      mma_16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = t0 + nt * 8 + 2 * q4 + (e & 1) < sh.T ? s[nt][e] * sh.scale : -INFINITY;
}

// acc[dt] += P V over a fill's 16 MT keys for the 8-lane output tiles dt
// < DT from lane c (of the V box at vb) on, at most ceil(d / 8) of them;
// P as bf16 A fragments, V by ldmatrix.trans.
template <int MT, int DT>
__device__ __forceinline__ void fill_pv(const Tile& t, float (&acc)[DT][4],
                                        const uint32_t (&pa)[MT][4], uint32_t vb, int c, int d) {
  const int lr = t.lane & 15, lhi = t.lane >> 4;
#pragma unroll
  for (int dp = 0; dp < DT / 2; ++dp) {  // two 8-lane output tiles a pass
    if (16 * dp >= d) break;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      // matrices: keys 0-7 / 8-15 @ lanes c + 16 dp, @ c + 16 dp + 8
      uint32_t b[4];
      ldsm_x4_trans(b, vb + kv_off(kk * 16 + lr, c + 16 * dp + 8 * lhi, 16 * MT));
      mma_16816(acc[2 * dp], pa[kk], b[0], b[1]);
      mma_16816(acc[2 * dp + 1], pa[kk], b[2], b[3]);
    }
  }
}

// bf16 of an 8-lane output tile (head lanes 8 dt ..) over q's columns, for
// the thread's rows of image n
__device__ __forceinline__ void store_tile(const Tile& t, const float (&o)[4], int rq, int c0,
                                           int dt, int n, const RowImages& im) {
  const int g = t.lane >> 2, q4 = t.lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (im.own[r] == n)
      *reinterpret_cast<uint32_t*>(t.hs + swz(rq + g + 8 * r, c0 + 8 * dt + 2 * q4)) =
          pack_bf16(o[2 * r], o[2 * r + 1]);
}

// p = bf16(e / l) as the A fragments of P.V, from e = exp(s - max) in s;
// e / l as e * (1 / l), within an f32 ulp of the division, far below the
// bf16 rounding that follows
template <int MT>
__device__ __forceinline__ void probs(const float (&e)[2 * MT][4], const float (&inv)[2],
                                      uint32_t (&pa)[MT][4]) {
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    pa[kk][0] = pack_bf16(e[2 * kk][0] * inv[0], e[2 * kk][1] * inv[0]);
    pa[kk][1] = pack_bf16(e[2 * kk][2] * inv[1], e[2 * kk][3] * inv[1]);
    pa[kk][2] = pack_bf16(e[2 * kk + 1][0] * inv[0], e[2 * kk + 1][1] * inv[0]);
    pa[kk][3] = pack_bf16(e[2 * kk + 1][2] * inv[1], e[2 * kk + 1][3] * inv[1]);
  }
}

// One pass (T <= 128, MT = tpad / 16): a warp's 16 rows of head h against
// image n's K / V in the fill at kv.
template <int MT>
__device__ __forceinline__ void attend_one(const Tile& t, uint32_t kv, int h, int n,
                                           const RowImages& im, const TailShape& sh) {
  const int d = sh.d, c0 = h * d, rq = 16 * t.warp;
  float s[2 * MT][4];
  fill_logits<MT>(t, s, kv, rq, c0, d, 0, sh);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
#pragma unroll
  for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
      l[e >> 1] += s[nt][e];
    }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  uint32_t pa[MT][4];
  probs<MT>(s, inv, pa);
  const uint32_t vb = kv + kv_fill_bytes(d, 16 * MT) / 2;
  __syncwarp();  // every lane has read its q rows
  for (int dp = 0; 16 * dp < d; ++dp) {  // two 8-lane output tiles a pass
    float o[2][4] = {};
    fill_pv<MT, 2>(t, o, pa, vb, 16 * dp, d - 16 * dp);
    store_tile(t, o[0], rq, c0, 2 * dp, n, im);
    if (16 * dp + 8 < d) store_tile(t, o[1], rq, c0, 2 * dp + 1, n, im);
  }
}

// One pass at head width 64 on wgmma: the warpgroup's 64 rows of head h
// against image n's K / V in the fill at kv. S = q K^T (m64 n(16 MT) k16: A,
// q, is box h of the swizzled hs; B, K, K-major in the fill), the softmax in
// the accumulator layout (mma.sync's C fragments, so as attend_one), then
// P.V (m64 n64: A, P, from registers; B, V, MN-major in the fill). Every
// warp computes all its rows; only the rows of image n are stored.
template <int MT>
__device__ __forceinline__ void attend_one_wgmma(const Tile& t, uint32_t kv, int h, int n,
                                                 const RowImages& im, const TailShape& sh) {
  constexpr int TP = 16 * MT;  // keys
  const int q4 = t.lane & 3, rq = 16 * t.warp;
  const uint32_t qa = smem_u32(t.hs) + h * (TILE * 128);
  float acc[8 * MT];
#pragma unroll
  for (int i = 0; i < 8 * MT; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(acc, sw128_desc(qa + kk * 32, 16, 1024), sw128_desc(kv + kk * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8 * MT; ++i) {
    const int key = 8 * (i >> 2) + 2 * q4 + (i & 1), r = (i >> 1) & 1;
    acc[i] = key < sh.T ? acc[i] * sh.scale : -INFINITY;
    m[r] = fmaxf(m[r], acc[i]);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
#pragma unroll
  for (int i = 0; i < 8 * MT; ++i) {
    acc[i] = __expf(acc[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += acc[i];
  }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  uint32_t pa[MT][4];
#pragma unroll
  for (int kk = 0; kk < MT; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // tiles 2 kk (j = 0, 1) and 2 kk + 1 (j = 2, 3), rows g / g + 8
      pa[kk][j] = pack_bf16(acc[8 * kk + 4 * (j >> 1) + 2 * (j & 1)] * inv[j & 1],
                            acc[8 * kk + 4 * (j >> 1) + 2 * (j & 1) + 1] * inv[j & 1]);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint32_t vb = kv + TP * 128;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < MT; ++kk)
    wgmma_rs_mn(o, pa[kk], sw128_desc(vb + kk * 2048, TP * 128, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const float tile[4] = {o[4 * dt], o[4 * dt + 1], o[4 * dt + 2], o[4 * dt + 3]};
    store_tile(t, tile, rq, 64 * h, dt, n, im);
  }
}

// Two sweeps (128 < T <= 512) over the 2 * chunks fills of head h and
// image n from fill g on: the first for each row's max and sum of exp(s -
// max), the second for P.V. Fills of an inactive warp are waited for and
// released only.
__device__ __forceinline__ void attend_two(const Tile& t, int& g, int h, int n, bool active,
                                           const RowImages& im, const TailShape& sh) {
  constexpr int MT = KV_CHUNK / 16;
  const int d = sh.d, c0 = h * d, rq = 16 * t.warp;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[16][4];
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep)
    for (int c = 0; c < sh.chunks; ++c, g += 2) {
      int st;
      uint32_t parity;
      fill_slot(t, g, st, parity);
      mbar_wait(&t.full[st], parity);
      if (active) {
        const uint32_t kv = smem_u32(t.ring + st * t.stage_bytes);
        float s[2 * MT][4];
        fill_logits<MT>(t, s, kv, rq, c0, d, c * KV_CHUNK, sh);
        if (sweep == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < 2 * MT; ++nt)
              mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
            const float m_new = fmaxf(m[r], quad_max(mx));
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2 * MT; ++nt)
              sum += __expf(s[nt][2 * r] - m_new) + __expf(s[nt][2 * r + 1] - m_new);
            l[r] = l[r] * __expf(m[r] - m_new) + quad_sum(sum);
            m[r] = m_new;
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
          const float inv[2] = {1.f / l[0], 1.f / l[1]};
          uint32_t pa[MT][4];
          probs<MT>(s, inv, pa);
          fill_pv<MT, 16>(t, acc, pa, kv + kv_fill_bytes(d, KV_CHUNK) / 2, 0, d);
        }
      }
      release_stage(t, st);
    }
  if (active) {
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      if (8 * dt < d) store_tile(t, acc[dt], rq, c0, dt, n, im);
  }
}

// The cross-attention of the tile (rows of images n_lo .. n_hi) over the
// ring's K / V fills from fill0 on: warpgroup wg takes heads wg, wg + 2, ...
// (the odd head count's last fills are empty for warpgroup 1).
__device__ __forceinline__ void cross_attention(const Tile& t, int fill0, int n_lo, int n_hi,
                                                int row0, const TailShape& sh) {
  const RowImages im = row_images(t, row0, sh.S);
  int g = fill0 + t.wg;
  for (int h = t.wg; h < sh.heads + (sh.heads & 1); h += 2)
    for (int n = n_lo; n <= n_hi; ++n) {
      const bool active = h < sh.heads && im.first <= n && n <= im.last;
      if (sh.chunks > 1) {
        attend_two(t, g, h, n, active, im, sh);
        continue;
      }
      int st;
      uint32_t parity;
      fill_slot(t, g, st, parity);
      mbar_wait(&t.full[st], parity);
      if (h < sh.heads && sh.d == 64) {  // the whole warpgroup: wgmma
        const uint32_t kv = smem_u32(t.ring + st * t.stage_bytes);
        switch (sh.tpad / 16) {
          case 1: attend_one_wgmma<1>(t, kv, h, n, im, sh); break;
          case 2: attend_one_wgmma<2>(t, kv, h, n, im, sh); break;
          case 3: attend_one_wgmma<3>(t, kv, h, n, im, sh); break;
          case 4: attend_one_wgmma<4>(t, kv, h, n, im, sh); break;
          case 5: attend_one_wgmma<5>(t, kv, h, n, im, sh); break;
          case 6: attend_one_wgmma<6>(t, kv, h, n, im, sh); break;
          case 7: attend_one_wgmma<7>(t, kv, h, n, im, sh); break;
          default: attend_one_wgmma<8>(t, kv, h, n, im, sh); break;
        }
      } else if (active) {
        const uint32_t kv = smem_u32(t.ring + st * t.stage_bytes);
        switch (sh.tpad / 16) {
          case 1: attend_one<1>(t, kv, h, n, im, sh); break;
          case 2: attend_one<2>(t, kv, h, n, im, sh); break;
          case 3: attend_one<3>(t, kv, h, n, im, sh); break;
          case 4: attend_one<4>(t, kv, h, n, im, sh); break;
          case 5: attend_one<5>(t, kv, h, n, im, sh); break;
          case 6: attend_one<6>(t, kv, h, n, im, sh); break;
          case 7: attend_one<7>(t, kv, h, n, im, sh); break;
          default: attend_one<8>(t, kv, h, n, im, sh); break;
        }
      }
      release_stage(t, st);
      g += 2;
    }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
spatial_tail_chain(const __grid_constant__ TailMaps maps, const TailVecs vec,
                   const TailShape sh) {
  constexpr int NH = C / 2;   // columns of one consumer warpgroup
  constexpr int NJ = C / 16;  // its 8-column tiles
  constexpr int KS = C / 64;  // 64-deep slices of one product
  constexpr int BUF = TILE * C * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Tile t;
  t.hs = base;                        // o1, the LN outputs, q / the attention output, h
  unsigned char* const xs = base + BUF;  // x in, x2 out
  t.ring = base + 2 * BUF;
  t.full = reinterpret_cast<uint64_t*>(t.ring + sh.stages * sh.stage_bytes);
  t.empty = t.full + MAX_STAGES;
  uint64_t* const x_bar = t.empty + MAX_STAGES;
  uint64_t* const o1_bar = x_bar + 1;
  t.red = reinterpret_cast<float*>(o1_bar + 1);
  t.stages = sh.stages;
  t.stage_bytes = sh.stage_bytes;
  t.wg = threadIdx.x >> 7;
  const int row0 = blockIdx.x * TILE;  // rows <= 2^30
  const int n_lo = row0 / sh.S;
  const int n_hi = min(row0 + TILE - 1, sh.rows - 1) / sh.S;
  const int sweeps = sh.chunks > 1 ? 2 * sh.chunks : 1;
  // K / V fills per warpgroup
  const int units = (sh.heads + 1) / 2 * (n_hi - n_lo + 1) * sweeps;

  if (threadIdx.x == 0) {
    ring_init(t);
    mbar_init(x_bar, 1);
    mbar_init(o1_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (t.wg == 2) {
    // ---- producer: x and o1, the Wo1 and Wq2 slices, the heads' K / V,
    // the Wo2 slices ----
    if (threadIdx.x == PRODUCER) {
      mbar_expect_tx(x_bar, BUF);
      for (int kb = 0; kb < KS; ++kb)
        tma_load_2d(xs + kb * TILE * 128, &maps.x, x_bar, kb * 64, row0);
      mbar_expect_tx(o1_bar, BUF);
      for (int kb = 0; kb < KS; ++kb)
        tma_load_2d(t.hs + kb * TILE * 128, &maps.o1, o1_bar, kb * 64, row0);
      RingCursor cur;
      produce_weight<C>(t, cur, &maps.w[0]);
      produce_weight<C>(t, cur, &maps.w[1]);
      const int boxes = (sh.d + 63) / 64;
      const int kv_bytes = kv_fill_bytes(sh.d, sh.tpad);
      for (int pair = 0; pair < (sh.heads + 1) / 2; ++pair)
        for (int n = n_lo; n <= n_hi; ++n)
          for (int u = 0; u < sweeps; ++u)
            for (int w = 0; w < 2; ++w) {
              const int h = 2 * pair + w;
              if (h >= sh.heads) {
                cur.skip(t);
                cur.advance(t);
                continue;
              }
              unsigned char* sp = cur.acquire(t, kv_bytes);
              const int t0 = (u % sh.chunks) * KV_CHUNK;
              for (int bx = 0; bx < boxes; ++bx) {
                tma_load_4d(sp + bx * sh.tpad * 128, &maps.k, cur.bar(t), 64 * bx, h, t0, n);
                tma_load_4d(sp + kv_bytes / 2 + bx * sh.tpad * 128, &maps.v, cur.bar(t), 64 * bx,
                            h, t0, n);
              }
              cur.advance(t);
            }
      produce_weight<C>(t, cur, &maps.w[2]);
    }
    return;
  }

  // ---- consumers ----
  t.warp = (threadIdx.x >> 5) & 3;
  t.lane = threadIdx.x & 31;
  t.r0 = t.warp * 16 + (t.lane >> 2);
  t.cb = t.wg * NH + 2 * (t.lane & 3);
  auto resid = [](float x, float mm, float b) { return resid_then_bias(x, mm, b); };
  auto to_hs = [&](int h, int c, uint32_t v) {
    *reinterpret_cast<uint32_t*>(t.hs + swz(t.r0 + 8 * h, c)) = v;
  };
  uint32_t xr[NJ][2];  // x as bf16 pairs, rows r0 / r0 + 8, columns cb + 8 j
  mbar_wait(x_bar, 0);
  load_x<C>(t, xs, xr);
  mbar_wait(o1_bar, 0);

  float acc[C / 4];
  ring_product<C>(t, 0, acc);  // o1 Wo1^T
  residual<C>(t, xr, acc, vec.o1_b, resid);
  chain_layernorm<C>(t, xr, vec.ln2_s, vec.ln2_b, sh.eps, to_hs);
  fence_proxy_async();
  consumers_sync();  // the LN output is whole before either warpgroup reads it
  ring_product<C>(t, 2 * KS, acc);  // q
  consumers_sync();  // both warpgroups are done reading the LN output
  store_acc<C>(t, t.hs, acc);
  fence_proxy_async();  // the wgmma attention reads q
  consumers_sync();  // q is whole
  cross_attention(t, 4 * KS, n_lo, n_hi, row0, sh);
  fence_proxy_async();
  consumers_sync();  // the attention output is whole
  ring_product<C>(t, 4 * KS + 2 * units, acc);  // ao Wo2^T
  residual<C>(t, xr, acc, vec.o2_b, resid);
  // h = LN3(x2) into hs (both products on it are done), x2 into xs, then
  // out by TMA stores (rows past the tensor are not written)
  chain_layernorm<C>(t, xr, vec.ln3_s, vec.ln3_b, sh.eps, to_hs);
  store_x<C>(t, xs, xr);
  fence_proxy_async();
  consumers_sync();
  if (threadIdx.x == 0) {
    for (int kb = 0; kb < KS; ++kb) {
      tma_store_2d(&maps.h, t.hs + kb * TILE * 128, kb * 64, row0);
      tma_store_2d(&maps.x2, xs + kb * TILE * 128, kb * 64, row0);
    }
    bulk_commit();
    bulk_wait_read<0>();  // the shared memory stays until the stores have read it
  }
}

// The context's K or V (N, T, heads * d) as the 4-D map {d, heads, T, N},
// boxes of 64 lanes x 1 head x tpad tokens x 1 image.
int context_map(CUtensorMap* map, const void* p, int N, int T, int heads, int d, int tpad) {
  const long long hd = (long long)heads * d;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(T * hd) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(tpad), 1};
  return make_tensor_map(map, p, 4, dims, strides, box);
}

template <int C>
int chain_launch(const void* x, const void* o1, const void* ctx_k, const void* ctx_v,
                 const void* const* w, const TailVecs& vec, void* x2, void* h,
                 const TailShape& sh, cudaStream_t stream) {
  TailMaps maps;
  int err = make_matrix_map(&maps.x, x, sh.rows, C, TILE);
  if (err == 0) err = make_matrix_map(&maps.o1, o1, sh.rows, C, TILE);
  if (err == 0) err = make_matrix_map(&maps.x2, x2, sh.rows, C, TILE);
  if (err == 0) err = make_matrix_map(&maps.h, h, sh.rows, C, TILE);
  for (int i = 0; i < 3 && err == 0; ++i) err = make_matrix_map(&maps.w[i], w[i], C, C, C / 4);
  const int N = sh.rows / sh.S;
  if (err == 0) err = context_map(&maps.k, ctx_k, N, sh.T, sh.heads, sh.d, sh.tpad);
  if (err == 0) err = context_map(&maps.v, ctx_v, N, sh.T, sh.heads, sh.d, sh.tpad);
  if (err != 0) return err;
  const int smem = tail_smem_bytes(C, sh.stages, sh.stage_bytes);
  auto kernel = spatial_tail_chain<C>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<sh.tiles, THREADS, smem, stream>>>(maps, vec, sh);
  return static_cast<int>(cudaGetLastError());
}

// ---- spatial_tail_chain_wide (384 < C <= 768) ----------------------------------

constexpr int XCHUNK = 64;  // context tokens per sweep step (8 n-tiles)

// Logits of a warp's 16 query rows (A fragments qa) against context tokens
// t0 .. t0 + 63 of one head (kb: token rows of stride HD), scaled in f32;
// tokens past T are -inf.
template <int D>
__device__ __forceinline__ void chunk_logits(float (&s)[8][4],
                                             const uint32_t (&qa)[D / 16][4],
                                             const bf16* kb, int t0, int T,
                                             int HD, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int tok = t0 + nt * 8 + g;
    const bf16* kr = kb + (long long)tok * HD + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t b0 = tok < T ? ld32(kr + ks * 16) : 0u;
      const uint32_t b1 = tok < T ? ld32(kr + ks * 16 + 8) : 0u;
      mma_16816(s[nt], qa[ks], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = t0 + nt * 8 + 2 * tq + (e & 1) < T ? s[nt][e] * scale : -INFINITY;
  }
}

__device__ __forceinline__ uint32_t pack_pair(const bf16* p, long long stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

// softmax(q k^T * scale) v over the T context tokens for the tile's rows:
// one warp per (head, 16-row m-tile), mma.sync for Q K^T and P V. A first
// sweep over 64-token chunks finds each row's max and sum of exp(s - max)
// in f32; a second forms P = bf16(exp(s - max) / sum) (the probabilities
// normalised, then rounded, as the reference does) and accumulates P V in
// f32. Rows of an m-tile that belong to different images (S % 16 != 0) are
// run once per image against that image's K / V, each row kept from its
// own. The result, rounded to bf16, overwrites the head's q columns.
template <int D>
__device__ void cross_attention_wide(bf16* qs, int ldq, const bf16* __restrict__ ctx_k,
                                const bf16* __restrict__ ctx_v, long long r0,
                                int n_rows, int S, int T, int HD, int heads,
                                float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  for (int item = warp; item < 2 * heads; item += FUSED_THREADS / 32) {
    const int h = item >> 1, rb = (item & 1) * 16;
    if (rb >= n_rows) continue;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* qr = qs + (rb + g) * ldq + h * D + ks * 16 + 2 * tq;
      qa[ks][0] = ld32(qr);
      qa[ks][1] = ld32(qr + 8 * ldq);
      qa[ks][2] = ld32(qr + 8);
      qa[ks][3] = ld32(qr + 8 * ldq + 8);
    }
    const long long n_lo = (r0 + rb) / S;
    const long long n_hi = (r0 + min(rb + 15, n_rows - 1)) / S;
    for (long long n = n_lo; n <= n_hi; ++n) {
      const bf16* kb = ctx_k + n * T * HD + h * D;
      const bf16* vb = ctx_v + n * T * HD + h * D;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float s[8][4];
      for (int t0 = 0; t0 < T; t0 += XCHUNK) {
        chunk_logits<D>(s, qa, kb, t0, T, HD, scale);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
          const float m_new = fmaxf(m[r], quad_max(mx));
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            sum += expf(s[nt][2 * r] - m_new) + expf(s[nt][2 * r + 1] - m_new);
          l[r] = l[r] * expf(m[r] - m_new) + quad_sum(sum);
          m[r] = m_new;
        }
      }
      float acc[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
      for (int t0 = 0; t0 < T; t0 += XCHUNK) {
        chunk_logits<D>(s, qa, kb, t0, T, HD, scale);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = expf(s[nt][e] - m[e >> 1]) / l[e >> 1];
#pragma unroll
        for (int kk = 0; kk < XCHUNK / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const int tok = t0 + kk * 16 + 2 * tq;
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            const bf16* vr = vb + (long long)tok * HD + dt * 8 + g;
            const uint32_t b0 = tok + 1 < T ? pack_pair(vr, HD)
                                : (tok < T ? pack_pair(vr, 0) & 0xffffu : 0u);
            const uint32_t b1 = tok + 9 < T ? pack_pair(vr + 8 * HD, HD)
                                : (tok + 8 < T ? pack_pair(vr + 8 * HD, 0) & 0xffffu : 0u);
            mma_16816(acc[dt], pa, b0, b1);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rb + g + 8 * half;
        if (row >= n_rows || (r0 + row) / S != n) continue;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
          *reinterpret_cast<uint32_t*>(qs + row * ldq + h * D + dt * 8 + 2 * tq) =
              pack_bf16(acc[dt][2 * half], acc[dt][2 * half + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(FUSED_THREADS)
spatial_tail_chain_wide(const bf16* __restrict__ x, const bf16* __restrict__ o1,
                   const bf16* __restrict__ ctx_k,
                   const bf16* __restrict__ ctx_v,
                   const bf16* __restrict__ o1_w, const bf16* __restrict__ o1_b,
                   const bf16* __restrict__ ln2_s,
                   const bf16* __restrict__ ln2_b,
                   const bf16* __restrict__ q2_w, const bf16* __restrict__ o2_w,
                   const bf16* __restrict__ o2_b,
                   const bf16* __restrict__ ln3_s,
                   const bf16* __restrict__ ln3_b, bf16* __restrict__ x2_out,
                   bf16* __restrict__ h_out, int rows, int S, int C, int HD1,
                   int HD, int T, int heads, float scale, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = C + 8, ldh = max(C, HD1) + 8, ldq = HD + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = xs + FUSED_ROWS * ldx;
  bf16* qs = hs + FUSED_ROWS * ldh;

  const long long r0 = (long long)blockIdx.x * FUSED_ROWS;
  const int n_rows = (int)min((long long)FUSED_ROWS, rows - r0);

  rows_load(xs, ldx, C, n_rows, [&](int r) { return x + (r0 + r) * C; });
  rows_load(hs, ldh, HD1, n_rows, [&](int r) { return o1 + (r0 + r) * HD1; });
  __syncthreads();

  // x1 = (x + bf16(o1 Wo1^T)) + b_o1
  rows_gemm(hs, ldh, o1_w, C, HD1, [&](int r, int c, float v0, float v1) {
    bf16* p = xs + r * ldx + c;
    p[0] = __float2bfloat16(resid_then_bias(__bfloat162float(p[0]), v0,
                                            __bfloat162float(o1_b[c])));
    p[1] = __float2bfloat16(resid_then_bias(__bfloat162float(p[1]), v1,
                                            __bfloat162float(o1_b[c + 1])));
  });
  __syncthreads();
  rows_layernorm(xs, ldx, hs, ldh, C, FUSED_ROWS, ln2_s, ln2_b, eps);
  __syncthreads();
  // q = bf16(h Wq2^T)
  rows_gemm(hs, ldh, q2_w, HD, C, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(qs + r * ldq + c) = pack_bf16(v0, v1);
  });
  __syncthreads();

  // cross-attention on the tensor cores; the output overwrites q
  const int d = HD / heads;
#define DVDX_XATTN_CASE(dd)                                                  \
  case dd:                                                                   \
    cross_attention_wide<dd>(qs, ldq, ctx_k, ctx_v, r0, n_rows, S, T, HD, heads, \
                        scale);                                              \
    break;
  switch (d) {
    DVDX_XATTN_CASE(16) DVDX_XATTN_CASE(32) DVDX_XATTN_CASE(48)
    DVDX_XATTN_CASE(64) DVDX_XATTN_CASE(80) DVDX_XATTN_CASE(96)
    DVDX_XATTN_CASE(112) DVDX_XATTN_CASE(128)
  }
#undef DVDX_XATTN_CASE
  __syncthreads();

  // x2 = (x1 + bf16(ao Wo2^T)) + b_o2
  rows_gemm(qs, ldq, o2_w, C, HD, [&](int r, int c, float v0, float v1) {
    bf16* p = xs + r * ldx + c;
    p[0] = __float2bfloat16(resid_then_bias(__bfloat162float(p[0]), v0,
                                            __bfloat162float(o2_b[c])));
    p[1] = __float2bfloat16(resid_then_bias(__bfloat162float(p[1]), v1,
                                            __bfloat162float(o2_b[c + 1])));
  });
  __syncthreads();
  rows_layernorm(xs, ldx, hs, ldh, C, FUSED_ROWS, ln3_s, ln3_b, eps);
  __syncthreads();
  rows_store(xs, ldx, C, n_rows, [&](int r) { return x2_out + (r0 + r) * C; });
  rows_store(hs, ldh, C, n_rows, [&](int r) { return h_out + (r0 + r) * C; });
}

struct spatial_tail_ff {};  // names the FF launches in profiles

int wide_launch(const void* x, const void* o1, const void* ctx_k, const void* ctx_v,
                const void* o1_w, const void* o1_b, const void* ln2_s, const void* ln2_b,
                const void* q2_w, const void* o2_w, const void* o2_b, const void* ln3_s,
                const void* ln3_b, void* x2, void* h, int rows, int S, int C, int HD1,
                int HD, int T, int heads, float scale, float eps, cudaStream_t st) {
  if (HD1 % 16 || HD1 > MAX_DIM || HD % 16 || HD > MAX_DIM || (HD / heads) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldx = C + 8, ldh = (C > HD1 ? C : HD1) + 8, ldq = HD + 8;
  const int smem = FUSED_ROWS * (ldx + ldh + ldq) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      spatial_tail_chain_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (rows + FUSED_ROWS - 1) / FUSED_ROWS;
  spatial_tail_chain_wide<<<grid, FUSED_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(o1),
      static_cast<const bf16*>(ctx_k), static_cast<const bf16*>(ctx_v),
      static_cast<const bf16*>(o1_w), static_cast<const bf16*>(o1_b),
      static_cast<const bf16*>(ln2_s), static_cast<const bf16*>(ln2_b),
      static_cast<const bf16*>(q2_w), static_cast<const bf16*>(o2_w),
      static_cast<const bf16*>(o2_b), static_cast<const bf16*>(ln3_s),
      static_cast<const bf16*>(ln3_b), static_cast<bf16*>(x2),
      static_cast<bf16*>(h), rows, S, C, HD1, HD, T, heads, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, C) with rows = N * S, o1 (rows, HD1), ctx_k / ctx_v (N, T, HD);
// weights in nn.Linear's (out, in) layout: o1_w (C, HD1), q2_w (HD, C),
// o2_w (C, HD), ffi_w (2I, C) value rows first, ffo_w (C, I); vectors of C
// (2I for ffi_b); x2 and h are (rows, C) scratch, inner (rows, I) scratch;
// out (rows, C). All contiguous bf16, 16-byte aligned; 1 <= T <= 512,
// I % 128 == 0, heads dividing HD.
//   C % 64 == 0, C <= 384: spatial_tail_chain, with HD1 == HD == C and head
//   widths that are multiples of 8 up to 128; `stages` (the ring's depth,
//   even) from the wrapper's plan.
//   384 < C <= 768: spatial_tail_chain_wide, with HD1 and HD multiples of 16
//   up to 768 and head widths that are multiples of 16 up to 128; `stages`
//   unused.
extern "C" int dvdx_spatial_tail(
    const void* x, const void* o1, const void* ctx_k, const void* ctx_v,
    const void* o1_w, const void* o1_b, const void* ln2_s, const void* ln2_b,
    const void* q2_w, const void* o2_w, const void* o2_b, const void* ln3_s,
    const void* ln3_b, const void* ffi_w, const void* ffi_b,
    const void* ffo_w, const void* ffo_b, void* x2, void* h, void* inner,
    void* out, int rows, int S, int C, int HD1, int HD, int T, int heads, int I,
    int stages, float scale, float eps, void* stream) {
  if (C < 64 || C % 64 || C > MAX_DIM || heads < 1 || HD % heads || HD / heads > 128 ||
      T < 1 || T > MAX_CTX || I % FF_IN_BN || rows < 1 || S < 1 || rows % S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (C > CHAIN_MAX_DIM) {
    rc = wide_launch(x, o1, ctx_k, ctx_v, o1_w, o1_b, ln2_s, ln2_b, q2_w, o2_w, o2_b, ln3_s,
                     ln3_b, x2, h, rows, S, C, HD1, HD, T, heads, scale, eps, st);
  } else {
    const int d = HD / heads;
    const int tpad = T > KV_CHUNK ? KV_CHUNK : (T + 15) / 16 * 16;
    const int slice = slice_bytes(C), kv = kv_fill_bytes(d, tpad);
    const int stage_bytes = slice > kv ? slice : kv;
    const long long tiles = ((long long)rows + TILE - 1) / TILE;
    if (HD1 != C || HD != C || d % 8 || stages < 2 || stages > MAX_STAGES || stages % 2 ||
        tail_smem_bytes(C, stages, stage_bytes) > SMEM_LIMIT || rows > (1 << 30))
      return static_cast<int>(cudaErrorInvalidValue);
    auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
    const void* w[3] = {o1_w, q2_w, o2_w};
    const TailVecs vec = {bf(o1_b), bf(ln2_s), bf(ln2_b), bf(o2_b), bf(ln3_s), bf(ln3_b)};
    const TailShape sh = {rows, S, T, heads, d, tpad, (T + KV_CHUNK - 1) / KV_CHUNK,
                          static_cast<int>(tiles), stages, stage_bytes, scale, eps};
    switch (C) {
      case 64: rc = chain_launch<64>(x, o1, ctx_k, ctx_v, w, vec, x2, h, sh, st); break;
      case 128: rc = chain_launch<128>(x, o1, ctx_k, ctx_v, w, vec, x2, h, sh, st); break;
      case 192: rc = chain_launch<192>(x, o1, ctx_k, ctx_v, w, vec, x2, h, sh, st); break;
      case 256: rc = chain_launch<256>(x, o1, ctx_k, ctx_v, w, vec, x2, h, sh, st); break;
      case 320: rc = chain_launch<320>(x, o1, ctx_k, ctx_v, w, vec, x2, h, sh, st); break;
      default: rc = chain_launch<384>(x, o1, ctx_k, ctx_v, w, vec, x2, h, sh, st); break;
    }
  }
  if (rc != 0) return rc;
  rc = geglu_in_launch<spatial_tail_ff>(h, ffi_w, ffi_b, inner, rows, C, I, st);
  if (rc != 0) return rc;
  return geglu_out_launch<spatial_tail_ff>(inner, ffo_w, ffo_b, x2, out, rows, C, I, st);
}
