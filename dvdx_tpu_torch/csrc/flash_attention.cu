// Non-causal flash attention over (B, S, H, D) bf16, f32 online softmax.
//
// Replaces dvdx_tpu/ops/pallas/flash_attention.py:flash_attention
// (_onepass_kernel / _flash_kernel) and flash_attention_mh
// (_onepass_mh_kernel / _flash_mh_kernel): the key length Sk may differ from
// the query length (cross-attention), every operand and the output are
// addressed by strides (the mh entry point passes the first head_dim lanes of
// each 128-lane head strip), and q may be scaled and rounded to bf16 before
// QK^T (q_scale; the mh kernels' order) instead of scaling the logits.
//
// Bound on the H100: at the UNet's spatial shapes (S = 2880 / 720, D = 64)
// the 4*S^2*D flops per head dominate the 4*S*D*2 bytes moved, so the kernel
// is bounded by tensor-core operations, and at D = 64 the S^2 exponentials
// (16 a clock per SM) cost about as much as the products. Only wgmma reaches
// the tensor cores' full rate, and only if the operand tiles arrive without
// stalling it.
//
// Design, after FlashAttention-3: one block per (128 queries, batch*head),
// three warpgroups. Warpgroup 2 is the producer: one thread loads Q once and
// K / V tiles of BK keys into a 3-stage ring in shared memory with TMA,
// signalled by mbarriers (full / empty per stage), and gives its registers
// to the consumers (setmaxnreg). Warpgroups 0 and 1 each own 64 query rows:
// S = Q K^T on wgmma from shared memory (both K-major), the online softmax in
// registers with ex2 on logits pre-multiplied by scale*log2(e), P rounded
// to bf16 in registers and fed as wgmma's A operand, V as its MN-major B
// operand straight from the TMA tile (no transpose). Each consumer issues
// tile j's Q K^T together with tile j-1's P.V and runs tile j's softmax
// while P.V is still on the tensor cores (FlashAttention-3's intra-warpgroup
// overlap); the two consumers take turns at issuing (named barriers), so
// one's softmax runs while the other's products hold the tensor cores.
//
// TMA addresses each operand through a 4-D map {D, H, S, B} built from the
// caller's strides (each a multiple of 16 bytes), one box of 64 lanes x 1
// head x rows x 1 batch at a time. Lanes past D and rows past S / Sk lie
// outside the map and arrive as zeros: D = 40 reads no lane of the next
// head, and the ragged key tail adds nothing to P.V; its logits are masked
// at -1e30. D <= 64 runs one 64-lane box (BK = 128 keys), 64 < D <= 128 two
// (BK = 64). Numerics: f32 logits, max and sum; P rounded to bf16 before
// P.V; the output divided by the f32 row sum. Fixed launch shape and
// summation order, no atomics: bit-exact re-execution.
#include "hopper.cuh"

using namespace dvdx;

namespace {

constexpr int BQ = 128;       // query rows per block: 2 consumer warpgroups x 64
constexpr int THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 loads
constexpr int STAGES = 3;     // K / V ring depth

// 2^x on the special-function unit; results below 2^-126 flush to zero
// (probabilities that small add nothing to an f32 row sum)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DK>  // head dim padded to 64 or 128 lanes
struct Cfg {
  static constexpr int BK = DK == 64 ? 128 : 64;  // keys per tile
  static constexpr int BOXES = DK / 64;           // 64-lane boxes per row
  static constexpr int Q_BYTES = BQ * DK * 2;
  static constexpr int KV_BYTES = BK * DK * 2;    // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES +
                              (1 + 2 * STAGES) * 8;
};

template <int DK>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tma(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
              int H, int S, int Sk, int D, long long osb, long long oss,
              long long osh, float q_scale, float scale_log2) {
  using Cf = Cfg<DK>;
  constexpr int BK = Cf::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(base);  // [BOXES][BQ][64]
  bf16* k_s = q_s + BQ * DK;                  // [STAGES][BOXES][BK][64]
  bf16* v_s = k_s + STAGES * BK * DK;         // [STAGES][BOXES][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * BK * DK);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (Sk + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Cf::Q_BYTES);
      for (int x = 0; x < Cf::BOXES; ++x)
        tma_load_4d(q_s + x * BQ * 64, &q_map, q_full, x * 64, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * Cf::KV_BYTES);
        for (int x = 0; x < Cf::BOXES; ++x) {
          const int off = (st * Cf::BOXES + x) * BK * 64;
          tma_load_4d(k_s + off, &k_map, &full[st], x * 64, h, j * BK, b);
          tma_load_4d(v_s + off, &v_map, &full[st], x * 64, h, j * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64*wg .. +63 ----
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int t = lane & 3;
    mbar_wait(q_full, 0);
    if (q_scale != 1.f) {
      // scale this warpgroup's rows in place (elementwise, so the swizzle
      // does not matter), then hand them to the async proxy
      for (int i = tid; i < Cf::BOXES * 64 * 8; i += 128) {
        const int x = i >> 9, r = (i >> 3) & 63, c = i & 7;
        uint4* p = reinterpret_cast<uint4*>(q_s + x * BQ * 64 +
                                            (wg * 64 + r) * 64 + c * 8);
        uint4 v = *p;
        v.x = scale_bf16x2(v.x, q_scale);
        v.y = scale_bf16x2(v.y, q_scale);
        v.z = scale_bf16x2(v.z, q_scale);
        v.w = scale_bf16x2(v.w, q_scale);
        *p = v;
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
    }

    float acc[DK / 2];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;

    uint32_t pa[BK / 16][4];
    float s[BK / 2];
    float alpha[2];

    // S = Q K^T for the tile in stage st, 64 x BK per warpgroup
    auto issue_qk = [&](int st) {
      const uint32_t k_addr = smem_u32(k_s) + st * Cf::KV_BYTES;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss(s, sw128_desc(q_addr + (kk >> 2) * (BQ * 128) + (kk & 3) * 32, 16, 1024),
                 sw128_desc(k_addr + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024), 1);
      wgmma_commit();
    };
    // O += P V: P (64 x BK, bf16) from registers, V MN-major from stage st
    auto issue_pv = [&](int st) {
      const uint32_t v_addr = smem_u32(v_s) + st * Cf::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_mn(acc, pa[kk], sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
    };
    // the online softmax of tile j's logits: s becomes exp(s*scale - max),
    // the running max and sum move on, alpha rescales the old O
    auto softmax = [&](int j) {
      const int k0 = j * BK;
      if (k0 + BK > Sk) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= Sk) s[i] = -1e30f;
      }
      float mx[2] = {m_run[0], m_run[1]}, ms[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2((m_run[r] - mx[r]) * scale_log2);
        m_run[r] = mx[r];
        ms[r] = mx[r] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]));
        rowsum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rowsum[r];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // The two consumers take turns at issuing their products (named
    // barriers 3 and 4, 256 threads: one warpgroup waits, the other
    // arrives), so one's softmax runs while the other's products hold the
    // tensor cores instead of both contending at once.
    const int my_turn = 3 + wg, their_turn = 4 - wg;
    if (wg == 1) named_bar_arrive(their_turn, 256);  // warpgroup 0 goes first

    // tile 0: O is still zero, nothing to rescale
    mbar_wait(&full[0], 0);
    named_bar_sync(my_turn, 256);
    issue_qk(0);
    named_bar_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    pack_p();
    // tile j: its Q K^T and tile j-1's P V go to the tensor cores together;
    // the softmax of tile j runs while P V is still in flight, and O is
    // rescaled once P V has landed
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % STAGES, prev = (j + STAGES - 1) % STAGES;
      mbar_wait(&full[st], (j / STAGES) & 1);
      named_bar_sync(my_turn, 256);
      issue_qk(st);
      issue_pv(prev);
      named_bar_arrive(their_turn, 256);
      wgmma_wait<1>();
      fence_regs(s);
      softmax(j);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&empty[prev]);  // K and V of tile j - 1 are consumed
#pragma unroll
      for (int i = 0; i < DK / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    const int last = (n_tiles - 1) % STAGES;
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_pv(last);
    named_bar_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(&empty[last]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
    const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
    bf16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int nt = 0; nt < DK / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col >= D) continue;  // D % 8 == 0: a column pair is in or out
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + row0 * oss + col) =
            pack_bf16(acc[4 * nt] / l_run[0], acc[4 * nt + 1] / l_run[0]);
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * oss + col) =
            pack_bf16(acc[4 * nt + 2] / l_run[1], acc[4 * nt + 3] / l_run[1]);
    }
  }
}

// The 4-D map {D, H, len, B} of one operand with element strides st = (b,
// s, h), boxes of 64 lanes x 1 x rows x 1.
int operand_map(CUtensorMap* map, const void* p, const long long* st, int B,
                int H, int len, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return make_tensor_map(map, p, 4, dims, strides, box);
}

template <int DK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int S, int Sk, int D, const long long* qs, const long long* ks,
           const long long* vs, const long long* os, float q_scale, float scale,
           cudaStream_t stream) {
  using Cf = Cfg<DK>;
  CUtensorMap qm, km, vm;
  int err = operand_map(&qm, q, qs, B, H, S, D, BQ);
  if (err == 0) err = operand_map(&km, k, ks, B, H, Sk, D, Cf::BK);
  if (err == 0) err = operand_map(&vm, v, vs, B, H, Sk, D, Cf::BK);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tma<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_tma<DK><<<grid, THREADS, Cf::SMEM, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), H, S, Sk, D, os[0], os[1], os[2],
      q_scale, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements for the (b, s, h) axes of q, k, v and the output;
// the d axis is contiguous and every stride and base is 16-byte aligned. q
// has S rows, k and v have Sk. D must be a multiple of 8 and at most 128
// (checked by the wrapper). q_scale == 1 leaves q as it is.
extern "C" int dvdx_flash_attention(const void* q, const void* k, const void* v,
                                    void* o, int B, int H, int S, int Sk, int D,
                                    long long qsb, long long qss, long long qsh,
                                    long long ksb, long long kss, long long ksh,
                                    long long vsb, long long vss, long long vsh,
                                    long long osb, long long oss, long long osh,
                                    float q_scale, float scale, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh}, os[3] = {osb, oss, osh};
  if (B * H > 65535 || Sk < 1 || S < 1 || D < 8 || D > 128 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(q, k, v, o, B, H, S, Sk, D, qs, ks, vs, os, q_scale, scale, st);
  return launch<128>(q, k, v, o, B, H, S, Sk, D, qs, ks, vs, os, q_scale, scale, st);
}
