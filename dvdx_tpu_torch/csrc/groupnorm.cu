// GroupNorm (+ per-sample channel pre-bias) (+ SiLU) over (N, L, C) bf16.
//
// Replaces dvdx_tpu/ops/groupnorm.py:group_norm_act (_gn_pallas / _gn_kernel).
// The TPU kernel holds one whole (L, C) row in VMEM; the H100 has 227 KB of
// shared memory per block and the UNet's rows reach 29.5 MB ((2, 46080, 320)
// in the temporal transformer's norm), so the statistics are reduced across
// the grid in a fixed order instead.
//
// Bound on the H100: a few f32 operations per element against 2 bytes read
// and 2 written, so bytes: one read of x and one write of y at 3.35 TB/s.
//
// Design: ONE launch, a persistent grid of co-resident blocks (cooperative
// launch, occupancy x SMs, no more blocks than work items) running three
// phases separated by a grid-wide barrier (grid_barrier below; its counter
// is the only atomic and no sum goes through it):
//   1. partial sums: work item (sample, chunk of chunk_rows rows), items
//      walked blockIdx.x, +gridDim.x, ... Each thread owns a fixed octet of
//      8 channels and one of R row lanes, loads 16 bytes a time, UNROLL
//      rows in flight, and sums x + bias and its square over its rows in
//      order; the block adds the row lanes per channel, then a warp per
//      group the group's channels (a fixed butterfly) ->
//      part[sample][chunk][group].
//   2. statistics: work item (sample, group); the block's threads sum the
//      chunk partials strided by the block size, in order, then a fixed
//      halving tree -> mean and rsqrt(var + eps) with one-pass moments, the
//      variance clamped at 0 (replaces a serial loop over up to 2880 chunk
//      partials per group in one thread).
//   3. apply: the items of phase 1 in the reverse order, so the chunks read
//      last, still in the 50 MB L2, are read again first (a UNet sample is
//      at most 29.5 MB; the VAE's rows, up to 94 MB, are read twice from
//      HBM). Per octet the scale, shift and bias live in registers; there is
//      no per-element modulus; loads and stores are 16 bytes; SiLU as
//      v / (1 + exp(-v)).
// The chunking is planned by the wrapper (ops/groupnorm.py plan) and depends
// on the shape only, so the sums, whatever the grid, run in one fixed order
// and a rerun is bit-identical.
#include "common.cuh"

using namespace dvdx;

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // rows a thread loads before it sums them
constexpr int MAXC = 2560;  // widest GN input: the UNet's 1280+1280 skip concat

// Grid-wide barrier state. A launch leaves the count at 0; the generation
// only grows. The port launches GroupNorm on one stream, so two launches
// never share it at once.
__device__ __align__(128) unsigned int g_bar_count = 0;  // apart from the
__device__ __align__(128) unsigned int g_bar_gen = 0;    // line the waiters poll

// Every block arrives once; the last one resets the count and moves the
// generation on, the others wait for that. Writes before the barrier are
// visible after it to reads that bypass L1 (__ldcg). A wait that never ends
// traps after 2^24 polls (seconds) instead of hanging.
__device__ __forceinline__ void grid_barrier() {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &g_bar_gen;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(&g_bar_count, 1u) == gridDim.x - 1) {
      atomicExch(&g_bar_count, 0u);
      __threadfence();
      *gen = g + 1;
    } else {
      unsigned int polls = 0;
      while (*gen == g) {
        __nanosleep(32);
        if (++polls == (1u << 24)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

struct GnArgs {
  const bf16* x;      // (N, L, C)
  const bf16* bias;   // (N, C) or null
  const float* gamma; // (C)
  const float* beta;  // (C)
  bf16* y;            // (N, L, C)
  float* part;        // (N, nchunks, G, 2)
  float* stats;       // (N, G, 2): mean, rstd
  int N, L, C, G, chunk_rows, nchunks, silu;
  float eps;
};

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 p = __bfloat1622float2(h);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void octet_bias(const GnArgs& a, int n, int c0, float (&b)[8]) {
  if (a.bias != nullptr) {
    unpack8(*reinterpret_cast<const uint4*>(a.bias + (long long)n * a.C + c0), b);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = 0.f;
  }
}

// 4 blocks of 256 threads on each SM (at most 64 registers a thread), so
// that an SM keeps 1024 x UNROLL 16-byte loads in flight
__global__ void __launch_bounds__(THREADS, 4)
gn_fused(const GnArgs a) {
  __shared__ float csum[MAXC];
  __shared__ float csq[MAXC];
  __shared__ float tree[2][THREADS];
  const int C = a.C, G = a.G, cpg = C / G;
  const int octets = C / 8;
  const int lanes = octets >= THREADS ? 1 : THREADS / octets;  // row lanes R
  const int pairs = lanes * octets;  // (row lane, octet) pairs of a block
  const int items = a.N * a.nchunks;

  // ---- phase 1: per (sample, chunk) group partial sums ----
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int n = it / a.nchunks, chunk = it % a.nchunks;
    const int l0 = chunk * a.chunk_rows, l1 = min(a.L, l0 + a.chunk_rows);
    for (int j = threadIdx.x; j < pairs; j += THREADS) {
      const int rl = j / octets, c0 = (j % octets) * 8;
      float b[8], s[8], q[8];
      octet_bias(a, n, c0, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
      const long long step = (long long)lanes * C;
      const bf16* xp = a.x + ((long long)n * a.L + l0 + rl) * C + c0;
      auto add = [&](const uint4& v) {
        float f[8];
        unpack8(v, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = f[e] + b[e];
          s[e] += y;
          q[e] = fmaf(y, y, q[e]);
        }
      };
      int l = l0 + rl;
      // UNROLL loads in flight, then the sums in row order
      for (; l + (UNROLL - 1) * lanes < l1; l += UNROLL * lanes, xp += UNROLL * step) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(xp + u * step));
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add(v[u]);
      }
      for (; l < l1; l += lanes, xp += step) add(__ldg(reinterpret_cast<const uint4*>(xp)));
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        csum[rl * C + c0 + e] = s[e];
        csq[rl * C + c0 + e] = q[e];
      }
    }
    __syncthreads();
    // channel totals over the row lanes, in lane order, into lane 0's slots
    for (int c = threadIdx.x; c < C; c += THREADS) {
      float s = 0.f, q = 0.f;
      for (int rl = 0; rl < lanes; ++rl) {
        s += csum[rl * C + c];
        q += csq[rl * C + c];
      }
      csum[c] = s;
      csq[c] = q;
    }
    __syncthreads();
    // group totals: a warp per group, lanes over its channels, a fixed
    // butterfly across the lanes
    for (int gi = threadIdx.x >> 5; gi < G; gi += THREADS / 32) {
      float s = 0.f, q = 0.f;
      for (int c = gi * cpg + (threadIdx.x & 31); c < (gi + 1) * cpg; c += 32) {
        s += csum[c];
        q += csq[c];
      }
      s = warp_sum(s);
      q = warp_sum(q);
      if ((threadIdx.x & 31) == 0) {
        float* p = a.part + (((long long)n * a.nchunks + chunk) * G + gi) * 2;
        p[0] = s;
        p[1] = q;
      }
    }
    __syncthreads();  // csum is rewritten by the next item
  }
  grid_barrier();

  // ---- phase 2: per (sample, group) statistics ----
  const float count = static_cast<float>(a.L) * cpg;
  for (int it = blockIdx.x; it < a.N * G; it += gridDim.x) {
    const int n = it / G, gi = it % G;
    float s = 0.f, q = 0.f;
    for (int ch = threadIdx.x; ch < a.nchunks; ch += THREADS) {
      const float2 p = __ldcg(reinterpret_cast<const float2*>(
          a.part + (((long long)n * a.nchunks + ch) * G + gi) * 2));
      s += p.x;
      q += p.y;
    }
    tree[0][threadIdx.x] = s;
    tree[1][threadIdx.x] = q;
    __syncthreads();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) {
        tree[0][threadIdx.x] += tree[0][threadIdx.x + h];
        tree[1][threadIdx.x] += tree[1][threadIdx.x + h];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float mean = tree[0][0] / count;
      const float var = fmaxf(tree[1][0] / count - mean * mean, 0.f);
      a.stats[it * 2] = mean;
      a.stats[it * 2 + 1] = rsqrtf(var + a.eps);
    }
    __syncthreads();  // tree is rewritten by the next item
  }
  grid_barrier();

  // ---- phase 3: normalise, affine, SiLU; phase 1's items in reverse ----
  for (int k = blockIdx.x; k < items; k += gridDim.x) {
    const int it = items - 1 - k;
    const int n = it / a.nchunks, chunk = it % a.nchunks;
    const int l0 = chunk * a.chunk_rows, l1 = min(a.L, l0 + a.chunk_rows);
    for (int j = threadIdx.x; j < pairs; j += THREADS) {
      const int rl = j / octets, c0 = (j % octets) * 8;
      float b[8], sc[8], sh[8];
      octet_bias(a, n, c0, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int gi = (c0 + e) / cpg;
        const float2 st = __ldcg(reinterpret_cast<const float2*>(a.stats + (n * G + gi) * 2));
        sc[e] = st.y * a.gamma[c0 + e];
        sh[e] = a.beta[c0 + e] - st.x * sc[e];
      }
      const long long off0 = ((long long)n * a.L + l0 + rl) * C + c0;
      const long long step = (long long)lanes * C;
      const bf16* xp = a.x + off0;
      bf16* yp = a.y + off0;
      auto apply = [&](const uint4& v) {
        float f[8];
        unpack8(v, f);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float v0 = (f[e] + b[e]) * sc[e] + sh[e];
          float v1 = (f[e + 1] + b[e + 1]) * sc[e + 1] + sh[e + 1];
          if (a.silu) {
            v0 = v0 * (1.f / (1.f + expf(-v0)));
            v1 = v1 * (1.f / (1.f + expf(-v1)));
          }
          w[e / 2] = pack_bf16(v0, v1);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
      };
      int l = l0 + rl;
      for (; l + (UNROLL - 1) * lanes < l1; l += UNROLL * lanes) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(reinterpret_cast<const uint4*>(xp + u * step));
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          *reinterpret_cast<uint4*>(yp + u * step) = apply(v[u]);
        xp += UNROLL * step;
        yp += UNROLL * step;
      }
      for (; l < l1; l += lanes, xp += step, yp += step)
        *reinterpret_cast<uint4*>(yp) = apply(__ldg(reinterpret_cast<const uint4*>(xp)));
    }
  }
}

}  // namespace

// x, y: (N, L, C) contiguous bf16, 16-byte aligned; bias: (N, C) bf16 or
// null; gamma, beta: (C) f32; part: (N, nchunks, G, 2) f32 scratch; stats:
// (N, G, 2) f32 scratch. C % 8 == 0, C <= 2560, C % G == 0; chunk_rows and
// nchunks from the wrapper's plan, nchunks * chunk_rows covering L.
extern "C" int dvdx_group_norm(const void* x, const void* bias,
                               const void* gamma, const void* beta, void* y,
                               void* part, void* stats, int N, int L, int C,
                               int G, int chunk_rows, int nchunks, float eps,
                               int silu, void* stream) {
  if (N < 1 || L < 1 || C % 8 || C > MAXC || G < 1 || C % G || chunk_rows < 1 ||
      nchunks < 1 || (long long)chunk_rows * nchunks < L ||
      (long long)chunk_rows * (nchunks - 1) >= L)
    return static_cast<int>(cudaErrorInvalidValue);
  static int capacity = 0;  // co-resident blocks on the card
  if (capacity == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_fused, THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    capacity = sms * per_sm;
    if (capacity < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const GnArgs a = {static_cast<const bf16*>(x), static_cast<const bf16*>(bias),
                    static_cast<const float*>(gamma), static_cast<const float*>(beta),
                    static_cast<bf16*>(y), static_cast<float*>(part),
                    static_cast<float*>(stats), N, L, C, G, chunk_rows, nchunks,
                    silu, eps};
  const int items = N * nchunks > N * G ? N * nchunks : N * G;
  const int grid = items < capacity ? items : capacity;
  void* args[] = {const_cast<GnArgs*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_fused), dim3(grid), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream)));
}
