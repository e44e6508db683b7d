// GroupNorm (+ per-sample channel pre-bias) (+ SiLU) over (N, L, C) bf16 or
// float32 (one template; the float32 model's norms take the second).
//
// Replaces dvdx_tpu/ops/groupnorm.py:group_norm_act (_gn_pallas / _gn_kernel).
// The TPU kernel holds one whole (L, C) row in VMEM; the H100 has 227 KB of
// shared memory per block and the UNet's rows reach 29.5 MB ((2, 46080, 320)
// in the temporal transformer's norm), so the statistics are reduced across
// the grid in a fixed order instead.
//
// Bound on the H100: a few f32 operations per element against 2 bytes read
// and 2 written (4 and 4 in float32), so bytes: one read of x and one write
// of y at 3.35 TB/s.
//
// Design: ONE launch, a persistent grid of co-resident blocks (cooperative
// launch, occupancy x SMs, no more blocks than work items) running three
// phases separated by a grid-wide barrier (grid_barrier below; its counter
// is the only atomic and no sum goes through it):
//   1. partial sums: work item (sample, chunk of chunk_rows rows), items
//      walked blockIdx.x, +gridDim.x, ... Each thread owns a fixed octet of
//      8 channels and one of R row lanes, loads an octet (16 bytes of bf16,
//      32 of float32) a time, Rows<T>::unroll rows in flight, and sums x + bias and its square over its rows in
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
//      no per-element modulus; loads and stores are whole octets; SiLU as
//      v / (1 + exp(-v)).
// The chunking is planned by the wrapper (ops/groupnorm.py plan) and depends
// on the shape only, so the sums, whatever the grid, run in one fixed order
// and a rerun is bit-identical.
//
// Frame-sharded GroupNorm (ops/groupnorm.py group_norm_act_sharded: each rank
// holds some frames, the statistics span all of them) splits the launch at
// its first barrier into two entries, with an all-reduce between them. Both
// are bounded by bytes (moments-out reads x once, moments-in reads x and
// writes y once), and at the UNet's frame-sharded norms (4-18 us of bytes)
// a launch's ramp and tail are a large share, so each entry is one plain
// launch that keeps many 16-byte loads in flight:
//   moments-out (dvdx_group_norm_moments): phase 1 in float64. A block a
//     (sample, chunk), the chunks of the wrapper's moments_plan (about 384
//     blocks in all, one wave of 3 an SM on the H100, a function of the
//     shape only): each thread sums its octet's rows in order, as gn_fused's
//     phase 1 loads them (Octet<T>::unroll rows in flight), in float64 (x
//     and x^2, a float32 value and its square exact in float64); the block
//     adds its row lanes per channel in lane order through a shared-memory
//     stage sized to the shape (lanes x C doubles, at most 40 KB at C =
//     2560), then a warp per group its channels, strided over the lanes in
//     order and a fixed butterfly -> part (N, G, nchunks, 2). The last
//     block of a sample to finish (its writers' __threadfence and a ticket a
//     sample, g_moment_tickets, the only atomic: no sum goes through it)
//     sums the sample's chunk partials, a warp per group, strided over the
//     lanes in chunk order and a fixed butterfly -> sums (2, N, G) float64,
//     and sets the ticket back to 0 for the next launch. A float64 sum of
//     these values rounds to one float32 mean in any order, so the split
//     across ranks gives the one-device moments (the JAX package gets the
//     same moments from GSPMD's all-reduce of its float32 sums).
//   moments-in (dvdx_group_norm_apply): phase 3 alone, from float32 (mean,
//     E[x^2]) per (sample, group). One launch of the co-resident blocks,
//     with chunks sized so that each takes about one (sample, chunk) item
//     (an element's result does not depend on the chunking); a block
//     computes its sample's per-channel scale and shift once into shared
//     memory (the variance clamped at 0, 1 / sqrt(var + eps), gamma / beta;
//     each float32 operation rounded as the plain version rounds it, no
//     contraction), then each thread streams its octet's rows,
//     Octet<T>::unroll in flight, with SiLU as gn_fused's.
// Both bound by bytes. A float32 (mean, E[x^2]) pair is passed as two
// arrays, and the wrapper allocates the outputs without the fill that
// torch.empty makes while deterministic algorithms are on.
#include "common.cuh"

using namespace dvdx;

namespace {

constexpr int THREADS = 256;
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

// One octet of 8 channels in registers as loaded, and its rows in flight:
// bf16 is one 16-byte load and 4 rows, float32 two and 2 rows (the same
// registers).
template <typename T> struct Octet;
template <> struct Octet<bf16> {
  uint4 v;
  static constexpr int unroll = 4;
  __device__ __forceinline__ static Octet load(const bf16* p) {
    return {__ldg(reinterpret_cast<const uint4*>(p))};
  }
  __device__ __forceinline__ void unpack(float (&f)[8]) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      const float2 p = __bfloat1622float2(h);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                              pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
};
template <> struct Octet<float> {
  float4 a, b;
  static constexpr int unroll = 2;
  __device__ __forceinline__ static Octet load(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)), __ldg(reinterpret_cast<const float4*>(p + 4))};
  }
  __device__ __forceinline__ void unpack(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T>
struct GnArgs {
  const T* x;         // (N, L, C)
  const T* bias;      // (N, C) or null
  const float* gamma; // (C)
  const float* beta;  // (C)
  T* y;               // (N, L, C)
  float* part;        // (N, nchunks, G, 2)
  float* stats;       // (N, G, 2): mean, rstd
  int N, L, C, G, chunk_rows, nchunks, silu;
  float eps;
};

template <typename T>
__device__ __forceinline__ void octet_bias(const GnArgs<T>& a, int n, int c0, float (&b)[8]) {
  if (a.bias != nullptr) {
    Octet<T>::load(a.bias + (long long)n * a.C + c0).unpack(b);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = 0.f;
  }
}

// 4 blocks of 256 threads on each SM (at most 64 registers a thread), so
// that an SM keeps 1024 x UNROLL 16-byte loads in flight
template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
gn_fused(const GnArgs<T> a) {
  constexpr int UNROLL = Octet<T>::unroll;  // rows a thread loads before it sums them
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
      const T* xp = a.x + ((long long)n * a.L + l0 + rl) * C + c0;
      auto add = [&](const Octet<T>& v) {
        float f[8];
        v.unpack(f);
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
        Octet<T> v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = Octet<T>::load(xp + u * step);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) add(v[u]);
      }
      for (; l < l1; l += lanes, xp += step) add(Octet<T>::load(xp));
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
      const T* xp = a.x + off0;
      T* yp = a.y + off0;
      auto apply = [&](const Octet<T>& v, T* dst) {
        float f[8];
        v.unpack(f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          f[e] = (f[e] + b[e]) * sc[e] + sh[e];
          if (a.silu) f[e] = f[e] * (1.f / (1.f + expf(-f[e])));
        }
        Octet<T>::store(dst, f);
      };
      int l = l0 + rl;
      for (; l + (UNROLL - 1) * lanes < l1; l += UNROLL * lanes) {
        Octet<T> v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = Octet<T>::load(xp + u * step);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) apply(v[u], yp + u * step);
        xp += UNROLL * step;
        yp += UNROLL * step;
      }
      for (; l < l1; l += lanes, xp += step, yp += step) apply(Octet<T>::load(xp), yp);
    }
  }
}

}  // namespace

namespace {

// the shapes every entry takes: C a multiple of 8 up to MAXC, G dividing C,
// and chunks of chunk_rows rows covering L with none empty
bool bad_shape(int N, int L, int C, int G, int chunk_rows, int nchunks) {
  return N < 1 || L < 1 || C % 8 || C > MAXC || G < 1 || C % G || chunk_rows < 1 ||
         nchunks < 1 || (long long)chunk_rows * nchunks < L ||
         (long long)chunk_rows * (nchunks - 1) >= L;
}

template <typename T>
int group_norm_launch(const void* x, const void* bias, const void* gamma, const void* beta,
                      void* y, void* part, void* stats, int N, int L, int C, int G,
                      int chunk_rows, int nchunks, float eps, int silu, cudaStream_t stream) {
  if (bad_shape(N, L, C, G, chunk_rows, nchunks)) return static_cast<int>(cudaErrorInvalidValue);
  static int capacity = 0;  // co-resident blocks on the card
  if (capacity == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_fused<T>, THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    capacity = sms * per_sm;
    if (capacity < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const GnArgs<T> a = {static_cast<const T*>(x), static_cast<const T*>(bias),
                       static_cast<const float*>(gamma), static_cast<const float*>(beta),
                       static_cast<T*>(y), static_cast<float*>(part),
                       static_cast<float*>(stats), N, L, C, G, chunk_rows, nchunks,
                       silu, eps};
  const int items = N * nchunks > N * G ? N * nchunks : N * G;
  const int grid = items < capacity ? items : capacity;
  void* args[] = {const_cast<GnArgs<T>*>(&a)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_fused<T>), dim3(grid), dim3(THREADS), args, 0, stream));
}

}  // namespace

namespace {

// Per-sample tickets of moments-out: a sample's blocks count themselves in,
// and the last one sets the ticket back to 0, so a launch leaves them all at
// 0. The port launches GroupNorm on one stream, so two launches never share
// them at once.
constexpr int MAX_MOMENT_SAMPLES = 4096;
__device__ unsigned int g_moment_tickets[MAX_MOMENT_SAMPLES];

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// row lanes R of a block: (row lane, octet) pairs cover the block once
__host__ __device__ __forceinline__ int row_lanes(int C) {
  return C / 8 >= THREADS ? 1 : THREADS / (C / 8);
}

// The rows l0 + rl, + lanes, ... < l1 of the octet column at xp (row l0 +
// rl), step = lanes * C elements apart: fn(octet, offset of its row) in row
// order, Octet<T>::unroll loads in flight before the first of them
template <typename T, class Fn>
__device__ __forceinline__ void walk_rows(const T* xp, long long step, int l, int l1, int lanes,
                                          Fn&& fn) {
  constexpr int UNROLL = Octet<T>::unroll;
  long long off = 0;
  for (; l + (UNROLL - 1) * lanes < l1; l += UNROLL * lanes, off += UNROLL * step) {
    Octet<T> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = Octet<T>::load(xp + off + u * step);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) fn(v[u], off + u * step);
  }
  for (; l < l1; l += lanes, off += step) fn(Octet<T>::load(xp + off), off);
}

// moments-out: float64 sums of x and x^2 per (sample, chunk, group) into
// part, then, in the last block of each sample, per (sample, group) into
// sums. Every sum in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
gn_moments(const T* __restrict__ x, double* part, double* __restrict__ sums, int N, int L, int C,
           int G, int chunk_rows, int nchunks) {
  extern __shared__ double stage[];  // [2][lanes * C]: per (row lane, channel) sums
  __shared__ bool last;
  const int cpg = C / G, octets = C / 8, lanes = row_lanes(C);
  const int pairs = lanes * octets;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x / nchunks, chunk = blockIdx.x - n * nchunks;
  const int l0 = chunk * chunk_rows, l1 = min(L, l0 + chunk_rows);
  double* ssum = stage;
  double* ssq = stage + pairs * 8;
  for (int j = threadIdx.x; j < pairs; j += THREADS) {
    const int rl = j / octets, c0 = (j - rl * octets) * 8;
    double s[8], q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.0;
    walk_rows(x + ((long long)n * L + l0 + rl) * C + c0, (long long)lanes * C, l0 + rl, l1,
              lanes, [&](const Octet<T>& o, long long) {
                float f[8];
                o.unpack(f);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  const double v = f[e];
                  s[e] += v;
                  q[e] = fma(v, v, q[e]);
                }
              });
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ssum[rl * C + c0 + e] = s[e];
      ssq[rl * C + c0 + e] = q[e];
    }
  }
  __syncthreads();
  // channel totals over the row lanes, in lane order, into lane 0's slots
  if (lanes > 1) {
    for (int c = threadIdx.x; c < C; c += THREADS) {
      double s = ssum[c], q = ssq[c];
      for (int rl = 1; rl < lanes; ++rl) {
        s += ssum[rl * C + c];
        q += ssq[rl * C + c];
      }
      ssum[c] = s;
      ssq[c] = q;
    }
    __syncthreads();
  }
  // group totals: a warp per group, lanes over its channels in order, a
  // fixed butterfly across the lanes
  for (int gi = warp; gi < G; gi += THREADS / 32) {
    double s = 0.0, q = 0.0;
    for (int c = gi * cpg + lane; c < (gi + 1) * cpg; c += 32) {
      s += ssum[c];
      q += ssq[c];
    }
    s = warp_sum_f64(s);
    q = warp_sum_f64(q);
    if (lane == 0) {
      *reinterpret_cast<double2*>(part + (((long long)n * G + gi) * nchunks + chunk) * 2) =
          make_double2(s, q);
      __threadfence();  // the partial is visible before the block counts itself in
    }
  }

  // the last block of sample n to finish sums its chunk partials: a warp per
  // group, lanes strided over the chunks in order (8 loads in flight), then
  // a fixed butterfly
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_moment_tickets[n], 1u) == unsigned(nchunks - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int gi = warp; gi < G; gi += THREADS / 32) {
    const double2* p =
        reinterpret_cast<const double2*>(part + ((long long)n * G + gi) * nchunks * 2);
    double s = 0.0, q = 0.0;
    for (int c0 = lane; c0 < nchunks; c0 += 32 * 8) {
      double2 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + 32 * u < nchunks) v[u] = __ldcg(p + c0 + 32 * u);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + 32 * u < nchunks) {
          s += v[u].x;
          q += v[u].y;
        }
    }
    s = warp_sum_f64(s);
    q = warp_sum_f64(q);
    if (lane == 0) {
      sums[n * G + gi] = s;
      sums[(long long)N * G + n * G + gi] = q;
    }
  }
  if (threadIdx.x == 0) g_moment_tickets[n] = 0;
}

// moments-in: normalise, affine, SiLU from the given float32 mean and
// E[x^2], each (N, G), the (sample, chunk) items walked blockIdx.x,
// +gridDim.x, ...
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
gn_apply(const T* __restrict__ x, const float* __restrict__ mean_in,
         const float* __restrict__ sq_in, const float* __restrict__ gamma,
         const float* __restrict__ beta, T* __restrict__ y, int N, int L, int C, int G,
         int chunk_rows, int nchunks, float eps, int silu) {
  extern __shared__ float affine[];  // [2][C]: scale and shift of the block's sample
  const int cpg = C / G, octets = C / 8, lanes = row_lanes(C);
  const int pairs = lanes * octets;
  int cur = -1;  // the sample whose scale and shift affine holds
  for (int it = blockIdx.x; it < N * nchunks; it += gridDim.x) {
    const int n = it / nchunks, chunk = it - n * nchunks;
    if (n != cur) {  // the same for the whole block
      __syncthreads();  // the last item is done with affine
      for (int c = threadIdx.x; c < C; c += THREADS) {
        const int gi = c / cpg;
        const float mean = mean_in[n * G + gi];
        const float var = fmaxf(__fsub_rn(sq_in[n * G + gi], __fmul_rn(mean, mean)), 0.f);
        const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
        const float sc = __fmul_rn(rstd, gamma[c]);
        affine[c] = sc;
        affine[C + c] = __fsub_rn(beta[c], __fmul_rn(mean, sc));
      }
      __syncthreads();
      cur = n;
    }
    const int l0 = chunk * chunk_rows, l1 = min(L, l0 + chunk_rows);
    for (int j = threadIdx.x; j < pairs; j += THREADS) {
      const int rl = j / octets, c0 = (j - rl * octets) * 8;
      float sc[8], sh[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[e] = affine[c0 + e];
        sh[e] = affine[C + c0 + e];
      }
      const long long off0 = ((long long)n * L + l0 + rl) * C + c0;
      T* yp = y + off0;
      walk_rows(x + off0, (long long)lanes * C, l0 + rl, l1, lanes,
                [&](const Octet<T>& v, long long off) {
                  float f[8];
                  v.unpack(f);
#pragma unroll
                  for (int e = 0; e < 8; ++e) {
                    f[e] = __fadd_rn(__fmul_rn(f[e], sc[e]), sh[e]);
                    if (silu) f[e] = f[e] * (1.f / (1.f + expf(-f[e])));
                  }
                  Octet<T>::store(yp + off, f);
                });
    }
  }
}

// co-resident blocks of gn_apply<T> on the card at its largest shared memory
template <typename T>
int apply_capacity(int& capacity) {
  if (capacity > 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_apply<T>, THREADS,
                                                      2 * MAXC * sizeof(float));
  if (e != cudaSuccess) return static_cast<int>(e);
  capacity = sms * per_sm;
  return capacity < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

}  // namespace

// moments-out. x: (N, L, C) contiguous, bf16 (f32 == 0) or float32 (f32 ==
// 1), 16-byte aligned; part: (N, G, nchunks, 2) float64 scratch; sums: (2, N,
// G) float64, the sums of x and of x^2 per (sample, group). N <= 4096; other
// shape limits as dvdx_group_norm's; chunk_rows and nchunks from the
// wrapper's moments_plan (a block a chunk). One launch.
extern "C" int dvdx_group_norm_moments(const void* x, void* part, void* sums, int N, int L,
                                       int C, int G, int chunk_rows, int nchunks, int f32,
                                       void* stream) {
  if (bad_shape(N, L, C, G, chunk_rows, nchunks) || N > MAX_MOMENT_SAMPLES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(part);
  double* out = static_cast<double*>(sums);
  const size_t smem = 2 * sizeof(double) * row_lanes(C) * C;
  if (f32)
    gn_moments<float><<<N * nchunks, THREADS, smem, s>>>(static_cast<const float*>(x), p, out,
                                                         N, L, C, G, chunk_rows, nchunks);
  else
    gn_moments<bf16><<<N * nchunks, THREADS, smem, s>>>(static_cast<const bf16*>(x), p, out, N,
                                                        L, C, G, chunk_rows, nchunks);
  return static_cast<int>(cudaGetLastError());
}

// moments-in. x, y: as dvdx_group_norm's; mean, sq: (N, G) float32, the
// mean and E[x^2] per (sample, group); gamma, beta: (C) f32. One launch of
// the co-resident blocks, about one (sample, chunk) item each (every
// element's result is the same whatever the chunking).
extern "C" int dvdx_group_norm_apply(const void* x, const void* mean, const void* sq,
                                     const void* gamma, const void* beta, void* y, int N, int L,
                                     int C, int G, float eps, int silu, int f32, void* stream) {
  if (bad_shape(N, L, C, G, L, 1)) return static_cast<int>(cudaErrorInvalidValue);
  static int capacity[2] = {0, 0};  // co-resident blocks: bf16, float32
  const int rc = f32 ? apply_capacity<float>(capacity[1]) : apply_capacity<bf16>(capacity[0]);
  if (rc) return rc;
  const int cap = capacity[f32 ? 1 : 0];
  const long long rows = ((long long)N * L + cap - 1) / cap;
  const int chunk_rows = rows < L ? static_cast<int>(rows) : L;
  const int nchunks = (L + chunk_rows - 1) / chunk_rows;
  const int items = N * nchunks, grid = items < cap ? items : cap;
  const size_t smem = 2 * sizeof(float) * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* sq2 = static_cast<const float*>(sq);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (f32)
    gn_apply<float><<<grid, THREADS, smem, s>>>(static_cast<const float*>(x), mu, sq2, ga, be,
                                                static_cast<float*>(y), N, L, C, G, chunk_rows,
                                                nchunks, eps, silu);
  else
    gn_apply<bf16><<<grid, THREADS, smem, s>>>(static_cast<const bf16*>(x), mu, sq2, ga, be,
                                               static_cast<bf16*>(y), N, L, C, G, chunk_rows,
                                               nchunks, eps, silu);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (N, L, C) contiguous, bf16 (f32 == 0) or float32 (f32 == 1), 16-byte
// aligned; bias: (N, C) of x's type or null; gamma, beta: (C) f32; part:
// (N, nchunks, G, 2) f32 scratch; stats: (N, G, 2) f32 scratch. C % 8 == 0,
// C <= 2560, C % G == 0; chunk_rows and nchunks from the wrapper's plan,
// nchunks * chunk_rows covering L.
extern "C" int dvdx_group_norm(const void* x, const void* bias,
                               const void* gamma, const void* beta, void* y,
                               void* part, void* stats, int N, int L, int C,
                               int G, int chunk_rows, int nchunks, float eps,
                               int silu, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? group_norm_launch<float>(x, bias, gamma, beta, y, part, stats, N, L, C, G,
                                        chunk_rows, nchunks, eps, silu, s)
             : group_norm_launch<bf16>(x, bias, gamma, beta, y, part, stats, N, L, C, G,
                                       chunk_rows, nchunks, eps, silu, s);
}
