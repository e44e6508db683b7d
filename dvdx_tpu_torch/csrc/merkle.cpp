// Multithreaded SHA-256 for the Proof-of-Inference Merkle commitment.
//
// A miner commits every recorded denoise step's (t, z_t, eps_t) leaf: at
// zeroscope-v2-576w's standard geometry 25 leaves of 2 + 2 x 368,640 bf16
// bytes, at XL 50 leaves of 2 + 2 x 1,769,472. This library provides:
//
//   dvdx_sha256_leaves : leaf hashes sha256(t_be16 || z || eps), threaded
//                        across leaves
//   dvdx_merkle_root   : bottom-up sorted-pair tree root (odd-node dup)
//   dvdx_sha256        : one-shot hash
//
// Self-contained SHA-256 (FIPS 180-4), with SHA-NI where the CPU has it
// (checked at run time), so the library builds with g++ alone. The same
// three entry points as the JAX package's hasher, over the same bytes.
// Built and bound by dvdx_tpu_torch/utils/native.py (g++ at first use);
// the plain version it is held against is the hashlib loop of
// dvdx_tpu_torch/verify/merkle.py.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#define DVDX_X86 1
#endif

namespace {

#ifdef DVDX_X86
bool has_sha_ni() {
  static const bool ok = [] {
    unsigned a, b, c, d;
    if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return false;
    return (b & (1u << 29)) != 0;  // EBX bit 29 = SHA
  }();
  return ok;
}

// One or more 64-byte blocks via SHA-NI (FIPS 180-4 schedule in xmm lanes).
__attribute__((target("sha,sse4.1")))
void sha_ni_blocks(uint32_t state[8], const uint8_t* data, size_t nblocks) {
  static const uint32_t K[64] = {
      0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
      0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
      0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
      0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
      0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
      0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
      0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
      0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
      0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
      0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
      0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  // state layout for sha256rnds2: ABEF / CDGH
  __m128i tmp = _mm_loadu_si128((const __m128i*)&state[0]);   // DCBA
  __m128i st1 = _mm_loadu_si128((const __m128i*)&state[4]);   // HGFE
  tmp = _mm_shuffle_epi32(tmp, 0xB1);  // CDAB
  st1 = _mm_shuffle_epi32(st1, 0x1B);  // EFGH
  __m128i abef = _mm_alignr_epi8(tmp, st1, 8);                // ABEF
  __m128i cdgh = _mm_blend_epi16(st1, tmp, 0xF0);             // CDGH

  while (nblocks--) {
    __m128i save0 = abef, save1 = cdgh;
    __m128i msg0 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i*)(data + 0)), MASK);
    __m128i msg1 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i*)(data + 16)), MASK);
    __m128i msg2 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i*)(data + 32)), MASK);
    __m128i msg3 = _mm_shuffle_epi8(
        _mm_loadu_si128((const __m128i*)(data + 48)), MASK);

    __m128i msg;
#define RND2(mi, ki)                                                        \
  msg = _mm_add_epi32(mi, _mm_loadu_si128((const __m128i*)&K[ki]));         \
  cdgh = _mm_sha256rnds2_epu32(cdgh, abef, msg);                            \
  msg = _mm_shuffle_epi32(msg, 0x0E);                                       \
  abef = _mm_sha256rnds2_epu32(abef, cdgh, msg);
#define SCHED(m0, m1, m2, m3)                                               \
  m0 = _mm_sha256msg1_epu32(m0, m1);                                        \
  m0 = _mm_add_epi32(m0, _mm_alignr_epi8(m3, m2, 4));                       \
  m0 = _mm_sha256msg2_epu32(m0, m3);

    RND2(msg0, 0) RND2(msg1, 4) RND2(msg2, 8) RND2(msg3, 12)
    SCHED(msg0, msg1, msg2, msg3) RND2(msg0, 16)
    SCHED(msg1, msg2, msg3, msg0) RND2(msg1, 20)
    SCHED(msg2, msg3, msg0, msg1) RND2(msg2, 24)
    SCHED(msg3, msg0, msg1, msg2) RND2(msg3, 28)
    SCHED(msg0, msg1, msg2, msg3) RND2(msg0, 32)
    SCHED(msg1, msg2, msg3, msg0) RND2(msg1, 36)
    SCHED(msg2, msg3, msg0, msg1) RND2(msg2, 40)
    SCHED(msg3, msg0, msg1, msg2) RND2(msg3, 44)
    SCHED(msg0, msg1, msg2, msg3) RND2(msg0, 48)
    SCHED(msg1, msg2, msg3, msg0) RND2(msg1, 52)
    SCHED(msg2, msg3, msg0, msg1) RND2(msg2, 56)
    SCHED(msg3, msg0, msg1, msg2) RND2(msg3, 60)
#undef RND2
#undef SCHED

    abef = _mm_add_epi32(abef, save0);
    cdgh = _mm_add_epi32(cdgh, save1);
    data += 64;
  }

  tmp = _mm_shuffle_epi32(abef, 0x1B);  // FEBA
  st1 = _mm_shuffle_epi32(cdgh, 0xB1);  // DCHG
  __m128i dcba = _mm_blend_epi16(tmp, st1, 0xF0);
  __m128i hgfe = _mm_alignr_epi8(st1, tmp, 8);
  _mm_storeu_si128((__m128i*)&state[0], dcba);
  _mm_storeu_si128((__m128i*)&state[4], hgfe);
}
#endif  // DVDX_X86

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    std::memcpy(h, init, sizeof(init));
  }

  static inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
        0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
        0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
        0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
        0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
        0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
        0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
        0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void blocks(const uint8_t* data, size_t nblocks) {
#ifdef DVDX_X86
    if (has_sha_ni()) {
      sha_ni_blocks(h, data, nblocks);
      return;
    }
#endif
    for (size_t i = 0; i < nblocks; i++) block(data + 64 * i);
  }

  void update(const uint8_t* data, size_t n) {
    len += n;
    if (buflen) {
      size_t take = 64 - buflen < n ? 64 - buflen : n;
      std::memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      n -= take;
      if (buflen == 64) {
        blocks(buf, 1);
        buflen = 0;
      }
    }
    if (n >= 64) {
      blocks(data, n / 64);
      data += (n / 64) * 64;
      n %= 64;
    }
    if (n) {
      std::memcpy(buf, data, n);
      buflen = n;
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bitlen = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bitlen >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void hash_leaf(uint16_t t, const uint8_t* z, const uint8_t* eps,
               size_t bytes_per_tensor, uint8_t out[32]) {
  Sha256 s;
  uint8_t tb[2] = {uint8_t(t >> 8), uint8_t(t & 0xff)};  // big-endian u16
  s.update(tb, 2);
  s.update(z, bytes_per_tensor);
  s.update(eps, bytes_per_tensor);
  s.final(out);
}

}  // namespace

extern "C" {

void dvdx_sha256(const uint8_t* data, size_t n, uint8_t* out) {
  Sha256 s;
  s.update(data, n);
  s.final(out);
}

// Leaf hashes for n steps; z/eps are contiguous (n, bytes_per_tensor) blobs.
void dvdx_sha256_leaves(const uint16_t* timesteps, const uint8_t* z,
                        const uint8_t* eps, size_t n, size_t bytes_per_tensor,
                        uint8_t* out, int n_threads) {
  if (n_threads <= 1 || n < 2) {
    for (size_t i = 0; i < n; i++)
      hash_leaf(timesteps[i], z + i * bytes_per_tensor,
                eps + i * bytes_per_tensor, bytes_per_tensor, out + 32 * i);
    return;
  }
  size_t workers = size_t(n_threads) < n ? size_t(n_threads) : n;
  std::vector<std::thread> threads;
  for (size_t w = 0; w < workers; w++) {
    threads.emplace_back([=]() {
      for (size_t i = w; i < n; i += workers)
        hash_leaf(timesteps[i], z + i * bytes_per_tensor,
                  eps + i * bytes_per_tensor, bytes_per_tensor, out + 32 * i);
    });
  }
  for (auto& t : threads) t.join();
}

// Sorted-pair Merkle root with odd-node duplication over n 32-byte leaves.
void dvdx_merkle_root(const uint8_t* leaves, size_t n, uint8_t* root) {
  std::vector<uint8_t> level(leaves, leaves + 32 * n);
  size_t m = n;
  while (m > 1) {
    if (m % 2) {  // duplicate last
      level.insert(level.end(), level.end() - 32, level.end());
      m++;
    }
    std::vector<uint8_t> next(32 * (m / 2));
    for (size_t i = 0; i < m; i += 2) {
      const uint8_t* a = level.data() + 32 * i;
      const uint8_t* b = level.data() + 32 * (i + 1);
      const uint8_t *lo = a, *hi = b;
      if (std::memcmp(a, b, 32) > 0) { lo = b; hi = a; }
      Sha256 s;
      s.update(lo, 32);
      s.update(hi, 32);
      s.final(next.data() + 32 * (i / 2));
    }
    level.swap(next);
    m /= 2;
  }
  std::memcpy(root, level.data(), 32);
}

}  // extern "C"
