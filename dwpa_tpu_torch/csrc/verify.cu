// K3: the crack step's verify on Hopper (sm_90a) -- PMKID, EAPOL keyver 1/2
// and keyver 3 (AES-128-CMAC) matches over a batch of PMKs.
//
// Replaces XLA's compiled verify, not a Pallas kernel: the JAX package's
// verify_step (dwpa_tpu/parallel/step.py, jax.jit of shard_map, and the
// rules step that compiles expand -> PBKDF2 -> verify into one program)
// over the three match functions of dwpa_tpu/models/m22000.py:
//   _pmkid_impl       -> verify_pmkid_kernel
//   eapol_match       -> verify_eapol_kernel<1 | 2>
//   eapol_cmac_match  -> verify_cmac_kernel
// Each kernel computes its function bit for bit, including the leading
// net axis and the nonce-correction variant axis, from the int32[8, B] PMK
// matrix and the per-net constants that prep_net builds on the host.
//
// What bounds it: integer issue.  Per (net, column) a kernel reads 32 PMK
// bytes and writes V result bytes, against tens of thousands of 32-bit
// operations: 4 SHA-1 compressions for PMKID; per variant 3 SHA-1 (the
// PRF) + 2 + E + 1 SHA-1 or MD5 (the MIC) for keyver 1/2; per variant
// 3 SHA-256, one AES-128 key schedule and F + 2 AES-128 blocks for
// keyver 3.  The S-box lookups of keyver 3 also load from shared memory.
//
// What the design does about it:
//  - one thread per (net row n, column b), blockIdx.y over nets; the PMK's
//    HMAC pad states are computed once per thread and reused for all V
//    variants of that net;
//  - every state, message schedule and AES round key lives in registers;
//    the per-net constants are warp-uniform loads (one address a warp);
//  - rotates are funnel shifts; compressions and AES rounds are unrolled
//    so padding words and round constants fold into the instructions;
//  - the AES S-box is copied into each block's shared memory once, from a
//    table in this file; AES runs on four big-endian column words;
//  - no early exit on a mismatch: every thread does the same work, and
//    every (n, v, b) byte of the output is written.  Bucket-pad rows
//    compute like any other row; the caller's mask drops them.
//
// Interface: plain C functions (no PyTorch headers), loaded with ctypes by
// dwpa_tpu_torch/ops/verify_cuda.py.  Words are uint32 here and int32
// (same bits) on the torch side; the result is one byte (0/1) per element.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__constant__ uint32_t kSha256K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// T[i] = floor(2**32 * |sin(i + 1)|) (RFC 1321).
__constant__ uint32_t kMd5T[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu, 0xf57c0fafu, 0x4787c62au,
    0xa8304613u, 0xfd469501u, 0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u, 0xf61e2562u, 0xc040b340u,
    0x265e5a51u, 0xe9b6c7aau, 0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu, 0xa9e3e905u, 0xfcefa3f8u,
    0x676f02d9u, 0x8d2a4c8au, 0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u, 0x289b7ec6u, 0xeaa127fau,
    0xd4ef3085u, 0x04881d05u, 0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u, 0x655b59c3u, 0x8f0ccc92u,
    0xffeff47du, 0x85845dd1u, 0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u,
};

// The AES S-box (FIPS-197), the same table as ops/aes.py's SBOX; each
// block of the keyver-3 kernel copies it into shared memory.
__device__ const uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
};

constexpr uint32_t kIpad = 0x36363636u;
constexpr uint32_t kOpad = 0x5C5C5C5Cu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return (x << 24) | ((x & 0xFF00u) << 8) | ((x >> 8) & 0xFF00u) | (x >> 24);
}

// ---------------------------------------------------------------------------
// Compressions.  ``w`` is the 16-word block and is overwritten.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void sha1_compress(uint32_t st[5], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      wt = rotl(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^ w[t & 15], 1);
      w[t & 15] = wt;
    }
    uint32_t f, k;
    if (t < 20) {
      f = d ^ (b & (c ^ d));
      k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (d & (b ^ c));
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    const uint32_t tmp = rotl(a, 5) + f + e + k + wt;
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = tmp;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
}

__device__ __forceinline__ void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                        kSha256K[t] + wt;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

__device__ __forceinline__ int md5_shift(int t) {
  const int j = t & 3;
  switch (t >> 4) {
    case 0:
      return j == 0 ? 7 : j == 1 ? 12 : j == 2 ? 17 : 22;
    case 1:
      return j == 0 ? 5 : j == 1 ? 9 : j == 2 ? 14 : 20;
    case 2:
      return j == 0 ? 4 : j == 1 ? 11 : j == 2 ? 16 : 23;
    default:
      return j == 0 ? 6 : j == 1 ? 10 : j == 2 ? 15 : 21;
  }
}

// MD5 over little-endian words (the host packs keyver 1's blocks so).
__device__ __forceinline__ void md5_compress(uint32_t st[4], const uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t f;
    int g;
    if (t < 16) {
      f = (b & c) | (~b & d);
      g = t;
    } else if (t < 32) {
      f = (d & b) | (~d & c);
      g = (5 * t + 1) & 15;
    } else if (t < 48) {
      f = b ^ c ^ d;
      g = (3 * t + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * t) & 15;
    }
    const uint32_t tmp = d;
    d = c;
    c = b;
    b = b + rotl(a + f + kMd5T[t] + w[g], md5_shift(t));
    a = tmp;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
}

// ---------------------------------------------------------------------------
// HMAC pieces.  Every key here fits one block: its zero-padded 16 words
// give the ipad/opad states, each one compression from the IV.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void sha1_pads(const uint32_t key[16], uint32_t ist[5],
                                          uint32_t ost[5]) {
  uint32_t wi[16], wo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    wi[i] = key[i] ^ kIpad;
    wo[i] = key[i] ^ kOpad;
  }
  const uint32_t iv[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u, 0xC3D2E1F0u};
#pragma unroll
  for (int i = 0; i < 5; ++i) ist[i] = ost[i] = iv[i];
  sha1_compress(ist, wi);
  sha1_compress(ost, wo);
}

__device__ __forceinline__ void sha256_pads(const uint32_t key[16], uint32_t ist[8],
                                            uint32_t ost[8]) {
  uint32_t wi[16], wo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    wi[i] = key[i] ^ kIpad;
    wo[i] = key[i] ^ kOpad;
  }
  const uint32_t iv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                          0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
#pragma unroll
  for (int i = 0; i < 8; ++i) ist[i] = ost[i] = iv[i];
  sha256_compress(ist, wi);
  sha256_compress(ost, wo);
}

__device__ __forceinline__ void md5_pads(const uint32_t key[16], uint32_t ist[4],
                                         uint32_t ost[4]) {
  uint32_t wi[16], wo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    wi[i] = key[i] ^ kIpad;
    wo[i] = key[i] ^ kOpad;
  }
  const uint32_t iv[4] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u};
#pragma unroll
  for (int i = 0; i < 4; ++i) ist[i] = ost[i] = iv[i];
  md5_compress(ist, wi);
  md5_compress(ost, wo);
}

// The outer hash of HMAC-SHA1: ``st`` = the 20-byte inner digest, hashed
// from the opad state (64 + 20 = 84 bytes in all).
__device__ __forceinline__ void sha1_outer(const uint32_t ost[5], const uint32_t st[5],
                                           uint32_t out[5]) {
  uint32_t w[16] = {st[0], st[1], st[2], st[3], st[4], 0x80000000u, 0u, 0u,
                    0u,    0u,    0u,    0u,    0u,    0u,          0u, 84u * 8u};
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i] = ost[i];
  sha1_compress(out, w);
}

// The pre-padded 16-word block at ``src`` (a warp-uniform address).
__device__ __forceinline__ void load_block(const uint32_t* __restrict__ src, uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = src[i];
}

// The 8 PMK words of column ``b`` as a zero-padded HMAC key block.
__device__ __forceinline__ void pmk_key(const uint32_t* __restrict__ pmk, int B, int b,
                                        uint32_t key[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = pmk[static_cast<size_t>(i) * B + b];
#pragma unroll
  for (int i = 8; i < 16; ++i) key[i] = 0u;
}

// HMAC-SHA{1,256} PRF of one variant: two pre-padded blocks after the key.
__device__ __forceinline__ void prf_sha1(const uint32_t ist[5], const uint32_t ost[5],
                                         const uint32_t* __restrict__ blocks, uint32_t out[5]) {
  uint32_t st[5], w[16];
#pragma unroll
  for (int i = 0; i < 5; ++i) st[i] = ist[i];
  load_block(blocks, w);
  sha1_compress(st, w);
  load_block(blocks + 16, w);
  sha1_compress(st, w);
  sha1_outer(ost, st, out);
}

__device__ __forceinline__ void prf_sha256(const uint32_t ist[8], const uint32_t ost[8],
                                           const uint32_t* __restrict__ blocks,
                                           uint32_t out[8]) {
  uint32_t st[8], w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = ist[i];
  load_block(blocks, w);
  sha256_compress(st, w);
  load_block(blocks + 16, w);
  sha256_compress(st, w);
  // outer message: the 32-byte inner digest (64 + 32 = 96 bytes in all)
  uint32_t wo[16] = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                     0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 96u * 8u};
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = ost[i];
  sha256_compress(out, wo);
}

// ---------------------------------------------------------------------------
// AES-128 on four big-endian column words (byte 4c + r of the block is
// byte r, most significant first, of word c), S-box in shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t sub_word(const uint32_t* sbox, uint32_t x) {
  return (sbox[x >> 24] << 24) | (sbox[(x >> 16) & 0xFFu] << 16) |
         (sbox[(x >> 8) & 0xFFu] << 8) | sbox[x & 0xFFu];
}

// xtime of each byte of a word.
__device__ __forceinline__ uint32_t xtime4(uint32_t x) {
  return ((x & 0x7F7F7F7Fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1Bu);
}

__device__ __forceinline__ uint32_t mix_column(uint32_t x) {
  const uint32_t r8 = rotl(x, 8);
  return xtime4(x ^ r8) ^ r8 ^ rotl(x, 16) ^ rotl(x, 24);
}

__device__ __forceinline__ void aes128_expand(const uint32_t* sbox, const uint32_t key[4],
                                              uint32_t rk[44]) {
  const uint32_t rcon[10] = {0x01u, 0x02u, 0x04u, 0x08u, 0x10u,
                             0x20u, 0x40u, 0x80u, 0x1Bu, 0x36u};
#pragma unroll
  for (int i = 0; i < 4; ++i) rk[i] = key[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t t = sub_word(sbox, rotl(rk[4 * r + 3], 8)) ^ (rcon[r] << 24);
    rk[4 * r + 4] = rk[4 * r] ^ t;
    rk[4 * r + 5] = rk[4 * r + 1] ^ rk[4 * r + 4];
    rk[4 * r + 6] = rk[4 * r + 2] ^ rk[4 * r + 5];
    rk[4 * r + 7] = rk[4 * r + 3] ^ rk[4 * r + 6];
  }
}

// s <- AES-128(rk, s).
__device__ __forceinline__ void aes128_encrypt(const uint32_t* sbox, const uint32_t rk[44],
                                               uint32_t s[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] ^= rk[c];
#pragma unroll
  for (int r = 1; r <= 10; ++r) {
    uint32_t t[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // SubBytes + ShiftRows: row i of column c comes from column c + i.
      t[c] = (sbox[s[c] >> 24] << 24) | (sbox[(s[(c + 1) & 3] >> 16) & 0xFFu] << 16) |
             (sbox[(s[(c + 2) & 3] >> 8) & 0xFFu] << 8) | sbox[s[(c + 3) & 3] & 0xFFu];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = (r < 10 ? mix_column(t[c]) : t[c]) ^ rk[4 * r + c];
  }
}

// CMAC's doubling in GF(2^128): shift the 128-bit big-endian value left
// by one, xor 0x87 into the last byte if the top bit fell out.
__device__ __forceinline__ void cmac_dbl(uint32_t s[4]) {
  const uint32_t carry = s[0] >> 31;
  s[0] = (s[0] << 1) | (s[1] >> 31);
  s[1] = (s[1] << 1) | (s[2] >> 31);
  s[2] = (s[2] << 1) | (s[3] >> 31);
  s[3] = (s[3] << 1) ^ (0x87u & (0u - carry));
}

// Four column words from 16 byte values (int32 0..255 each).
__device__ __forceinline__ void pack_bytes(const uint32_t* __restrict__ src, uint32_t w[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    w[c] = (src[4 * c] << 24) | (src[4 * c + 1] << 16) | (src[4 * c + 2] << 8) | src[4 * c + 3];
  }
}

// ---------------------------------------------------------------------------
// Kernels.  Grid: x over columns (kBlock each), y over nets.
// ---------------------------------------------------------------------------

// PMKID: HMAC-SHA1(PMK, msg block)[:4] == target.  out: [N, B].
__global__ void __launch_bounds__(kBlock)
verify_pmkid_kernel(const uint32_t* __restrict__ pmk, int B, const uint32_t* __restrict__ msg,
                    const uint32_t* __restrict__ target, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  const int n = blockIdx.y;
  uint32_t key[16], ist[5], ost[5];
  pmk_key(pmk, B, b, key);
  sha1_pads(key, ist, ost);
  uint32_t st[5], w[16], mac[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) st[i] = ist[i];
  load_block(msg + static_cast<size_t>(n) * 16, w);
  sha1_compress(st, w);
  sha1_outer(ost, st, mac);
  const uint32_t* tg = target + static_cast<size_t>(n) * 4;
  out[static_cast<size_t>(n) * B + b] =
      (mac[0] == tg[0]) & (mac[1] == tg[1]) & (mac[2] == tg[2]) & (mac[3] == tg[3]);
}

// EAPOL keyver 1/2: per variant v, KCK = PRF-SHA1(PMK, prf[n, v])[:4],
// then HMAC-SHA1(KCK) (keyver 2) or HMAC-MD5(bswap32(KCK)) (keyver 1)
// over the E EAPOL blocks; the first 4 MIC words == target.
// prf: [N, V, 2, 16]; eapol: [N, E, 16]; target: [N, 4]; out: [N, V, B].
template <int KEYVER>
__global__ void __launch_bounds__(kBlock)
verify_eapol_kernel(const uint32_t* __restrict__ pmk, int B, const uint32_t* __restrict__ prf,
                    int V, const uint32_t* __restrict__ eapol, int E,
                    const uint32_t* __restrict__ target, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  const int n = blockIdx.y;
  uint32_t key[16], ist[5], ost[5];
  pmk_key(pmk, B, b, key);
  sha1_pads(key, ist, ost);
  const uint32_t* tg = target + static_cast<size_t>(n) * 4;
  const uint32_t t0 = tg[0], t1 = tg[1], t2 = tg[2], t3 = tg[3];
  const uint32_t* eap = eapol + static_cast<size_t>(n) * E * 16;
#pragma unroll 1
  for (int v = 0; v < V; ++v) {
    uint32_t ptk[5];
    prf_sha1(ist, ost, prf + (static_cast<size_t>(n) * V + v) * 32, ptk);
    uint32_t mac[5], w[16];
    if (KEYVER == 1) {
      uint32_t k[16] = {bswap32(ptk[0]), bswap32(ptk[1]), bswap32(ptk[2]), bswap32(ptk[3]),
                        0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      uint32_t ii[4], oo[4];
      md5_pads(k, ii, oo);
#pragma unroll 1
      for (int e = 0; e < E; ++e) {
        load_block(eap + e * 16, w);
        md5_compress(ii, w);
      }
      // outer message: the 16-byte inner digest (64 + 16 = 80 bytes in all)
      const uint32_t wo[16] = {ii[0], ii[1], ii[2], ii[3], 0x80u, 0u, 0u, 0u,
                               0u,    0u,    0u,    0u,    0u,    0u, 80u * 8u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i) mac[i] = oo[i];
      md5_compress(mac, wo);
    } else {
      uint32_t k[16] = {ptk[0], ptk[1], ptk[2], ptk[3], 0u, 0u, 0u, 0u,
                        0u,     0u,     0u,     0u,     0u, 0u, 0u, 0u};
      uint32_t ii[5], oo[5];
      sha1_pads(k, ii, oo);
#pragma unroll 1
      for (int e = 0; e < E; ++e) {
        load_block(eap + e * 16, w);
        sha1_compress(ii, w);
      }
      sha1_outer(oo, ii, mac);
    }
    out[(static_cast<size_t>(n) * V + v) * B + b] =
        (mac[0] == t0) & (mac[1] == t1) & (mac[2] == t2) & (mac[3] == t3);
  }
}

// EAPOL keyver 3: per variant v, KCK = the big-endian bytes of
// PRF-SHA256(PMK, prf[n, v])[:4]; AES-128-CMAC(KCK) over the F full
// blocks and the last block (10*-padded unless ``last_complete``, which
// picks subkey K1 over K2) == the 16 target bytes.
// prf: [N, V, 2, 16]; full: [N, F, 16], last and target: [N, 16] byte
// values; out: [N, V, B].
__global__ void __launch_bounds__(kBlock)
verify_cmac_kernel(const uint32_t* __restrict__ pmk, int B, const uint32_t* __restrict__ prf,
                   int V, const uint32_t* __restrict__ full, int F,
                   const uint32_t* __restrict__ last, int last_complete,
                   const uint32_t* __restrict__ target, uint8_t* __restrict__ out) {
  static_assert(2 * kBlock == 256, "two S-box entries per thread");
  __shared__ uint32_t sbox[256];
  sbox[threadIdx.x] = kSbox[threadIdx.x];
  sbox[threadIdx.x + kBlock] = kSbox[threadIdx.x + kBlock];
  __syncthreads();
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  const int n = blockIdx.y;
  uint32_t key[16], ist[8], ost[8];
  pmk_key(pmk, B, b, key);
  sha256_pads(key, ist, ost);
  uint32_t lastw[4], tg[4];
  pack_bytes(last + static_cast<size_t>(n) * 16, lastw);
  pack_bytes(target + static_cast<size_t>(n) * 16, tg);
  const uint32_t* blocks = full + static_cast<size_t>(n) * F * 16;
#pragma unroll 1
  for (int v = 0; v < V; ++v) {
    uint32_t ptk[8], rk[44];
    prf_sha256(ist, ost, prf + (static_cast<size_t>(n) * V + v) * 32, ptk);
    aes128_expand(sbox, ptk, rk);
    uint32_t sub[4] = {0u, 0u, 0u, 0u};
    aes128_encrypt(sbox, rk, sub);  // L = AES(K, 0)
    cmac_dbl(sub);                  // K1
    if (!last_complete) cmac_dbl(sub);  // K2
    uint32_t c[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
    for (int f = 0; f < F; ++f) {
      uint32_t m[4];
      pack_bytes(blocks + f * 16, m);
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] ^= m[i];
      aes128_encrypt(sbox, rk, c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] ^= lastw[i] ^ sub[i];
    aes128_encrypt(sbox, rk, c);
    out[(static_cast<size_t>(n) * V + v) * B + b] =
        (c[0] == tg[0]) & (c[1] == tg[1]) & (c[2] == tg[2]) & (c[3] == tg[3]);
  }
}

dim3 grid_for(int B, int N) { return dim3((B + kBlock - 1) / kBlock, N); }

}  // namespace

// Each launch function runs on ``stream`` and returns cudaGetLastError()
// after the launch (0 = launched).  pmk: [8, B] words; N nets (<= 65535).

extern "C" int verify_pmkid_launch(const void* pmk, int B, const void* msg, const void* target,
                                   int N, void* out, void* stream) {
  if (B > 0 && N > 0) {
    verify_pmkid_kernel<<<grid_for(B, N), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pmk), B, static_cast<const uint32_t*>(msg),
        static_cast<const uint32_t*>(target), static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int verify_eapol_launch(const void* pmk, int B, const void* prf, int V,
                                   const void* eapol, int E, const void* target, int N,
                                   int keyver, void* out, void* stream) {
  if (keyver != 1 && keyver != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && N > 0 && V > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* p = static_cast<const uint32_t*>(pmk);
    const auto* r = static_cast<const uint32_t*>(prf);
    const auto* e = static_cast<const uint32_t*>(eapol);
    const auto* t = static_cast<const uint32_t*>(target);
    auto* o = static_cast<uint8_t*>(out);
    if (keyver == 1) {
      verify_eapol_kernel<1><<<grid_for(B, N), kBlock, 0, st>>>(p, B, r, V, e, E, t, o);
    } else {
      verify_eapol_kernel<2><<<grid_for(B, N), kBlock, 0, st>>>(p, B, r, V, e, E, t, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int verify_cmac_launch(const void* pmk, int B, const void* prf, int V,
                                  const void* full, int F, const void* last, int last_complete,
                                  const void* target, int N, void* out, void* stream) {
  if (B > 0 && N > 0 && V > 0) {
    verify_cmac_kernel<<<grid_for(B, N), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pmk), B, static_cast<const uint32_t*>(prf), V,
        static_cast<const uint32_t*>(full), F, static_cast<const uint32_t*>(last),
        last_complete, static_cast<const uint32_t*>(target), static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
