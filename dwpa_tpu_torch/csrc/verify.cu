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
// matrix and per-net constants: prep_net's, and the derived constants
// that ops/verify_prep.py builds once per crack step.
//
// What bounds it: integer issue, and for keyver 3 shared-memory loads.
// Per (net, column) a kernel reads 32 PMK bytes and writes V result bytes
// against thousands to tens of thousands of 32-bit operations: for PMKID 2
// SHA-1 compressions a net (the message block and its outer hash) after 2
// a column (the PMK's pad states); per variant 2 SHA-1 (block 1 of the
// PRF and its outer hash) + 2 + E + 1 SHA-1 or MD5 (the MIC) for keyver
// 1/2; per variant 2 SHA-256, one AES-128 key schedule and F + 2 AES-128
// blocks for keyver 3.  An AES round is 16 table lookups: 1,480 a
// (variant, column) at F = 7, and shared memory serves one warp's 32 lanes
// a clock per SM, a quarter of the issue rate and half the integer pipes'
// rate.  The byte-wise S-box of the first design issued 2.05x the
// instructions keyver 3's function needs (two shifts, a load and an or a
// byte), with bank conflicts on its random lookups.
//
// What the design does about it:
//  - PMKID: one thread per column, the grid over columns.  The PMK's pad
//    states are computed once a column, then a loop over the part's N
//    nets runs each net's inner compression from its W + K schedule and
//    the outer hash: 2 + 2N compressions a column.  The first design ran a
//    thread per (net, column) that repeated the pads and expanded the
//    net's schedule, the same for every column, in every thread: 4N
//    compressions and 2.6x the function's instructions at N = 32.  When
//    the columns alone would leave the card short of blocks (a small
//    batch: ops/verify_cuda.pmkid_nets_per_thread decides from B and the
//    SM count), grid.y splits the nets into groups and each thread
//    computes the pads once for its group's nets, so a small batch with
//    many nets still runs short chains on every SM;
//  - keyver 1/2 and 3: one thread per (net row n, column b), blockIdx.y
//    over nets; the PMK's HMAC pad states are computed once per thread and
//    reused for all V variants of that net;
//  - work that is the same for every column is not done per thread: the
//    message schedules of the constant blocks (PMKID's message blocks,
//    PRF blocks 0 and 1 of every variant, the EAPOL blocks) come
//    precomputed with the round constants folded in, read warp-uniformly
//    as 16-byte loads; PRF block 0 is compressed once per distinct
//    value: once per (net, column) for keyver 3, whose nonce corrections
//    all fall in block 1, and once per run of equal blocks for keyver
//    1/2, whose variants the host orders so that equal blocks 0 are
//    adjacent (``order``, with kNewBlock0 on the first of a run); each
//    result goes to its variant's own row;
//  - AES rounds 1-9 are T-table lookups, out = T0[a0] ^ T1[a1] ^ T2[a2] ^
//    T3[a3] ^ rk: 16 loads and 8 three-input xors a round.  The last
//    round and the key schedule take their S-box bytes out of T0 and T2
//    words, whose bytes hold S[x] at every row but one;
//  - no bank conflicts: each block holds the four tables replicated 32
//    times, T0 and T2 in its first 64 KiB and T1 and T3 in its second,
//    entry x at byte x << 8 with lane l's copy at + 4l (T0, T1) and
//    + 128 + 4l (T2, T3), so lane l reads only bank l; one PRMT builds
//    the address from the state byte and the lane's offset.  128 KiB a
//    block of 512 threads at most 128 registers: one block, 16 warps, an
//    SM.  With two tables (T1 and T3 by a rotate of T0 and T2) a round
//    issues 8 more integer instructions and the integer pipes, not the
//    loads, bound the AES; with four, its 160 loads a block do.
//    chip_smoke.py phase 15 times the kernel at F = 0, 7 and 15 beside
//    the loads' time, which shows the bound;
//  - every state, schedule word of a per-thread block and round key lives
//    in registers; rotates are funnel shifts; rounds are unrolled so
//    constants fold into the instructions;
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

constexpr int kBlock = 128;      // pmkid, eapol
constexpr int kCmacBlock = 512;  // cmac: one 128 KiB table copy serves 512 threads
// order[n, j]: the variant's own index, with this flag on the first of a
// run of variants that share PRF block 0 (ops/verify_prep.NEW_BLOCK0).
constexpr uint32_t kNewBlock0 = 1u << 16;
// The keyver-3 tables in shared memory: 256 entries of 64 words (T0 x 32
// lanes, then T2 x 32 lanes), then 256 of T1 and T3 alike.
constexpr int kTableWords = 2 * 256 * 64;
constexpr int kTable13 = 256 * 64 * 4;  // byte offset of T1 and T3
constexpr int kTableBytes = kTableWords * 4;


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

// The AES T-table T0 (FIPS-197 5.2.1 in big-endian column words):
// T0[x] = (2 S[x], S[x], S[x], 3 S[x]) from row 0 down, S the AES S-box
// of ops/aes.py.  Each block of the keyver-3 kernel spreads it and its
// rotations T1-T3 over shared memory.
__device__ const uint32_t kTe0[256] = {
    0xc66363a5u, 0xf87c7c84u, 0xee777799u, 0xf67b7b8du, 0xfff2f20du, 0xd66b6bbdu,
    0xde6f6fb1u, 0x91c5c554u, 0x60303050u, 0x02010103u, 0xce6767a9u, 0x562b2b7du,
    0xe7fefe19u, 0xb5d7d762u, 0x4dababe6u, 0xec76769au, 0x8fcaca45u, 0x1f82829du,
    0x89c9c940u, 0xfa7d7d87u, 0xeffafa15u, 0xb25959ebu, 0x8e4747c9u, 0xfbf0f00bu,
    0x41adadecu, 0xb3d4d467u, 0x5fa2a2fdu, 0x45afafeau, 0x239c9cbfu, 0x53a4a4f7u,
    0xe4727296u, 0x9bc0c05bu, 0x75b7b7c2u, 0xe1fdfd1cu, 0x3d9393aeu, 0x4c26266au,
    0x6c36365au, 0x7e3f3f41u, 0xf5f7f702u, 0x83cccc4fu, 0x6834345cu, 0x51a5a5f4u,
    0xd1e5e534u, 0xf9f1f108u, 0xe2717193u, 0xabd8d873u, 0x62313153u, 0x2a15153fu,
    0x0804040cu, 0x95c7c752u, 0x46232365u, 0x9dc3c35eu, 0x30181828u, 0x379696a1u,
    0x0a05050fu, 0x2f9a9ab5u, 0x0e070709u, 0x24121236u, 0x1b80809bu, 0xdfe2e23du,
    0xcdebeb26u, 0x4e272769u, 0x7fb2b2cdu, 0xea75759fu, 0x1209091bu, 0x1d83839eu,
    0x582c2c74u, 0x341a1a2eu, 0x361b1b2du, 0xdc6e6eb2u, 0xb45a5aeeu, 0x5ba0a0fbu,
    0xa45252f6u, 0x763b3b4du, 0xb7d6d661u, 0x7db3b3ceu, 0x5229297bu, 0xdde3e33eu,
    0x5e2f2f71u, 0x13848497u, 0xa65353f5u, 0xb9d1d168u, 0x00000000u, 0xc1eded2cu,
    0x40202060u, 0xe3fcfc1fu, 0x79b1b1c8u, 0xb65b5bedu, 0xd46a6abeu, 0x8dcbcb46u,
    0x67bebed9u, 0x7239394bu, 0x944a4adeu, 0x984c4cd4u, 0xb05858e8u, 0x85cfcf4au,
    0xbbd0d06bu, 0xc5efef2au, 0x4faaaae5u, 0xedfbfb16u, 0x864343c5u, 0x9a4d4dd7u,
    0x66333355u, 0x11858594u, 0x8a4545cfu, 0xe9f9f910u, 0x04020206u, 0xfe7f7f81u,
    0xa05050f0u, 0x783c3c44u, 0x259f9fbau, 0x4ba8a8e3u, 0xa25151f3u, 0x5da3a3feu,
    0x804040c0u, 0x058f8f8au, 0x3f9292adu, 0x219d9dbcu, 0x70383848u, 0xf1f5f504u,
    0x63bcbcdfu, 0x77b6b6c1u, 0xafdada75u, 0x42212163u, 0x20101030u, 0xe5ffff1au,
    0xfdf3f30eu, 0xbfd2d26du, 0x81cdcd4cu, 0x180c0c14u, 0x26131335u, 0xc3ecec2fu,
    0xbe5f5fe1u, 0x359797a2u, 0x884444ccu, 0x2e171739u, 0x93c4c457u, 0x55a7a7f2u,
    0xfc7e7e82u, 0x7a3d3d47u, 0xc86464acu, 0xba5d5de7u, 0x3219192bu, 0xe6737395u,
    0xc06060a0u, 0x19818198u, 0x9e4f4fd1u, 0xa3dcdc7fu, 0x44222266u, 0x542a2a7eu,
    0x3b9090abu, 0x0b888883u, 0x8c4646cau, 0xc7eeee29u, 0x6bb8b8d3u, 0x2814143cu,
    0xa7dede79u, 0xbc5e5ee2u, 0x160b0b1du, 0xaddbdb76u, 0xdbe0e03bu, 0x64323256u,
    0x743a3a4eu, 0x140a0a1eu, 0x924949dbu, 0x0c06060au, 0x4824246cu, 0xb85c5ce4u,
    0x9fc2c25du, 0xbdd3d36eu, 0x43acacefu, 0xc46262a6u, 0x399191a8u, 0x319595a4u,
    0xd3e4e437u, 0xf279798bu, 0xd5e7e732u, 0x8bc8c843u, 0x6e373759u, 0xda6d6db7u,
    0x018d8d8cu, 0xb1d5d564u, 0x9c4e4ed2u, 0x49a9a9e0u, 0xd86c6cb4u, 0xac5656fau,
    0xf3f4f407u, 0xcfeaea25u, 0xca6565afu, 0xf47a7a8eu, 0x47aeaee9u, 0x10080818u,
    0x6fbabad5u, 0xf0787888u, 0x4a25256fu, 0x5c2e2e72u, 0x381c1c24u, 0x57a6a6f1u,
    0x73b4b4c7u, 0x97c6c651u, 0xcbe8e823u, 0xa1dddd7cu, 0xe874749cu, 0x3e1f1f21u,
    0x964b4bddu, 0x61bdbddcu, 0x0d8b8b86u, 0x0f8a8a85u, 0xe0707090u, 0x7c3e3e42u,
    0x71b5b5c4u, 0xcc6666aau, 0x904848d8u, 0x06030305u, 0xf7f6f601u, 0x1c0e0e12u,
    0xc26161a3u, 0x6a35355fu, 0xae5757f9u, 0x69b9b9d0u, 0x17868691u, 0x99c1c158u,
    0x3a1d1d27u, 0x279e9eb9u, 0xd9e1e138u, 0xebf8f813u, 0x2b9898b3u, 0x22111133u,
    0xd26969bbu, 0xa9d9d970u, 0x078e8e89u, 0x339494a7u, 0x2d9b9bb6u, 0x3c1e1e22u,
    0x15878792u, 0xc9e9e920u, 0x87cece49u, 0xaa5555ffu, 0x50282878u, 0xa5dfdf7au,
    0x038c8c8fu, 0x59a1a1f8u, 0x09898980u, 0x1a0d0d17u, 0x65bfbfdau, 0xd7e6e631u,
    0x844242c6u, 0xd06868b8u, 0x824141c3u, 0x299999b0u, 0x5a2d2d77u, 0x1e0f0f11u,
    0x7bb0b0cbu, 0xa85454fcu, 0x6dbbbbd6u, 0x2c16163au,
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

// The 8 PMK words of column ``b`` as a zero-padded HMAC key block.
__device__ __forceinline__ void pmk_key(const uint32_t* __restrict__ pmk, int B, int b,
                                        uint32_t key[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) key[i] = pmk[static_cast<size_t>(i) * B + b];
#pragma unroll
  for (int i = 8; i < 16; ++i) key[i] = 0u;
}


// ---------------------------------------------------------------------------
// Compressions over schedules read from memory: ``wk`` is the block's
// whole message schedule with the round constants folded in (SHA-1: 80
// words W[t] + K[t]; SHA-256: 64 words W[t] + K[t]; MD5: 64 words, the
// word round t reads plus T[t]), at a 16-byte aligned, warp-uniform
// address (ops/verify_prep.py).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void sha1_compress_wk(uint32_t st[5], const uint32_t* __restrict__ wk) {
  const uint4* q = reinterpret_cast<const uint4*>(wk);
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4];
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    const uint4 w4 = __ldg(q + i);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * i + j;
      uint32_t f;
      if (t < 20) {
        f = d ^ (b & (c ^ d));
      } else if (t < 40 || t >= 60) {
        f = b ^ c ^ d;
      } else {
        f = (b & c) | (d & (b ^ c));
      }
      const uint32_t tmp = rotl(a, 5) + f + e + w[j];
      e = d;
      d = c;
      c = rotl(b, 30);
      b = a;
      a = tmp;
    }
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
}

__device__ __forceinline__ void sha256_compress_wk(uint32_t st[8],
                                                   const uint32_t* __restrict__ wk) {
  const uint4* q = reinterpret_cast<const uint4*>(wk);
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint4 w4 = __ldg(q + i);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + w[j];
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

__device__ __forceinline__ void md5_compress_wk(uint32_t st[4], const uint32_t* __restrict__ wk) {
  const uint4* q = reinterpret_cast<const uint4*>(wk);
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint4 w4 = __ldg(q + i);
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * i + j;
      uint32_t f;
      if (t < 16) {
        f = (b & c) | (~b & d);
      } else if (t < 32) {
        f = (d & b) | (~d & c);
      } else if (t < 48) {
        f = b ^ c ^ d;
      } else {
        f = c ^ (b | ~d);
      }
      const uint32_t tmp = d;
      d = c;
      c = b;
      b = b + rotl(a + f + w[j], md5_shift(t));
      a = tmp;
    }
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
}

// ---------------------------------------------------------------------------
// AES-128 on four big-endian column words (byte 4c + r of the block is
// byte r, most significant first, of word c) with the T-tables in shared
// memory.  T0[x] = (2S[x], S[x], S[x], 3S[x]) from row 0 down, and Tk =
// rotr(T0, 8k).
// ---------------------------------------------------------------------------

struct TTable {
  const char* base;  // the block's tables (kTableBytes of shared memory)
  uint32_t lane0;    // this lane's copy of T0 (and at kTable13, of T1): 4 x lane
  uint32_t lane2;    // of T2 (T3): 128 + 4 x lane
};

// T0 at byte K of x (K = 0 the least significant), or T2 with ``lane`` =
// lane2, T1 and T3 with ``base`` + kTable13: one PRMT makes the address
// (x's byte K) << 8 | lane.
template <int K>
__device__ __forceinline__ uint32_t tlook(const char* base, uint32_t x, uint32_t lane) {
  return *reinterpret_cast<const uint32_t*>(base + __byte_perm(x, lane, 0x5504u | (K << 4)));
}

// SubWord(RotWord(w)) of the key schedule.
__device__ __forceinline__ uint32_t sub_rot_word(const TTable& t, uint32_t w) {
  return (tlook<2>(t.base, w, t.lane2) & 0xFF000000u) | (tlook<1>(t.base, w, t.lane0) & 0x00FF0000u) |
         (tlook<0>(t.base, w, t.lane0) & 0x0000FF00u) | (tlook<3>(t.base, w, t.lane2) & 0x000000FFu);
}

__device__ __forceinline__ void aes128_expand(const TTable& t, const uint32_t key[4],
                                              uint32_t rk[44]) {
  const uint32_t rcon[10] = {0x01u, 0x02u, 0x04u, 0x08u, 0x10u,
                             0x20u, 0x40u, 0x80u, 0x1Bu, 0x36u};
#pragma unroll
  for (int i = 0; i < 4; ++i) rk[i] = key[i];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    rk[4 * r + 4] = rk[4 * r] ^ sub_rot_word(t, rk[4 * r + 3]) ^ (rcon[r] << 24);
    rk[4 * r + 5] = rk[4 * r + 1] ^ rk[4 * r + 4];
    rk[4 * r + 6] = rk[4 * r + 2] ^ rk[4 * r + 5];
    rk[4 * r + 7] = rk[4 * r + 3] ^ rk[4 * r + 6];
  }
}

// s <- AES-128(rk, s).  Output column c takes row r from column c + r.
__device__ __forceinline__ void aes128_encrypt(const TTable& t, const uint32_t rk[44],
                                               uint32_t s[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] ^= rk[c];
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    uint32_t o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t x = tlook<3>(t.base, s[c], t.lane0) ^
                         tlook<1>(t.base, s[(c + 2) & 3], t.lane2) ^
                         tlook<2>(t.base + kTable13, s[(c + 1) & 3], t.lane0);
      o[c] = x ^ tlook<0>(t.base + kTable13, s[(c + 3) & 3], t.lane2) ^ rk[4 * r + c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = o[c];
  }
  uint32_t o[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[c] = ((tlook<3>(t.base, s[c], t.lane2) & 0xFF000000u) |
            (tlook<2>(t.base, s[(c + 1) & 3], t.lane0) & 0x00FF0000u) |
            (tlook<1>(t.base, s[(c + 2) & 3], t.lane0) & 0x0000FF00u) |
            (tlook<0>(t.base, s[(c + 3) & 3], t.lane2) & 0x000000FFu)) ^
           rk[40 + c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = o[c];
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

// ---------------------------------------------------------------------------
// Kernels.  Grid: x over columns; for eapol and cmac, y over nets.
// ---------------------------------------------------------------------------

// PMKID: HMAC-SHA1(PMK, msg block)[:4] == target, for each of the N nets.
// Grid: x over columns, y over groups of ``per`` nets (one group, all N
// nets, whenever the columns alone fill the card).  A thread computes its
// PMK's pad states once, then runs its group's nets in turn: the inner
// compression from the net's W + K schedule, the outer hash, the
// comparison.  sched: [N, 80]; target: [N, 4]; out: [N, B].
__global__ void __launch_bounds__(kBlock)
verify_pmkid_kernel(const uint32_t* __restrict__ pmk, int B, int N, int per,
                    const uint32_t* __restrict__ sched, const uint32_t* __restrict__ target,
                    uint8_t* __restrict__ out) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  const int n0 = blockIdx.y * per, n1 = min(N, n0 + per);
  uint32_t key[16], ist[5], ost[5];
  pmk_key(pmk, B, b, key);
  sha1_pads(key, ist, ost);
#pragma unroll 1
  for (int n = n0; n < n1; ++n) {
    const uint32_t* tg = target + static_cast<size_t>(n) * 4;
    const uint32_t t0 = __ldg(tg), t1 = __ldg(tg + 1), t2 = __ldg(tg + 2), t3 = __ldg(tg + 3);
    uint32_t st[5], mac[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) st[i] = ist[i];
    sha1_compress_wk(st, sched + static_cast<size_t>(n) * 80);
    sha1_outer(ost, st, mac);
    out[static_cast<size_t>(n) * B + b] =
        (mac[0] == t0) & (mac[1] == t1) & (mac[2] == t2) & (mac[3] == t3);
  }
}

// EAPOL keyver 1/2: per variant v, KCK = PRF-SHA1(PMK, prf[n, v])[:4],
// then HMAC-SHA1(KCK) (keyver 2) or HMAC-MD5(bswap32(KCK)) (keyver 1)
// over the E EAPOL blocks; the first 4 MIC words == target.
// order: [N, V]; prf_sched: [N, V, 2, 80] in visiting order; eapol_sched:
// [N, E, 80] (keyver 2) or [N, E, 64] (keyver 1); target: [N, 4];
// out: [N, V, B].
template <int KEYVER>
__global__ void __launch_bounds__(kBlock)
verify_eapol_kernel(const uint32_t* __restrict__ pmk, int B, int V,
                    const uint32_t* __restrict__ order, const uint32_t* __restrict__ prf_sched,
                    int E, const uint32_t* __restrict__ eapol_sched,
                    const uint32_t* __restrict__ target, uint8_t* __restrict__ out) {
  constexpr int kMicWords = KEYVER == 1 ? 64 : 80;
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  const int n = blockIdx.y;
  uint32_t key[16], ist[5], ost[5];
  pmk_key(pmk, B, b, key);
  sha1_pads(key, ist, ost);
  const uint32_t* tg = target + static_cast<size_t>(n) * 4;
  const uint32_t t0 = tg[0], t1 = tg[1], t2 = tg[2], t3 = tg[3];
  const uint32_t* ord = order + static_cast<size_t>(n) * V;
  const uint32_t* sched = prf_sched + static_cast<size_t>(n) * V * 160;
  const uint32_t* eap = eapol_sched + static_cast<size_t>(n) * E * kMicWords;
  uint8_t* o = out + static_cast<size_t>(n) * V * B + b;
  int j = 0;
#pragma unroll 1
  do {  // one trip per run of variants that share PRF block 0
    uint32_t st0[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) st0[i] = ist[i];
    sha1_compress_wk(st0, sched + static_cast<size_t>(j) * 160);
#pragma unroll 1
    do {  // the run's variants
      uint32_t st[5], ptk[5], mac[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) st[i] = st0[i];
      sha1_compress_wk(st, sched + static_cast<size_t>(j) * 160 + 80);
      sha1_outer(ost, st, ptk);
      if (KEYVER == 1) {
        uint32_t k[16] = {bswap32(ptk[0]), bswap32(ptk[1]), bswap32(ptk[2]), bswap32(ptk[3]),
                          0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        uint32_t ii[4], oo[4];
        md5_pads(k, ii, oo);
#pragma unroll 1
        for (int e = 0; e < E; ++e) md5_compress_wk(ii, eap + e * kMicWords);
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
        for (int e = 0; e < E; ++e) sha1_compress_wk(ii, eap + e * kMicWords);
        sha1_outer(oo, ii, mac);
      }
      o[static_cast<size_t>(ord[j] & (kNewBlock0 - 1u)) * B] =
          (mac[0] == t0) & (mac[1] == t1) & (mac[2] == t2) & (mac[3] == t3);
      ++j;
    } while (j < V && !(ord[j] & kNewBlock0));
  } while (j < V);
}

// EAPOL keyver 3: per variant v, KCK = the big-endian bytes of
// PRF-SHA256(PMK, prf[n, v])[:4]; AES-128-CMAC(KCK) over the F full
// blocks and the last block (10*-padded unless ``last_complete``, which
// picks subkey K1 over K2) == the 16 target bytes.
// prf_sched: [N, 1 + V, 64] (the shared block 0, then each variant's
// block 1); words: [N, F + 2, 4] (the full blocks, the last block, the
// target); out: [N, V, B].  Needs kTableBytes of dynamic shared memory.
__global__ void __launch_bounds__(kCmacBlock, 1)
verify_cmac_kernel(const uint32_t* __restrict__ pmk, int B, int V,
                   const uint32_t* __restrict__ prf_sched, int F,
                   const uint32_t* __restrict__ words, int last_complete,
                   uint8_t* __restrict__ out) {
  extern __shared__ uint32_t ttab[];
  // Word i is a copy of entry (i >> 6) & 255 of T0 rotated right by 16
  // if i & 32 (T2) and by 8 more in the second half (T1, T3).  This
  // thread writes words threadIdx.x + k * kCmacBlock.
  const int rot = (threadIdx.x & 32u) ? 16 : 0;
#pragma unroll
  for (int k = 0; k < kTableWords / kCmacBlock; ++k) {
    const int i = k * kCmacBlock + threadIdx.x;
    const uint32_t w = kTe0[(i >> 6) & 255];
    ttab[i] = rotr(w, rot + (i < kTableWords / 2 ? 0 : 8));
  }
  __syncthreads();
  const int b = blockIdx.x * kCmacBlock + threadIdx.x;
  if (b >= B) return;
  const int n = blockIdx.y;
  const uint32_t lane = (threadIdx.x & 31u) * 4u;
  const TTable t = {reinterpret_cast<const char*>(ttab), lane, 128u + lane};
  uint32_t key[16], ist[8], ost[8];
  pmk_key(pmk, B, b, key);
  sha256_pads(key, ist, ost);
  const uint32_t* sched = prf_sched + static_cast<size_t>(n) * (V + 1) * 64;
  const uint4* cw = reinterpret_cast<const uint4*>(words) + static_cast<size_t>(n) * (F + 2);
  sha256_compress_wk(ist, sched);  // PRF block 0, shared by every variant
  uint8_t* o = out + static_cast<size_t>(n) * V * B + b;
#pragma unroll 1
  for (int v = 0; v < V; ++v) {
    uint32_t ptk[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ptk[i] = ist[i];
    sha256_compress_wk(ptk, sched + (v + 1) * 64);
    // outer message: the 32-byte inner digest (64 + 32 = 96 bytes in all)
    uint32_t wo[16] = {ptk[0], ptk[1], ptk[2], ptk[3], ptk[4], ptk[5], ptk[6], ptk[7],
                       0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 96u * 8u};
#pragma unroll
    for (int i = 0; i < 8; ++i) ptk[i] = ost[i];
    sha256_compress(ptk, wo);
    uint32_t rk[44];
    aes128_expand(t, ptk, rk);
    // Block i of the chain: the first is AES(K, 0) = L, from which the
    // subkey; then the F full blocks and the last one xored into it.
    uint32_t c[4] = {0u, 0u, 0u, 0u}, sub[4];
#pragma unroll 1
    for (int i = 0; i < F + 2; ++i) {
      aes128_encrypt(t, rk, c);
      if (i == 0) {
        cmac_dbl(c);                        // K1
        if (!last_complete) cmac_dbl(c);    // K2
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sub[k] = c[k];
          c[k] = 0u;
        }
      }
      if (i <= F) {
        const uint4 m = __ldg(cw + i);
        c[0] ^= m.x;
        c[1] ^= m.y;
        c[2] ^= m.z;
        c[3] ^= m.w;
        if (i == F) {
#pragma unroll
          for (int k = 0; k < 4; ++k) c[k] ^= sub[k];
        }
      }
    }
    const uint4 tw = __ldg(cw + F + 1);
    o[static_cast<size_t>(v) * B] = (c[0] == tw.x) & (c[1] == tw.y) & (c[2] == tw.z) & (c[3] == tw.w);
  }
}

dim3 grid_for(int B, int N, int block) { return dim3((B + block - 1) / block, N); }

}  // namespace

// Each launch function runs on ``stream`` and returns cudaGetLastError()
// after the launch (0 = launched).  pmk: [8, B] words; N nets (<= 65535).

extern "C" int verify_pmkid_launch(const void* pmk, int B, const void* sched, const void* target,
                                   int N, int per, void* out, void* stream) {
  if (per < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && N > 0) {
    verify_pmkid_kernel<<<grid_for(B, (N + per - 1) / per, kBlock), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pmk), B, N, per, static_cast<const uint32_t*>(sched),
        static_cast<const uint32_t*>(target), static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int verify_eapol_launch(const void* pmk, int B, int V, const void* order,
                                   const void* prf_sched, int E, const void* eapol_sched,
                                   const void* target, int N, int keyver, void* out,
                                   void* stream) {
  if (keyver != 1 && keyver != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && N > 0 && V > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* p = static_cast<const uint32_t*>(pmk);
    const auto* r = static_cast<const uint32_t*>(order);
    const auto* s = static_cast<const uint32_t*>(prf_sched);
    const auto* e = static_cast<const uint32_t*>(eapol_sched);
    const auto* t = static_cast<const uint32_t*>(target);
    auto* o = static_cast<uint8_t*>(out);
    if (keyver == 1) {
      verify_eapol_kernel<1><<<grid_for(B, N, kBlock), kBlock, 0, st>>>(p, B, V, r, s, E, e, t, o);
    } else {
      verify_eapol_kernel<2><<<grid_for(B, N, kBlock), kBlock, 0, st>>>(p, B, V, r, s, E, e, t, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int verify_cmac_launch(const void* pmk, int B, int V, const void* prf_sched, int F,
                                  const void* words, int last_complete, int N, void* out,
                                  void* stream) {
  if (B > 0 && N > 0 && V > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        verify_cmac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    verify_cmac_kernel<<<grid_for(B, N, kCmacBlock), kCmacBlock, kTableBytes,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pmk), B, V, static_cast<const uint32_t*>(prf_sched), F,
        static_cast<const uint32_t*>(words), last_complete, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
