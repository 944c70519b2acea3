// PBKDF2-HMAC-SHA1 -> WPA PMK on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dwpa_tpu/ops/pbkdf2_pallas.py
// (pbkdf2_sha1_pmk_pallas, body _loop_kernel) together with the XLA
// prologue in front of it: this kernel computes the whole function,
//   PMK = PBKDF2-HMAC-SHA1(psk, essid, iterations, 32),
// from the column-trimmed key rows to the eight big-endian PMK words.
//
// What bounds it: the SM's ALU pipe, not bytes and not the issue rate.
// One PMK at 4096 iterations is 2 (pad states) + 2 x 2 (U1 of T1, T2) +
// 2 x 2 x 4095 SHA-1 compressions = 16,386, against at most 64 input
// bytes and 32 output bytes per candidate.  Every cycle that matters is
// a 32-bit add, logic op or rotate inside a compression.  ptxas issues
// the logic ops (LOP3), the rotates (SHF, and LEA.HI for rotl(a,5) plus
// an add) and 3-input adds (IADD3) on the ALU pipe, 64 lanes an SM a
// clock, and only 2-input adds (VIADD, IMAD) on the FMA pipe beside it;
// an SM issues 128 thread-instructions a clock in all.  Written plainly,
// 1,928 of the 2,316 SASS instructions of one loop iteration (both
// chains, four compressions; 83.2%) are ALU-pipe opcodes, and the loop
// runs with that pipe about 90% busy at about half the issue rate.
//
// What the design does about it:
//  - one thread per candidate carries both PBKDF2 output blocks (T1, T2):
//    two independent dependency chains for the scheduler to interleave;
//  - the ipad/opad states, both U chains and both accumulators live in
//    registers for all iterations; the only memory traffic is the key row
//    and the salt blocks in, and the PMK out; at most 64 registers, so
//    eight blocks of 128 fit an SM and a 131,072-row batch is one wave;
//  - rotates are funnel shifts (__funnelshift_l, one SHF each);
//  - the 20-byte-message padding words (0x80000000, zeros, the 84-byte
//    length) are compile-time constants in the fully unrolled rounds, so
//    the compiler folds them into the schedule and the round constants;
//  - the zero tail of the HMAC key block is rebuilt here from the trimmed
//    row width W, never padded on the host;
//  - the loop body is half an HMAC iteration: one compression of each
//    chain, from the inner pad state on even halves and from the outer on
//    odd ones (one LOP3 a state word selects it), the accumulators xored
//    on odd halves under the same mask;
//  - each round's sum is split between the pipes: e + (W_t + K) and
//    then + f are IMADs by a multiplier of 1 that arrives as a kernel
//    argument, so ptxas cannot turn them back into IADD3s; LEA.HI still
//    adds rotl(a, 5), and the rotates stay SHFs (rotating with IMAD.HI,
//    which issues at half rate, measured slower).
//
// Measured on an H100 80GB HBM3 at 700 W.  SASS of one loop trip (half
// an iteration, both chains): with every add written plainly, 1,181
// instructions, 982 of them on the ALU pipe (83.2%); as built here,
// 1,313, 846 on the ALU pipe (64.4%) and 460 on the FMA pipe.  Per
// launch of 131,072 / 65,536 / 2,048 rows: 61.1 / 31.8 / 10.1-10.3 ms,
// against 68.3 / 34.7 / 9.5 ms with the plain adds and 68.6 / 35.6 /
// 10.1-10.7 ms for the plain loop written as a whole iteration (2,316
// instructions).  The split loop written as a whole iteration reached
// 64.4 ms at best: there the extra IMADs paid in at most half the
// rounds, and they pay in all of them once the loop is half as long
// (presumably the instruction cache; no profiler on the card can say).
// The IMADs lengthen a round's dependency chain, which a launch of one
// warp an SM sub-partition (2,048 rows) feels: 0.6-0.8 ms of its 10 ms.
//
// Interface: a plain C function (no PyTorch headers), loaded with ctypes
// by dwpa_tpu_torch/ops/pbkdf2_cuda.py.  Words are uint32 here and int32
// (same bits) on the torch side.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// x * one + y as one IMAD: with ``one`` a runtime 1 the sum stays on the
// FMA pipe (a literal 1 would let ptxas emit an ALU-pipe IADD3).
__device__ __forceinline__ uint32_t imad(uint32_t x, uint32_t one, uint32_t y) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(one), "r"(y));
  return d;
}

// One SHA-1 compression of the 16-word block ``w`` into ``st`` (in place).
// ``w`` is the rolling message schedule and is overwritten; ``one`` is 1.
__device__ __forceinline__ void sha1_compress(uint32_t st[5], uint32_t w[16], uint32_t one) {
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
    // e + (W_t + K) is one VIADD where W_t is a constant (sha1_20's
    // padding words), an IMAD elsewhere; + f one more IMAD.
    const uint32_t ewk = t >= 5 && t < 16 ? e + (wt + k) : imad(e, one, wt + k);
    const uint32_t tmp = rotl(a, 5) + imad(f, one, ewk);
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

// out = compression of the 20-byte message ``m`` from ``st`` (a pad state):
// 64 key bytes + 20 message bytes = 84 bytes hashed.
__device__ __forceinline__ void sha1_20(const uint32_t st[5], const uint32_t m[5],
                                        uint32_t out[5], uint32_t one) {
  uint32_t w[16] = {m[0], m[1], m[2], m[3], m[4], 0x80000000u, 0u, 0u,
                    0u,   0u,   0u,   0u,   0u,   0u,          0u, 84u * 8u};
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i] = st[i];
  sha1_compress(out, w, one);
}

// U1 = HMAC-SHA1(key, salt block) for one pre-padded 16-word salt block.
__device__ __forceinline__ void hmac_first(const uint32_t ist[5], const uint32_t ost[5],
                                           const uint32_t* __restrict__ salt,
                                           uint32_t u[5], uint32_t one) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = salt[i];
  uint32_t inner[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) inner[i] = ist[i];
  sha1_compress(inner, w, one);
  sha1_20(ost, inner, u, one);
}

__global__ void __launch_bounds__(kBlock, 8)
pbkdf2_sha1_pmk_kernel(const uint32_t* __restrict__ pw, int W,
                       const uint32_t* __restrict__ salt1,
                       const uint32_t* __restrict__ salt2, int salt_stride,
                       int iterations, uint32_t* __restrict__ out, int B, uint32_t one) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;

  // Pad states of the HMAC key (the zero-padded 64-byte key block).
  uint32_t ipad[16], opad[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t k = i < W ? pw[static_cast<size_t>(b) * W + i] : 0u;
    ipad[i] = k ^ 0x36363636u;
    opad[i] = k ^ 0x5C5C5C5Cu;
  }
  uint32_t ist[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u, 0xC3D2E1F0u};
  uint32_t ost[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u, 0xC3D2E1F0u};
  sha1_compress(ist, ipad, one);
  sha1_compress(ost, opad, one);

  // First iteration of both output blocks, then the xor chain.
  const size_t soff = static_cast<size_t>(b) * salt_stride;
  uint32_t u1[5], u2[5], acc1[5], acc2[5];
  hmac_first(ist, ost, salt1 + soff, u1, one);
  hmac_first(ist, ost, salt2 + soff, u2, one);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    acc1[i] = u1[i];
    acc2[i] = u2[i];
  }
  // Iterations 2..iterations, a half at a time: u <- SHA-1(ist, u) on
  // even halves, u <- SHA-1(ost, u) and acc ^= u on odd ones.
#pragma unroll 1
  for (uint32_t h = 2; h < 2u * iterations; ++h) {
    const uint32_t outer = 0u - (h & 1u);
    uint32_t st[5], o1[5], o2[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) st[i] = (ist[i] & ~outer) | (ost[i] & outer);
    sha1_20(st, u1, o1, one);
    sha1_20(st, u2, o2, one);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      u1[i] = o1[i];
      u2[i] = o2[i];
      acc1[i] ^= o1[i] & outer;
      acc2[i] ^= o2[i] & outer;
    }
  }

  // PMK = T1 (20 bytes) || T2[:12], as out[word, candidate].
#pragma unroll
  for (int i = 0; i < 5; ++i) out[static_cast<size_t>(i) * B + b] = acc1[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[static_cast<size_t>(5 + i) * B + b] = acc2[i];
}

}  // namespace

// pw: [B, W] words; salt1/salt2: [16] (salt_stride 0) or [B, 16]
// (salt_stride 16); out: [8, B].  Launches on ``stream``; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int pbkdf2_sha1_pmk_launch(const void* pw, int W, const void* salt1,
                                      const void* salt2, int salt_stride, int iterations,
                                      void* out, int B, void* stream) {
  if (B > 0) {
    const int grid = (B + kBlock - 1) / kBlock;
    pbkdf2_sha1_pmk_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pw), W, static_cast<const uint32_t*>(salt1),
        static_cast<const uint32_t*>(salt2), salt_stride, iterations,
        static_cast<uint32_t*>(out), B, 1u);
  }
  return static_cast<int>(cudaGetLastError());
}
