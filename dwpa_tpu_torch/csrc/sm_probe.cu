// SM integer-throughput probe on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dwpa_tpu/ops/vpu_probe.py (_probe, body
// _probe_kernel): each element carries 5 uint32 words through
// iters x kUnroll applications of one op mix and writes the xor of the 5.
// The mixes are the JAX bodies (vpu_probe.py MIXES): add and xor (5 ops a
// step), rotl (5 rotates = 15 logical ops; here each is one funnel shift,
// which is the point of that mix on this card) and sha1_round (one SHA-1
// Ch round, 12 logical ops).  ops/sm_probe.py times it and turns the
// rates into the PMK/s ceiling and K1's measured bound.
//
// What bounds it: integer issue, by design.  One thread per element keeps
// the 5 words in registers for the whole run; the only memory traffic is
// 20 bytes in and 4 out per thread.  The work is a dependent chain per
// word, so the SM needs enough resident warps to hide each instruction's
// latency; ops/sm_probe.py sweeps the resident threads per SM.
//
// What the design does about the compiler:
//  - iters is a runtime argument and the outer loop is not unrolled, so
//    the trip count cannot be folded; the kUnroll steps inside are
//    unrolled, so loop bookkeeping is a few instructions per 64 steps;
//  - add, xor and rotl are linear, so a chain of them can be collapsed
//    algebraically ((a^b)^(b^c) = a^c; 64 rotates by n are one by 64n).
//    After every step each word passes through an empty asm with a "+r"
//    constraint: it emits no instruction but hides the value from the
//    compiler's algebra, so every step is computed.  ops/sm_probe.py still
//    reads each mix's loop from the SASS and reports a mix as folded if a
//    step takes fewer instructions than it must;
//  - all 5 words reach the output, so no chain is dead code.
//
// Interface: a plain C function (no PyTorch headers), loaded with ctypes
// by dwpa_tpu_torch/ops/sm_probe.py.  Words are uint32 here and int32
// (same bits) on the torch side.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kUnroll = 64;
constexpr int kMaxThreadsPerSm = 2048;
constexpr uint32_t kK0 = 0x5A827999u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// No instruction; the compiler may no longer reason about the words'
// values across this point.
__device__ __forceinline__ void opaque(uint32_t s[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) asm volatile("" : "+r"(s[i]));
}

struct MixAdd {
  __device__ __forceinline__ static void step(uint32_t s[5]) {
    const uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4];
    s[0] = a + b;
    s[1] = b + c;
    s[2] = c + d;
    s[3] = d + e;
    s[4] = e + a;
  }
};

struct MixXor {
  __device__ __forceinline__ static void step(uint32_t s[5]) {
    const uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4];
    s[0] = a ^ b;
    s[1] = b ^ c;
    s[2] = c ^ d;
    s[3] = d ^ e;
    s[4] = e ^ a;
  }
};

struct MixRotl {
  __device__ __forceinline__ static void step(uint32_t s[5]) {
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = rotl(s[i], 5 + i);
  }
};

struct MixSha1Round {
  __device__ __forceinline__ static void step(uint32_t s[5]) {
    const uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4];
    const uint32_t f = d ^ (b & (c ^ d));
    s[0] = rotl(a, 5) + f + e + kK0;
    s[1] = a;
    s[2] = rotl(b, 30);
    s[3] = c;
    s[4] = d;
  }
};

template <class Mix>
__device__ __forceinline__ void probe(const uint32_t* __restrict__ x,
                                      uint32_t* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  uint32_t s[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) s[k] = x[static_cast<size_t>(k) * n + i];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Mix::step(s);
      opaque(s);
    }
  }
  out[i] = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4];
}

}  // namespace

// One kernel per mix, with unmangled names, so the SASS of each mix's
// loop can be read on its own.  The launch bounds keep every kernel under
// 32 registers, so 2048 threads fit on one SM.
#define SM_PROBE_KERNEL(name, Mix)                                                  \
  extern "C" __global__ void __launch_bounds__(kBlock, kMaxThreadsPerSm / kBlock) \
  name(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n, int iters) { \
    probe<Mix>(x, out, n, iters);                                                   \
  }

SM_PROBE_KERNEL(sm_probe_add, MixAdd)
SM_PROBE_KERNEL(sm_probe_xor, MixXor)
SM_PROBE_KERNEL(sm_probe_rotl, MixRotl)
SM_PROBE_KERNEL(sm_probe_sha1_round, MixSha1Round)

// x: [5, n] words; out: [n].  mix: 0 add, 1 xor, 2 rotl, 3 sha1_round.
// Launches on ``stream``; returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for an unknown mix.
extern "C" int sm_probe_launch(int mix, const void* x, void* out, int n, int iters,
                               void* stream) {
  if (mix < 0 || mix >= 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const auto* in = static_cast<const uint32_t*>(x);
    auto* o = static_cast<uint32_t*>(out);
    const int grid = (n + kBlock - 1) / kBlock;
    const auto st = static_cast<cudaStream_t>(stream);
    switch (mix) {
      case 0: sm_probe_add<<<grid, kBlock, 0, st>>>(in, o, n, iters); break;
      case 1: sm_probe_xor<<<grid, kBlock, 0, st>>>(in, o, n, iters); break;
      case 2: sm_probe_rotl<<<grid, kBlock, 0, st>>>(in, o, n, iters); break;
      default: sm_probe_sha1_round<<<grid, kBlock, 0, st>>>(in, o, n, iters); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
