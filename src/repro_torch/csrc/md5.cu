// MD5 key search for Hopper (sm_90a): the smallest key i in [0, n) whose
// digest of the 8-byte message (i, i ^ 0x9E3779B9) equals a target, or n.
//
// Replaces the TPU kernel `_md5_kernel` / `md5_search_pallas` in
// src/repro/kernels/md5/kernel.py, which runs the 64 rounds lane-wise on a
// block of keys per grid step, writes one minimum per block, and leaves the
// minimum over blocks to the caller.
//
// On an H100 the search is bound by integer instructions: it reads nothing
// but the target and writes one int.  A round is a 3-input logic function
// (LOP3), a + f + K + m (IADD3, K + m folded where m is constant) and
// b + rotl(sum, s) (LEA.HI, a funnel shift and add in one): all three issue
// on the ALU pipe, 16 lanes a scheduler, half the issue rate.  Two routes,
// both a fixed grid of blocks that walks the keys (grid-stride, one key a
// thread at a time), the rounds written out in RFC 1321's order (the
// listing below) with the round constants as immediates and the constant
// message words (padding, length, zeros) folded by the compiler.  Each
// thread keeps its smallest hit, a warp takes the minimum of its lanes by
// shuffles, and only a warp that found a key issues one atomicMin on the
// result, which the wrapper sets to n before the launch.
//
// Route "fma" (the first kernel) hashes all 64 rounds of every key and
// compares the digest.
//
// Route "unwind": rounds 57-64 add only constant message words (m[8],
// m[15], m[6], m[13], m[4], m[11], m[2] = 0x80, m[9]), so the wrapper undoes
// them from the target once a call on the host (`md5_unwind` in
// kernels/md5/ref.py), which gives the state after round 56.  Round 56
// adds the key's second word w1: b after round 56 = c + rotl(b52 + f + K +
// w1, s) with b52, b after round 52, the only unknown, so b52 + w1 must
// equal a word T of the call.  Each key runs rounds 1-52 and is rejected
// unless b + w1 == T; a key that passes (in practice only the key sought:
// a chance of 2^-32 for any other) runs rounds 1-56 again and compares all
// four words.  That is 52 rounds a key, not 64.  The ALU pipe (16 lanes a
// scheduler) runs LOP3, IADD3 and LEA.HI; the route writes each round's
// adds a + K + m and + f as multiply-adds by a 1 the compiler cannot fold
// (`one`, a kernel argument), IMAD on the FMA pipe, so a round is two ALU
// and two FMA instructions, and takes two keys a thread in step, so that
// each round has two independent chains in flight.  Of the forms
// tools/cuda_core_probe.py times (the adds on either pipe, the rotate-add
// as IMAD.HI + IMAD, one, two or four keys a thread), this one was the
// fastest on an H100 (9.47-9.52 ms at n = 2^30, against 10.44-10.55 for
// one key a thread with either adds, and 13.0 for route "fma").

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kKeyXor = 0x9E3779B9u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int s) {
  return __funnelshift_l(x, x, s);
}

#define MD5_F(b, c, d) (((b) & (c)) | (~(b) & (d)))
#define MD5_G(b, c, d) (((d) & (b)) | (~(d) & (c)))
#define MD5_H(b, c, d) ((b) ^ (c) ^ (d))
#define MD5_I(b, c, d) ((c) ^ ((b) | ~(d)))

// RFC 1321's 64 rounds in order, each STEP(function, a, b, c, d, message
// word, constant, shift): a = b + rotl(a + f(b, c, d) + constant +
// m[word], shift).  Each round names the four registers in the order
// (d, a, b, c) of the round before.  Route "fma" runs the three parts in
// turn; route "unwind" runs the first for every key and the second for a
// key that passes its test, and undoes the third on the host.
#define MD5_ROUNDS_1_TO_52(STEP) \
  STEP(MD5_F, a, b, c, d, 0, 0xd76aa478u, 7) \
  STEP(MD5_F, d, a, b, c, 1, 0xe8c7b756u, 12) \
  STEP(MD5_F, c, d, a, b, 2, 0x242070dbu, 17) \
  STEP(MD5_F, b, c, d, a, 3, 0xc1bdceeeu, 22) \
  STEP(MD5_F, a, b, c, d, 4, 0xf57c0fafu, 7) \
  STEP(MD5_F, d, a, b, c, 5, 0x4787c62au, 12) \
  STEP(MD5_F, c, d, a, b, 6, 0xa8304613u, 17) \
  STEP(MD5_F, b, c, d, a, 7, 0xfd469501u, 22) \
  STEP(MD5_F, a, b, c, d, 8, 0x698098d8u, 7) \
  STEP(MD5_F, d, a, b, c, 9, 0x8b44f7afu, 12) \
  STEP(MD5_F, c, d, a, b, 10, 0xffff5bb1u, 17) \
  STEP(MD5_F, b, c, d, a, 11, 0x895cd7beu, 22) \
  STEP(MD5_F, a, b, c, d, 12, 0x6b901122u, 7) \
  STEP(MD5_F, d, a, b, c, 13, 0xfd987193u, 12) \
  STEP(MD5_F, c, d, a, b, 14, 0xa679438eu, 17) \
  STEP(MD5_F, b, c, d, a, 15, 0x49b40821u, 22) \
  STEP(MD5_G, a, b, c, d, 1, 0xf61e2562u, 5) \
  STEP(MD5_G, d, a, b, c, 6, 0xc040b340u, 9) \
  STEP(MD5_G, c, d, a, b, 11, 0x265e5a51u, 14) \
  STEP(MD5_G, b, c, d, a, 0, 0xe9b6c7aau, 20) \
  STEP(MD5_G, a, b, c, d, 5, 0xd62f105du, 5) \
  STEP(MD5_G, d, a, b, c, 10, 0x02441453u, 9) \
  STEP(MD5_G, c, d, a, b, 15, 0xd8a1e681u, 14) \
  STEP(MD5_G, b, c, d, a, 4, 0xe7d3fbc8u, 20) \
  STEP(MD5_G, a, b, c, d, 9, 0x21e1cde6u, 5) \
  STEP(MD5_G, d, a, b, c, 14, 0xc33707d6u, 9) \
  STEP(MD5_G, c, d, a, b, 3, 0xf4d50d87u, 14) \
  STEP(MD5_G, b, c, d, a, 8, 0x455a14edu, 20) \
  STEP(MD5_G, a, b, c, d, 13, 0xa9e3e905u, 5) \
  STEP(MD5_G, d, a, b, c, 2, 0xfcefa3f8u, 9) \
  STEP(MD5_G, c, d, a, b, 7, 0x676f02d9u, 14) \
  STEP(MD5_G, b, c, d, a, 12, 0x8d2a4c8au, 20) \
  STEP(MD5_H, a, b, c, d, 5, 0xfffa3942u, 4) \
  STEP(MD5_H, d, a, b, c, 8, 0x8771f681u, 11) \
  STEP(MD5_H, c, d, a, b, 11, 0x6d9d6122u, 16) \
  STEP(MD5_H, b, c, d, a, 14, 0xfde5380cu, 23) \
  STEP(MD5_H, a, b, c, d, 1, 0xa4beea44u, 4) \
  STEP(MD5_H, d, a, b, c, 4, 0x4bdecfa9u, 11) \
  STEP(MD5_H, c, d, a, b, 7, 0xf6bb4b60u, 16) \
  STEP(MD5_H, b, c, d, a, 10, 0xbebfbc70u, 23) \
  STEP(MD5_H, a, b, c, d, 13, 0x289b7ec6u, 4) \
  STEP(MD5_H, d, a, b, c, 0, 0xeaa127fau, 11) \
  STEP(MD5_H, c, d, a, b, 3, 0xd4ef3085u, 16) \
  STEP(MD5_H, b, c, d, a, 6, 0x04881d05u, 23) \
  STEP(MD5_H, a, b, c, d, 9, 0xd9d4d039u, 4) \
  STEP(MD5_H, d, a, b, c, 12, 0xe6db99e5u, 11) \
  STEP(MD5_H, c, d, a, b, 15, 0x1fa27cf8u, 16) \
  STEP(MD5_H, b, c, d, a, 2, 0xc4ac5665u, 23) \
  STEP(MD5_I, a, b, c, d, 0, 0xf4292244u, 6) \
  STEP(MD5_I, d, a, b, c, 7, 0x432aff97u, 10) \
  STEP(MD5_I, c, d, a, b, 14, 0xab9423a7u, 15) \
  STEP(MD5_I, b, c, d, a, 5, 0xfc93a039u, 21)
#define MD5_ROUNDS_53_TO_56(STEP) \
  STEP(MD5_I, a, b, c, d, 12, 0x655b59c3u, 6) \
  STEP(MD5_I, d, a, b, c, 3, 0x8f0ccc92u, 10) \
  STEP(MD5_I, c, d, a, b, 10, 0xffeff47du, 15) \
  STEP(MD5_I, b, c, d, a, 1, 0x85845dd1u, 21)
#define MD5_ROUNDS_57_TO_64(STEP) \
  STEP(MD5_I, a, b, c, d, 8, 0x6fa87e4fu, 6) \
  STEP(MD5_I, d, a, b, c, 15, 0xfe2ce6e0u, 10) \
  STEP(MD5_I, c, d, a, b, 6, 0xa3014314u, 15) \
  STEP(MD5_I, b, c, d, a, 13, 0x4e0811a1u, 21) \
  STEP(MD5_I, a, b, c, d, 4, 0xf7537e82u, 6) \
  STEP(MD5_I, d, a, b, c, 11, 0xbd3af235u, 10) \
  STEP(MD5_I, c, d, a, b, 2, 0x2ad7d2bbu, 15) \
  STEP(MD5_I, b, c, d, a, 9, 0xeb86d391u, 21)

// Route "fma"'s round.
#define MD5_STEP(f, a, b, c, d, g, k, s) \
  a = (b) + rotl((a) + f((b), (c), (d)) + (k) + m[g], (s));

__device__ __forceinline__ uint4 md5_u32x2(uint32_t w0, uint32_t w1) {
  const uint32_t m[16] = {w0, w1, 0x80u, 0u, 0u, 0u, 0u, 0u,
                          0u, 0u, 0u, 0u, 0u, 0u, 64u, 0u};
  uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu,
           d = 0x10325476u;
  MD5_ROUNDS_1_TO_52(MD5_STEP)
  MD5_ROUNDS_53_TO_56(MD5_STEP)
  MD5_ROUNDS_57_TO_64(MD5_STEP)
  return make_uint4(a + 0x67452301u, b + 0xefcdab89u, c + 0x98badcfeu,
                    d + 0x10325476u);
}

__global__ void __launch_bounds__(kThreads)
md5_search_kernel(uint32_t n, uint32_t t0, uint32_t t1, uint32_t t2,
                  uint32_t t3, int* __restrict__ found) {
  // n < 2^31 and the stride is below 2^31, so i + stride never wraps.
  const uint32_t stride = gridDim.x * kThreads;
  int best = static_cast<int>(n);
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const uint4 h = md5_u32x2(i, i ^ kKeyXor);
    if (h.x == t0 && h.y == t1 && h.z == t2 && h.w == t3) {
      best = min(best, static_cast<int>(i));
    }
  }
  // Every lane of the warp reaches the shuffles.
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    best = min(best, __shfl_xor_sync(0xffffffffu, best, offset));
  }
  if ((threadIdx.x & 31) == 0 && best < static_cast<int>(n)) {
    atomicMin(found, best);
  }
}

// How route "unwind"'s rounds add: kAddsOnAlu as route "fma" (IADD3 on the
// ALU pipe); kAddsOnFma a + K + m and then + f as two multiply-adds by
// `one` (IMAD on the FMA pipe), leaving each round two ALU instructions
// (LOP3, LEA.HI) and two FMA ones; kRotateOnFma the add as route "fma" and
// b + rotl(sum, s) as a multiply-add of the high word (IMAD.HI: sum >>
// (32 - s), plus b) and of the low word (IMAD: sum << s, plus that).
enum UnwindMode { kAddsOnAlu = 0, kAddsOnFma = 1, kRotateOnFma = 2 };

__device__ __forceinline__ uint32_t mad_lo(uint32_t x, uint32_t y,
                                           uint32_t z) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(z));
  return r;
}

__device__ __forceinline__ uint32_t mad_hi(uint32_t x, uint32_t y,
                                           uint32_t z) {
  uint32_t r;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(z));
  return r;
}

template <int MODE>
__device__ __forceinline__ uint32_t unwind_round(uint32_t a, uint32_t b,
                                                 uint32_t f, uint32_t km,
                                                 int s, uint32_t one) {
  if (MODE == kAddsOnFma) {
    return b + rotl(mad_lo(f, one, mad_lo(a, one, km)), s);
  }
  if (MODE == kRotateOnFma) {
    const uint32_t sum = a + f + km;
    return mad_lo(sum, 1u << s, mad_hi(sum, 1u << s, b));
  }
  return b + rotl(a + f + km, s);
}

// The state after round 56 of one key, by route "fma"'s rounds: route
// "unwind"'s test of a key that passed the test after round 52.
__device__ __noinline__ uint4 md5_state56(uint32_t key) {
  const uint32_t m[16] = {key, key ^ kKeyXor, 0x80u, 0u, 0u, 0u, 0u, 0u,
                          0u, 0u, 0u, 0u, 0u, 0u, 64u, 0u};
  uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu,
           d = 0x10325476u;
  MD5_ROUNDS_1_TO_52(MD5_STEP)
  MD5_ROUNDS_53_TO_56(MD5_STEP)
  return make_uint4(a, b, c, d);
}

// Route "unwind"'s round for each of a thread's KEYS keys in step (their
// registers are arrays), so that a round has KEYS independent chains.
#define MD5_UNWIND_STEP(f, a, b, c, d, g, k, s)                           \
  _Pragma("unroll") for (int j = 0; j < KEYS; ++j) {                     \
    a[j] = unwind_round<MODE>(a[j], b[j], f(b[j], c[j], d[j]),           \
                              (k) + m[j][g], (s), one);                  \
  }

// state: the unwound state after round 56 (a, b, c, d); word1_target: T,
// which b after round 52 plus the key's second word must equal.  A thread
// takes keys i, i + stride, ..., KEYS of them at a time.
template <int MODE, int KEYS>
__global__ void __launch_bounds__(kThreads)
md5_unwind_kernel(uint32_t n, uint4 state, uint32_t word1_target,
                  uint32_t one, int* __restrict__ found) {
  // n < 2^31 and KEYS * stride < 2^31, so no key index wraps.
  const uint32_t stride = gridDim.x * kThreads;
  int best = static_cast<int>(n);
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += KEYS * stride) {
    uint32_t m[KEYS][16], a[KEYS], b[KEYS], c[KEYS], d[KEYS];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const uint32_t key = i + j * stride;
#pragma unroll
      for (int w = 0; w < 16; ++w) m[j][w] = 0u;
      m[j][0] = key;
      m[j][1] = key ^ kKeyXor;
      m[j][2] = 0x80u;
      m[j][14] = 64u;
      a[j] = 0x67452301u;
      b[j] = 0xefcdab89u;
      c[j] = 0x98badcfeu;
      d[j] = 0x10325476u;
    }
    MD5_ROUNDS_1_TO_52(MD5_UNWIND_STEP)
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const uint32_t key = i + j * stride;
      if (key < n && b[j] + m[j][1] == word1_target) {  // b: after round 52
        const uint4 h = md5_state56(key);
        if (h.x == state.x && h.y == state.y && h.z == state.z &&
            h.w == state.w) {
          best = min(best, static_cast<int>(key));
        }
      }
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    best = min(best, __shfl_xor_sync(0xffffffffu, best, offset));
  }
  if ((threadIdx.x & 31) == 0 && best < static_cast<int>(n)) {
    atomicMin(found, best);
  }
}

#undef MD5_UNWIND_STEP
#undef MD5_STEP

//: route "unwind"'s form in the package's library: its adds as IMAD, two
//: keys a thread (the fastest of tools/cuda_core_probe.py's variants)
constexpr int kUnwindMode = kAddsOnFma;
constexpr int kUnwindKeys = 2;

template <int MODE, int KEYS>
int launch_unwind(uint32_t n, uint4 state, uint32_t word1_target,
                  int* found, int grid, cudaStream_t s) {
  md5_unwind_kernel<MODE, KEYS><<<grid, kThreads, 0, s>>>(
      n, state, word1_target, 1u, found);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route "fma".  found: one int32 the caller has set to n; 1 <= n < 2^31.
// Returns cudaGetLastError().
extern "C" int md5_search_u32(uint32_t n, uint32_t t0, uint32_t t1,
                              uint32_t t2, uint32_t t3, void* found, int grid,
                              void* stream) {
  md5_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, t0, t1, t2, t3, static_cast<int*>(found));
  return static_cast<int>(cudaGetLastError());
}

// Route "unwind".  s0-s3: the state after round 56 that the target
// unwinds to; word1_target: T (see the top of the file); found as above.
extern "C" int md5_unwind_u32(uint32_t n, uint32_t s0, uint32_t s1,
                              uint32_t s2, uint32_t s3, uint32_t word1_target,
                              void* found, int grid, void* stream) {
  return launch_unwind<kUnwindMode, kUnwindKeys>(
      n, make_uint4(s0, s1, s2, s3), word1_target, static_cast<int*>(found),
      grid, static_cast<cudaStream_t>(stream));
}

#ifdef MD5_PROBE
// Route "unwind" with its rounds in any of the three forms (mode: an
// UnwindMode) and 1, 2 or 4 keys a thread (keys), for
// tools/cuda_core_probe.py's comparison.
extern "C" int md5_unwind_probe_u32(uint32_t n, uint32_t s0, uint32_t s1,
                                    uint32_t s2, uint32_t s3,
                                    uint32_t word1_target, void* found,
                                    int grid, int mode, int keys,
                                    void* stream) {
  const uint4 state = make_uint4(s0, s1, s2, s3);
  auto* f = static_cast<int*>(found);
  auto s = static_cast<cudaStream_t>(stream);
#define MD5_PROBE_CASE(M, K)                                               \
  if (mode == M && keys == K) {                                            \
    return launch_unwind<M, K>(n, state, word1_target, f, grid, s);        \
  }
  MD5_PROBE_CASE(kAddsOnAlu, 1)
  MD5_PROBE_CASE(kAddsOnAlu, 2)
  MD5_PROBE_CASE(kAddsOnAlu, 4)
  MD5_PROBE_CASE(kAddsOnFma, 1)
  MD5_PROBE_CASE(kAddsOnFma, 2)
  MD5_PROBE_CASE(kAddsOnFma, 4)
  MD5_PROBE_CASE(kRotateOnFma, 1)
  MD5_PROBE_CASE(kRotateOnFma, 2)
#undef MD5_PROBE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // MD5_PROBE
