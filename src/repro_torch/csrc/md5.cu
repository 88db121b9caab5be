// MD5 key search for Hopper (sm_90a): the smallest key i in [0, n) whose
// digest of the 8-byte message (i, i ^ 0x9E3779B9) equals a target, or n.
//
// Replaces the TPU kernel `_md5_kernel` / `md5_search_pallas` in
// src/repro/kernels/md5/kernel.py, which runs the 64 rounds lane-wise on a
// block of keys per grid step, writes one minimum per block, and leaves the
// minimum over blocks to the caller.
//
// On an H100 the search is bound by integer operations: it reads nothing
// but the 16-byte target and writes one int.  Design: a fixed grid of blocks
// walks the keys (grid-stride, one key per thread at a time), the 64 rounds
// written out in RFC 1321's order with the round constants as immediates and
// the message words that are constant (padding, length, zeros) folded by the
// compiler; rotates are one funnel shift each.  Each thread keeps its
// smallest hit, a warp takes the minimum of its lanes by shuffles, and only a
// warp that found a key issues one atomicMin on the result, which the
// wrapper sets to n before the launch.

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
// One round: a = b + rotl(a + f(b, c, d) + k + m, s).  The next round names
// the same four registers in the order (d, a, b, c).
#define MD5_STEP(f, a, b, c, d, m, k, s) \
  a = (b) + rotl((a) + f((b), (c), (d)) + (k) + (m), (s))

__device__ __forceinline__ uint4 md5_u32x2(uint32_t w0, uint32_t w1) {
  const uint32_t m[16] = {w0, w1, 0x80u, 0u, 0u, 0u, 0u, 0u,
                          0u, 0u, 0u, 0u, 0u, 0u, 64u, 0u};
  uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu,
           d = 0x10325476u;

  MD5_STEP(MD5_F, a, b, c, d, m[0], 0xd76aa478u, 7);
  MD5_STEP(MD5_F, d, a, b, c, m[1], 0xe8c7b756u, 12);
  MD5_STEP(MD5_F, c, d, a, b, m[2], 0x242070dbu, 17);
  MD5_STEP(MD5_F, b, c, d, a, m[3], 0xc1bdceeeu, 22);
  MD5_STEP(MD5_F, a, b, c, d, m[4], 0xf57c0fafu, 7);
  MD5_STEP(MD5_F, d, a, b, c, m[5], 0x4787c62au, 12);
  MD5_STEP(MD5_F, c, d, a, b, m[6], 0xa8304613u, 17);
  MD5_STEP(MD5_F, b, c, d, a, m[7], 0xfd469501u, 22);
  MD5_STEP(MD5_F, a, b, c, d, m[8], 0x698098d8u, 7);
  MD5_STEP(MD5_F, d, a, b, c, m[9], 0x8b44f7afu, 12);
  MD5_STEP(MD5_F, c, d, a, b, m[10], 0xffff5bb1u, 17);
  MD5_STEP(MD5_F, b, c, d, a, m[11], 0x895cd7beu, 22);
  MD5_STEP(MD5_F, a, b, c, d, m[12], 0x6b901122u, 7);
  MD5_STEP(MD5_F, d, a, b, c, m[13], 0xfd987193u, 12);
  MD5_STEP(MD5_F, c, d, a, b, m[14], 0xa679438eu, 17);
  MD5_STEP(MD5_F, b, c, d, a, m[15], 0x49b40821u, 22);

  MD5_STEP(MD5_G, a, b, c, d, m[1], 0xf61e2562u, 5);
  MD5_STEP(MD5_G, d, a, b, c, m[6], 0xc040b340u, 9);
  MD5_STEP(MD5_G, c, d, a, b, m[11], 0x265e5a51u, 14);
  MD5_STEP(MD5_G, b, c, d, a, m[0], 0xe9b6c7aau, 20);
  MD5_STEP(MD5_G, a, b, c, d, m[5], 0xd62f105du, 5);
  MD5_STEP(MD5_G, d, a, b, c, m[10], 0x02441453u, 9);
  MD5_STEP(MD5_G, c, d, a, b, m[15], 0xd8a1e681u, 14);
  MD5_STEP(MD5_G, b, c, d, a, m[4], 0xe7d3fbc8u, 20);
  MD5_STEP(MD5_G, a, b, c, d, m[9], 0x21e1cde6u, 5);
  MD5_STEP(MD5_G, d, a, b, c, m[14], 0xc33707d6u, 9);
  MD5_STEP(MD5_G, c, d, a, b, m[3], 0xf4d50d87u, 14);
  MD5_STEP(MD5_G, b, c, d, a, m[8], 0x455a14edu, 20);
  MD5_STEP(MD5_G, a, b, c, d, m[13], 0xa9e3e905u, 5);
  MD5_STEP(MD5_G, d, a, b, c, m[2], 0xfcefa3f8u, 9);
  MD5_STEP(MD5_G, c, d, a, b, m[7], 0x676f02d9u, 14);
  MD5_STEP(MD5_G, b, c, d, a, m[12], 0x8d2a4c8au, 20);

  MD5_STEP(MD5_H, a, b, c, d, m[5], 0xfffa3942u, 4);
  MD5_STEP(MD5_H, d, a, b, c, m[8], 0x8771f681u, 11);
  MD5_STEP(MD5_H, c, d, a, b, m[11], 0x6d9d6122u, 16);
  MD5_STEP(MD5_H, b, c, d, a, m[14], 0xfde5380cu, 23);
  MD5_STEP(MD5_H, a, b, c, d, m[1], 0xa4beea44u, 4);
  MD5_STEP(MD5_H, d, a, b, c, m[4], 0x4bdecfa9u, 11);
  MD5_STEP(MD5_H, c, d, a, b, m[7], 0xf6bb4b60u, 16);
  MD5_STEP(MD5_H, b, c, d, a, m[10], 0xbebfbc70u, 23);
  MD5_STEP(MD5_H, a, b, c, d, m[13], 0x289b7ec6u, 4);
  MD5_STEP(MD5_H, d, a, b, c, m[0], 0xeaa127fau, 11);
  MD5_STEP(MD5_H, c, d, a, b, m[3], 0xd4ef3085u, 16);
  MD5_STEP(MD5_H, b, c, d, a, m[6], 0x04881d05u, 23);
  MD5_STEP(MD5_H, a, b, c, d, m[9], 0xd9d4d039u, 4);
  MD5_STEP(MD5_H, d, a, b, c, m[12], 0xe6db99e5u, 11);
  MD5_STEP(MD5_H, c, d, a, b, m[15], 0x1fa27cf8u, 16);
  MD5_STEP(MD5_H, b, c, d, a, m[2], 0xc4ac5665u, 23);

  MD5_STEP(MD5_I, a, b, c, d, m[0], 0xf4292244u, 6);
  MD5_STEP(MD5_I, d, a, b, c, m[7], 0x432aff97u, 10);
  MD5_STEP(MD5_I, c, d, a, b, m[14], 0xab9423a7u, 15);
  MD5_STEP(MD5_I, b, c, d, a, m[5], 0xfc93a039u, 21);
  MD5_STEP(MD5_I, a, b, c, d, m[12], 0x655b59c3u, 6);
  MD5_STEP(MD5_I, d, a, b, c, m[3], 0x8f0ccc92u, 10);
  MD5_STEP(MD5_I, c, d, a, b, m[10], 0xffeff47du, 15);
  MD5_STEP(MD5_I, b, c, d, a, m[1], 0x85845dd1u, 21);
  MD5_STEP(MD5_I, a, b, c, d, m[8], 0x6fa87e4fu, 6);
  MD5_STEP(MD5_I, d, a, b, c, m[15], 0xfe2ce6e0u, 10);
  MD5_STEP(MD5_I, c, d, a, b, m[6], 0xa3014314u, 15);
  MD5_STEP(MD5_I, b, c, d, a, m[13], 0x4e0811a1u, 21);
  MD5_STEP(MD5_I, a, b, c, d, m[4], 0xf7537e82u, 6);
  MD5_STEP(MD5_I, d, a, b, c, m[11], 0xbd3af235u, 10);
  MD5_STEP(MD5_I, c, d, a, b, m[2], 0x2ad7d2bbu, 15);
  MD5_STEP(MD5_I, b, c, d, a, m[9], 0xeb86d391u, 21);

  return make_uint4(a + 0x67452301u, b + 0xefcdab89u, c + 0x98badcfeu,
                    d + 0x10325476u);
}

#undef MD5_STEP
#undef MD5_I
#undef MD5_H
#undef MD5_G
#undef MD5_F

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

}  // namespace

// found: one int32 the caller has set to n; 1 <= n < 2^31.  Returns
// cudaGetLastError().
extern "C" int md5_search_u32(uint32_t n, uint32_t t0, uint32_t t1,
                              uint32_t t2, uint32_t t3, void* found, int grid,
                              void* stream) {
  md5_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, t0, t1, t2, t3, static_cast<int*>(found));
  return static_cast<int>(cudaGetLastError());
}
