// All-pairs N-Body accelerations for Hopper (sm_90a):
// a_i = sum_j m_j * d_ij / (|d_ij|^2 + eps^2)^(3/2), d_ij = p_j - p_i.
//
// Replaces the TPU kernel `_nbody_kernel` / `nbody_pallas` in
// src/repro/kernels/nbody/kernel.py, which keeps a block of targets in VMEM,
// streams source blocks along a sequential grid axis into a VMEM
// accumulator, and relies on the wrapper's zero-mass padding.
//
// On an H100 the function is bound by operations: n^2 pair interactions of
// 19 flops each (one rsqrt among them) against 16 bytes a body read and 12
// written.  In issue slots, an ordered pair needs at least 13: 3 FADD (the
// differences), 3 FFMA (|d|^2 with eps^2 folded in), 3 FMUL (m r^3), 3 FFMA
// (the sums) and one MUFU.RSQ.
//
// Route "fma", the first kernel (`nbody_kernel`): the classic CUDA design.
// Each thread owns one target and keeps its accumulator in registers; the
// block stages the source bodies through shared memory in float4 tiles of
// kThreads bodies, and every thread runs the unrolled inner loop over the
// tile (one broadcast 16-byte shared load per pair).  The sequential j axis
// of the TPU kernel becomes this loop inside the block.  `rsqrtf` without
// -ftz wraps MUFU.RSQ in a test for a subnormal argument and two scalings,
// 4 of its 18 issue slots a pair.
//
// Route "tile" (`nbody_tile_kernel`), for eps^2 >= FLT_MIN: the same sums
// with fewer issue slots a pair.
// - The rsqrt is `rsqrt.approx.ftz.f32`, MUFU.RSQ alone.  With eps^2 >=
//   FLT_MIN every |d|^2 + eps^2 is a normal float (a sum of non-negative
//   terms, rounded to nearest, is at least its largest term), where the
//   ftz form gives the bits of the guarded one; the wrapper sends eps^2 = 0
//   and a subnormal eps^2 to route "fma".  The rest of the arithmetic stays
//   IEEE (no fast math).
// - eps^2 folded into the first multiply-add of |d|^2, fma(dx, dx, eps^2):
//   one FADD a pair fewer, so 12 FP32 instructions and one MUFU a pair
//   (13.7 issue slots with the shared load and the loop's own, where the
//   first kernel has 18.2: the build phase of chip_smoke.py counts them in
//   the SASS), at the price of other last bits than route "fma"'s.
// - kTileTargets targets a thread (strided by kThreads, so that loads and
//   stores stay coalesced): one shared-memory load of a source feeds that
//   many pairs, which are independent chains for hiding MUFU's and LDS's
//   latency.
// - The sources are split into slices of whole tiles (blockIdx.y), so that
//   the grid fills the card although each block holds more targets.  Each
//   slice writes its own partial (slices x n x 3 floats), and a second pass
//   adds the partials in slice order, so every run gives the same bits.
//   With one slice the kernel writes the result itself; unfolded, each
//   target then sums its j in ascending order with the first kernel's
//   arithmetic and gets route "fma"'s bits (the probe checks it).
//
// In both routes the last source tile, where n is not a multiple of
// kThreads, is filled with zero-mass bodies at the origin in shared memory,
// which add nothing; nothing is padded in device memory, and targets past n
// are masked at the store.
//
// Built with NBODY_PROBE (tools/cuda_core_probe.py builds it so, the
// package does not), the source also holds route "tile" at 1, 2, 4 and 8
// targets a thread, each with and without eps^2 folded into the first
// multiply-add of |d|^2 (which changes the bits against route "fma").

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Route "tile": targets a thread, and whether eps^2 is folded into the
// first FFMA of |d|^2.  tools/cuda_core_probe.py --kernels nbody chose
// them, with eight slices, at n = 2^17 on an H100: the fold took 7 % off
// at every R and S, and 2 targets a thread beat 1, 4 and 8.
constexpr int kTileTargets = 2;
constexpr bool kTileFold = true;

__device__ __forceinline__ float4 body_or_zero(const float4* posm, int j,
                                               int end) {
  return j < end ? posm[j] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(kThreads)
nbody_kernel(const float4* __restrict__ posm, float* __restrict__ acc, int n,
             float softening2) {
  __shared__ float4 tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 me = body_or_zero(posm, i, n);
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < n; base += kThreads) {
    tile[threadIdx.x] = body_or_zero(posm, base + threadIdx.x, n);
    __syncthreads();
#pragma unroll 16
    for (int t = 0; t < kThreads; ++t) {
      const float4 src = tile[t];
      const float dx = src.x - me.x;
      const float dy = src.y - me.y;
      const float dz = src.z - me.z;
      const float dist2 = dx * dx + dy * dy + dz * dz + softening2;
      const float inv = rsqrtf(dist2);
      const float w = src.w * inv * inv * inv;  // m_j / dist^3
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    __syncthreads();
  }
  if (i < n) {
    acc[3 * static_cast<long long>(i)] = ax;
    acc[3 * static_cast<long long>(i) + 1] = ay;
    acc[3 * static_cast<long long>(i) + 2] = az;
  }
}

// MUFU.RSQ with no test around it: exact for normal arguments only.
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Block (x, s): targets [x R kThreads, (x + 1) R kThreads), sources of
// slice s, [s slice_len, min(n, (s + 1) slice_len)), slice_len a multiple
// of kThreads.  `out` is the result (one slice) or the partials, slice s
// at out + s n 3.
template <int R, bool FOLD>
__global__ void __launch_bounds__(kThreads)
nbody_tile_kernel(const float4* __restrict__ posm, float* __restrict__ out,
                  int n, float softening2, int slice_len) {
  __shared__ float4 tile[kThreads];
  const int first = blockIdx.x * R * kThreads + threadIdx.x;
  float mx[R], my[R], mz[R], ax[R], ay[R], az[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 me = body_or_zero(posm, first + r * kThreads, n);
    mx[r] = me.x;
    my[r] = me.y;
    mz[r] = me.z;
    ax[r] = ay[r] = az[r] = 0.f;
  }
  const int begin = blockIdx.y * slice_len;
  const int end = min(n, begin + slice_len);
  for (int base = begin; base < end; base += kThreads) {
    tile[threadIdx.x] = body_or_zero(posm, base + threadIdx.x, end);
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kThreads; ++t) {
      const float4 src = tile[t];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = src.x - mx[r];
        const float dy = src.y - my[r];
        const float dz = src.z - mz[r];
        const float dist2 =
            FOLD ? fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, softening2)))
                 : dx * dx + dy * dy + dz * dz + softening2;
        const float inv = rsqrt_ftz(dist2);
        const float w = src.w * inv * inv * inv;  // m_j / dist^3
        ax[r] += w * dx;
        ay[r] += w * dy;
        az[r] += w * dz;
      }
    }
    __syncthreads();
  }
  float* slice_out = out + blockIdx.y * 3 * static_cast<long long>(n);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = first + r * kThreads;
    if (i < n) {
      slice_out[3 * static_cast<long long>(i)] = ax[r];
      slice_out[3 * static_cast<long long>(i) + 1] = ay[r];
      slice_out[3 * static_cast<long long>(i) + 2] = az[r];
    }
  }
}

// acc[e] = partial[0][e] + partial[1][e] + ..., in slice order.
__global__ void __launch_bounds__(kThreads)
nbody_combine_kernel(const float* __restrict__ partial,
                     float* __restrict__ acc, long long count, int slices) {
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < count; e += static_cast<long long>(gridDim.x) * kThreads) {
    float sum = partial[e];
    for (int s = 1; s < slices; ++s) sum += partial[s * count + e];
    acc[e] = sum;
  }
}

template <int R, bool FOLD>
int launch_tile(const void* posm, void* acc, void* partial, int n,
                float softening2, int slices, int slice_len,
                cudaStream_t stream) {
  const dim3 grid((n + R * kThreads - 1) / (R * kThreads), slices);
  nbody_tile_kernel<R, FOLD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float4*>(posm),
      static_cast<float*>(slices == 1 ? acc : partial), n, softening2,
      slice_len);
  if (slices > 1) {
    const long long count = 3 * static_cast<long long>(n);
    const long long blocks = (count + kThreads - 1) / kThreads;
    nbody_combine_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                           kThreads, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<float*>(acc), count,
        slices);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// posm: (n, 4) f32 xyz + mass, dense and 16-byte aligned; acc: (n, 3) f32.
// Returns cudaGetLastError().
extern "C" int nbody_forces_f32(const void* posm, void* acc, int n,
                                float softening2, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  nbody_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(posm), static_cast<float*>(acc), n,
      softening2);
  return static_cast<int>(cudaGetLastError());
}

// Route "tile".  slices: how many slices of sources (slice_len each, a
// multiple of kThreads; the last may be shorter); partial: slices x n x 3
// f32 when slices > 1 (unused with one slice).  softening2 >= FLT_MIN.
extern "C" int nbody_tile_f32(const void* posm, void* acc, void* partial,
                              int n, float softening2, int slices,
                              int slice_len, void* stream) {
  return launch_tile<kTileTargets, kTileFold>(
      posm, acc, partial, n, softening2, slices, slice_len,
      static_cast<cudaStream_t>(stream));
}

#ifdef NBODY_PROBE
// Route "tile" at `targets` targets a thread (1, 2, 4, 8), eps^2 folded or
// not, for tools/cuda_core_probe.py's comparison.
extern "C" int nbody_tile_probe_f32(const void* posm, void* acc,
                                    void* partial, int n, float softening2,
                                    int slices, int slice_len, int targets,
                                    int fold, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define NBODY_PROBE_CASE(R, F)                                             \
  if (targets == R && fold == F) {                                         \
    return launch_tile<R, F>(posm, acc, partial, n, softening2, slices,    \
                             slice_len, s);                                \
  }
  NBODY_PROBE_CASE(1, false)
  NBODY_PROBE_CASE(1, true)
  NBODY_PROBE_CASE(2, false)
  NBODY_PROBE_CASE(2, true)
  NBODY_PROBE_CASE(4, false)
  NBODY_PROBE_CASE(4, true)
  NBODY_PROBE_CASE(8, false)
  NBODY_PROBE_CASE(8, true)
#undef NBODY_PROBE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // NBODY_PROBE
