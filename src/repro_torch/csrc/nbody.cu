// All-pairs N-Body accelerations for Hopper (sm_90a):
// a_i = sum_j m_j * d_ij / (|d_ij|^2 + eps^2)^(3/2), d_ij = p_j - p_i.
//
// Replaces the TPU kernel `_nbody_kernel` / `nbody_pallas` in
// src/repro/kernels/nbody/kernel.py, which keeps a block of targets in VMEM,
// streams source blocks along a sequential grid axis into a VMEM
// accumulator, and relies on the wrapper's zero-mass padding.
//
// On an H100 the function is bound by operations: n^2 pair interactions of
// 19 flops each (one rsqrtf among them) against 16 bytes a body read
// and 12 written.  Design: the classic CUDA one.  Each thread owns one target
// and keeps its accumulator in registers; the block stages the source bodies
// through shared memory in float4 tiles of kThreads bodies, and every thread
// runs the unrolled inner loop over the tile (one broadcast 16-byte shared
// load per pair).  The sequential j axis of the TPU kernel becomes this loop
// inside the block.  The last tile, where n is not a multiple of kThreads,
// is filled with zero-mass bodies at the origin in shared memory, which add
// nothing; nothing is padded in device memory, and targets past n are
// masked at the store.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nbody_kernel(const float4* __restrict__ posm, float* __restrict__ acc, int n,
             float softening2) {
  __shared__ float4 tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 me = i < n ? posm[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < n ? posm[j] : make_float4(0.f, 0.f, 0.f, 0.f);
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
