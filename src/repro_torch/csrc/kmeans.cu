// K-Means assignment + partial reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kmeans_kernel` / `kmeans_pallas` in
// src/repro/kernels/kmeans/kernel.py.  That kernel turns both steps into
// matrix products (distances as |p|^2 - 2 p.c^T + |c|^2, sums as a one-hot
// product) because its target has no atomics.  On an H100 with small k*f
// (the paper's K-Means has f = 4, k = 40) the least work is reading the
// points once, n*f*4 bytes, next to n*k*(2f+3) float operations on the CUDA
// cores, and the two bounds lie close together.
//
// Design: centroids and |c|^2 sit in shared memory.  A fixed grid (a few
// blocks per SM) walks the points with a grid-stride loop, one point per
// thread held in registers.  The distance uses the same formula as the
// reference, |p|^2 - 2 p.c + |c|^2, and strict `<`, so the lowest index wins
// a tie as `argmin` does.  Each block accumulates sums[k][f] (float) and
// counts[k] (int, exact) in shared memory with shared-memory atomics and
// writes one partial; the caller sums the (grid, k, f) / (grid, k) partials.
// Rows are masked with i < n, so no padding and no pad-count correction.
//
// Shared memory is (2*k*f + 2*k) * 4 bytes.  Above 48 KiB the launcher opts
// in to up to 227 KiB; beyond that the Python wrapper raises (there is no
// fallback to another path).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// F > 0: feature count known at compile time, the point lives in registers.
// F == 0: any feature count, the point is re-read from global memory (L1).
template <int F>
__global__ void __launch_bounds__(kThreads)
kmeans_kernel(const float* __restrict__ points,
              const float* __restrict__ centroids,
              float* __restrict__ part_sums,   // (grid, k, f)
              int* __restrict__ part_counts,   // (grid, k)
              long long n, int f_runtime, int k) {
  extern __shared__ __align__(16) float smem[];
  const int f = F > 0 ? F : f_runtime;
  const int kf = k * f;
  float* s_cent = smem;             // k*f
  float* s_c2 = s_cent + kf;        // k
  float* s_sums = s_c2 + k;         // k*f
  int* s_counts = reinterpret_cast<int*>(s_sums + kf);  // k

  const int tid = threadIdx.x;
  for (int j = tid; j < kf; j += kThreads) {
    s_cent[j] = centroids[j];
    s_sums[j] = 0.0f;
  }
  __syncthreads();
  for (int c = tid; c < k; c += kThreads) {
    float c2 = 0.0f;
    for (int d = 0; d < f; ++d) {
      const float v = s_cent[c * f + d];
      c2 += v * v;
    }
    s_c2[c] = c2;
    s_counts[c] = 0;
  }
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
       i < n; i += stride) {
    const float* p_ptr = points + i * f;
    float p[F > 0 ? F : 1];
    float p2 = 0.0f;
    if constexpr (F == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p_ptr);
      p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
    } else if constexpr (F > 0) {
#pragma unroll
      for (int d = 0; d < F; ++d) p[d] = p_ptr[d];
    }
    if constexpr (F > 0) {
#pragma unroll
      for (int d = 0; d < F; ++d) p2 += p[d] * p[d];
    } else {
      for (int d = 0; d < f; ++d) p2 += p_ptr[d] * p_ptr[d];
    }

    float best_d = 0.0f;
    int best = 0;
    for (int c = 0; c < k; ++c) {
      const float* cc = s_cent + c * f;
      float dot = 0.0f;
      if constexpr (F > 0 && F % 4 == 0) {
        // One 16-byte shared-memory load per four features: the loop is
        // bound by load issue otherwise.  (c * F * 4 is a multiple of 16.)
        const float4* cc4 = reinterpret_cast<const float4*>(cc);
#pragma unroll
        for (int q = 0; q < F / 4; ++q) {
          const float4 v = cc4[q];
          dot += p[4 * q] * v.x;
          dot += p[4 * q + 1] * v.y;
          dot += p[4 * q + 2] * v.z;
          dot += p[4 * q + 3] * v.w;
        }
      } else if constexpr (F > 0) {
#pragma unroll
        for (int d = 0; d < F; ++d) dot += p[d] * cc[d];
      } else {
        for (int d = 0; d < f; ++d) dot += p_ptr[d] * cc[d];
      }
      const float d2 = (p2 - 2.0f * dot) + s_c2[c];
      if (c == 0 || d2 < best_d) {
        best_d = d2;
        best = c;
      }
    }

    float* dst = s_sums + best * f;
    if constexpr (F > 0) {
#pragma unroll
      for (int d = 0; d < F; ++d) atomicAdd(dst + d, p[d]);
    } else {
      for (int d = 0; d < f; ++d) atomicAdd(dst + d, p_ptr[d]);
    }
    atomicAdd(s_counts + best, 1);
  }
  __syncthreads();

  float* out_s = part_sums + static_cast<long long>(blockIdx.x) * kf;
  int* out_c = part_counts + static_cast<long long>(blockIdx.x) * k;
  for (int j = tid; j < kf; j += kThreads) out_s[j] = s_sums[j];
  for (int c = tid; c < k; c += kThreads) out_c[c] = s_counts[c];
}

template <int F>
cudaError_t launch(const float* points, const float* centroids,
                   float* part_sums, int* part_counts, long long n, int f,
                   int k, int grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kmeans_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kmeans_kernel<F><<<grid, kThreads, smem, stream>>>(
      points, centroids, part_sums, part_counts, n, f, k);
  return cudaGetLastError();
}

}  // namespace

// points (n, f) f32, centroids (k, f) f32, part_sums (grid, k, f) f32,
// part_counts (grid, k) int32; every block writes its whole partial, so the
// outputs need no initialisation.  Returns cudaGetLastError().
extern "C" int kmeans_assign_partials_f32(const void* points,
                                          const void* centroids,
                                          void* part_sums, void* part_counts,
                                          long long n, int f, int k, int grid,
                                          void* stream) {
  const float* p = static_cast<const float*>(points);
  const float* c = static_cast<const float*>(centroids);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (2ull * k * f + 2ull * k) * sizeof(float);
  cudaError_t e;
  switch (f) {
    case 2: e = launch<2>(p, c, ps, pc, n, f, k, grid, smem, s); break;
    case 4: e = launch<4>(p, c, ps, pc, n, f, k, grid, smem, s); break;
    case 8: e = launch<8>(p, c, ps, pc, n, f, k, grid, smem, s); break;
    case 16: e = launch<16>(p, c, ps, pc, n, f, k, grid, smem, s); break;
    default: e = launch<0>(p, c, ps, pc, n, f, k, grid, smem, s); break;
  }
  return static_cast<int>(e);
}

extern "C" int kmeans_threads_per_block() { return kThreads; }
