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
// Both routes keep centroids and |c|^2 in shared memory, walk the points
// with a grid-stride loop over a fixed grid, compute each distance by the
// reference's formula in its order, (|p|^2 - 2 p.c) + |c|^2, with strict `<`
// (the lowest index wins a tie, as `argmin`), f32 throughout (no TF32, no
// tensor cores), and write one partial per block: sums (grid, k, f) f32 and
// counts (grid, k) int32 (exact); the caller sums the partials.  Rows are
// masked with i < n, so nothing is padded and no pad count is corrected.
//
// Route "fma", the first kernel (`kmeans_kernel`): one point per thread;
// for each centroid every thread reads the row and |c|^2 from shared memory
// again; each point then adds itself into one block-wide accumulator with
// f + 1 shared-memory atomics.  Shared memory is (2*k*f + 2*k) * 4 bytes;
// above 48 KiB the launcher opts in to up to 227 KiB; beyond that the
// Python wrapper raises (there is no fallback to another path).
//
// Route "private" (`kmeans_private_kernel`), for f in {2, 4, 8, 16}: P
// points per thread, so that each centroid row read from shared memory
// serves P points (the loop over centroids peeled at 0, its selection
// without a branch), and accumulators private to a thread, so that no warp
// waits on another's (shared-memory float atomics compile to
// compare-and-swap loops on sm_90): k x (f + 1) words a thread in shared
// memory laid out [word][thread] (no bank conflicts, no atomics), P = 16 at
// f <= 4 (64 / f above), where they fit (k (f + 1) up to about 225 words:
// the paper's k = 40, f = 4 among them; the wrapper sends larger k x f to
// route "fma"), one block of 256 threads an SM.  They are added up in a
// fixed order into the block's partial at the end.
//
// Built with KMEANS_PROBE (tools/cuda_core_probe.py builds it so, the
// package does not), the source also holds the probe's variants at f = 4:
// route "private" at P = 1, 2, 4, 8, 16 with and without its accumulation,
// and the first kernel with its sums or all its accumulation cut (ablations
// that time the distance loop alone).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// What a kernel accumulates: everything (both routes), or, for the probe's
// ablations, the counts only or nothing (the assignments are then summed
// into one int that is written out, so that the distance loop stays).
enum Accum { kFull = 0, kCountsOnly = 1, kNothing = 2 };

// F > 0: feature count known at compile time, the point lives in registers.
// F == 0: any feature count, the point is re-read from global memory (L1).
template <int F, int ACCUM>
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

  int sink = 0;
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

    if constexpr (ACCUM == kFull) {
      float* dst = s_sums + best * f;
      if constexpr (F > 0) {
#pragma unroll
        for (int d = 0; d < F; ++d) atomicAdd(dst + d, p[d]);
      } else {
        for (int d = 0; d < f; ++d) atomicAdd(dst + d, p_ptr[d]);
      }
    }
    if constexpr (ACCUM == kNothing)
      sink += best;
    else
      atomicAdd(s_counts + best, 1);
  }
  if constexpr (ACCUM == kNothing) atomicAdd(s_counts, sink);
  __syncthreads();

  float* out_s = part_sums + static_cast<long long>(blockIdx.x) * kf;
  int* out_c = part_counts + static_cast<long long>(blockIdx.x) * k;
  for (int j = tid; j < kf; j += kThreads) out_s[j] = s_sums[j];
  for (int c = tid; c < k; c += kThreads) out_c[c] = s_counts[c];
}

template <int F, int ACCUM = kFull>
cudaError_t launch(const float* points, const float* centroids,
                   float* part_sums, int* part_counts, long long n, int f,
                   int k, int grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kmeans_kernel<F, ACCUM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kmeans_kernel<F, ACCUM><<<grid, kThreads, smem, stream>>>(
      points, centroids, part_sums, part_counts, n, f, k);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "private"
// ---------------------------------------------------------------------------

// The route's points a thread (kernels/kmeans/kernel.py's
// points_per_thread): as many as keep 64 of its point floats in registers,
// at most 16 (16 at f = 4, the best of 1-16 on an H100).
constexpr int thread_points(int F) { return 64 / F < 16 ? 64 / F : 16; }

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Words of the accumulators of one block: k x (f + 1) a thread, or one word
// without accumulation (the probe's ablation).
__host__ __device__ inline long long acc_words(bool accum, int f, int k) {
  return accum ? static_cast<long long>(kThreads) * k * (f + 1) : 1;
}

__host__ inline size_t private_shared_bytes(bool accum, int f, int k) {
  return (static_cast<size_t>(k) * f + round4(k) + acc_words(accum, f, k)) *
         4;
}

// F features from p (16-byte aligned for F % 4 == 0, 8-byte for F == 2).
template <int F>
__device__ inline void load_row(const float* __restrict__ p, float (&v)[F]) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else if constexpr (F == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int d = 0; d < F; ++d) v[d] = p[d];
  }
}

// (|p|^2 - 2 p.c) + |c|^2, the dot summed in feature order: the first
// kernel's expression, so both round alike.
template <int F>
__device__ inline float distance(const float (&p)[F], float p2,
                                 const float (&c)[F], float c2) {
  float dot = 0.0f;
#pragma unroll
  for (int d = 0; d < F; ++d) dot += p[d] * c[d];
  return (p2 - 2.0f * dot) + c2;
}

// kAccum false: the probe's ablation (the assignments are summed into one
// int that is written out, so that the distance loop stays).
template <int F, int P, bool kAccum>
__global__ void __launch_bounds__(kThreads)
kmeans_private_kernel(const float* __restrict__ points,
                      const float* __restrict__ centroids,
                      float* __restrict__ part_sums,   // (grid, k, F)
                      int* __restrict__ part_counts,   // (grid, k)
                      long long n, int k) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kRow = F + 1;  // an accumulator row: F sums, then a count
  const int kf = k * F;
  float* s_cent = smem;                  // k*F
  float* s_c2 = s_cent + kf;             // k
  float* s_acc = s_c2 + round4(k);       // acc_words(kAccum, F, k)
  const int tid = threadIdx.x;
  const int words = static_cast<int>(acc_words(kAccum, F, k));
  for (int j = tid; j < kf; j += kThreads) s_cent[j] = centroids[j];
  for (int j = tid; j < words; j += kThreads) s_acc[j] = 0.0f;  // int 0 too
  __syncthreads();
  for (int c = tid; c < k; c += kThreads) {
    float c2 = 0.0f;
#pragma unroll
    for (int d = 0; d < F; ++d) {
      const float v = s_cent[c * F + d];
      c2 += v * v;
    }
    s_c2[c] = c2;
  }
  __syncthreads();

  int sink = 0;
  const long long span = static_cast<long long>(kThreads) * P;
  for (long long i0 = blockIdx.x * span + tid; i0 < n;
       i0 += gridDim.x * span) {
    float p[P][F], p2[P];
    bool valid[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const long long i = i0 + static_cast<long long>(j) * kThreads;
      valid[j] = i < n;
      if (valid[j]) {
        load_row<F>(points + i * F, p[j]);
      } else {
#pragma unroll
        for (int d = 0; d < F; ++d) p[j][d] = 0.0f;
      }
      p2[j] = 0.0f;
#pragma unroll
      for (int d = 0; d < F; ++d) p2[j] += p[j][d] * p[j][d];
    }

    // Centroid 0 sets each point's first best; then strict `<` keeps the
    // lowest index on a tie, selected without a branch.
    float best_d[P];
    int best[P];
    {
      float cc[F];
      load_row<F>(s_cent, cc);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        best_d[j] = distance<F>(p[j], p2[j], cc, s_c2[0]);
        best[j] = 0;
      }
    }
#pragma unroll 4
    for (int c = 1; c < k; ++c) {
      float cc[F];
      load_row<F>(s_cent + c * F, cc);
      const float c2 = s_c2[c];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float d2 = distance<F>(p[j], p2[j], cc, c2);
        const bool closer = d2 < best_d[j];
        best_d[j] = closer ? d2 : best_d[j];
        best[j] = closer ? c : best[j];
      }
    }

#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (!valid[j]) continue;
      if constexpr (kAccum) {
        float* col = s_acc + tid;
#pragma unroll
        for (int d = 0; d < F; ++d)
          col[(best[j] * kRow + d) * kThreads] += p[j][d];
        reinterpret_cast<int*>(col)[(best[j] * kRow + F) * kThreads] += 1;
      } else {
        sink += best[j];
      }
    }
  }
  if constexpr (!kAccum) atomicAdd(reinterpret_cast<int*>(s_acc), sink);
  __syncthreads();

  // The block's partial, each word summed over the threads in a fixed
  // order: a warp a word, 8 columns a lane, then across the lanes.
  float* out_s = part_sums + static_cast<long long>(blockIdx.x) * kf;
  int* out_c = part_counts + static_cast<long long>(blockIdx.x) * k;
  if constexpr (kAccum) {
    const int lane = tid % 32;
    for (int j = tid / 32; j < k * kRow; j += kWarps) {
      const int c = j / kRow, d = j % kRow;
      const float* col = s_acc + static_cast<long long>(j) * kThreads;
      if (d < F) {
        float s = 0.0f;
#pragma unroll
        for (int m = 0; m < kWarps; ++m) s += col[lane + 32 * m];
#pragma unroll
        for (int o = 16; o > 0; o /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) out_s[c * F + d] = s;
      } else {
        int s = 0;
#pragma unroll
        for (int m = 0; m < kWarps; ++m)
          s += reinterpret_cast<const int*>(col)[lane + 32 * m];
#pragma unroll
        for (int o = 16; o > 0; o /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) out_c[c] = s;
      }
    }
  } else {
    for (int j = tid; j < kf; j += kThreads) out_s[j] = 0.0f;
    for (int c = tid; c < k; c += kThreads)
      out_c[c] = c == 0 ? reinterpret_cast<const int*>(s_acc)[0] : 0;
  }
}

using PrivateKernel = void (*)(const float*, const float*, float*, int*,
                               long long, int);

// The route's instance for f; nullptr for another f.
PrivateKernel private_kernel(int f) {
  switch (f) {
    case 2: return kmeans_private_kernel<2, thread_points(2), true>;
    case 4: return kmeans_private_kernel<4, thread_points(4), true>;
    case 8: return kmeans_private_kernel<8, thread_points(8), true>;
    case 16: return kmeans_private_kernel<16, thread_points(16), true>;
    default: return nullptr;
  }
}

// kern with its dynamic shared memory for (accum, f, k) allowed; nullptr
// (and the error in *err) if there is no instance or it does not fit.
PrivateKernel ready(PrivateKernel kern, bool accum, int f, int k,
                    size_t* smem, cudaError_t* err) {
  *err = cudaErrorInvalidValue;
  if (!kern || k < 1) return nullptr;
  *smem = private_shared_bytes(accum, f, k);
  if (*smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
    if (*err != cudaSuccess) {
      cudaGetLastError();  // returned here; not left for the next launch
      return nullptr;
    }
  }
  *err = cudaSuccess;
  return kern;
}

cudaError_t launch_private(PrivateKernel kern, bool accum, const void* points,
                           const void* centroids, void* part_sums,
                           void* part_counts, long long n, int f, int k,
                           int grid, void* stream) {
  size_t smem = 0;
  cudaError_t e;
  if (!ready(kern, accum, f, k, &smem, &e)) return e;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(centroids),
      static_cast<float*>(part_sums), static_cast<int*>(part_counts), n, k);
  return cudaGetLastError();
}

// Blocks of kern one SM holds at once, or the negated error.
int blocks_per_sm(PrivateKernel kern, bool accum, int f, int k) {
  size_t smem = 0;
  cudaError_t e;
  if (!ready(kern, accum, f, k, &smem, &e)) return -static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads,
                                                    smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

#ifdef KMEANS_PROBE
// The probe's variants of route "private" at f = 4: P points a thread,
// with its accumulation or without; nullptr for another P.
template <bool kAccum>
PrivateKernel probe_kernel(int P) {
  switch (P) {
    case 1: return kmeans_private_kernel<4, 1, kAccum>;
    case 2: return kmeans_private_kernel<4, 2, kAccum>;
    case 4: return kmeans_private_kernel<4, 4, kAccum>;
    case 8: return kmeans_private_kernel<4, 8, kAccum>;
    case 16: return kmeans_private_kernel<4, 16, kAccum>;
    default: return nullptr;
  }
}

PrivateKernel probe_kernel(bool accum, int P) {
  return accum ? probe_kernel<true>(P) : probe_kernel<false>(P);
}
#endif

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

// Route "private": the arguments of kmeans_assign_partials_f32 for f in
// {2, 4, 8, 16} (points 16-byte aligned, 8-byte for f = 2) and k (f + 1)
// words a thread that fit in a block's shared memory.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another f.
extern "C" int kmeans_private_partials_f32(const void* points,
                                           const void* centroids,
                                           void* part_sums, void* part_counts,
                                           long long n, int f, int k, int grid,
                                           void* stream) {
  return static_cast<int>(launch_private(private_kernel(f), true, points,
                                         centroids, part_sums, part_counts, n,
                                         f, k, grid, stream));
}

// Blocks of route "private"'s instance for (f, k) one SM holds at once (its
// grid is this times the SMs, for one wave), or the negated error.
extern "C" int kmeans_private_blocks_per_sm(int f, int k) {
  return blocks_per_sm(private_kernel(f), true, f, k);
}

#ifdef KMEANS_PROBE
// The first kernel at f = 4 with its accumulation cut: accum 1 counts only,
// 2 nothing (the counts' partials then hold the sum of the assignments in
// block 0's first word, the sums zeros).
extern "C" int kmeans_first_ablation_f32(const void* points,
                                         const void* centroids,
                                         void* part_sums, void* part_counts,
                                         long long n, int k, int grid,
                                         int accum, void* stream) {
  const float* p = static_cast<const float*>(points);
  const float* c = static_cast<const float*>(centroids);
  float* ps = static_cast<float*>(part_sums);
  int* pc = static_cast<int*>(part_counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (2ull * k * 4 + 2ull * k) * sizeof(float);
  cudaError_t e = cudaErrorInvalidValue;
  if (accum == kCountsOnly)
    e = launch<4, kCountsOnly>(p, c, ps, pc, n, 4, k, grid, smem, s);
  else if (accum == kNothing)
    e = launch<4, kNothing>(p, c, ps, pc, n, 4, k, grid, smem, s);
  return static_cast<int>(e);
}

// A variant of route "private" at f = 4 (probe_kernel's accum and P) with
// route "private"'s other arguments.
extern "C" int kmeans_probe_partials_f32(const void* points,
                                         const void* centroids,
                                         void* part_sums, void* part_counts,
                                         long long n, int k, int grid,
                                         int accum, int per_thread,
                                         void* stream) {
  return static_cast<int>(launch_private(probe_kernel(accum, per_thread),
                                         accum, points, centroids, part_sums,
                                         part_counts, n, 4, k, grid, stream));
}

extern "C" int kmeans_probe_blocks_per_sm(int k, int accum, int per_thread) {
  return blocks_per_sm(probe_kernel(accum, per_thread), accum, 4, k);
}
#endif
