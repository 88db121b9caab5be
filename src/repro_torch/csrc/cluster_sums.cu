// Co-cluster sums CoC[r, c] = sum of Z[i, j] over row_assign[i] == r and
// col_assign[j] == c, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_csums_kernel` / `cluster_sums_pallas` in
// src/repro/kernels/coclustering/kernel.py, which computes R1^T (Z C1) with
// two one-hot matrix products per row block because its target has no
// atomics.  Here the assignments are read as int32 directly; no one-hot
// operand exists.
//
// On an H100 the work is bound by reading Z once: n * m * 4 bytes.  Design:
// a block owns a chunk of 256 columns and a slab of rows.  A thread keeps one
// column, so its column cluster is fixed, and the row cluster is the same for
// the whole block in any one row.  Each thread adds its element into a
// private shared-memory cell acc[r][thread]: neighbouring threads hit
// neighbouring banks and no atomics are needed in the loop over rows.  At
// the end the R * 256 cells are folded by column cluster into an (R, C) tile
// with shared-memory atomics, and the block writes that tile as one partial;
// the caller sums the partials.  Eight rows are loaded before they are
// accumulated, to keep several loads in flight per thread.  An assignment
// outside [0, R) or [0, C) contributes nothing, as a one-hot row of zeros
// would.
//
// Shared memory is (R * 256 + R * C) * 4 bytes.  Above 48 KiB the launcher
// opts in to up to 227 KiB; beyond that the Python wrapper raises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
cluster_sums_kernel(const float* __restrict__ z,
                    const int* __restrict__ row_assign,
                    const int* __restrict__ col_assign,
                    float* __restrict__ partials,  // (blocks, R, C)
                    int n, int m, int nrow_clusters, int ncol_clusters,
                    int rows_per_slab) {
  extern __shared__ float smem[];
  float* s_acc = smem;                               // R * kThreads
  float* s_tile = smem + nrow_clusters * kThreads;   // R * C
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kThreads + tid;
  const bool col_ok = col < m;
  const int row_begin = blockIdx.y * rows_per_slab;
  const int row_end = min(n, row_begin + rows_per_slab);

  for (int r = 0; r < nrow_clusters; ++r) s_acc[r * kThreads + tid] = 0.0f;
  for (int j = tid; j < nrow_clusters * ncol_clusters; j += kThreads)
    s_tile[j] = 0.0f;
  // A thread only ever touches its own s_acc cells until the barrier below.

  if (col_ok) {
    const float* zc = z + col;
    int i = row_begin;
    for (; i + kUnroll <= row_end; i += kUnroll) {
      float v[kUnroll];
      int r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = zc[static_cast<long long>(i + u) * m];
        r[u] = row_assign[i + u];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r[u] >= 0 && r[u] < nrow_clusters)
          s_acc[r[u] * kThreads + tid] += v[u];
      }
    }
    for (; i < row_end; ++i) {
      const int r = row_assign[i];
      if (r >= 0 && r < nrow_clusters)
        s_acc[r * kThreads + tid] += zc[static_cast<long long>(i) * m];
    }
  }
  __syncthreads();

  if (col_ok) {
    const int c = col_assign[col];
    if (c >= 0 && c < ncol_clusters) {
      for (int r = 0; r < nrow_clusters; ++r)
        atomicAdd(s_tile + r * ncol_clusters + c, s_acc[r * kThreads + tid]);
    }
  }
  __syncthreads();

  const int block_id = blockIdx.y * gridDim.x + blockIdx.x;
  float* out = partials +
      static_cast<long long>(block_id) * nrow_clusters * ncol_clusters;
  for (int j = tid; j < nrow_clusters * ncol_clusters; j += kThreads)
    out[j] = s_tile[j];
}

}  // namespace

// z (n, m) f32, row_assign (n,) int32, col_assign (m,) int32, partials
// (col_chunks * row_slabs, R, C) f32 with col_chunks = ceil(m / 256); every
// block writes its whole partial.  Returns cudaGetLastError().
extern "C" int cluster_sums_partials_f32(const void* z, const void* row_assign,
                                         const void* col_assign,
                                         void* partials, int n, int m,
                                         int nrow_clusters, int ncol_clusters,
                                         int row_slabs, int rows_per_slab,
                                         void* stream) {
  const size_t smem =
      (static_cast<size_t>(nrow_clusters) * kThreads +
       static_cast<size_t>(nrow_clusters) * ncol_clusters) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cluster_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((m + kThreads - 1) / kThreads, row_slabs);
  cluster_sums_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int*>(row_assign),
      static_cast<const int*>(col_assign), static_cast<float*>(partials), n, m,
      nrow_clusters, ncol_clusters, rows_per_slab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cluster_sums_threads_per_block() { return kThreads; }
