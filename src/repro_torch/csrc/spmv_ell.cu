// Sparse matrix-vector product in ELLPACK format for Hopper (sm_90a):
// y[r] = sum_j data[r, j] * x[cols[r, j]].
//
// Replaces the TPU kernel `_spmv_kernel` / `spmv_ell_pallas` in
// src/repro/kernels/spmv_ell/kernel.py, which keeps the whole vector x in
// VMEM and gathers from it with `jnp.take(x, cols, fill_value=0)`, a row
// block per grid step, after the wrapper has padded the rows.
//
// On an H100 the product is bound by bytes: data and cols (8 bytes an entry)
// are read once, y written once, and x, 4 bytes a column, at least once.
// The gather is random, so each x[c] costs a 32-byte sector from L2 or
// device memory, and x (128 MiB in the main path) does not fit the 50 MB L2:
// the real traffic is well above the bound.  x goes through the read-only
// path (`__ldg`); data and cols are streamed (`__ldcs`), read once.
//
// Design: a group of L lanes takes one row (L a power of two).  With
// max_nnz a multiple of 4 and 16-byte aligned buffers, each lane reads four
// entries of data and cols with one 16-byte load each, so a warp reads 32
// consecutive 16-byte pieces; otherwise the lanes read neighbouring single
// entries.  The group sums its lanes with shuffles.  One thread per row
// would read 64-byte rows with a stride between neighbouring threads and
// keep more of the row per thread in flight; the group gives coalesced
// loads at any max_nnz and was preferred for that.  Rows past the end are
// masked; nothing is padded.
//
// Columns follow `jnp.take`'s fill mode, which is what the reference kernel
// computes: c in [-n, 0) reads x[c + n], c in [0, n) reads x[c], any other c
// reads 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gather(const float* __restrict__ x, int c,
                                        int n) {
  const int i = c < 0 ? c + n : c;  // no overflow: c >= -2^31, n < 2^31
  return (i >= 0 && i < n) ? __ldg(x + i) : 0.0f;
}

// lanes (L) is a power of two, at most 32: row = thread >> log2(L).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ x, float* __restrict__ y,
                long long rows, int nnz, int n, int lanes) {
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads +
                           threadIdx.x;
  const long long row = thread >> (__ffs(lanes) - 1);
  const int lane = static_cast<int>(thread) & (lanes - 1);
  float sum = 0.0f;
  if (row < rows) {
    const long long base = row * nnz;
    if (VEC) {
      for (int j = 4 * lane; j < nnz; j += 4 * lanes) {
        const float4 d = __ldcs(reinterpret_cast<const float4*>(data + base + j));
        const int4 c = __ldcs(reinterpret_cast<const int4*>(cols + base + j));
        sum += d.x * gather(x, c.x, n);
        sum += d.y * gather(x, c.y, n);
        sum += d.z * gather(x, c.z, n);
        sum += d.w * gather(x, c.w, n);
      }
    } else {
      for (int j = lane; j < nnz; j += lanes) {
        sum += __ldcs(data + base + j) * gather(x, __ldcs(cols + base + j), n);
      }
    }
  }
  // Every lane of the warp reaches the shuffles (no early return above).
  for (int offset = lanes / 2; offset > 0; offset /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, offset, lanes);
  }
  if (row < rows && lane == 0) y[row] = sum;
}

}  // namespace

// data: (rows, nnz) f32, cols: (rows, nnz) int32, both dense row-major;
// x: (n,) f32; y: (rows,) f32.  lanes in {1, 2, 4, 8, 16, 32}; vec != 0 only
// when nnz % 4 == 0 and data and cols are 16-byte aligned.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another lane count.
extern "C" int spmv_ell_f32(const void* data, const void* cols, const void* x,
                            void* y, long long rows, int nnz, int n, int lanes,
                            int vec, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* d = static_cast<const float*>(data);
  const auto* c = static_cast<const int*>(cols);
  const auto* xv = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const auto blocks = static_cast<unsigned>((rows * lanes + kThreads - 1) /
                                            kThreads);
  if (vec) {
    spmv_ell_kernel<true><<<blocks, kThreads, 0, s>>>(d, c, xv, out, rows,
                                                      nnz, n, lanes);
  } else {
    spmv_ell_kernel<false><<<blocks, kThreads, 0, s>>>(d, c, xv, out, rows,
                                                       nnz, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
