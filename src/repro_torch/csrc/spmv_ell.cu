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
// device memory; where x (128 MiB in the main path) does not fit the 50 MB
// L2, the sectors come from device memory in random order, and that gather,
// not the stream of data and cols, sets the time.  Two routes:
//
// Route "fma" (the first kernel): a group of L lanes takes one row (L a
// power of two).  With max_nnz a multiple of 4 and 16-byte aligned buffers,
// each lane reads four entries of data and cols with one 16-byte load each,
// so a warp reads 32 consecutive 16-byte pieces; otherwise the lanes read
// neighbouring single entries.  The group sums its lanes with shuffles.
// Rows past the end are masked; nothing is padded.
//
// Route "bin", for an x larger than L2: the entries are binned by column
// slice (2^cbits columns, 16 MiB of x) before they are gathered, so that
// each slice's gathers hit L2.  Passes:
//   0. `spmv_finite_kernel` sets a flag on the device if x holds a NaN or
//      an inf.  Where x is finite, an entry with data == 0 adds +-0 to a
//      sum that starts at +0, which leaves it bit for bit as it was, so
//      such entries are neither binned nor gathered; where the flag is set,
//      every entry is, so that 0 * inf gives NaN where the reference has it.
//   1. `spmv_bin_scatter_kernel`: a block takes 2^rbits rows (a "count
//      block", at most kBlockEntries entries), reads their data and cols
//      once with 16-byte loads, counts the entries it keeps in each slice
//      in shared memory, stages them there sorted by slice, and writes them
//      to its own region of the bins (room for all its entries), each as 8
//      bytes: (row in its count block << cbits | column in its slice,
//      value); consecutive threads write consecutive entries, so a warp
//      fills whole sectors.  Where each slice's run starts in the region
//      goes to a table (slices + 1 a block), so no pass over the whole
//      matrix has to count first.
//   2. `spmv_bin_gather_kernel`, one launch a slice, so that only that
//      slice of x is read while it runs and it stays in L2: a block takes
//      the runs of that slice of 2^(10 - rbits) count blocks (1024 rows),
//      gathers x from L2, adds d * x into its rows in shared memory, then
//      adds its rows into y with plain loads and stores (a row belongs to
//      one block of a launch, and the launches run in order; the first
//      writes y).  Shared float atomicAdd is a compare-and-swap loop on
//      sm_90, but its rows are rarely contended: about 1.4 entries a row
//      and slice.  The order of the sums within a row and slice is the
//      atomics', so it changes from run to run.
//   Each gather costs a 32-byte sector of L2 for 4 bytes, and every byte
//   of both passes goes through L2: the L2's sector rate, not the device
//   memory, bounds the gather pass.
// An entry whose column is out of range reads 0 (below): its term is d * 0,
// +-0 where d is finite (skipped), NaN where it is not (binned as NaN
// against column 0 of slice 0, which then gives NaN as the reference does).
//
// Columns follow `jnp.take`'s fill mode, which is what the reference kernel
// computes: c in [-n, 0) reads x[c + n], c in [0, n) reads x[c], any other c
// reads 0.
//
// Built with SPMV_PROBE (tools/cuda_core_probe.py builds it so, the package
// never does), the file also holds route "fma"'s ablations: every entry
// gathered (no zero skip), and the gather replaced by a constant.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
//: route "bin": the most column slices (n < 2^31 with slices of at least
//: 2^22 columns), the most entries of a count block (staged in shared
//: memory) and the rows a gather block sums in shared memory
constexpr int kMaxSlices = 512;
constexpr int kBlockEntries = 4096;
constexpr int kGatherRows = 1024;

// What route "fma"'s kernel does with an entry: the package's route skips
// the gather where data == 0 and x is finite; the probe's ablations gather
// every entry, or read no x at all.
enum Mode { kSkipZeros = 0, kGatherAll = 1, kConstant = 2 };

__device__ __forceinline__ int column(int c, int n) {
  return c < 0 ? c + n : c;  // no overflow: c >= -2^31, n < 2^31
}

__device__ __forceinline__ float gather(const float* __restrict__ x, int c,
                                        int n) {
  const int i = column(c, n);
  return (i >= 0 && i < n) ? __ldg(x + i) : 0.0f;
}

__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

template <int MODE>
__device__ __forceinline__ float term(float d, int c,
                                      const float* __restrict__ x, int n,
                                      bool all) {
  if (MODE == kConstant) return d * static_cast<float>(c & 1);
  if (MODE == kSkipZeros && !all && d == 0.0f) return 0.0f;
  return d * gather(x, c, n);
}

// lanes (L) is a power of two, at most 32: row = thread >> log2(L).
template <bool VEC, int MODE>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const float* __restrict__ data, const int* __restrict__ cols,
                const float* __restrict__ x, float* __restrict__ y,
                long long rows, int nnz, int n, int lanes,
                const int* __restrict__ nonfinite) {
  const long long thread = static_cast<long long>(blockIdx.x) * kThreads +
                           threadIdx.x;
  const long long row = thread >> (__ffs(lanes) - 1);
  const int lane = static_cast<int>(thread) & (lanes - 1);
  const bool all = MODE == kSkipZeros && *nonfinite != 0;
  float sum = 0.0f;
  if (row < rows) {
    const long long base = row * nnz;
    if (VEC) {
      for (int j = 4 * lane; j < nnz; j += 4 * lanes) {
        const float4 d = __ldcs(reinterpret_cast<const float4*>(data + base + j));
        const int4 c = __ldcs(reinterpret_cast<const int4*>(cols + base + j));
        sum += term<MODE>(d.x, c.x, x, n, all);
        sum += term<MODE>(d.y, c.y, x, n, all);
        sum += term<MODE>(d.z, c.z, x, n, all);
        sum += term<MODE>(d.w, c.w, x, n, all);
      }
    } else {
      for (int j = lane; j < nnz; j += lanes) {
        sum += term<MODE>(__ldcs(data + base + j), __ldcs(cols + base + j), x,
                          n, all);
      }
    }
  }
  // Every lane of the warp reaches the shuffles (no early return above).
  for (int offset = lanes / 2; offset > 0; offset /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, offset, lanes);
  }
  if (row < rows && lane == 0) y[row] = sum;
}

// Sets *nonfinite to 1 if x holds a NaN or an inf (the caller zeroed it).
__global__ void __launch_bounds__(kThreads)
spmv_finite_kernel(const float* __restrict__ x, long long n,
                   int* __restrict__ nonfinite) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  bool bad = false;
  const long long quads = (reinterpret_cast<uintptr_t>(x) % 16 == 0) ? n / 4
                                                                      : 0;
  for (long long q = first; q < quads; q += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + q);
    bad |= !(finite(v.x) && finite(v.y) && finite(v.z) && finite(v.w));
  }
  for (long long i = 4 * quads + first; i < n; i += stride) {
    bad |= !finite(__ldg(x + i));
  }
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0) *nonfinite = 1;
}

// Route "bin"'s layout of one launch (see the top of the file).
struct BinShape {
  long long rows;
  int nnz;           // a multiple of 4, 2^rbits * nnz <= kBlockEntries
  int n;
  int cbits;         // a slice is 2^cbits columns
  int rbits;         // a count block is 2^rbits rows; rbits + cbits <= 32
  int slices;        // ceil(n / 2^cbits)
  int count_blocks;  // ceil(rows / 2^rbits)
};

// Where entry (d, c) goes: its slice (or -1 where it is skipped), its
// column in the slice and the value it carries.
__device__ __forceinline__ int classify(float d, int c, const BinShape& s,
                                        bool all, uint32_t* col_in_slice,
                                        float* value) {
  const int i = column(c, s.n);
  if (i >= 0 && i < s.n) {
    if (!all && d == 0.0f) return -1;
    *col_in_slice = static_cast<uint32_t>(i) & ((1u << s.cbits) - 1u);
    *value = d;
    return i >> s.cbits;
  }
  if (finite(d)) return -1;  // d * 0 is +-0
  *col_in_slice = 0;
  *value = d * 0.0f;  // NaN
  return 0;
}

// One block a count block: its kept entries, sorted by slice, into its
// region of the bins (2^rbits * nnz entries from b * 2^rbits * nnz), and
// where each slice's run starts in it into starts[b * (slices + 1) + i]
// (the last: the entries kept).
__global__ void __launch_bounds__(kThreads)
spmv_bin_scatter_kernel(const float* __restrict__ data,
                        const int* __restrict__ cols, BinShape s,
                        const int* __restrict__ nonfinite,
                        int* __restrict__ starts, uint2* __restrict__ bins) {
  constexpr int kQuads = kBlockEntries / 4 / kThreads;  // a thread's, at most
  __shared__ int count[kMaxSlices];
  __shared__ int first[kMaxSlices + 1];
  __shared__ uint2 stage[kBlockEntries];
  for (int i = threadIdx.x; i < s.slices; i += kThreads) count[i] = 0;
  const long long b = blockIdx.x;
  const long long row0 = b << s.rbits;
  const int block_rows = static_cast<int>(
      min(static_cast<long long>(1) << s.rbits, s.rows - row0));
  const int quads = block_rows * s.nnz / 4;
  const int quads_per_row = s.nnz / 4;
  const auto* dq = reinterpret_cast<const float4*>(data + row0 * s.nnz);
  const auto* cq = reinterpret_cast<const int4*>(cols + row0 * s.nnz);
  float4 d[kQuads];
  int4 c[kQuads];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int q = threadIdx.x + k * kThreads;
    d[k] = q < quads ? __ldcs(dq + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    c[k] = q < quads ? __ldcs(cq + q) : make_int4(0, 0, 0, 0);
  }
  const bool all = *nonfinite != 0;
  __syncthreads();  // count[] zeroed
  int rank[kQuads][4];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int q = threadIdx.x + k * kThreads;
    const float dv[4] = {d[k].x, d[k].y, d[k].z, d[k].w};
    const int cv[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t off;
      float v;
      const int slice = q < quads ? classify(dv[e], cv[e], s, all, &off, &v)
                                  : -1;
      rank[k][e] = slice >= 0 ? atomicAdd(count + slice, 1) : 0;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // first[] = exclusive prefix of count[]
    const int lane = threadIdx.x;
    int carry = 0;
    for (int i0 = 0; i0 < s.slices; i0 += 32) {
      const int v = i0 + lane < s.slices ? count[i0 + lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      if (i0 + lane < s.slices) first[i0 + lane] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) first[s.slices] = carry;
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= s.slices; i += kThreads) {
    starts[b * (s.slices + 1) + i] = first[i];
  }
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int q = threadIdx.x + k * kThreads;
    const uint32_t row_bits = static_cast<uint32_t>(q / quads_per_row)
                              << s.cbits;
    const float dv[4] = {d[k].x, d[k].y, d[k].z, d[k].w};
    const int cv[4] = {c[k].x, c[k].y, c[k].z, c[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t off;
      float v;
      const int slice = q < quads ? classify(dv[e], cv[e], s, all, &off, &v)
                                  : -1;
      if (slice >= 0) {
        stage[first[slice] + rank[k][e]] =
            make_uint2(row_bits | off, __float_as_uint(v));
      }
    }
  }
  __syncthreads();
  uint2* __restrict__ region = bins + b * (static_cast<long long>(s.nnz)
                                           << s.rbits);
  for (int j = threadIdx.x; j < first[s.slices]; j += kThreads) {
    region[j] = stage[j];
  }
}

// One launch a slice: a block takes the runs of `slice` of kGatherRows
// rows' count blocks, sums them into its rows in shared memory, then its
// rows into y.
__global__ void __launch_bounds__(kThreads)
spmv_bin_gather_kernel(const uint2* __restrict__ bins,
                       const int* __restrict__ starts,
                       const float* __restrict__ x, float* __restrict__ y,
                       BinShape s, int slice) {
  __shared__ float acc[kGatherRows];
  const int per_block = kGatherRows >> s.rbits;  // count blocks
  const long long row0 = static_cast<long long>(blockIdx.x) * kGatherRows;
  const int block_rows = static_cast<int>(
      min(static_cast<long long>(kGatherRows), s.rows - row0));
  for (int r = threadIdx.x; r < block_rows; r += kThreads) acc[r] = 0.0f;
  __syncthreads();
  const float* __restrict__ xs =
      x + (static_cast<long long>(slice) << s.cbits);
  const uint32_t col_mask = (1u << s.cbits) - 1u;
  constexpr int kUnroll = 4;
  for (int g = 0; g < per_block; ++g) {
    const long long b = row0 / (1ll << s.rbits) + g;
    if (b >= s.count_blocks) break;
    const int* st = starts + b * (s.slices + 1) + slice;
    const int lo = st[0];
    const int hi = st[1];
    const uint2* __restrict__ run =
        bins + b * (static_cast<long long>(s.nnz) << s.rbits);
    float* __restrict__ rows = acc + (g << s.rbits);
    for (int e = lo + threadIdx.x; e < hi; e += kUnroll * kThreads) {
      uint2 p[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int at = e + k * kThreads;
        p[k] = at < hi ? __ldcs(run + at) : make_uint2(0u, 0u);
      }
      float v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        v[k] = __uint_as_float(p[k].y) * __ldg(xs + (p[k].x & col_mask));
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (e + k * kThreads < hi) atomicAdd(rows + (p[k].x >> s.cbits), v[k]);
      }
    }
  }
  __syncthreads();
  float* __restrict__ yb = y + row0;
  for (int r = threadIdx.x; r < block_rows; r += kThreads) {
    yb[r] = slice == 0 ? acc[r] : yb[r] + acc[r];
  }
}

template <int MODE>
int launch_fma(const float* d, const int* c, const float* xv, float* out,
               long long rows, int nnz, int n, int lanes, int vec,
               const int* nonfinite, cudaStream_t s) {
  const auto blocks = static_cast<unsigned>((rows * lanes + kThreads - 1) /
                                            kThreads);
  if (vec) {
    spmv_ell_kernel<true, MODE><<<blocks, kThreads, 0, s>>>(
        d, c, xv, out, rows, nnz, n, lanes, nonfinite);
  } else {
    spmv_ell_kernel<false, MODE><<<blocks, kThreads, 0, s>>>(
        d, c, xv, out, rows, nnz, n, lanes, nonfinite);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_finite(const float* x, int n, int* nonfinite, int grid,
                  cudaStream_t s) {
  spmv_finite_kernel<<<grid, kThreads, 0, s>>>(x, n, nonfinite);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route "fma".  data: (rows, nnz) f32, cols: (rows, nnz) int32, both dense
// row-major; x: (n,) f32; y: (rows,) f32; nonfinite: one int32 the caller
// zeroed, set here by a pass over x (grid blocks) before the product.
// lanes in {1, 2, 4, 8, 16, 32}; vec != 0 only when nnz % 4 == 0 and data
// and cols are 16-byte aligned.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another lane count.
extern "C" int spmv_ell_f32(const void* data, const void* cols, const void* x,
                            void* y, long long rows, int nnz, int n, int lanes,
                            int vec, void* nonfinite, int grid, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* flag = static_cast<int*>(nonfinite);
  const auto* xv = static_cast<const float*>(x);
  if (int err = launch_finite(xv, n, flag, grid, s)) return err;
  return launch_fma<kSkipZeros>(
      static_cast<const float*>(data), static_cast<const int*>(cols), xv,
      static_cast<float*>(y), rows, nnz, n, lanes, vec, flag, s);
}

// Route "bin".  data, cols, x as above, 16-byte aligned, nnz % 4 == 0,
// 1 <= n; y: (rows,) f32, written; nonfinite: one int32 the caller zeroed;
// starts: count blocks x (slices + 1) int32; bins: count blocks x 2^rbits
// x nnz uint2 (room for every entry).  cbits + rbits <= 32, 2^rbits * nnz
// <= kBlockEntries, slices = ceil(n / 2^cbits) <= kMaxSlices.  grid:
// blocks of the finite pass.
extern "C" int spmv_ell_bin_f32(const void* data, const void* cols,
                                const void* x, void* y, long long rows,
                                int nnz, int n, int cbits, int rbits,
                                void* nonfinite, void* starts, void* bins,
                                int grid, void* stream) {
  const int slices = static_cast<int>(
      (static_cast<long long>(n) + (1ll << cbits) - 1) >> cbits);
  const long long count_blocks = (rows + (1ll << rbits) - 1) >> rbits;
  if (nnz % 4 != 0 || cbits + rbits > 32 ||
      (static_cast<long long>(nnz) << rbits) > kBlockEntries ||
      slices > kMaxSlices || n < 1 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const BinShape shape{rows,  nnz,    n, cbits, rbits,
                       slices, static_cast<int>(count_blocks)};
  const auto* xv = static_cast<const float*>(x);
  auto* flag = static_cast<int*>(nonfinite);
  auto* st = static_cast<int*>(starts);
  auto* bin = static_cast<uint2*>(bins);
  if (int err = launch_finite(xv, n, flag, grid, s)) return err;
  spmv_bin_scatter_kernel<<<static_cast<unsigned>(count_blocks), kThreads, 0,
                            s>>>(static_cast<const float*>(data),
                                 static_cast<const int*>(cols), shape, flag,
                                 st, bin);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  const auto gather_blocks =
      static_cast<unsigned>((rows + kGatherRows - 1) / kGatherRows);
  for (int slice = 0; slice < slices; ++slice) {
    spmv_bin_gather_kernel<<<gather_blocks, kThreads, 0, s>>>(
        bin, st, xv, static_cast<float*>(y), shape, slice);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  return 0;
}

#ifdef SPMV_PROBE
// Route "fma"'s ablations on the same grid: mode 1 gathers every entry (no
// zero skip), mode 2 reads no x (the stream of data and cols alone), mode 0
// is the route itself (the flag read, not set: the caller gives it).
extern "C" int spmv_ell_probe_f32(const void* data, const void* cols,
                                  const void* x, void* y, long long rows,
                                  int nnz, int n, int lanes, int vec,
                                  const void* nonfinite, int mode,
                                  void* stream) {
  const auto* d = static_cast<const float*>(data);
  const auto* c = static_cast<const int*>(cols);
  const auto* xv = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  const auto* flag = static_cast<const int*>(nonfinite);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSkipZeros:
      return launch_fma<kSkipZeros>(d, c, xv, out, rows, nnz, n, lanes, vec,
                                    flag, s);
    case kGatherAll:
      return launch_fma<kGatherAll>(d, c, xv, out, rows, nnz, n, lanes, vec,
                                    flag, s);
    case kConstant:
      return launch_fma<kConstant>(d, c, xv, out, rows, nnz, n, lanes, vec,
                                   flag, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // SPMV_PROBE
