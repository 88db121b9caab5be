// C = A @ B with an f32 accumulator, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gemm_kernel` / `gemm_pallas` in
// src/repro/kernels/gemm/kernel.py, which revisits one accumulator tile over
// a sequential K grid axis and feeds a matrix unit with aligned blocks.
//
// On an H100 a large product is bound by operations: 2*m*n*k of them.  This
// first version is the classic shared-memory-tiled kernel: a block of 256
// threads owns a 128 x 128 tile of C and loops over K in steps of 16 inside
// the block (blocks run in no order, so nothing carries over between them);
// each thread keeps an 8 x 8 accumulator in registers, split into four 4 x 4
// quadrants so that shared-memory reads are 16-byte wide and free of bank
// conflicts.  A is stored transposed in shared memory.  f32 inputs are
// multiplied in true f32 on the CUDA cores (fused multiply-add), never in
// TF32; bf16 inputs are widened to f32 on the way into shared memory and
// accumulate in f32 the same way.  The result is cast to the output type at
// the end.  Ragged m, n and k are masked: out-of-range elements load as 0 and
// are not stored.  Loads are 16 bytes per request where the row length
// allows (a multiple of 8 elements) and element-wise otherwise.
//
// The tensor cores (wgmma fed by TMA) are the way to the card's full rate
// and are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ inline void store_out(float* p, float v) { *p = v; }
__device__ inline void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Eight consecutive elements, 16-byte requests; p is 16-byte aligned.
__device__ inline void load8_vec(const float* p, float (&out)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}
__device__ inline void load8_vec(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// Elements (row, col .. col+7) of a dense (nrows, ncols) matrix as floats;
// what lies outside the matrix reads as 0.
template <typename T>
__device__ inline void load8(const T* __restrict__ base, int row, int col,
                             int nrows, int ncols, bool vec, float (&out)[8]) {
  if (row < nrows && vec && col + 8 <= ncols) {
    load8_vec(base + static_cast<long long>(row) * ncols + col, out);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    out[e] = (row < nrows && col + e < ncols)
                 ? to_float(base[static_cast<long long>(row) * ncols + col + e])
                 : 0.0f;
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
            TOut* __restrict__ C, int M, int N, int K, bool vec_a,
            bool vec_b) {
  __shared__ __align__(16) float As[BK][BM + kPad];  // transposed: [k][m]
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // Global -> shared assignment: 8 elements of A and 8 of B per thread.
  const int a_row = tid % BM;        // threads of a warp on different rows
  const int a_col = (tid / BM) * 8;  // 0 or 8
  const int b_row = tid / 16;        // 0..15
  const int b_col = (tid % 16) * 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    float a[8], b[8];
    load8(A, m0 + a_row, k0 + a_col, M, K, vec_a, a);
    load8(B, k0 + b_row, n0 + b_col, K, N, vec_b, b);
    __syncthreads();  // the previous step's reads of As/Bs are done
#pragma unroll
    for (int e = 0; e < 8; ++e) As[a_col + e][a_row] = a[e];
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) =
        make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(&Bs[b_row][b_col + 4]) =
        make_float4(b[4], b[5], b[6], b[7]);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[kk][BM / 2 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
      const float ar[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float br[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                           b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (col < N)
        store_out(C + static_cast<long long>(row) * N + col, acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  const bool aligned_a = reinterpret_cast<size_t>(a) % 16 == 0;
  const bool aligned_b = reinterpret_cast<size_t>(b) % 16 == 0;
  const bool vec_a = aligned_a && K % 8 == 0;
  const bool vec_b = aligned_b && N % 8 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), M, N, K, vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// a (m, k), b (k, n), c (m, n), dense row-major.  Type codes: 0 = float32,
// 1 = bfloat16; a and b share in_type.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown type code.
extern "C" int gemm_rowmajor(const void* a, const void* b, void* c, int m,
                             int n, int k, int in_type, int out_type,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (in_type == 0 && out_type == 0)
    e = launch<float, float>(a, b, c, m, n, k, s);
  else if (in_type == 0 && out_type == 1)
    e = launch<float, __nv_bfloat16>(a, b, c, m, n, k, s);
  else if (in_type == 1 && out_type == 0)
    e = launch<__nv_bfloat16, float>(a, b, c, m, n, k, s);
  else if (in_type == 1 && out_type == 1)
    e = launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, s);
  return static_cast<int>(e);
}
