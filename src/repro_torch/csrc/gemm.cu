// C = A @ B with an f32 accumulator, for Hopper (sm_90a), by three routes.
//
// Replaces the TPU kernel `_gemm_kernel` / `gemm_pallas` in
// src/repro/kernels/gemm/kernel.py, which revisits one accumulator tile over
// a sequential K grid axis and feeds a matrix unit with aligned blocks.
//
// On an H100 a large product is bound by operations: 2*m*n*k of them, at
// 989 TFLOP/s for bf16 inputs on the tensor cores and 67 TFLOP/s for f32 on
// the CUDA cores.  The wrapper (kernels/gemm/kernel.py, `gemm_route`) picks
// the route before the launch from dtype, shape and alignment alone:
//
// "wgmma" -- bf16 inputs whose rows TMA can describe (K and N multiples of
// 8, so rows are whole 16-byte units, and 16-byte-aligned bases), out bf16
// or f32.  One block of 384 threads per 128 x 256 tile of C, the tiles
// walked in groups of 16 row tiles so that a wave of blocks shares its A
// and B tiles in L2.  Warpgroup 0 is the producer: it gives up its
// registers (setmaxnreg) and one thread keeps a ring of 4 stages of 64 K
// values in flight with TMA (16 KB of A, 32 KB of B a stage, 128-byte
// swizzle, one mbarrier "full" and one "empty" a stage).  Warpgroups 1 and
// 2 are the consumers: each issues m64n256k16 on its 64 rows, 4 a stage,
// with the 64 x 256 f32 accumulator in registers (128 a thread; ptxas holds
// every thread of a 384-thread block to 168 registers whatever setmaxnreg
// moves at run time, and the consumers fit in them without spilling).  B
// is read as it lies, (k, n) row-major, through wgmma's transpose-B
// immediate: no transposed copy.  TMA fills what lies past M, N or K with
// zeros, which masks a ragged K; the epilogue casts to the out type once and
// masks its stores past M and N.  The tensor cores sum a k16 step's products
// in their own order before adding them to the f32 accumulator, so results
// differ from cuBLAS's in the last bits of f32 before the cast.
//
// "pipe" -- f32 inputs with K a multiple of 16 and N of 4 (rows of whole
// 16-byte units, 16-byte-aligned bases), out f32: true f32 on the
// CUDA cores, each output one chain of fused multiply-adds in ascending k,
// no split of K, so the sums are those of route "fma" (and of cuBLAS in f32
// at 8192^3).  The first kernel's tiles, thread layout and tile order
// (below), with the loads taken off the critical path: two buffers of 16 K
// values in shared memory and one __syncthreads() a stage, not two; the
// next stage's A and B are read from device memory into registers (16-byte
// loads, A transposed as it is stored) while the current stage is
// computed, then stored into the buffer the previous stage freed; and in
// the inner loop the operands of the next k step are read from shared
// memory while the products of this one run.  Rows past M and columns past
// N are read clamped and never stored.  Layouts measured slower than this
// one on an H100 and not kept: a 2-4-stage ring filled by cp.async (A kept
// (m, k) and read 4 k at a time, or A through registers and only B by
// cp.async), 128 x 256 tiles with 8 x 16 sums a thread, 32- or 8-deep
// stages, tiles walked in groups of 16 row tiles as route "wgmma" does, and
// zeroing k past a K that is not a multiple of 16; an instance with bf16
// out spilled 16 bytes, so bf16 out takes route "fma".
//
// "fma" -- everything else: f32 inputs "pipe" does not take (such as
// K = 136 or N = 130), and bf16 inputs TMA cannot describe (such as a
// K of 60, whose 120-byte rows it refuses); the first version.  The classic
// shared-memory-tiled kernel: a block of 256 threads owns a 128 x 128 tile
// of C and loops over K in steps of 16; each thread keeps an 8 x 8
// accumulator in registers, split into four 4 x 4 quadrants so that
// shared-memory reads are 16-byte wide and free of bank conflicts.  A is
// stored transposed in shared memory.  f32 inputs are multiplied in true f32
// on the CUDA cores (fused multiply-add), never in TF32, bit-equal to cuBLAS
// at 8192^3; bf16 inputs are widened to f32 on the way into shared memory.
// Ragged m, n and k are masked: out-of-range elements load as 0 and are not
// stored.  Loads are 16 bytes per request where the row length allows (a
// multiple of 8 elements) and element-wise otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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


// --- route "wgmma" ----------------------------------------------------------

namespace tc {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, GROUP_M = 16;
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int PANEL = 64;      // bf16 values in a 128-byte swizzled row
constexpr int A_STAGE = BM * BK * 2;   // 16 KB
constexpr int B_PANEL = BK * PANEL * 2;  // 8 KB: 64 k rows x 64 n values
constexpr int B_STAGE = BK * BN * 2;   // 32 KB: 4 panels
constexpr int SMEM_BYTES =
    STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * 8 + 1024;

__device__ inline void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ inline void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  TOut* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sa = smem;                     // STAGES x (BM rows x 128 B)
  uint8_t* sb = smem + STAGES * A_STAGE;  // STAGES x 4 panels x (BK x 128 B)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_STAGE);
  uint64_t* empty = full + STAGES;

  // Tile of this block, in groups of GROUP_M row tiles.
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int pid = blockIdx.x;
  const int in_group = GROUP_M * tiles_n;
  const int first_m = (pid / in_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % in_group) % group_m) * BM;
  const int n0 = ((pid % in_group) / group_m) * BN;
  const int kblocks = (K + BK - 1) / BK;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kb = 0; kb < kblocks; ++kb) {
        const int s = kb % STAGES;
        hopper::mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], A_STAGE + B_STAGE);
        hopper::tma_load_2d(sa + s * A_STAGE, &map_a, &full[s], kb * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / PANEL; ++j)
          hopper::tma_load_2d(sb + s * B_STAGE + j * B_PANEL, &map_b,
                              &full[s], n0 + j * PANEL, kb * BK);
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int c = wg - 1;  // rows 64 c .. 64 c + 63 of the tile
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int s = kb % STAGES;
      hopper::mbar_wait(&full[s], (kb / STAGES) & 1);
      const uint8_t* a = sa + s * A_STAGE + c * 64 * 128;
      const uint8_t* b = sb + s * B_STAGE;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_ss256<1>(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                               hopper::desc_sw128(b + kk * 16 * 128, B_PANEL,
                                                  1024),
                               1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: cast once, masked stores of column pairs.
    const int w = tid / 32, l = tid % 32;
    const int row = m0 + c * 64 + w * 16 + l / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * (l % 4);
      if (col >= N) continue;
      if (row < M)
        store2(C + static_cast<long long>(row) * N + col, acc[4 * j],
               acc[4 * j + 1]);
      if (row + 8 < M)
        store2(C + static_cast<long long>(row + 8) * N + col, acc[4 * j + 2],
               acc[4 * j + 3]);
    }
  }
}

template <typename TOut>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  alignas(64) CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(M)};
  const uint64_t strides_a[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t box_a[2] = {BK, BM};
  int err = hopper::encode_tensor_map(&map_a, a, 2, dims_a, strides_a, box_a);
  if (err != 0) return err;
  const uint64_t dims_b[2] = {static_cast<uint64_t>(N),
                              static_cast<uint64_t>(K)};
  const uint64_t strides_b[1] = {static_cast<uint64_t>(N) * 2};
  const uint32_t box_b[2] = {PANEL, BK};
  err = hopper::encode_tensor_map(&map_b, b, 2, dims_b, strides_b, box_b);
  if (err != 0) return err;
  auto kernel = gemm_wgmma_kernel<TOut>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  kernel<<<blocks, kThreads, SMEM_BYTES, stream>>>(
      map_a, map_b, static_cast<TOut*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// --- route "pipe" -----------------------------------------------------------

namespace pipe {

constexpr int BM = 128, BN = 128, BK = 16, kThreads = 256;
constexpr int A_LD = BM + 4;        // A^T rows (k, m): the first kernel's pad
constexpr int A_STAGE = BK * A_LD;  // floats
constexpr int B_STAGE = BK * BN;    // floats
constexpr int SMEM_BYTES = 2 * (A_STAGE + B_STAGE) * 4;

__global__ void __launch_bounds__(kThreads, 2)
gemm_pipe_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int M, int N, int K) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // 2 x (BK, A_LD): A^T
  float* Bs = As + 2 * A_STAGE;                 // 2 x (BK, BN)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // A stage: 8 consecutive k of one row a thread (threads of a warp on 32
  // rows), stored transposed; B stage: 4 consecutive n of two k rows 8
  // apart (a warp on 128 consecutive n).  Rows past M read the last row and
  // columns past N the last four (what they give is never stored); K is a
  // multiple of 16, so every stage is whole, and N of 4, so a 16-byte unit
  // never straddles the edge: the loads need no test.  (A test that zeroes
  // k past K in a short last stage, even one taken once after the loop,
  // made ptxas compile the whole kernel slower than route "fma" on an
  // H100.)
  const int a_row = tid % BM, a_col = (tid / BM) * 8;
  const int b_row = tid / 32, b_col = (tid % 32) * 4;
  const float* a_src =
      A + static_cast<long long>(min(m0 + a_row, M - 1)) * K + a_col;
  const float* b_src =
      B + static_cast<long long>(b_row) * N + min(n0 + b_col, N - 4);
  float4 a_next[2], b_next[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      a_next[j] = *reinterpret_cast<const float4*>(a_src + k0 + 4 * j);
      b_next[j] = *reinterpret_cast<const float4*>(
          b_src + static_cast<long long>(k0 + 8 * j) * N);
    }
  };
  auto store = [&](int buf) {
    float* as = As + buf * A_STAGE + a_col * A_LD + a_row;
    float* bs = Bs + buf * B_STAGE + b_row * BN + b_col;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      as[(4 * j) * A_LD] = a_next[j].x;
      as[(4 * j + 1) * A_LD] = a_next[j].y;
      as[(4 * j + 2) * A_LD] = a_next[j].z;
      as[(4 * j + 3) * A_LD] = a_next[j].w;
      *reinterpret_cast<float4*>(bs + 8 * j * BN) = b_next[j];
    }
  };

  // Thread (tx, ty) owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3}, and
  // columns 4 tx + {0..3} and 64 + 4 tx + {0..3}: 8 x 8 sums, each one
  // chain of fmaf in ascending k.  The operands of k step kk + 1 are read
  // from shared memory while the products of step kk run.
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto compute = [&](int buf) {
    const float* as = As + buf * A_STAGE;
    const float* bs = Bs + buf * B_STAGE;
    float4 f[2][4];
    auto fetch = [&](float4 (&g)[4], int kk) {
      g[0] = *reinterpret_cast<const float4*>(as + kk * A_LD + ty * 4);
      g[1] = *reinterpret_cast<const float4*>(as + kk * A_LD + BM / 2 +
                                               ty * 4);
      g[2] = *reinterpret_cast<const float4*>(bs + kk * BN + tx * 4);
      g[3] = *reinterpret_cast<const float4*>(bs + kk * BN + BN / 2 +
                                              tx * 4);
    };
    fetch(f[0], 0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk + 1 < BK) fetch(f[(kk + 1) & 1], kk + 1);
      const float4* g = f[kk & 1];
      const float ar[8] = {g[0].x, g[0].y, g[0].z, g[0].w,
                           g[1].x, g[1].y, g[1].z, g[1].w};
      const float br[8] = {g[2].x, g[2].y, g[2].z, g[2].w,
                           g[3].x, g[3].y, g[3].z, g[3].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  };

  const int kblocks = K / BK;
  load(0);
  store(0);
  // Not unrolled: two copies of the 1024 products of a stage would not fit
  // the instruction cache.
#pragma unroll 1
  for (int kb = 0; kb < kblocks; ++kb) {
    __syncthreads();  // stage kb is stored; every thread is done with kb - 1
    const bool more = kb + 1 < kblocks;
    if (more) load((kb + 1) * BK);  // in flight during stage kb
    compute(kb & 1);
    if (more) store((kb + 1) & 1);  // into the buffer of stage kb - 1
  }

  // Epilogue: four columns at a time (N is a multiple of 4).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 0 : BM / 2) + ty * 4 + (i % 4);
    if (row >= M) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + q * (BN / 2) + tx * 4;
      if (col < N)
        *reinterpret_cast<float4*>(C + static_cast<long long>(row) * N +
                                   col) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                        acc[i][4 * q + 3]);
    }
  }
}

int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_pipe_kernel<<<grid, kThreads, SMEM_BYTES, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pipe

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

// Route "wgmma": a (m, k) and b (k, n) bf16, dense row-major, 16-byte
// aligned, k and n multiples of 8 (the wrapper's `gemm_route` checks all of
// it); c (m, n) of out_type 0 = float32 or 1 = bfloat16.  Returns
// cudaGetLastError(), or the negated CUresult of a tensor map that could
// not be encoded.
extern "C" int gemm_bf16_wgmma(const void* a, const void* b, void* c, int m,
                               int n, int k, int out_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_type == 0) return tc::launch<float>(a, b, c, m, n, k, s);
  if (out_type == 1) return tc::launch<__nv_bfloat16>(a, b, c, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Route "pipe": a (m, k) and b (k, n) float32, dense row-major, 16-byte
// aligned, k a multiple of 16 and n of 4 (the wrapper's `gemm_route` checks
// all of it); c (m, n) float32 (out_type 0; any other is refused).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another out_type.
extern "C" int gemm_f32_pipe(const void* a, const void* b, void* c, int m,
                             int n, int k, int out_type, void* stream) {
  if (out_type != 0) return static_cast<int>(cudaErrorInvalidValue);
  return pipe::launch(a, b, c, m, n, k, static_cast<cudaStream_t>(stream));
}
