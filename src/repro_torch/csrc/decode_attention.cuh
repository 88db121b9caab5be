// The pieces decode attention's kernels share: on the bf16 or f32 cache
// (csrc/decode_attention.cu) and on the int8 cache
// (csrc/decode_attention_int8.cu).  Both split a row's keys over blocks of
// whole 64-key tiles and combine the splits by their m and l in a second
// kernel, here; route "mma" of both runs the same warp-level products
// (S = Q K^T and P V by mma.sync m16n8k16 from bf16 tiles in shared memory)
// and combines its four warps the same way, also here.  Everything is in
// an anonymous namespace: each source holds its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BT = 64;     // keys per tile (two threads a key in route fma)
constexpr int OMAX = 32;   // outputs a thread owns: group * D <= 4096
constexpr float kNegInf = -1e30f;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ inline float round_p(float p) { return p; }
template <>
__device__ inline float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ inline void store_out(float* p, float v) { *p = v; }
__device__ inline void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// One block a (batch, query head): the splits' partials weighted by
// exp(m_s - M), divided by the weighted sum of their l.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l, T* __restrict__ out,
                      float* __restrict__ lse, int splits, int D) {
  const long long row = blockIdx.x;
  const float* pm = part_m + row * splits;
  const float* pl = part_l + row * splits;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[s]);
  float L = 0.f;
  for (int s = 0; s < splits; ++s) L += pl[s] * expf(pm[s] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s)
      o = fmaf(part_acc[(row * splits + s) * D + d], expf(pm[s] - M), o);
    store_out(out + row * D + d, o * inv);
  }
  if (threadIdx.x == 0) lse[row] = M + logf(fmaxf(L, 1e-30f));
}

// Route "fma"'s combine of `splits` partials of B * HQ rows, or nothing for
// one split (the first kernel wrote the result); cudaGetLastError().
template <typename T>
inline int combine_fma(void* part_acc, void* part_m, void* part_l, void* out,
                       void* lse, int rows, int splits, int D,
                       cudaStream_t stream) {
  if (splits == 1) return static_cast<int>(cudaSuccess);
  decode_combine_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<T*>(out),
      static_cast<float*>(lse), splits, D);
  return static_cast<int>(cudaGetLastError());
}

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BT = 16 * kWarps;  // keys a tile: 16 a warp
constexpr float kLn2 = 0.6931471805599453f;

// Bytes of one row of a bf16 tile in shared memory: D values and 16 bytes
// of padding, so that the 8 rows one ldmatrix reads start in 8 different
// groups of 4 banks (2 D + 16 is 16 times an odd number for D % 16 == 0).
__host__ __device__ inline int row_bytes(int D) { return 2 * D + 16; }

// Bytes the four warps' m, l, weights and accumulators take after the loop
// (in the ring, which is free by then) for a group padded to `rows`.
inline size_t finish_bytes(size_t rows, int D) {
  return sizeof(float) * (kWarps * rows * (3 + D) + 2 * rows);
}

// A value reduced over the block (max, or sum in a fixed order) and handed
// to every thread; `red` holds one float a warp of shared memory.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
    v = MAX ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();  // red is free again
  return v;
}

// Splits of row b that hold keys: the split s covers keys from
// s * tiles_per_split * BT, so those below kv_len[b].
__device__ inline int live_splits(int end, int tiles_per_split, int splits) {
  const int keys = tiles_per_split * BT;
  return min(splits, (end + keys - 1) / keys);
}

// S = Q K^T for a warp's 16 keys (two n8 tiles), k16 steps over D: Qs the
// group's queries (16 MT rows of `rb` bytes), ks the warp's 16 keys, bf16.
template <int MT, int DMAX>
__device__ __forceinline__ void warp_scores(float (&s)[MT][2][4],
                                            const uint8_t* Qs,
                                            const uint8_t* ks, int rb, int D,
                                            int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DMAX / 16; ++kd) {
    if (kd * 16 >= D) break;
    uint32_t kf[4];
    hopper::ldmatrix_x4(kf, ks + ((lane & 7) + ((lane >> 4) << 3)) * rb
                                + (kd * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t qf[4];
      hopper::ldmatrix_x4(qf, Qs + (mt * 16 + (lane & 15)) * rb
                                  + (kd * 16 + (lane >> 4) * 8) * 2);
      hopper::mma_bf16_16816(s[mt][0], qf, kf[0], kf[1]);
      hopper::mma_bf16_16816(s[mt][1], qf, kf[2], kf[3]);
    }
  }
}

// acc += P V: the warp's 16 keys are the k16 step, V (bf16, the warp's 16
// keys from vs) read as it lies (keys along k) through ldmatrix's
// transpose, 16 columns a load.
template <int MT, int DMAX>
__device__ __forceinline__ void warp_pv(float (&acc)[MT][DMAX / 8][4],
                                        const uint32_t (&pf)[MT][4],
                                        const uint8_t* vs, int rb, int D,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < DMAX / 16; ++j) {
    if (j * 16 >= D) break;
    uint32_t vf[4];
    hopper::ldmatrix_x4_trans(
        vf, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * rb
                + (j * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      hopper::mma_bf16_16816(acc[mt][2 * j], pf[mt], vf[0], vf[1]);
      hopper::mma_bf16_16816(acc[mt][2 * j + 1], pf[mt], vf[2], vf[3]);
    }
  }
}

// The four warps' (m, l, acc) combined through shared memory at `ring`
// (free once every copy has landed and every warp is past its last tile;
// `finish_bytes` of it), each warp's weight exp2(m_w - M) taken once a row:
// the block's output and lse (one split) or its partials (m in base 2).
// Every thread of the block calls it.
template <int MT, int NT>
__device__ __forceinline__ void finish_warps(
    float (&acc)[MT][NT][4], const float (&m_run)[MT][2],
    float (&l_run)[MT][2], uint8_t* ring, int G, int D, long long head0,
    int split, int splits, bf16* __restrict__ out, float* __restrict__ lse,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l) {
  constexpr int ROWS = 16 * MT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[mt][h] += __shfl_xor_sync(0xffffffffu, l_run[mt][h], 1);
      l_run[mt][h] += __shfl_xor_sync(0xffffffffu, l_run[mt][h], 2);
    }
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);  // (kWarps, ROWS)
  float* wl = wm + kWarps * ROWS;
  float* wt = wl + kWarps * ROWS;  // each warp's weight exp2(m_w - M)
  float* ML = wt + kWarps * ROWS;  // M, then the combined l, a row
  float* Os = ML + 2 * ROWS;       // (kWarps, ROWS, D)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + lane / 4 + 8 * h;
      if ((lane & 3) == 0) {
        wm[warp * ROWS + row] = m_run[mt][h];
        wl[warp * ROWS + row] = l_run[mt][h];
      }
      if (row < G) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + 2 * (lane & 3);
          if (j * 8 < D)
            *reinterpret_cast<float2*>(Os + (warp * ROWS + row) * D + col) =
                make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
      }
    }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * ROWS + g]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = exp2f(wm[w * ROWS + g] - M);
      wt[w * ROWS + g] = wgt;
      L = fmaf(wl[w * ROWS + g], wgt, L);
    }
    ML[g] = M;
    ML[ROWS + g] = L;
    if (splits == 1) {
      lse[head0 + g] = M * kLn2 + logf(fmaxf(L, 1e-30f));
    } else {
      part_m[(head0 + g) * splits + split] = M;
      part_l[(head0 + g) * splits + split] = L;
    }
  }
  __syncthreads();
  for (int o = tid; o < G * D; o += kThreads) {
    const int g = o / D, d = o % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum = fmaf(Os[(w * ROWS + g) * D + d], wt[w * ROWS + g], sum);
    if (splits == 1)
      out[head0 * D + o] = __float2bfloat16(sum / fmaxf(ML[ROWS + g], 1e-30f));
    else
      part_acc[((head0 + g) * splits + split) * D + d] = sum;
  }
}

// A block with no key in one split (kv_len 0): zeros and lse -1e30, as the
// first kernel gives.  With several splits the combine skips the block.
__device__ __forceinline__ void empty_rows(int G, int D, long long head0,
                                           bf16* __restrict__ out,
                                           float* __restrict__ lse) {
  for (int o = threadIdx.x; o < G * D; o += kThreads)
    out[head0 * D + o] = __float2bfloat16(0.f);
  for (int g = threadIdx.x; g < G; g += kThreads)
    lse[head0 + g] = kNegInf + logf(1e-30f);
}

// One block a (batch, query head) row: the splits that hold keys, each
// weighted by exp2(m_s - M) taken once (the threads over the splits), then
// the weighted sums divided by the weighted sum of l (the threads over the
// columns).  The work is a few dependent reads from L2, so the reads that
// do not wait on kv_len are issued with it.  `ws` holds splits + 4 floats
// of shared memory.  Launched as a programmatic dependent of the first
// kernel, it may start once each of that kernel's blocks has executed
// griddepcontrol.launch_dependents or exited, and waits for the kernel's
// memory at griddepcontrol.wait.
__global__ void __launch_bounds__(kThreads)
decode_mma_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const int* __restrict__ kv_len,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          int HQ, int T_len, int splits, int tiles_per_split,
                          int D) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  extern __shared__ float ws[];
  float* red = ws + splits;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pm = part_m + row * splits;
  const float* pl = part_l + row * splits;
  // Every split's m and l (those past the live ones are never used).
  float m_s = kNegInf, l_s = 0.f;
  if (tid < splits) {
    m_s = pm[tid];
    l_s = pl[tid];
  }
  const int end = min(max(kv_len[row / HQ], 0), T_len);
  const int n_s = live_splits(end, tiles_per_split, splits);
  float M = kNegInf;
  for (int s = tid; s < n_s; s += kThreads)
    M = fmaxf(M, s == tid ? m_s : pm[s]);
  M = block_reduce<true>(M, red);
  float L = 0.f;
  for (int s = tid; s < n_s; s += kThreads) {
    ws[s] = exp2f((s == tid ? m_s : pm[s]) - M);
    L = fmaf(s == tid ? l_s : pl[s], ws[s], L);
  }
  L = block_reduce<false>(L, red);  // its barrier also publishes ws
  if (tid == 0)
    lse[row] = (M == kNegInf ? kNegInf : M * kLn2) + logf(fmaxf(L, 1e-30f));
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = tid; d < D; d += kThreads) {
    const float* pa = part_acc + row * splits * D + d;
    float acc = 0.f;
#pragma unroll 16
    for (int s = 0; s < n_s; ++s) acc = fmaf(pa[s * D], ws[s], acc);
    out[row * D + d] = __float2bfloat16(acc * inv);
  }
}

// Route "mma"'s combine of `splits` partials of B * HQ rows, or nothing for
// one split; cudaGetLastError().  It is launched as a programmatic
// dependent of the first kernel, just before it on the stream: a first
// kernel that executes griddepcontrol.launch_dependents as its blocks
// start (the int8 cache's route "gemv") lets it start during its tail.
inline int combine_mma(void* part_acc, void* part_m, void* part_l,
                       const void* kv_len, void* out, void* lse, int B, int HQ,
                       int T_len, int splits, int tiles_per_split, int D,
                       cudaStream_t stream) {
  if (splits == 1) return static_cast<int>(cudaSuccess);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * HQ);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * (splits + 4);
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_mma_combine_kernel, static_cast<const float*>(part_acc),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const int*>(kv_len), static_cast<bf16*>(out),
      static_cast<float*>(lse), HQ, T_len, splits, tiles_per_split, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

}  // namespace
