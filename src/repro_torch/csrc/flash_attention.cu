// Online-softmax (flash) attention for Hopper (sm_90a): GQA/MQA, causal and
// sliding-window masks on absolute positions, ragged S and T masked.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/kernel.py, which keeps a q block resident
// in VMEM while a sequential kv grid axis streams k/v blocks through it, with
// the running max, denominator and accumulator in VMEM scratch, and relies on
// its wrapper to pad S and T to block multiples.
//
// On an H100 prefill attention is bound by operations: 4 * D flops for every
// (query, key) pair the masks let through, against q, k, v and o read or
// written once.  This first version runs on the CUDA cores in f32 (the
// tensor cores, mma.sync and then wgmma fed by TMA, are left to a later
// version), so it is far from the bf16 tensor-core bound.  Design: one block
// of 256 threads per (batch, query head, 64-row query tile); the KV head is
// `h / group`, so GQA and MQA share k/v with no copies.  The q tile sits in
// shared memory for the whole loop; k and v tiles of BK keys go through
// shared memory (widened to f32 on the way in, 16-byte loads).  The sequential
// kv grid axis of the TPU kernel becomes a loop inside the block, and that
// loop starts at the first tile the window lets through and stops after the
// last one the causal mask lets through: the reference visits the fully
// masked tiles and wipes them with alpha = 0, so the result is the same.
// Each thread owns 4 query rows x BK/16 keys of the score tile and 4 rows x
// DP/16 columns of the f32 accumulator, all in registers; a row's max and sum
// are reduced over the 16 lanes that share it by shuffles.  Scores are
// products of f32 (or widened bf16) values summed in f32, then scaled;
// masked scores are -1e30 as in the reference; for bf16 inputs p is rounded
// to bf16 before P.V, as the reference does; the output is
// acc / max(l, 1e-30) in q's type.  Rows past S are computed and not stored;
// keys past T load as zeros and are masked.  Head dims up to 256 (a multiple
// of 8) are padded with zeros in shared memory to DP in {32, 64, 96, 128,
// 256}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int kThreads = 256;  // 16 x 16
constexpr int TM = BQ / 16;    // query rows per thread
constexpr float kNegInf = -1e30f;

__device__ inline void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ inline void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
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

// Rows [rows) of a (rows, D) matrix at `src` into shared memory with row
// stride `ld` floats, as f32, zero past `valid` rows and past D columns.
template <typename T, int DP>
__device__ inline void load_tile(const T* __restrict__ src, float* dst,
                                 int rows, int valid, int D, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DP / VEC;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int d = (idx % PER_ROW) * VEC;
    float* out = dst + r * ld + d;
    if (r < valid && d < D) {
      load16(src + static_cast<long long>(r) * D + d, out);
    } else {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i)
        reinterpret_cast<float4*>(out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int HQ,
                       int HKV, int S, int T_len, int D, int causal,
                       int window, float scale, int q_offset) {
  constexpr int TN = BK / 16;   // keys per thread in the score tile
  constexpr int TD = DP / 16;   // accumulator columns per thread
  constexpr int LDQ = DP + 4;   // q/k row stride: 16-byte aligned rows
  constexpr int LDP = BK + 16;  // p row stride: rows ty, ty+1 in other banks
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ps = Vs + BK * DP;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q_row0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const T* qb = q + (static_cast<long long>(b) * HQ + h) * S * D;
  const T* kb = k + (static_cast<long long>(b) * HKV + hk) * T_len * D;
  const T* vb = v + (static_cast<long long>(b) * HKV + hk) * T_len * D;
  T* ob = out + (static_cast<long long>(b) * HQ + h) * S * D;

  // Key tiles the masks let through for any row of this query tile.
  const int q_first = q_offset + q_row0;
  const int q_last = q_offset + min(q_row0 + BQ, S) - 1;
  int k_end = T_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  load_tile<T, DP>(qb + static_cast<long long>(q_row0) * D, Qs, BQ,
                   S - q_row0, D, LDQ);

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(kb + static_cast<long long>(k0) * D, Ks, BK,
                     T_len - k0, D, LDQ);
    load_tile<T, DP>(vb + static_cast<long long>(k0) * D, Vs, BK,
                     T_len - k0, D, DP);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j.
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qf[TM], kf[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qf[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LDQ + d]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }

    // Masks, online softmax, p into shared memory.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q_offset + q_row0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < T_len;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = round_p<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns tx + 16 j.
    const int kv_valid = min(BK, k_end - k0);
    for (int c = 0; c < kv_valid; ++c) {
      float pv[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q_row0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store_out(ob + static_cast<long long>(row) * D + d,
                           acc[i][j] * inv);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int HQ, int HKV, int S, int T_len, int D, int causal, int window,
           float scale, int q_offset, cudaStream_t stream) {
  constexpr int BK = DP <= 96 ? 64 : 32;
  constexpr int LDQ = DP + 4;
  constexpr int LDP = BK + 16;
  const size_t smem =
      sizeof(float) * (BQ * LDQ + BK * LDQ + BK * DP + BQ * LDP);
  auto kernel = flash_attention_kernel<T, DP, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, HQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), HQ, HKV, S, T_len, D,
      causal, window, scale, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int HQ, int HKV, int S, int T_len, int D, int causal, int window,
             float scale, int q_offset, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                         window, scale, q_offset, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                         window, scale, q_offset, stream);
  if (D <= 96)
    return launch<T, 96>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                         window, scale, q_offset, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                          window, scale, q_offset, stream);
  return launch<T, 256>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal, window,
                        scale, q_offset, stream);
}

}  // namespace

// q (B, HQ, S, D), k and v (B, HKV, T, D), out (B, HQ, S, D), all dense,
// 16-byte aligned and of one type: dtype 0 = f32, 1 = bf16.  D <= 256 and a
// multiple of 8; HQ a multiple of HKV.  window <= 0 means no window.
// Returns cudaGetLastError() (or the error of setting the shared memory).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int HQ,
                                   int HKV, int S, int T_len, int D,
                                   int causal, int window, float scale,
                                   int q_offset, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                           window, scale, q_offset, st);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, HQ, HKV, S, T_len, D,
                                 causal, window, scale, q_offset, st);
}
