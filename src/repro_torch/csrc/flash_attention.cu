// Online-softmax (flash) attention for Hopper (sm_90a): GQA/MQA, causal and
// sliding-window masks on absolute positions, ragged S and T masked, by two
// routes.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/kernel.py, which keeps a q block resident
// in VMEM while a sequential kv grid axis streams k/v blocks through it, with
// the running max, denominator and accumulator in VMEM scratch, and relies on
// its wrapper to pad S and T to block multiples.
//
// On an H100 prefill attention is bound by operations: 4 * D flops for every
// (query, key) pair the masks let through, against q, k, v and o read or
// written once; at 989 TFLOP/s in bf16 on the tensor cores.  Both routes
// share the loop bounds: the sequential kv grid axis of the TPU kernel
// becomes a loop inside the block that starts at the first key tile the
// window lets through and stops after the last one the causal mask lets
// through (the reference visits the fully masked tiles and wipes them with
// alpha = 0, so the result is the same); the KV head is `h / group`, so GQA
// and MQA share k/v with no copies; masked scores are -1e30 as in the
// reference; the output is acc / max(l, 1e-30) in q's type.  The wrapper
// (kernels/flash_attention/kernel.py, `flash_route`) picks the route before
// the launch from dtype, shape and alignment alone:
//
// "wgmma" -- bf16 inputs (head dims up to 256, multiples of 8: 16-byte rows
// that TMA can describe).  One block of 288 threads per (batch, query head,
// query tile), the tiles with the most keys launched first.  A producer
// warp loads the q tile once and then k and v tiles of BKV keys through a
// ring of two stages, all by TMA with 3-D tensor maps (D, rows, batch x
// heads) and the 128-byte swizzle, all kept in bf16.  A box is clipped at
// the end of its head: rows past S or T and columns past D read as zeros,
// so D is padded to DP in {64, 128, 256} (phi3's 96 to 128: the padding is
// zeros in q, k and v and costs only products).  Two consumer warpgroups
// run S = Q K^T by m64nBKVk16 from shared memory (scores f32 in
// registers), the masks only on tiles that cross an edge, the online
// softmax in base 2 on the accumulator fragment (a row's max by shuffles
// within its quad of lanes, its sum kept per thread and reduced at the
// end), p rounded to bf16 as the reference rounds it to v's type, and acc
// += P V by wgmma with P from registers and the v tile read through the
// transpose-B immediate; the f32 accumulator stays in registers.  Up to DP
// = 128 the query tile is 128 rows, 64 a warpgroup, with BKV = 128 keys;
// at DP = 256 the 64 x 256 accumulator would not fit beside the scores in
// the 168 registers a thread may hold, so the tile is 64 rows, both
// warpgroups compute its scores and each owns 128 of the 256 columns, with
// BKV = 64.

// "fma" -- f32 inputs (held at 2e-4, which bf16 operands cannot meet), and
// a bf16 call with no keys at all.  One block of 256 threads per (batch,
// query head, 64-row query tile) on the CUDA cores.  The q tile sits in
// shared memory for the whole loop; k and v tiles of BK keys go through
// shared memory (widened to f32 on the way in, 16-byte loads).  Each thread
// owns 4 query rows x BK/16 keys of the score tile and 4 rows x DP/16
// columns of the f32 accumulator, all in registers; a row's max and sum are
// reduced over the 16 lanes that share it by shuffles.  Scores are products
// of f32 (or widened bf16) values summed in f32, then scaled; for bf16
// inputs p is rounded to bf16 before P.V.  Rows past S are computed and not
// stored; keys past T load as zeros and are masked.  Head dims up to 256 (a
// multiple of 8) are padded with zeros in shared memory to DP in {32, 64,
// 96, 128, 256}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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


// --- route "wgmma" ----------------------------------------------------------

namespace tc {

// Two consumer warpgroups (warps 0-7) and one producer warp (warp 8).  The
// four schedulers of an SM split its 65,536 registers, and with 9 warps one
// of them holds 3: ptxas allows 168 registers a thread (as for 384 threads;
// it compiles to that cap even after a setmaxnreg, so none is used here).
constexpr int kThreads = 288;
constexpr int kConsumers = 256;
constexpr int PANEL = 64;  // bf16 values in a 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;

// Tiles of a head dim padded to DP.  Up to DP = 128 each consumer
// warpgroup owns 64 query rows and all DP columns of their accumulator
// (BQ = 128 rows a block).  At DP = 256 a 64 x 256 f32 accumulator (128
// registers) and a score tile do not fit in 168 registers, so the two
// warpgroups share one 64-row slab (BQ = 64) and each owns half of D: both
// compute the same scores and softmax, each its 128 columns of P V.
template <int DP>
struct Tiles {
  static constexpr bool SPLIT_D = DP > 128;
  static constexpr int BQ = SPLIT_D ? 64 : 128;      // query rows a block
  static constexpr int DW = SPLIT_D ? DP / 2 : DP;   // columns a warpgroup
  static constexpr int BKV = DP <= 128 ? 128 : 64;   // keys a stage
  static constexpr int PANELS = DP / PANEL;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;  // one of k or v
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 8 * 8 + 1024;
};

// S = Q K^T for one 64-row q slab and one key tile, over DP / 16 k steps:
// panel kk / 4, then 32 bytes a k16 step inside it.
template <int DP, int BQ, int BKV>
__device__ inline void scores(float (&sc)[BKV / 2], const uint8_t* q,
                              const uint8_t* k) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t dq = hopper::desc_sw128(
        q + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024);
    const uint64_t dk = hopper::desc_sw128(
        k + (kk / 4) * BKV * 128 + (kk % 4) * 32, 16, 1024);
    if constexpr (BKV == 128)
      hopper::wgmma_ss128<0>(sc, dq, dk, kk > 0);
    else
      hopper::wgmma_ss64<0>(sc, dq, dk, kk > 0);
  }
}

// acc += P V for one key tile and DW columns of v (MN-major, panels of
// BKV rows), P from registers.
template <int DW, int BKV>
__device__ inline void pv(float (&acc)[DW / 2],
                          const uint32_t (&pa)[BKV / 16][4],
                          const uint8_t* v) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(v + kk * 16 * 128, BKV * 128, 1024);
    if constexpr (DW == 64)
      hopper::wgmma_rs64(acc, pa[kk], dv, 1);
    else
      hopper::wgmma_rs128(acc, pa[kk], dv, 1);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ out, int HQ, int HKV, int S,
                   int T_len, int D, int causal, int window, float scale_log2,
                   int q_offset) {
  using Tl = Tiles<DP>;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, DW = Tl::DW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* sq = smem;                 // PANELS x (BQ rows x 128 B)
  // 2 stages x (k, v) x PANELS x (BKV rows x 128 B)
  uint8_t* skv = smem + Tl::Q_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + 4 * Tl::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;   // 2 stages
  uint64_t* empty = bars + 3;  // 2 stages

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const int q_row0 = qt * BQ;

  // Key tiles the masks let through for any row of this query tile.
  const int q_first = q_offset + q_row0;
  const int q_last = q_offset + min(q_row0 + BQ, S) - 1;
  int k_end = T_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_first - window + 1);
  const int kt_begin = k_begin / BKV;
  const int kt_end = k_end > 0 ? (k_end + BKV - 1) / BKV : 0;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, Tl::Q_BYTES);
#pragma unroll
      for (int p = 0; p < Tl::PANELS; ++p)
        hopper::tma_load_3d(sq + p * BQ * 128, &map_q, q_full, p * PANEL,
                            q_row0, b * HQ + h);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1;
        hopper::mbar_wait(&empty[s], ((i >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * Tl::KV_BYTES);
        uint8_t* ks = skv + s * 2 * Tl::KV_BYTES;
        uint8_t* vs = ks + Tl::KV_BYTES;
        const int k0 = (kt_begin + i) * BKV;
#pragma unroll
        for (int p = 0; p < Tl::PANELS; ++p) {
          hopper::tma_load_3d(ks + p * BKV * 128, &map_k, &full[s], p * PANEL,
                              k0, b * HKV + hk);
          hopper::tma_load_3d(vs + p * BKV * 128, &map_v, &full[s], p * PANEL,
                              k0, b * HKV + hk);
        }
      }
    }
  } else {
    const int c = threadIdx.x / 128;  // consumer warpgroup: 0 or 1
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, l = tid % 32;
    // This warpgroup's rows and columns of the tile.
    const int row0 = Tl::SPLIT_D ? 0 : c * 64;
    const int col0 = Tl::SPLIT_D ? c * DW : 0;
    // This thread's two rows (absolute positions) and its first key column.
    const int r_lo = q_row0 + row0 + w * 16 + l / 4;
    const int pos_lo = q_offset + r_lo, pos_hi = pos_lo + 8;
    const int col = 2 * (l % 4);
    // Rows of this warpgroup, for deciding which tiles need the masks.
    const int wg_first = q_offset + q_row0 + row0;
    const int wg_last = wg_first + 63;
    const uint8_t* q = sq + row0 * 128;

    float acc[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;
    float m_lo = -1e30f, m_hi = -1e30f;  // running max, base-2 units
    float l_lo = 0.f, l_hi = 0.f;        // this thread's share of the sum

    hopper::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i & 1;
      const int k0 = (kt_begin + i) * BKV;
      const uint8_t* ks = skv + s * 2 * Tl::KV_BYTES;
      const uint8_t* vs = ks + Tl::KV_BYTES + (col0 / PANEL) * BKV * 128;
      hopper::mbar_wait(&full[s], (i >> 1) & 1);

      float sc[BKV / 2];
      hopper::wgmma_fence();
      scores<DP, BQ, BKV>(sc, q, ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // Masks (only where the tile crosses an edge), then base-2 scores.
      const bool edge = k0 + BKV > T_len ||
                        (causal && k0 + BKV - 1 > wg_first) ||
                        (window > 0 && wg_last - k0 >= window);
      float mx_lo = -1e30f, mx_hi = -1e30f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + col + (e & 1);
            const int qpos = e < 2 ? pos_lo : pos_hi;
            bool ok = kpos < T_len;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && (qpos - kpos) < window;
            x = ok ? x : -1e30f;
          }
          sc[4 * j + e] = x;
          if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
        }
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float new_lo = fmaxf(m_lo, mx_lo), new_hi = fmaxf(m_hi, mx_hi);
      const float alpha_lo = exp2f(m_lo - new_lo);
      const float alpha_hi = exp2f(m_hi - new_hi);
      m_lo = new_lo;
      m_hi = new_hi;

      // p = exp2(s - m): the sum takes it unrounded, P V rounded to bf16.
      uint32_t pa[BKV / 16][4];
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const float p0 = exp2f(sc[4 * j] - new_lo);
        const float p1 = exp2f(sc[4 * j + 1] - new_lo);
        const float p2 = exp2f(sc[4 * j + 2] - new_hi);
        const float p3 = exp2f(sc[4 * j + 3] - new_hi);
        sum_lo += p0 + p1;
        sum_hi += p2 + p3;
        // key group j is half (j % 2) of the k16 step j / 2
        pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p2, p3);
      }
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        acc[4 * j] *= alpha_lo;
        acc[4 * j + 1] *= alpha_lo;
        acc[4 * j + 2] *= alpha_hi;
        acc[4 * j + 3] *= alpha_hi;
      }

      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      pv<DW, BKV>(acc, pa, vs);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::mbar_arrive(&empty[s]);
    }

    // The quad's shares of each row's sum, then out = acc / max(l, 1e-30).
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* ob = out + (static_cast<long long>(b) * HQ + h) * S * D;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const int d = col0 + 8 * j + col;
      if (d >= D) continue;
      if (r_lo < S)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<long long>(r_lo) * D + d) =
            __floats2bfloat162_rn(acc[4 * j] * inv_lo,
                                  acc[4 * j + 1] * inv_lo);
      if (r_lo + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<long long>(r_lo + 8) * D + d) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv_hi,
                                  acc[4 * j + 3] * inv_hi);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int HQ, int HKV, int S, int T_len, int D, int causal, int window,
           float scale, int q_offset, cudaStream_t stream) {
  using Tl = Tiles<DP>;
  alignas(64) CUtensorMap map_q, map_k, map_v;
  const uint64_t dq[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                          static_cast<uint64_t>(B) * HQ};
  const uint64_t sq[2] = {static_cast<uint64_t>(D) * 2,
                          static_cast<uint64_t>(S) * D * 2};
  const uint32_t box_q[3] = {PANEL, Tl::BQ, 1};
  int err = hopper::encode_tensor_map(&map_q, q, 3, dq, sq, box_q);
  if (err != 0) return err;
  const uint64_t dkv[3] = {static_cast<uint64_t>(D),
                           static_cast<uint64_t>(T_len),
                           static_cast<uint64_t>(B) * HKV};
  const uint64_t skv[2] = {static_cast<uint64_t>(D) * 2,
                           static_cast<uint64_t>(T_len) * D * 2};
  const uint32_t box_kv[3] = {PANEL, Tl::BKV, 1};
  err = hopper::encode_tensor_map(&map_k, k, 3, dkv, skv, box_kv);
  if (err != 0) return err;
  err = hopper::encode_tensor_map(&map_v, v, 3, dkv, skv, box_kv);
  if (err != 0) return err;
  auto kernel = flash_wgmma_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + Tl::BQ - 1) / Tl::BQ, HQ, B);
  kernel<<<grid, kThreads, Tl::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), HQ, HKV, S,
      T_len, D, causal, window, scale * kLog2e, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// Route "wgmma": q (B, HQ, S, D), k and v (B, HKV, T, D), out (B, HQ, S, D),
// all bf16, dense and 16-byte aligned; D <= 256 and a multiple of 8; T >= 1;
// HQ a multiple of HKV (the wrapper's `flash_route` checks it).  window <= 0
// means no window.  Returns cudaGetLastError(), or the negated CUresult of
// a tensor map that could not be encoded.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* out, int B, int HQ,
                                     int HKV, int S, int T_len, int D,
                                     int causal, int window, float scale,
                                     int q_offset, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return tc::launch<64>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                          window, scale, q_offset, st);
  if (D <= 128)
    return tc::launch<128>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                           window, scale, q_offset, st);
  return tc::launch<256>(q, k, v, out, B, HQ, HKV, S, T_len, D, causal,
                         window, scale, q_offset, st);
}
