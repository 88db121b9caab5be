// The RWKV-6 WKV recurrence for Hopper (sm_90a).  For each (batch, head),
// with an f32 state S (K x V):
//   o_t = sum_k r_t[k] * (S[k,:] + u[k] * k_t[k] * v_t[:])
//   S  <- w_t[k] * S[k,:] + k_t[k] * v_t[:]
// returning every o_t (in the inputs' type) and the final S (f32), from a
// given initial S.
//
// Replaces the TPU kernel `_wkv6_kernel` / `wkv6_pallas` in
// src/repro/kernels/rwkv6/kernel.py, which keeps the (K x V) state in VMEM
// scratch, runs one (batch, head) a grid row and streams time in chunks
// along a sequential grid axis, with the wrapper padding time with w = 1,
// k = 0.
//
// What bounds it on this card: the function needs 5 K V + 3 K + 2 V flops a
// step and head (the bonus term factors as (sum_k r u k) v; these kernels
// fold it into each element, 7 K V) and the bytes are r, k, v, w read and
// o written once, far below both peaks; what holds it is the recurrence, T
// dependent steps for each of only B x H chains.
//
// Route "fma", the first kernel (`wkv6_kernel`): the layout of the CUDA
// wkv6 kernel that the TPU kernel adapts, the state columns in registers,
// spread over more threads and blocks.  A block of 64 threads owns one
// (batch, head) and 16 value columns (so H = 40 heads of 64 give 160
// blocks); four threads share a column, each keeping a quarter of it (K/4
// state floats, channels k = 4 i + part) in registers for the whole
// sequence, so the state is read once and written once, and the four
// partial outputs of a step are summed by two warp shuffles (each thread's
// own sum runs as two chains).  r, k, w and v of a chunk of 32 steps are
// staged in shared memory, widened to f32; the next chunk's loads are
// issued into registers before the current chunk is computed, so that
// their latency hides behind 32 steps of work.  K is a template bound (16,
// 32 or 64): channels past K stage as 0 and leave their state at 0.  It
// walks all T steps in one block, so it takes the decode step (T = 1) and
// short prompts.
//
// Route "chunk", for T of at least two chunks: the recurrence as a scan
// over chunks of L steps (L = 64 on the main path, chosen by a sweep on an
// H100), three launches, whose critical path is L + T/L + L steps instead
// of T, on B H (T/L) blocks of 128 threads (1,280 at rwkv6-3b's prefill):
//   1. `wkv6_deltas_kernel`, all chunks at once: the state update from a
//      zero state over the chunk, dS_c = sum_s diag(prod_{s<j<=end} w_j)
//      k_s v_s^T, by the first kernel's S = fmaf(w, S, k v) steps, and the
//      chunk's decay product P_c = prod_j w_j (a K-vector, by multiplying).
//   2. `wkv6_carry_kernel`, serial over the T/L chunks, a thread for each
//      (b, h, k, v): S_0 = s0, S_{c+1} = P_c S_c + dS_c, written over dS_c
//      as the state each chunk starts from; the last is the final state.
//      Its traffic, 2 (T/L) K V 4 bytes a head each way (21 MB at L = 64),
//      stays in the 50 MB L2 after pass 1 wrote it.
//   3. `wkv6_outputs_kernel`, all chunks at once: the first kernel's loop
//      over the chunk from S_c (the read with the bonus, the dot with r,
//      the output rounded once to the inputs' type).
// A block owns one (batch, head) and chunk and all its V <= 64 columns:
// thread (group g, part p) keeps the 8 x 4 state floats of channels 8 i + p
// and columns 4 g .. 4 g + 3 in registers, so every shared read of r, k or
// w feeds four columns (with one column a thread, the first kernel's
// layout, these passes took 1.6-1.8x as long on an H100).  The
// eight parts' partial outputs are reduced and scattered by four
// shuffles.  Channels stage part-major ([step][part][i], rows padded by 4
// floats), so that a thread reads its 8 channels of r, k and w as two
// 16-byte loads without bank conflicts; a stage is 16 steps, the next
// stage's loads held in registers, unwidened, while this one is computed.
// No exp, log or division: a decay of exactly 0 gives P_c = 0, a clean
// reset, as the serial recurrence does, and subnormal decays stay products
// (the factored form with exp(-cumulative log decay) overflows f32).  Only
// K, V <= 64 are instanced (channels and columns past them stage as 0).
//
// Rounding: both routes form k_t v_t^T, the state and the read in f32 and
// round only the output to the inputs' type; the chunked route sums the
// same products in another order across chunk boundaries.  The Pallas
// kernel rounds k_t v_t^T to the inputs' type first (bf16 x bf16 -> bf16,
// `kernel.py:41`), and the reference's `wkv6_ref`, which the plain version
// in kernels/rwkv6/ref.py follows, also rounds the read before the dot with
// r (`ref.py:39`).  In f32 they agree.  In bf16 the Pallas kernel's rounding
// of k_t v_t^T, carried in the state over a 2048-step prefill, put outputs
// up to 3.3 times outside the bf16 limit of the f32 plain version
// (chip_smoke.py on an H100); formed in f32, they stay inside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;    // time steps staged at a time
constexpr int kCols = 16;     // value columns a block
constexpr int kParts = 4;     // threads a column
constexpr int kThreads = kCols * kParts;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One chunk's r, k, w (kChunk x KMAX each) and v (kChunk x kCols) in the
// registers of the block's threads: element e of a thread is flat index
// tid + e * kThreads of the chunk, so that neighbouring threads load
// neighbouring addresses.  What lies past T, K or V reads as 0.
template <int KMAX, typename T>
struct Chunk {
  static constexpr int kKeys = kChunk * KMAX / kThreads;
  static constexpr int kVals = kChunk * kCols / kThreads;
  T r[kKeys], k[kKeys], w[kKeys], v[kVals];

  __device__ void load(const T* __restrict__ rp, const T* __restrict__ kp,
                       const T* __restrict__ wp, const T* __restrict__ vp,
                       long long key_base, long long val_base, int t0,
                       int steps, int K, int V, int v0, int tid) {
    const T zero = T(0.0f);
#pragma unroll
    for (int e = 0; e < kKeys; ++e) {
      const int idx = tid + e * kThreads;
      const int tt = idx / KMAX;
      const int c = idx % KMAX;
      const bool in = tt < steps && c < K;
      const long long off = key_base + static_cast<long long>(t0 + tt) * K + c;
      r[e] = in ? rp[off] : zero;
      k[e] = in ? kp[off] : zero;
      w[e] = in ? wp[off] : zero;
    }
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      const int idx = tid + e * kThreads;
      const int tt = idx / kCols;
      const int c = v0 + idx % kCols;
      const bool in = tt < steps && c < V;
      v[e] = in ? vp[val_base + static_cast<long long>(t0 + tt) * V + c]
                : zero;
    }
  }

  __device__ void stage(float (*rs)[KMAX], float (*ks)[KMAX],
                        float (*ws)[KMAX], float (*vs)[kCols], int tid) const {
#pragma unroll
    for (int e = 0; e < kKeys; ++e) {
      const int idx = tid + e * kThreads;
      rs[idx / KMAX][idx % KMAX] = to_float(r[e]);
      ks[idx / KMAX][idx % KMAX] = to_float(k[e]);
      ws[idx / KMAX][idx % KMAX] = to_float(w[e]);
    }
#pragma unroll
    for (int e = 0; e < kVals; ++e) {
      const int idx = tid + e * kThreads;
      vs[idx / kCols][idx % kCols] = to_float(v[e]);
    }
  }
};

template <int KMAX, typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_final, int H,
            int T_len, int K, int V) {
  constexpr int kPer = KMAX / kParts;  // state floats a thread
  __shared__ float rs[kChunk][KMAX];
  __shared__ float ks[kChunk][KMAX];
  __shared__ float ws[kChunk][KMAX];
  __shared__ float vs[kChunk][kCols];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int col = tid / kParts;        // column within the block
  const int part = tid % kParts;       // channels k = kParts * i + part
  const int v0 = blockIdx.y * kCols;
  const int vc = v0 + col;             // the value column
  const bool has_col = vc < V;
  const long long key_base = static_cast<long long>(bh) * T_len * K;
  const long long val_base = static_cast<long long>(bh) * T_len * V;
  const long long state_base = static_cast<long long>(bh) * K * V;

  float S[kPer], uu[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = kParts * i + part;
    const bool in = c < K && has_col;
    S[i] = in ? s0[state_base + static_cast<long long>(c) * V + vc] : 0.f;
    uu[i] = c < K ? u[h * K + c] : 0.f;
  }

  Chunk<KMAX, T> next;
  next.load(r, k, w, v, key_base, val_base, 0, min(kChunk, T_len), K, V, v0,
            tid);
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int steps = min(kChunk, T_len - t0);
    __syncthreads();  // the previous chunk's reads are done
    next.stage(rs, ks, ws, vs, tid);
    __syncthreads();
    if (t0 + kChunk < T_len)
      next.load(r, k, w, v, key_base, val_base, t0 + kChunk,
                min(kChunk, T_len - t0 - kChunk), K, V, v0, tid);

    T* __restrict__ o = out + val_base + static_cast<long long>(t0) * V + vc;
    for (int tt = 0; tt < steps; ++tt) {
      const float vv = vs[tt][col];
      float acc2[2] = {0.f, 0.f};  // two chains of multiply-adds
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = kParts * i + part;
        const float kv = ks[tt][c] * vv;
        acc2[i % 2] = fmaf(rs[tt][c], fmaf(uu[i], kv, S[i]), acc2[i % 2]);
        S[i] = fmaf(ws[tt][c], S[i], kv);
      }
      float acc = acc2[0] + acc2[1];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0 && has_col) store(o + static_cast<long long>(tt) * V, acc);
    }
  }

  if (has_col) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = kParts * i + part;
      if (c < K) s_final[state_base + static_cast<long long>(c) * V + vc] = S[i];
    }
  }
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* s_final, int B, int H, int T_len, int K, int V,
                     cudaStream_t stream) {
  if (K < 1 || K > 64 || V < 1 || V > 64) return cudaErrorInvalidValue;
  const dim3 grid(B * H, (V + kCols - 1) / kCols);
  const auto* rp = static_cast<const T*>(r);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* wp = static_cast<const T*>(w);
  const auto* up = static_cast<const float*>(u);
  const auto* sp = static_cast<const float*>(s0);
  auto* op = static_cast<T*>(out);
  auto* fp = static_cast<float*>(s_final);
  if (K <= 16)
    wkv6_kernel<16, T><<<grid, kThreads, 0, stream>>>(
        rp, kp, vp, wp, up, sp, op, fp, H, T_len, K, V);
  else if (K <= 32)
    wkv6_kernel<32, T><<<grid, kThreads, 0, stream>>>(
        rp, kp, vp, wp, up, sp, op, fp, H, T_len, K, V);
  else
    wkv6_kernel<64, T><<<grid, kThreads, 0, stream>>>(
        rp, kp, vp, wp, up, sp, op, fp, H, T_len, K, V);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "chunk"
// ---------------------------------------------------------------------------

constexpr int kStageC = 16;                   // time steps staged at a time
constexpr int kKeysC = 64;                    // channels (K <= 64)
constexpr int kValsC = 64;                    // value columns (V <= 64)
constexpr int kPartsC = 8;                    // threads sharing a column
constexpr int kPerC = kKeysC / kPartsC;       // channels a thread: 8
constexpr int kColsC = 4;                     // value columns a thread
constexpr int kThreadsC = kPartsC * kValsC / kColsC;  // 128
constexpr int kRowC = kPerC + 4;              // a part's channels, padded
// blocks an SM the two passes are compiled for (at most 128 registers)
constexpr int kMinBlocksC = 4;
// quads (4 consecutive values) of one array a stage, and a thread
constexpr int kQuads = kStageC * kKeysC / 4;
constexpr int kQuadsPer = kQuads / kThreadsC;  // 2
static_assert(kStageC * kValsC / 4 == kQuads, "values stage as keys do");

// Four values of T as loaded, held unwidened until they are staged (so
// that no instruction waits on a load before it must).
template <typename T> struct Raw4;
template <> struct Raw4<float> {
  float4 x;
  __device__ void load(const float* __restrict__ p, bool vec, int valid) {
    if (vec && valid == 4) {
      x = *reinterpret_cast<const float4*>(p);
    } else {
      x.x = valid > 0 ? p[0] : 0.f;
      x.y = valid > 1 ? p[1] : 0.f;
      x.z = valid > 2 ? p[2] : 0.f;
      x.w = valid > 3 ? p[3] : 0.f;
    }
  }
  __device__ float4 widen() const { return x; }
};
template <> struct Raw4<__nv_bfloat16> {
  uint2 x;
  __device__ void load(const __nv_bfloat16* __restrict__ p, bool vec,
                       int valid) {
    if (vec && valid == 4) {
      x = *reinterpret_cast<const uint2*>(p);
    } else {
      const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
      const __nv_bfloat162 lo(valid > 0 ? p[0] : z, valid > 1 ? p[1] : z);
      const __nv_bfloat162 hi(valid > 2 ? p[2] : z, valid > 3 ? p[3] : z);
      x.x = *reinterpret_cast<const unsigned*>(&lo);
      x.y = *reinterpret_cast<const unsigned*>(&hi);
    }
  }
  __device__ float4 widen() const {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// One stage (kStageC steps) of NK key arrays and of v in the registers of
// the block's threads: quad q = tid + e kThreadsC is step q / 16, channels
// (or columns) 4 (q % 16) .. + 3.  Keys stage part-major, xs[tt][part][i]
// for channel c = kPartsC i + part, rows padded, so that a thread reads its
// 8 channels as two 16-byte loads without bank conflicts; values stage as
// vs[tt][column].  Past T, K or V: 0.
template <typename T, int NK>
struct StageC {
  Raw4<T> key[NK][kQuadsPer], val[kQuadsPer];

  __device__ void load(const T* const (&keys)[NK], const T* __restrict__ v,
                       long long key_base, long long val_base, int t0,
                       int steps, int K, int V, bool vec_k, bool vec_v,
                       int tid) {
#pragma unroll
    for (int e = 0; e < kQuadsPer; ++e) {
      const int q = tid + e * kThreadsC;
      const int tt = q / (kKeysC / 4);
      const int c0 = 4 * (q % (kKeysC / 4));
      const bool in_t = tt < steps;
      const long long t = t0 + tt;
#pragma unroll
      for (int a = 0; a < NK; ++a)
        key[a][e].load(keys[a] + key_base + t * K + c0, vec_k,
                       in_t ? min(4, max(0, K - c0)) : 0);
      val[e].load(v + val_base + t * V + c0, vec_v,
                  in_t ? min(4, max(0, V - c0)) : 0);
    }
  }

  __device__ void store(float (*const (&ks)[NK])[kPartsC][kRowC],
                        float (*vs)[kValsC], int tid) const {
#pragma unroll
    for (int e = 0; e < kQuadsPer; ++e) {
      const int q = tid + e * kThreadsC;
      const int tt = q / (kKeysC / 4);
      const int c0 = 4 * (q % (kKeysC / 4));
#pragma unroll
      for (int a = 0; a < NK; ++a) {
        const float4 f = key[a][e].widen();
        const int part = c0 % kPartsC, i = c0 / kPartsC;
        ks[a][tt][part][i] = f.x;
        ks[a][tt][part + 1][i] = f.y;
        ks[a][tt][part + 2][i] = f.z;
        ks[a][tt][part + 3][i] = f.w;
      }
      *reinterpret_cast<float4*>(&vs[tt][c0]) = val[e].widen();
    }
  }
};

__device__ inline float lane(const float4& f, int m) {
  return m == 0 ? f.x : m == 1 ? f.y : m == 2 ? f.z : f.w;
}

// A thread's 8 channels of one staged step, as two 16-byte loads.
__device__ inline void read8(float (*xs)[kPartsC][kRowC], int tt, int part,
                             float (&x)[kPerC]) {
  const float4 a = *reinterpret_cast<const float4*>(&xs[tt][part][0]);
  const float4 b = *reinterpret_cast<const float4*>(&xs[tt][part][4]);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// A block of 128 threads owns one (batch, head) and one chunk, all its
// value columns: thread (group g, part p) keeps the 8 x 4 state floats of
// channels 8 i + p and columns 4 g .. 4 g + 3 in registers, so every
// shared read of r, k or w feeds four columns.
struct ChunkLayout {
  int bh, chunk, tid, group, part, t_begin, t_end;
  long long key_base, val_base, slot;
  __device__ ChunkLayout(int n_chunks, int T_len, int K, int V, int L) {
    bh = blockIdx.x / n_chunks;
    chunk = blockIdx.x % n_chunks;
    tid = threadIdx.x;
    group = tid / kPartsC;
    part = tid % kPartsC;
    t_begin = chunk * L;
    t_end = min(T_len, t_begin + L);
    key_base = static_cast<long long>(bh) * T_len * K;
    val_base = static_cast<long long>(bh) * T_len * V;
    slot = static_cast<long long>(bh) * n_chunks + chunk;
  }
};

// Pass 1: dS_c from a zero state over chunk c, and P_c.  Block (bh, c) of
// grid.x = B H n_chunks.
template <typename T>
__global__ void __launch_bounds__(kThreadsC, kMinBlocksC)
wkv6_deltas_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ w, float* __restrict__ states,
                   float* __restrict__ decays, int T_len, int K, int V,
                   int L, int n_chunks, bool vec_k, bool vec_v) {
  __shared__ __align__(16) float ks[kStageC][kPartsC][kRowC];
  __shared__ __align__(16) float ws[kStageC][kPartsC][kRowC];
  __shared__ __align__(16) float vs[kStageC][kValsC];
  const ChunkLayout at(n_chunks, T_len, K, V, L);
  const T* const keys[2] = {k, w};
  float (*const smem_keys[2])[kPartsC][kRowC] = {ks, ws};

  float S[kPerC][kColsC];
#pragma unroll
  for (int i = 0; i < kPerC; ++i)
#pragma unroll
    for (int m = 0; m < kColsC; ++m) S[i][m] = 0.f;
  float prod = 1.f;  // the decay product of channel tid (tid < 64)

  StageC<T, 2> next;
  next.load(keys, v, at.key_base, at.val_base, at.t_begin,
            min(kStageC, at.t_end - at.t_begin), K, V, vec_k, vec_v, at.tid);
  for (int t0 = at.t_begin; t0 < at.t_end; t0 += kStageC) {
    const int steps = min(kStageC, at.t_end - t0);
    __syncthreads();  // the previous stage's reads are done
    next.store(smem_keys, vs, at.tid);
    __syncthreads();
    if (t0 + kStageC < at.t_end)
      next.load(keys, v, at.key_base, at.val_base, t0 + kStageC,
                min(kStageC, at.t_end - t0 - kStageC), K, V, vec_k, vec_v,
                at.tid);
    for (int tt = 0; tt < steps; ++tt) {
      const float4 vv = *reinterpret_cast<const float4*>(
          &vs[tt][kColsC * at.group]);
      float kk[kPerC], ww[kPerC];
      read8(ks, tt, at.part, kk);
      read8(ws, tt, at.part, ww);
#pragma unroll
      for (int i = 0; i < kPerC; ++i)
#pragma unroll
        for (int m = 0; m < kColsC; ++m)
          S[i][m] = fmaf(ww[i], S[i][m], kk[i] * lane(vv, m));
      prod *= ws[tt][at.tid % kPartsC][(at.tid / kPartsC) % kPerC];
    }
  }

  const int col0 = kColsC * at.group;
#pragma unroll
  for (int i = 0; i < kPerC; ++i) {
    const int c = kPartsC * i + at.part;
    if (c >= K) continue;
    float* row = states + (at.slot * K + c) * V + col0;
    if (vec_v) {
      *reinterpret_cast<float4*>(row) =
          make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
    } else {
#pragma unroll
      for (int m = 0; m < kColsC; ++m)
        if (col0 + m < V) row[m] = S[i][m];
    }
  }
  if (at.tid < K) decays[at.slot * K + at.tid] = prod;
}

// Pass 2: the carried states, one thread a (b, h, k, v), serial over the
// chunks, the next chunks' dS and P loaded ahead of the chain.
constexpr int kCarryThreads = 256;
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kCarryThreads)
wkv6_carry_kernel(const float* __restrict__ s0, float* __restrict__ states,
                  const float* __restrict__ decays,
                  float* __restrict__ s_final, long long BH, int K, int V,
                  int n_chunks) {
  const long long kv_n = static_cast<long long>(K) * V;
  const long long e = static_cast<long long>(blockIdx.x) * kCarryThreads
                      + threadIdx.x;
  if (e >= BH * kv_n) return;
  const long long bh = e / kv_n;
  const long long rem = e % kv_n;
  float* __restrict__ st = states + bh * n_chunks * kv_n + rem;
  const float* __restrict__ dc = decays + bh * n_chunks * K + rem / V;
  float S = s0[e];
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float d[kAhead], p[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < n_chunks) {
        d[j] = st[(c0 + j) * kv_n];
        p[j] = dc[static_cast<long long>(c0 + j) * K];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < n_chunks) {
        st[(c0 + j) * kv_n] = S;  // the state chunk c0 + j starts from
        S = fmaf(p[j], S, d[j]);
      }
    }
  }
  s_final[e] = S;
}

// Pass 3: the outputs of chunk c from S_c, by the first kernel's steps.
// The eight parts' partial sums of a thread's four columns are reduced and
// scattered by four shuffles, so that parts 2 m and 2 m + 1 hold column
// 4 g + m, which the first of them stores.
template <typename T>
__global__ void __launch_bounds__(kThreadsC, kMinBlocksC)
wkv6_outputs_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ states, T* __restrict__ out,
                    int H, int T_len, int K, int V, int L, int n_chunks,
                    bool vec_k, bool vec_v) {
  __shared__ __align__(16) float rs[kStageC][kPartsC][kRowC];
  __shared__ __align__(16) float ks[kStageC][kPartsC][kRowC];
  __shared__ __align__(16) float ws[kStageC][kPartsC][kRowC];
  __shared__ __align__(16) float vs[kStageC][kValsC];
  const ChunkLayout at(n_chunks, T_len, K, V, L);
  const int h = at.bh % H;
  const T* const keys[3] = {r, k, w};
  float (*const smem_keys[3])[kPartsC][kRowC] = {rs, ks, ws};

  const int col0 = kColsC * at.group;
  float S[kPerC][kColsC], uu[kPerC];
#pragma unroll
  for (int i = 0; i < kPerC; ++i) {
    const int c = kPartsC * i + at.part;
    uu[i] = c < K ? u[h * K + c] : 0.f;
    const float* row = states + (at.slot * K + c) * V + col0;
    if (c < K && vec_v) {
      const float4 f = *reinterpret_cast<const float4*>(row);
      S[i][0] = f.x; S[i][1] = f.y; S[i][2] = f.z; S[i][3] = f.w;
    } else {
#pragma unroll
      for (int m = 0; m < kColsC; ++m)
        S[i][m] = c < K && col0 + m < V ? row[m] : 0.f;
    }
  }
  const bool hi4 = at.part & 4, hi2 = at.part & 2;
  const int my_col = col0 + (at.part >> 1);  // the column it may store
  const bool stores = !(at.part & 1) && my_col < V;

  StageC<T, 3> next;
  next.load(keys, v, at.key_base, at.val_base, at.t_begin,
            min(kStageC, at.t_end - at.t_begin), K, V, vec_k, vec_v, at.tid);
  for (int t0 = at.t_begin; t0 < at.t_end; t0 += kStageC) {
    const int steps = min(kStageC, at.t_end - t0);
    __syncthreads();  // the previous stage's reads are done
    next.store(smem_keys, vs, at.tid);
    __syncthreads();
    if (t0 + kStageC < at.t_end)
      next.load(keys, v, at.key_base, at.val_base, t0 + kStageC,
                min(kStageC, at.t_end - t0 - kStageC), K, V, vec_k, vec_v,
                at.tid);

    T* __restrict__ o =
        out + at.val_base + static_cast<long long>(t0) * V + my_col;
    for (int tt = 0; tt < steps; ++tt) {
      const float4 vv = *reinterpret_cast<const float4*>(&vs[tt][col0]);
      float rr[kPerC], kk[kPerC], ww[kPerC];
      read8(rs, tt, at.part, rr);
      read8(ks, tt, at.part, kk);
      read8(ws, tt, at.part, ww);
      float acc[kColsC][2];  // two chains of multiply-adds a column
#pragma unroll
      for (int m = 0; m < kColsC; ++m) acc[m][0] = acc[m][1] = 0.f;
#pragma unroll
      for (int i = 0; i < kPerC; ++i)
#pragma unroll
        for (int m = 0; m < kColsC; ++m) {
          const float kv = kk[i] * lane(vv, m);
          acc[m][i % 2] = fmaf(rr[i], fmaf(uu[i], kv, S[i][m]), acc[m][i % 2]);
          S[i][m] = fmaf(ww[i], S[i][m], kv);
        }
      float a[kColsC];
#pragma unroll
      for (int m = 0; m < kColsC; ++m) a[m] = acc[m][0] + acc[m][1];
      // Across parts p ^ 4: keep columns {0, 1} (p & 4 clear) or {2, 3}.
      const float s0 = hi4 ? a[0] : a[2], s1 = hi4 ? a[1] : a[3];
      float k0 = hi4 ? a[2] : a[0], k1 = hi4 ? a[3] : a[1];
      k0 += __shfl_xor_sync(0xffffffffu, s0, 4);
      k1 += __shfl_xor_sync(0xffffffffu, s1, 4);
      // Across parts p ^ 2: keep column (p & 4) / 2 + (p & 2) / 2.
      float mine = hi2 ? k1 : k0;
      mine += __shfl_xor_sync(0xffffffffu, hi2 ? k0 : k1, 2);
      // Across parts p ^ 1: both hold the column's sum.
      mine += __shfl_xor_sync(0xffffffffu, mine, 1);
      if (stores) store(o + static_cast<long long>(tt) * V, mine);
    }
  }
}

template <typename T>
cudaError_t dispatch_chunk(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* out, void* s_final, void* states,
                           void* decays, int B, int H, int T_len, int K,
                           int V, int L, cudaStream_t stream) {
  if (K < 1 || K > kKeysC || V < 1 || V > kValsC || L < 1 || T_len < 1)
    return cudaErrorInvalidValue;
  const int n_chunks = (T_len + L - 1) / L;
  const long long bh = static_cast<long long>(B) * H;
  if (bh * n_chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* rp = static_cast<const T*>(r);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* wp = static_cast<const T*>(w);
  auto* sp = static_cast<float*>(states);
  auto* dp = static_cast<float*>(decays);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec_k = K == kKeysC && aligned(r) && aligned(k) && aligned(w);
  const bool vec_v = V == kValsC && aligned(v);
  const dim3 grid(static_cast<unsigned>(bh * n_chunks));
  wkv6_deltas_kernel<T><<<grid, kThreadsC, 0, stream>>>(
      kp, vp, wp, sp, dp, T_len, K, V, L, n_chunks, vec_k, vec_v);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long cells = bh * K * V;
  wkv6_carry_kernel<<<static_cast<unsigned>(
                          (cells + kCarryThreads - 1) / kCarryThreads),
                      kCarryThreads, 0, stream>>>(
      static_cast<const float*>(s0), sp, dp, static_cast<float*>(s_final),
      bh, K, V, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wkv6_outputs_kernel<T><<<grid, kThreadsC, 0, stream>>>(
      rp, kp, vp, wp, static_cast<const float*>(u), sp,
      static_cast<T*>(out), H, T_len, K, V, L, n_chunks, vec_k, vec_v);
  return cudaGetLastError();
}

}  // namespace

// r, k, w: (B, H, T, K); v, out: (B, H, T, V), all of one type (0 = float32,
// 1 = bfloat16), dense; u: (H, K) f32; s0, s_final: (B, H, K, V) f32.
// K and V at most 64.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a K, V or type code the kernel does not take.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* out, void* s_final, int B, int H, int T_len,
                        int K, int V, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = dispatch<float>(r, k, v, w, u, s0, out, s_final, B, H, T_len, K, V,
                        st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_final, B, H, T_len,
                                K, V, st);
  return static_cast<int>(e);
}

// Route "chunk": the arguments of wkv6_fwd, and scratch: states (B, H,
// ceil(T / L), K, V) f32 (the chunks' dS, then the states they start
// from) and decays (B, H, ceil(T / L), K) f32; L the chunk length.
// Three launches on the stream; returns the first error.
extern "C" int wkv6_chunk_fwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* out, void* s_final, void* states,
                              void* decays, int B, int H, int T_len, int K,
                              int V, int L, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = dispatch_chunk<float>(r, k, v, w, u, s0, out, s_final, states, decays,
                              B, H, T_len, K, V, L, st);
  else if (dtype == 1)
    e = dispatch_chunk<__nv_bfloat16>(r, k, v, w, u, s0, out, s_final,
                                      states, decays, B, H, T_len, K, V, L,
                                      st);
  return static_cast<int>(e);
}
