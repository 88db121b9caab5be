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
// step and head (the bonus term factors as (sum_k r u k) v; this kernel
// folds it into each element, 7 K V) and the bytes are r, k, v, w read and
// o written once, far below both peaks;
// what holds it is the recurrence, T dependent steps for each of only B x H
// chains.  Design: the layout of the CUDA wkv6 kernel that the TPU kernel
// adapts, the state columns in registers, spread over more threads and
// blocks.  A block of 64 threads owns one (batch, head) and 16 value columns
// (so H = 40 heads of 64 give 160 blocks); four threads share a column, each
// keeping a quarter of it (K/4 state floats, channels k = 4 i + part) in
// registers for the whole sequence, so the state is read once and written
// once, and the four partial outputs of a step are summed by two warp
// shuffles (each thread's own sum runs as two chains).  r, k, w and v of a
// chunk of 32 steps are staged in shared memory, widened to f32; the next
// chunk's loads are issued into registers before the current chunk is
// computed, so that their latency hides behind 32 steps of work.  K is a
// template bound (16, 32 or 64): channels past K stage as 0 and leave their
// state at 0.  Ragged T and V are masked; nothing is padded.
//
// Rounding: the kernel forms k_t v_t^T, the state and the read in f32 and
// rounds only the output to the inputs' type.  The Pallas kernel rounds
// k_t v_t^T to the inputs' type first (bf16 x bf16 -> bf16, `kernel.py:41`),
// and the reference's `wkv6_ref`, which the plain version in
// kernels/rwkv6/ref.py follows, also rounds the read before the dot with r
// (`ref.py:39`).  In f32 the three agree.  In bf16 the Pallas kernel's
// rounding of k_t v_t^T, carried in the state over a 2048-step prefill, put
// outputs up to 3.3 times outside the bf16 limit of the f32 plain version
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
