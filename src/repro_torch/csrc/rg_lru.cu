// The RG-LRU linear recurrence of RecurrentGemma for Hopper (sm_90a).  For
// each (batch, channel), sequential in time:
//   a = exp(log_a_t),  h <- a * h + sqrt(max(1 - a^2, 0)) * gx_t
// returning every h (in gx's type) and the final h (f32), from a given h0.
//
// Replaces the TPU kernel `_rg_lru_kernel` / `rg_lru_pallas` in
// src/repro/kernels/rg_lru/kernel.py, which tiles channels in lane-aligned
// blocks of 128 across the grid, keeps the (1, block_d) state in VMEM scratch
// and streams time in chunks along a sequential grid axis, with the wrapper
// padding T and D.
//
// What bounds it on this card: the bytes, log_a and gx read and h written
// once (a few flops an element against 6 or 12 bytes); what holds it is the
// recurrence, T dependent steps for each of B x D chains.  Both routes keep
// the first kernel's arithmetic: accurate expf and sqrtf (no fast-math), and
// the Pallas kernel's order of operations without contraction into fused
// multiply-adds: a * a, 1 - a^2, beta * gx, a * h, and their sum each
// rounded once.  Ragged T and D are masked; nothing is padded.  The lanes of
// a warp sit on neighbouring channels, so every load and store of a time
// step is coalesced over D.
//
// Route "fma", the first kernel (`rg_lru_kernel`): one thread per (batch,
// channel), 32 channels (one warp) a block, so that D = 2560 gives 80
// blocks a batch row, one warp on 80 of the 132 SMs.  The time loop keeps h
// in a register; loads are issued 32 steps ahead (the next group of 32 is
// loaded while the current one is computed).  It takes the decode step
// (T = 1) and short prompts.
//
// Route "chunk", for T of at least three chunks: the recurrence is linear
// in h, so time splits into chunks of L steps (L = 64 on the main path,
// chosen by a sweep on an H100; the wrapper grows L past 64 chunks) and the
// grid holds B x (T / L) x D threads (2,560 warps at recurrentgemma-2b's
// 2048-token prefill, not 80):
//   1. `rg_lru_local_kernel`, all chunks at once: each chunk's scan from
//      h = 0, hloc_c, and the product of its decays in step order,
//      A_c = prod_t a_t (of the rounded a, so that an a that underflows to 0
//      resets the carry cleanly; no exp of summed logs).
//   2. `rg_lru_outputs_kernel`, all chunks at once: the thread of chunk c
//      first carries h0 across the chunks before it,
//      h_in_{c+1} = A_c h_in_c + hloc_c (the product and the sum each
//      rounded once; its loads independent of each other, its chain c steps
//      long), then runs the chunk's scan again from h_in_c, writing every h;
//      the last chunk writes the final h.
// Its critical path is L + T / L + L steps instead of T.  128 channels a
// block; the next 16 steps' loads in flight while 16 are computed, in whole
// groups of 16 with no test on a step, the ragged end step by step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // channels a block
constexpr int kAhead = 32;    // time steps a group

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One step from the decay a = exp(log_a).
__device__ inline float step_a(float h, float a, float gx) {
  const float beta = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(beta, gx));
}

__device__ inline float step(float h, float log_a, float gx) {
  return step_a(h, expf(log_a), gx);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ log_a, const T* __restrict__ gx,
              const float* __restrict__ h0, T* __restrict__ out,
              float* __restrict__ h_final, int T_len, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const long long b = blockIdx.y;
  if (d >= D) return;
  const long long base = b * T_len * D + d;
  const T* __restrict__ la_p = log_a + base;
  const T* __restrict__ gx_p = gx + base;
  T* __restrict__ o_p = out + base;
  float h = h0[b * D + d];

  const int groups = T_len / kAhead;
  float la[kAhead], x[kAhead];
  if (groups > 0) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      la[i] = to_float(la_p[static_cast<long long>(i) * D]);
      x[i] = to_float(gx_p[static_cast<long long>(i) * D]);
    }
  }
  for (int g = 0; g < groups; ++g) {
    const long long t0 = static_cast<long long>(g) * kAhead;
    float la_next[kAhead], x_next[kAhead];
    if (g + 1 < groups) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        la_next[i] = to_float(la_p[(t0 + kAhead + i) * D]);
        x_next[i] = to_float(gx_p[(t0 + kAhead + i) * D]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      h = step(h, la[i], x[i]);
      store(o_p + (t0 + i) * D, h);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      la[i] = la_next[i];
      x[i] = x_next[i];
    }
  }
  for (long long t = static_cast<long long>(groups) * kAhead; t < T_len; ++t) {
    h = step(h, to_float(la_p[t * D]), to_float(gx_p[t * D]));
    store(o_p + t * D, h);
  }
  h_final[b * D + d] = h;
}

// ---------------------------------------------------------------------------
// Route "chunk"
// ---------------------------------------------------------------------------

constexpr int kThreadsC = 128;  // channels a block
constexpr int kAheadC = 16;     // time steps a group, loaded a group ahead

// A channel's steps [t, t_end) from h: whole groups of kAheadC steps, each
// group's loads issued while the group before it is computed, with no test
// on a step; then the last, ragged group step by step.  kWrite: store every
// h at o_p; else multiply each a into prod, in step order.  la_p, gx_p and
// o_p point at step 0 of the channel; D is the step stride.
template <typename T, bool kWrite>
__device__ inline float scan_span(float h, float& prod,
                                  const T* __restrict__ la_p,
                                  const T* __restrict__ gx_p,
                                  T* __restrict__ o_p, long long t,
                                  long long t_end, long long D) {
  const long long whole_end = t + (t_end - t) / kAheadC * kAheadC;
  float la[kAheadC], x[kAheadC];
  if (t < whole_end) {
#pragma unroll
    for (int i = 0; i < kAheadC; ++i) {
      la[i] = to_float(la_p[(t + i) * D]);
      x[i] = to_float(gx_p[(t + i) * D]);
    }
  }
  for (; t < whole_end; t += kAheadC) {
    float la_next[kAheadC], x_next[kAheadC];
    if (t + kAheadC < whole_end) {
#pragma unroll
      for (int i = 0; i < kAheadC; ++i) {
        la_next[i] = to_float(la_p[(t + kAheadC + i) * D]);
        x_next[i] = to_float(gx_p[(t + kAheadC + i) * D]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAheadC; ++i) {
      const float a = expf(la[i]);
      h = step_a(h, a, x[i]);
      if constexpr (kWrite)
        store(o_p + (t + i) * D, h);
      else
        prod = __fmul_rn(prod, a);
    }
#pragma unroll
    for (int i = 0; i < kAheadC; ++i) {
      la[i] = la_next[i];
      x[i] = x_next[i];
    }
  }
  for (; t < t_end; ++t) {
    const float a = expf(to_float(la_p[t * D]));
    h = step_a(h, a, to_float(gx_p[t * D]));
    if constexpr (kWrite)
      store(o_p + t * D, h);
    else
      prod = __fmul_rn(prod, a);
  }
  return h;
}

// Where a thread of a chunked pass works: channel d of batch row b (grid.z)
// in chunk c (grid.y), steps [t_begin, t_end).
struct ChunkAt {
  int d, c;
  long long b, base, t_begin, t_end, slot;
  __device__ ChunkAt(int T_len, int D, int L, int n_chunks) {
    d = blockIdx.x * kThreadsC + threadIdx.x;
    c = blockIdx.y;
    b = blockIdx.z;
    base = b * T_len * D + d;
    t_begin = static_cast<long long>(c) * L;
    t_end = min(static_cast<long long>(T_len), t_begin + L);
    slot = (b * n_chunks + c) * D + d;  // in the (B, n_chunks, D) scratch
  }
};

// Pass 1: each chunk's scan from h = 0 and its decay product.
template <typename T>
__global__ void __launch_bounds__(kThreadsC)
rg_lru_local_kernel(const T* __restrict__ log_a, const T* __restrict__ gx,
                    float* __restrict__ hloc, float* __restrict__ decay,
                    int T_len, int D, int L, int n_chunks) {
  const ChunkAt at(T_len, D, L, n_chunks);
  if (at.d >= D) return;
  float prod = 1.f;
  const float h = scan_span<T, false>(0.f, prod, log_a + at.base,
                                      gx + at.base, nullptr, at.t_begin,
                                      at.t_end, D);
  hloc[at.slot] = h;
  decay[at.slot] = prod;
}

// h_in_{c+1} = A_c h_in_c + hloc_c, rounded as the plain version rounds it.
__device__ inline float carry(float h, float a, float hl) {
  return __fadd_rn(__fmul_rn(a, h), hl);
}

// Pass 2: each chunk's scan from the h it starts from, folded here from h0
// and the aggregates of the chunks before it, writing every h; the last
// chunk writes the final h.
template <typename T>
__global__ void __launch_bounds__(kThreadsC)
rg_lru_outputs_kernel(const T* __restrict__ log_a, const T* __restrict__ gx,
                      const float* __restrict__ h0,
                      const float* __restrict__ hloc,
                      const float* __restrict__ decay, T* __restrict__ out,
                      float* __restrict__ h_final, int T_len, int D, int L,
                      int n_chunks) {
  const ChunkAt at(T_len, D, L, n_chunks);
  if (at.d >= D) return;
  float h = h0[at.b * D + at.d];
  const long long first = at.slot - static_cast<long long>(at.c) * D;
#pragma unroll 8
  for (int c = 0; c < at.c; ++c)
    h = carry(h, decay[first + static_cast<long long>(c) * D],
              hloc[first + static_cast<long long>(c) * D]);
  float unused = 1.f;
  h = scan_span<T, true>(h, unused, log_a + at.base, gx + at.base,
                         out + at.base, at.t_begin, at.t_end, D);
  if (at.c == n_chunks - 1) h_final[at.b * D + at.d] = h;
}

template <typename T>
cudaError_t launch_chunk(const void* log_a, const void* gx, const void* h0,
                         void* out, void* h_final, void* hloc, void* decay,
                         int B, int T_len, int D, int L, cudaStream_t st) {
  if (L < 1 || T_len < 1 || D < 1 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  const int n_chunks = (T_len + L - 1) / L;
  if (n_chunks > 65535) return cudaErrorInvalidValue;
  const auto* la = static_cast<const T*>(log_a);
  const auto* x = static_cast<const T*>(gx);
  const auto* hz = static_cast<const float*>(h0);
  auto* hl = static_cast<float*>(hloc);
  auto* dc = static_cast<float*>(decay);
  const dim3 grid((D + kThreadsC - 1) / kThreadsC, n_chunks, B);
  rg_lru_local_kernel<T><<<grid, kThreadsC, 0, st>>>(la, x, hl, dc, T_len, D,
                                                     L, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rg_lru_outputs_kernel<T><<<grid, kThreadsC, 0, st>>>(
      la, x, hz, hl, dc, static_cast<T*>(out), static_cast<float*>(h_final),
      T_len, D, L, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// log_a, gx, out: (B, T, D) of one type (0 = float32, 1 = bfloat16), dense;
// h0, h_final: (B, D) f32.  B <= 65535.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown type code.
extern "C" int rg_lru_fwd(const void* log_a, const void* gx, const void* h0,
                          void* out, void* h_final, int B, int T_len, int D,
                          int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  if (dtype == 0)
    rg_lru_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(log_a), static_cast<const float*>(gx),
        static_cast<const float*>(h0), static_cast<float*>(out),
        static_cast<float*>(h_final), T_len, D);
  else if (dtype == 1)
    rg_lru_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(log_a),
        static_cast<const __nv_bfloat16*>(gx), static_cast<const float*>(h0),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(h_final), T_len,
        D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Route "chunk": the arguments of rg_lru_fwd, scratch hloc and decay, each
// (B, ceil(T / L), D) f32, and the chunk length L.  B and ceil(T / L) at
// most 65535.  Returns the first error.
extern "C" int rg_lru_chunk_fwd(const void* log_a, const void* gx,
                                const void* h0, void* out, void* h_final,
                                void* hloc, void* decay, int B, int T_len,
                                int D, int L, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = launch_chunk<float>(log_a, gx, h0, out, h_final, hloc, decay, B,
                            T_len, D, L, st);
  else if (dtype == 1)
    e = launch_chunk<__nv_bfloat16>(log_a, gx, h0, out, h_final, hloc, decay,
                                    B, T_len, D, L, st);
  return static_cast<int>(e);
}
