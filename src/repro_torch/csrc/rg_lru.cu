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
// recurrence, T dependent steps for each of B x D chains.  Design: one thread
// per (batch, channel), 32 channels (one warp) a block so that D = 2560 gives
// 80 blocks a batch row; the lanes of the warp on neighbouring channels, so
// every load and store of a time step is coalesced over D.  The time loop
// keeps h in a register; loads are issued 32 steps ahead (the next group of
// 32 is loaded while the current one is computed), so that each chain waits
// on memory once a group and not once a step.  Accurate expf and sqrtf (no
// fast-math), and the Pallas kernel's order of operations without contraction
// into fused multiply-adds: a * a, 1 - a^2, beta * gx, a * h, and their sum
// each rounded once.  Ragged T and D are masked; nothing is padded.

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

__device__ inline float step(float h, float log_a, float gx) {
  const float a = expf(log_a);
  const float beta = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(beta, gx));
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
