// Black-Scholes call and put prices for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bs_kernel` / `black_scholes_pallas` in
// src/repro/kernels/black_scholes/kernel.py, which prices one (8, 128)-tiled
// block of options per grid step after the wrapper has padded n with ones.
//
// On an H100 the function is bound by bytes: three f32 inputs read once and
// two f32 outputs written once, 20 bytes an option, against some 100
// arithmetic operations an option (erff, logf, expf, sqrtf included), far
// below the card's operations-to-bytes ratio.  Design: a fixed grid of
// blocks walks the options (grid-stride), with 16-byte streaming loads and
// stores (`__ldcs`/`__stcs`: each byte is touched once, so it should not
// displace anything in L2) where all five buffers are 16-byte aligned, and a
// scalar loop for the remainder.  Nothing is padded: the loops stop at n.
//
// The arithmetic follows the Pallas kernel's order, erf(d * 0.70710678...)
// included, with the accurate erff/logf/expf/sqrtf (no fast math) and
// round-to-nearest intrinsics that keep the compiler from contracting
// products and sums into fused multiply-adds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;

// mu = riskfree + volatility^2 / 2 and neg_r = -riskfree, formed on the host.
__device__ __forceinline__ void price_one(float s, float k, float t, float mu,
                                          float vol, float neg_r, float& call,
                                          float& put) {
  const float sqrt_t = sqrtf(t);
  const float vol_sqrt_t = __fmul_rn(vol, sqrt_t);
  const float d1 = __fdiv_rn(__fadd_rn(logf(__fdiv_rn(s, k)), __fmul_rn(mu, t)),
                             vol_sqrt_t);
  const float d2 = __fsub_rn(d1, vol_sqrt_t);
  const float cnd1 = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(d1, kInvSqrt2))));
  const float cnd2 = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(d2, kInvSqrt2))));
  const float k_exp_rt = __fmul_rn(k, expf(__fmul_rn(neg_r, t)));
  call = __fsub_rn(__fmul_rn(s, cnd1), __fmul_rn(k_exp_rt, cnd2));
  put = __fsub_rn(__fmul_rn(k_exp_rt, __fsub_rn(1.0f, cnd2)),
                  __fmul_rn(s, __fsub_rn(1.0f, cnd1)));
}

__global__ void __launch_bounds__(kThreads)
black_scholes_kernel(const float* __restrict__ price,
                     const float* __restrict__ strike,
                     const float* __restrict__ years, float* __restrict__ call,
                     float* __restrict__ put, long long n, float mu, float vol,
                     float neg_r, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(price);
    const float4* k4 = reinterpret_cast<const float4*>(strike);
    const float4* t4 = reinterpret_cast<const float4*>(years);
    float4* c4 = reinterpret_cast<float4*>(call);
    float4* p4 = reinterpret_cast<float4*>(put);
    for (long long i = tid; i < n4; i += stride) {
      const float4 s = __ldcs(s4 + i);
      const float4 k = __ldcs(k4 + i);
      const float4 t = __ldcs(t4 + i);
      float4 c, p;
      price_one(s.x, k.x, t.x, mu, vol, neg_r, c.x, p.x);
      price_one(s.y, k.y, t.y, mu, vol, neg_r, c.y, p.y);
      price_one(s.z, k.z, t.z, mu, vol, neg_r, c.z, p.z);
      price_one(s.w, k.w, t.w, mu, vol, neg_r, c.w, p.w);
      __stcs(c4 + i, c);
      __stcs(p4 + i, p);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float c, p;
    price_one(price[i], strike[i], years[i], mu, vol, neg_r, c, p);
    call[i] = c;
    put[i] = p;
  }
}

}  // namespace

// price, strike, years, call, put: (n,) f32, dense; vec != 0 only when all
// five are 16-byte aligned.  Returns cudaGetLastError().
extern "C" int black_scholes_f32(const void* price, const void* strike,
                                 const void* years, void* call, void* put,
                                 long long n, float mu, float vol, float neg_r,
                                 int vec, int grid, void* stream) {
  black_scholes_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(price), static_cast<const float*>(strike),
      static_cast<const float*>(years), static_cast<float*>(call),
      static_cast<float*>(put), n, mu, vol, neg_r, vec);
  return static_cast<int>(cudaGetLastError());
}
