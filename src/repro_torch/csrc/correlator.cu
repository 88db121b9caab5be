// The radio-astronomy correlator for Hopper (sm_90a): for every channel c
// and every antenna pair (i, j), V[c,i,j] = sum_t x[c,t,i] * conj(x[c,t,j]),
// with complex samples stored as trailing (re, im) pairs:
//   re: re_i re_j + im_i im_j,   im: im_i re_j - re_i im_j.
//
// Replaces the TPU kernel `_corr_kernel` / `correlate_pallas` in
// src/repro/kernels/correlator/kernel.py, which runs one channel a grid row,
// streams time blocks through VMEM along a sequential grid axis and adds
// four (ant x time)(time x ant) products on the matrix unit into two f32
// scratch accumulators, with the wrapper padding time with zeros.
//
// On an H100 the function is bound by operations: 8 A (A + 1) / 2 T flops a
// channel (four real multiply-adds a pair and sample, over the pairs i <= j:
// V is Hermitian) against 8 bytes a sample read and 8 bytes a pair written;
// this kernel does 8 A^2 T.  Design: the register-tiled antenna-pair scheme
// of the many-core correlator, tiled as csrc/gemm.cu tiles a product.  One
// block of 256 threads owns one channel and a 64 x 64 tile of antenna pairs;
// each thread keeps a 4 x 4 tile of pairs (32 f32 accumulators, re and im)
// in registers.  The block walks time in steps of 16 samples inside the
// block (the sequential grid axis of the TPU kernel becomes this loop): it
// stages both antenna ranges' samples in shared memory, de-interleaved into
// re and im rows, and every thread reads four re and four im values of each
// side as 16-byte broadcast loads, 64 fused multiply-adds for 4 shared loads
// a sample.  The sums are true f32 FMA on the CUDA cores, never TF32 (the
// reference asks for f32 accumulation).  Samples past T or past A load as 0
// and pairs past A are not stored: nothing is padded.  The full A x A matrix
// is computed, as the TPU kernel computes it; its Hermitian half is
// redundant work a later version can skip.  Samples come in f32 or bf16;
// bf16 samples are widened to f32 as they are staged, summed in f32 and
// rounded to bf16 once as they are stored, as the TPU kernel's f32
// accumulators are cast to the samples' type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TA = 64;        // antennas a tile side
constexpr int TT = 16;        // samples a stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 pairs each

// One (re, im) pair of the samples' type, and its widening and rounding.
template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  __device__ static float2 load(float2 x) { return x; }
  __device__ static float2 store(float re, float im) {
    return make_float2(re, im);
  }
};
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ static float2 load(__nv_bfloat162 x) {
    return __bfloat1622float2(x);
  }
  __device__ static __nv_bfloat162 store(float re, float im) {
    return __floats2bfloat162_rn(re, im);
  }
};

template <typename S>
__global__ void __launch_bounds__(kThreads, 2)
correlate_kernel(const typename Pair<S>::type* __restrict__ samples,
                 typename Pair<S>::type* __restrict__ out, int T, int A) {
  using P = Pair<S>;
  __shared__ __align__(16) float re_i[TT][TA];
  __shared__ __align__(16) float im_i[TT][TA];
  __shared__ __align__(16) float re_j[TT][TA];
  __shared__ __align__(16) float im_j[TT][TA];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int j0 = blockIdx.x * TA;
  const int i0 = blockIdx.y * TA;
  const long long c = blockIdx.z;
  const typename P::type* __restrict__ chan = samples + c * T * A;

  float vr[4][4], vi[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) vr[p][q] = vi[p][q] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += TT) {
    // Each side is TT x TA samples: four (re, im) pairs a thread, threads of
    // a warp on neighbouring antennas of one time row.
    float2 si[4], sj[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      const int tt = idx / TA;
      const int a = idx % TA;
      const int t = t0 + tt;
      const bool t_in = t < T;
      const long long row = static_cast<long long>(t) * A;
      si[e] = (t_in && i0 + a < A) ? P::load(chan[row + i0 + a])
                                   : make_float2(0.f, 0.f);
      sj[e] = (t_in && j0 + a < A) ? P::load(chan[row + j0 + a])
                                   : make_float2(0.f, 0.f);
    }
    __syncthreads();  // the previous stage's reads are done
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      const int tt = idx / TA;
      const int a = idx % TA;
      re_i[tt][a] = si[e].x;
      im_i[tt][a] = si[e].y;
      re_j[tt][a] = sj[e].x;
      im_j[tt][a] = sj[e].y;
    }
    __syncthreads();

#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      const float4 ri4 = *reinterpret_cast<const float4*>(&re_i[tt][ty * 4]);
      const float4 ii4 = *reinterpret_cast<const float4*>(&im_i[tt][ty * 4]);
      const float4 rj4 = *reinterpret_cast<const float4*>(&re_j[tt][tx * 4]);
      const float4 ij4 = *reinterpret_cast<const float4*>(&im_j[tt][tx * 4]);
      const float ri[4] = {ri4.x, ri4.y, ri4.z, ri4.w};
      const float ii[4] = {ii4.x, ii4.y, ii4.z, ii4.w};
      const float rj[4] = {rj4.x, rj4.y, rj4.z, rj4.w};
      const float ij[4] = {ij4.x, ij4.y, ij4.z, ij4.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          vr[p][q] = fmaf(ri[p], rj[q], vr[p][q]);
          vr[p][q] = fmaf(ii[p], ij[q], vr[p][q]);
          vi[p][q] = fmaf(ii[p], rj[q], vi[p][q]);
          vi[p][q] = fmaf(-ri[p], ij[q], vi[p][q]);
        }
    }
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
    if (i >= A) continue;
    typename P::type* __restrict__ row = out + (c * A + i) * A;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < A) row[j] = P::store(vr[p][q], vi[p][q]);
    }
  }
}

template <typename S>
int launch(const void* samples, void* out, int C, int T, int A,
           void* stream) {
  using Vec = typename Pair<S>::type;
  const dim3 grid((A + TA - 1) / TA, (A + TA - 1) / TA, C);
  correlate_kernel<S><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec*>(samples), static_cast<Vec*>(out), T, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// samples: (C, T, A, 2), dense, aligned to a (re, im) pair; out: (C, A, A, 2)
// in the samples' type.  C <= 65535.  Returns cudaGetLastError().
extern "C" int correlate_f32(const void* samples, void* out, int C, int T,
                             int A, void* stream) {
  return launch<float>(samples, out, C, T, A, stream);
}

extern "C" int correlate_bf16(const void* samples, void* out, int C, int T,
                              int A, void* stream) {
  return launch<__nv_bfloat16>(samples, out, C, T, A, stream);
}
