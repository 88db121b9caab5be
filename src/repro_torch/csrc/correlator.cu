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
// V is Hermitian) against 8 bytes a sample read and 8 bytes a pair written.
// Both routes use the register-tiled antenna-pair scheme of the many-core
// correlator, tiled as csrc/gemm.cu tiles a product: a block of 256 threads
// owns one channel and a 64 x 64 tile of antenna pairs; each thread keeps a
// 4 x 4 tile of pairs (32 f32 accumulators, re and im) in registers.  The
// block walks time in stages of 16 samples inside the block (the
// sequential grid axis of the TPU kernel becomes this loop): it stages both
// antenna ranges' samples in shared memory, de-interleaved into re and im
// rows, and every thread reads four re and four im values of each side as
// 16-byte broadcast loads, 64 fused multiply-adds for 4 shared loads a
// sample.  The sums are true f32 FMA on the CUDA cores, never TF32 (the
// reference asks for f32 accumulation).  Samples past T or past A load as 0
// and pairs past A are not stored: nothing is padded.  Samples come in f32
// or bf16; bf16 samples are widened to f32 as they are staged, summed in
// f32 and rounded to bf16 once as they are stored, as the TPU kernel's f32
// accumulators are cast to the samples' type.
//
// Route "fma", the first kernel (`correlate_kernel`): a grid of all
// (A/64)^2 tiles a channel, so it computes the full A x A matrix as the TPU
// kernel does; each stage's samples are loaded, then stored to shared
// memory, then summed.
//
// Route "tri" (`correlate_tri_kernel`), for A > 64: a grid of only the
// n (n + 1) / 2 tiles (ti, tj) with ti <= tj, n = ceil(A / 64), 10 of 16 at
// A = 256; the block maps its linear index to (ti, tj).  A block with
// ti < tj also writes tile (tj, ti) as the conjugate transpose of its own:
// staged through shared memory (re and -im, rows padded by one float), then
// stored a row at a time, 16 bytes a thread where A keeps rows 16-byte
// aligned, so every off-diagonal pair is bit-exactly Hermitian.  A diagonal
// tile computes all of its pairs and is stored once.  The next stage's
// samples are loaded into registers (in the samples' type) before the
// current stage's 16 steps of FMAs, so their latency hides behind the sums.

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
  __device__ static float2 zero() { return make_float2(0.f, 0.f); }
  __device__ static float2 load(float2 x) { return x; }
  __device__ static float2 store(float re, float im) {
    return make_float2(re, im);
  }
};
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ static __nv_bfloat162 zero() {
    return __floats2bfloat162_rn(0.f, 0.f);
  }
  __device__ static float2 load(__nv_bfloat162 x) {
    return __bfloat1622float2(x);
  }
  __device__ static __nv_bfloat162 store(float re, float im) {
    return __floats2bfloat162_rn(re, im);
  }
};

// The TT samples of a staged stage: thread (ty, tx)'s 4 x 4 pairs, i from
// the i side's antennas 4 ty .. 4 ty + 3, j from the j side's 4 tx ..
// 4 tx + 3, four real multiply-adds a pair and sample.
__device__ __forceinline__ void stage_sums(float (*re_i)[TA],
                                           float (*im_i)[TA],
                                           float (*re_j)[TA],
                                           float (*im_j)[TA], int tx, int ty,
                                           float (&vr)[4][4],
                                           float (&vi)[4][4]) {
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

// Thread (ty, tx)'s 4 x 4 pairs of the tile at (i0, j0), rounded to the
// samples' type; pairs past A are not stored.
template <typename S>
__device__ __forceinline__ void store_tile(
    typename Pair<S>::type* __restrict__ out, float (&vr)[4][4],
    float (&vi)[4][4], long long c, int A, int i0, int j0, int tx, int ty) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
    if (i >= A) continue;
    typename Pair<S>::type* __restrict__ row = out + (c * A + i) * A;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx * 4 + q;
      if (j < A) row[j] = Pair<S>::store(vr[p][q], vi[p][q]);
    }
  }
}

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

    stage_sums(re_i, im_i, re_j, im_j, tx, ty, vr, vi);
  }

  store_tile<S>(out, vr, vi, c, A, i0, j0, tx, ty);
}

// Route "tri": the tile pair (ti, tj), ti <= tj, of linear index p in
// row-major order over the upper triangle of an n x n grid of tiles.
__device__ inline void tile_pair(int p, int n, int& ti, int& tj) {
  ti = 0;
  while (p >= n - ti) {
    p -= n - ti;
    ++ti;
  }
  tj = ti + p;
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 2)
correlate_tri_kernel(const typename Pair<S>::type* __restrict__ samples,
                     typename Pair<S>::type* __restrict__ out, int T, int A,
                     int n_tiles) {
  using P = Pair<S>;
  using Vec = typename P::type;
  constexpr int kRow = TA + 1;  // the mirrored tile's padded row
  // One buffer: the samples of a stage (4 x TT x TA floats), then, after
  // the time loop, the mirrored tile (re and -im, TA x kRow each).
  __shared__ __align__(16) float smem[2 * TA * kRow];
  float (*re_i)[TA] = reinterpret_cast<float (*)[TA]>(smem);
  float (*im_i)[TA] = reinterpret_cast<float (*)[TA]>(smem + TT * TA);
  float (*re_j)[TA] = reinterpret_cast<float (*)[TA]>(smem + 2 * TT * TA);
  float (*im_j)[TA] = reinterpret_cast<float (*)[TA]>(smem + 3 * TT * TA);

  int ti, tj;
  tile_pair(blockIdx.x, n_tiles, ti, tj);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = ti * TA;
  const int j0 = tj * TA;
  const long long c = blockIdx.y;
  const Vec* __restrict__ chan = samples + c * T * A;

  float vr[4][4], vi[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) vr[p][q] = vi[p][q] = 0.0f;

  // Each side of a stage is TT x TA samples: four pairs a thread, threads
  // of a warp on neighbouring antennas of one time row.  Held in the
  // samples' type until they are staged.
  Vec si[4], sj[4];
  auto load = [&](int t0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      const int t = t0 + idx / TA;
      const int a = idx % TA;
      const bool t_in = t < T;
      const long long row = static_cast<long long>(t) * A;
      const Vec zero = P::zero();
      si[e] = (t_in && i0 + a < A) ? chan[row + i0 + a] : zero;
      sj[e] = (t_in && j0 + a < A) ? chan[row + j0 + a] : zero;
    }
  };

  load(0);
  for (int t0 = 0; t0 < T; t0 += TT) {
    __syncthreads();  // the previous stage's reads are done
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      const int tt = idx / TA;
      const int a = idx % TA;
      const float2 x = P::load(si[e]);
      const float2 y = P::load(sj[e]);
      re_i[tt][a] = x.x;
      im_i[tt][a] = x.y;
      re_j[tt][a] = y.x;
      im_j[tt][a] = y.y;
    }
    __syncthreads();
    if (t0 + TT < T) load(t0 + TT);  // in flight during the sums below

    stage_sums(re_i, im_i, re_j, im_j, tx, ty, vr, vi);
  }

  // The tile (ti, tj) itself, from registers.
  store_tile<S>(out, vr, vi, c, A, i0, j0, tx, ty);
  if (ti == tj) return;

  // The mirror (tj, ti): V[j, i] = conj(V[i, j]).  Tile ti lies wholly
  // inside A (ti < tj), so only its rows j past A are masked.
  float (*mre)[kRow] = reinterpret_cast<float (*)[kRow]>(smem);
  float (*mim)[kRow] = reinterpret_cast<float (*)[kRow]>(smem + TA * kRow);
  __syncthreads();  // the last stage's reads are done
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mre[tx * 4 + q][ty * 4 + p] = vr[p][q];
      mim[tx * 4 + q][ty * 4 + p] = -vi[p][q];
    }
  __syncthreads();
  constexpr int kPerVec = 16 / static_cast<int>(sizeof(Vec));  // pairs
  if ((A * static_cast<int>(sizeof(Vec))) % 16 == 0) {
    // 16 bytes a thread, neighbouring threads on neighbouring addresses.
    constexpr int kVecs = TA / kPerVec;  // a row's 16-byte stores
    for (int e = tid; e < TA * kVecs; e += kThreads) {
      const int jl = e / kVecs;
      const int il = (e % kVecs) * kPerVec;
      if (j0 + jl >= A) continue;
      __align__(16) Vec v[kPerVec];
#pragma unroll
      for (int m = 0; m < kPerVec; ++m)
        v[m] = P::store(mre[jl][il + m], mim[jl][il + m]);
      *reinterpret_cast<uint4*>(out + (c * A + j0 + jl) * A + i0 + il) =
          *reinterpret_cast<const uint4*>(v);
    }
  } else {
    // Rows not 16-byte aligned: a pair a thread, still coalesced.
    for (int e = tid; e < TA * TA; e += kThreads) {
      const int jl = e / TA;
      const int il = e % TA;
      if (j0 + jl < A)
        out[(c * A + j0 + jl) * A + i0 + il] =
            P::store(mre[jl][il], mim[jl][il]);
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

template <typename S>
int launch_tri(const void* samples, void* out, int C, int T, int A,
               int pairs, void* stream) {
  using Vec = typename Pair<S>::type;
  const long long n = (A + TA - 1) / TA;
  if (pairs != n * (n + 1) / 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(pairs, C);
  correlate_tri_kernel<S><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec*>(samples), static_cast<Vec*>(out), T, A,
      static_cast<int>(n));
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

// Route "tri": the same arguments and result, and `pairs`, the wrapper's
// count of tiles with ti <= tj, n (n + 1) / 2 for n = ceil(A / 64).
extern "C" int correlate_tri_f32(const void* samples, void* out, int C,
                                 int T, int A, int pairs, void* stream) {
  return launch_tri<float>(samples, out, C, T, A, pairs, stream);
}

extern "C" int correlate_tri_bf16(const void* samples, void* out, int C,
                                  int T, int A, int pairs, void* stream) {
  return launch_tri<__nv_bfloat16>(samples, out, C, T, A, pairs, stream);
}
