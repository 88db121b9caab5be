// Single-token (decode) attention against a KV cache for Hopper (sm_90a):
// one query token per (batch, query head), masked at kv_len[b], with the
// output and the log-sum-exp m + log l of every head.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_pallas` in
// src/repro/kernels/decode_attention/kernel.py, which runs one program per
// (batch, kv head) over a sequential grid axis of 512-key cache blocks, all
// `group` query heads of that kv head together, with the running max,
// denominator and accumulator in VMEM scratch; its wrapper pads T, and every
// block is read whatever kv_len says.
//
// On an H100 decode attention is bound by bytes: the cache's K and V up to
// kv_len are read once, against about 4 * D flops a key and query head.  So
// the design is about reading the cache at full rate and no further than
// kv_len.  A block of 128 threads takes one (batch, kv head) and all `group`
// query heads of it, as the TPU kernel does, and streams the cache in tiles
// of 64 keys through shared memory with 16-byte loads (12 of them in flight
// a thread for D = 96 in bf16), stopping at kv_len[b]: keys beyond it add
// exactly 0 in the reference, so they are not read.  A block takes its tiles
// one after another (load, sync, compute), and batch x kv heads can be too
// few blocks for 132 SMs (8 for gemma's MQA at 8 slots) while the rows'
// lengths differ, so the keys are also split over `splits` blocks of whole
// tiles (flash-decode; the wrapper aims at 16 blocks an SM, which on an H100
// took phi3-mini's decode shape from 0.176 ms in one split to 0.059 ms):
// each block keeps its own running max m, sum l and f32 accumulator, and a
// second small kernel combines the splits by their m and l.  With one split
// the first kernel writes the result itself.
// In a tile, two threads take a key and dot it with the group's queries
// (f32 products of widened values, summed in f32, then scaled; -1e30 past
// kv_len as in the reference); one warp a head takes the tile's max and sum
// by shuffles; for bf16 inputs p is rounded to bf16 before P.V, as the
// reference does; the threads then own (head, column) outputs of P.V.  The
// output is acc / max(l, 1e-30) in q's type and lse = m + log(max(l, 1e-30))
// in f32.  A row with kv_len 0 gives zeros (the reference gives no useful
// number there either).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int BT = 64;     // keys per tile (two threads a key)
constexpr int OMAX = 32;   // outputs a thread owns: group * D <= 4096
constexpr float kNegInf = -1e30f;

__device__ inline void widen16(const uint4& raw, const float*, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(&raw);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ inline void widen16(const uint4& raw, const __nv_bfloat16*,
                               float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

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

__device__ inline size_t align16(size_t bytes) { return (bytes + 15) & ~15; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ part_acc,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l, int HKV, int G, int T_len,
                        int D, int tiles_per_split, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int HQ = HKV * G;
  const int GD = G * D;
  const int tid = threadIdx.x;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int k_stride = row_bytes + 16;  // padded: keys in other banks

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* Qs = reinterpret_cast<float*>(base);             // (G, D)
  float* Ss = Qs + GD;                                    // (G, BT)
  float* m_s = Ss + G * BT;                               // (G,)
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  char* Kb = base + align16(sizeof(float) * (GD + G * BT + 3 * G));
  char* Vb = Kb + BT * k_stride;

  const long long head0 = static_cast<long long>(b) * HQ + hk * G;
  const T* kb = k + (static_cast<long long>(b) * HKV + hk) * T_len * D;
  const T* vb = v + (static_cast<long long>(b) * HKV + hk) * T_len * D;
  const int end = min(max(kv_len[b], 0), T_len);
  const int t_begin = split * tiles_per_split * BT;
  const int t_stop = min(end, t_begin + tiles_per_split * BT);

  for (int i = tid; i < GD; i += kThreads)
    Qs[i] = to_float(q[head0 * D + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int n_out = (GD + kThreads - 1) / kThreads;
  float acc[OMAX];
#pragma unroll
  for (int j = 0; j < OMAX; ++j) acc[j] = 0.f;

  const int per_row = D / VEC;
  const int key = tid >> 1, half = tid & 1;
  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = t_begin; t0 < t_stop; t0 += BT) {
    const int n_valid = min(BT, t_stop - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BT * per_row; idx += kThreads) {
      const int r = idx / per_row, c = idx % per_row;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (r < n_valid) {
        const long long off = static_cast<long long>(t0 + r) * D + c * VEC;
        kr = *reinterpret_cast<const uint4*>(kb + off);
        vr = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Kb + r * k_stride + c * 16) = kr;
      *reinterpret_cast<uint4*>(Vb + r * row_bytes + c * 16) = vr;
    }
    __syncthreads();

    // Scores: two threads a key, each over every other 16-byte chunk.
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
      for (int c = half; c < per_row; c += 2) {
        float kf[VEC];
        widen16(*reinterpret_cast<const uint4*>(Kb + key * k_stride + c * 16),
                static_cast<const T*>(nullptr), kf);
        const float* qg = Qs + g * D + c * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qg[e], kf[e], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) Ss[g * BT + key] = key < n_valid ? part * scale : kNegInf;
    }
    __syncthreads();

    // Online softmax: one warp a head, two keys a lane.
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = Ss[g * BT + lane], s1 = Ss[g * BT + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[g * BT + lane] = round_p<T>(p0);
      Ss[g * BT + lane + 32] = round_p<T>(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for the (head, column) outputs of this thread.
    const T* Vt = reinterpret_cast<const T*>(Vb);
#pragma unroll
    for (int j = 0; j < OMAX; ++j) {
      if (j >= n_out) break;
      const int o = tid + j * kThreads;
      if (o < GD) {
        const int g = o / D, d = o % D;
        const float* p = Ss + g * BT;
        // Four partial sums, so that the shared-memory loads of the next
        // keys issue while a sum waits on its multiply-add.
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int t = 0;
        for (; t + 4 <= n_valid; t += 4) {
          a0 = fmaf(p[t], to_float(Vt[t * D + d]), a0);
          a1 = fmaf(p[t + 1], to_float(Vt[(t + 1) * D + d]), a1);
          a2 = fmaf(p[t + 2], to_float(Vt[(t + 2) * D + d]), a2);
          a3 = fmaf(p[t + 3], to_float(Vt[(t + 3) * D + d]), a3);
        }
        for (; t < n_valid; ++t) a0 = fmaf(p[t], to_float(Vt[t * D + d]), a0);
        acc[j] = acc[j] * a_s[g] + ((a0 + a1) + (a2 + a3));
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < OMAX; ++j) {
    if (j >= n_out) break;
    const int o = tid + j * kThreads;
    if (o < GD) {
      const int g = o / D, d = o % D;
      if (splits == 1) {
        store_out(out + head0 * D + o, acc[j] / fmaxf(l_s[g], 1e-30f));
      } else {
        part_acc[((head0 + g) * splits + split) * D + d] = acc[j];
      }
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    if (splits == 1) {
      lse[head0 + g] = m_s[g] + logf(fmaxf(l_s[g], 1e-30f));
    } else {
      part_m[(head0 + g) * splits + split] = m_s[g];
      part_l[(head0 + g) * splits + split] = l_s[g];
    }
  }
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* lse, void* part_acc, void* part_m, void* part_l,
           int B, int HKV, int G, int T_len, int D, int splits,
           int tiles_per_split, float scale, cudaStream_t stream) {
  const size_t head = (sizeof(float) * (G * D + G * BT + 3 * G) + 15) & ~15;
  const size_t smem = head + BT * (D * sizeof(T) + 16) + BT * D * sizeof(T);
  auto kernel = decode_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, HKV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), HKV, G, T_len, D, tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * HKV * G, kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<T*>(out),
      static_cast<float*>(lse), splits, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, HKV * G, D), k and v (B, HKV, T, D), out like q: dense, 16-byte
// aligned, of one type (dtype 0 = f32, 1 = bf16); kv_len (B,) int32; lse
// (B, HKV * G) f32.  D a multiple of 16 / sizeof(type), G * D <= 4096,
// G <= 64.  With splits > 1, part_acc (B * HKV * G, splits, D), part_m and
// part_l (B * HKV * G, splits) f32 are scratch, and split s covers the keys
// of tiles [s * tiles_per_split, (s + 1) * tiles_per_split) of 64.
// Returns cudaGetLastError() (or the error of setting the shared memory).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* out, void* lse, void* part_acc,
                                    void* part_m, void* part_l, int B,
                                    int HKV, int G, int T_len, int D,
                                    int splits, int tiles_per_split,
                                    float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, kv_len, out, lse, part_acc, part_m, part_l,
                         B, HKV, G, T_len, D, splits, tiles_per_split, scale,
                         st);
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, lse, part_acc, part_m,
                               part_l, B, HKV, G, T_len, D, splits,
                               tiles_per_split, scale, st);
}
