// Single-token (decode) attention against a KV cache for Hopper (sm_90a):
// one query token per (batch, query head), masked at kv_len[b], with the
// output and the log-sum-exp m + log l of every head, by two routes.
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
// kv_len, and about latency: at 8 slots the whole cache of an MQA model is a
// few MB, microseconds at the memory's rate.  The wrapper
// (kernels/decode_attention/kernel.py, `decode_route`) picks the route
// before the launch from dtype, shape and alignment alone.  Both routes
// split the keys over `splits` blocks of whole tiles (flash-decode), since
// batch x kv heads can be too few blocks for 132 SMs (8 for gemma's MQA at
// 8 slots) while the rows' lengths differ: each block keeps its own running
// max m, sum l and f32 accumulator, and a second small kernel combines the
// splits by their m and l.  With one split the first kernel writes the
// result itself.  A row with kv_len 0 gives zeros (the reference gives no
// useful number there either) and lse = -1e30.  Keys past kv_len add exactly
// 0 in the reference, so neither route reads them.
//
// "mma" -- bf16, D a multiple of 16, the group's heads padded to 16, 32 or
// 64 rows times D at most 4096.  A block of 4 warps takes one (batch, kv
// head, split) and the group's query heads on the tensor cores: the
// queries, padded with zero rows, are the A operand of mma.sync m16n8k16
// (bf16 in, f32 sums), each warp takes 16 keys of a 64-key tile, S = Q K^T
// over the k16 steps of D and P V over its 16 keys.  The cache streams
// through a ring of 2 (D > 128) or 3 tiles of K and V in shared memory,
// filled by 16-byte cp.async copies (keys past the split's end or kv_len
// zero-filled, not read), so the next tiles are in flight while a tile is
// computed; one __syncthreads() a tile.  Each warp keeps its own online
// softmax in base 2 on the accumulator fragments (row max and sum by quad
// shuffles), rounds p to bf16 as the A operand of P V, which is the
// rounding the reference makes, and sums l from the unrounded p.  At the
// end the four warps' (m, l, acc) are combined through shared memory, each
// warp's weight exp(m_w - M) taken once a row.  A second kernel combines
// the splits, one block a query head, each split's weight taken once a row
// too.  (Combining them in the last block of a (batch, kv head) to finish,
// found by an atomic ticket, was slower at the MQA shapes, where one block
// did the work of 8-10 rows, and no faster at phi3-mini's.)
//
// "fma" -- everything else (f32, and bf16 the tensor cores' route does not
// take), the first version.  A block of 128 threads takes one (batch, kv
// head, split) and all `group` query heads of it, as the TPU kernel does,
// and streams the cache in tiles of 64 keys through shared memory with
// 16-byte loads (12 of them in flight a thread for D = 96 in bf16),
// stopping at kv_len[b]; it takes its tiles one after another (load, sync,
// compute).  In a tile, two threads take a key and dot it with the group's
// queries (f32 products of widened values, summed in f32, then scaled;
// -1e30 past kv_len as in the reference); one warp a head takes the tile's
// max and sum by shuffles; for bf16 inputs p is rounded to bf16 before P.V,
// as the reference does; the threads then own (head, column) outputs of
// P.V.
//
// Both routes write the output as acc / max(l, 1e-30) in q's type and lse =
// m + log(max(l, 1e-30)) in f32.  Build without --use_fast_math.  The
// combine kernels and route "mma"'s warp-level products and four-warp
// combine live in decode_attention.cuh, shared with the kernels on the int8
// cache (decode_attention_int8.cu).

#include "decode_attention.cuh"

namespace {

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
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine_fma<T>(part_acc, part_m, part_l, out, lse, B * HKV * G,
                        splits, D, stream);
}


// --- route "mma" ------------------------------------------------------------

namespace mma {

template <int MT, int STAGES>
inline size_t smem_bytes(int D) {
  const size_t rows = 16 * MT, rb = row_bytes(D);
  const size_t ring = STAGES * 2 * BT * rb;
  const size_t warps = finish_bytes(rows, D);
  return rows * rb + (ring > warps ? ring : warps);
}

template <int MT, int DMAX, int STAGES>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ kv_len,
                  bf16* __restrict__ out, float* __restrict__ lse,
                  float* __restrict__ part_acc, float* __restrict__ part_m,
                  float* __restrict__ part_l, int HKV, int G, int T_len,
                  int D, int tiles_per_split, float scale_log2) {
  constexpr int ROWS = 16 * MT;
  constexpr int NT = DMAX / 8;  // n8 tiles of the output, at most
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int HQ = HKV * G;
  const int rb = row_bytes(D);
  const int chunks = D / 8;  // 16-byte chunks a row
  const int stage_bytes = 2 * BT * rb;

  extern __shared__ float4 smem4[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* ring = Qs + ROWS * rb;

  const long long head0 = static_cast<long long>(b) * HQ + hk * G;
  const long long kv0 = (static_cast<long long>(b) * HKV + hk) * T_len * D;
  const bf16* kb = k + kv0;
  const bf16* vb = v + kv0;
  const int end = min(max(kv_len[b], 0), T_len);
  const int t_begin = split * tiles_per_split * BT;
  const int t_stop = min(end, t_begin + tiles_per_split * BT);
  const int n_tiles = t_stop > t_begin ? (t_stop - t_begin + BT - 1) / BT : 0;

  if (n_tiles > 0) {
    // The queries, rows past the group zero-filled: part of the first group.
    for (int idx = tid; idx < ROWS * chunks; idx += kThreads) {
      const int r = idx / chunks, c = idx % chunks;
      hopper::cp_async16(Qs + r * rb + c * 16,
                         q + (head0 + min(r, G - 1)) * D + c * 8, r < G);
    }
    auto load_tile = [&](int i) {
      const int t0 = t_begin + i * BT;
      uint8_t* ks = ring + (i % STAGES) * stage_bytes;
      uint8_t* vs = ks + BT * rb;
      for (int idx = tid; idx < BT * chunks; idx += kThreads) {
        const int r = idx / chunks, c = idx % chunks;
        const bool ok = t0 + r < t_stop;
        const long long off =
            static_cast<long long>(ok ? t0 + r : t_begin) * D + c * 8;
        hopper::cp_async16(ks + r * rb + c * 16, kb + off, ok);
        hopper::cp_async16(vs + r * rb + c * 16, vb + off, ok);
      }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n_tiles) load_tile(i);
      hopper::cp_async_commit();
    }

    float acc[MT][NT][4];
    float m_run[MT][2], l_run[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_run[mt][h] = kNegInf;
        l_run[mt][h] = 0.f;
      }
    }

    for (int i = 0; i < n_tiles; ++i) {
      hopper::cp_async_wait<STAGES - 2>();
      __syncthreads();  // tile i is in; every warp is done with tile i - 1
      if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1);
      hopper::cp_async_commit();

      const int key0 = t_begin + i * BT + warp * 16;
      if (key0 >= t_stop) continue;  // no key of this warp in the tile
      const uint8_t* ks = ring + (i % STAGES) * stage_bytes + warp * 16 * rb;
      const uint8_t* vs = ks + BT * rb;

      float s[MT][2][4];
      warp_scores<MT, DMAX>(s, Qs, ks, rb, D, lane);

      // Online softmax in base 2, rows l/4 (h = 0) and l/4 + 8 (h = 1) of
      // each m16 tile; the quad's four lanes hold a row's 16 scores.
      uint32_t pf[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + n * 8 + 2 * (lane & 3) + (e & 1);
            s[mt][n][e] = key < t_stop ? s[mt][n][e] * scale_log2 : kNegInf;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = fmaxf(fmaxf(s[mt][0][2 * h], s[mt][0][2 * h + 1]),
                           fmaxf(s[mt][1][2 * h], s[mt][1][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[mt][h], mx);
          const float alpha = exp2f(m_run[mt][h] - m_new);
          m_run[mt][h] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              s[mt][n][e] = exp2f(s[mt][n][e] - m_new);
              sum += s[mt][n][e];
            }
          l_run[mt][h] = l_run[mt][h] * alpha + sum;  // this lane's part
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[mt][j][2 * h] *= alpha;
            acc[mt][j][2 * h + 1] *= alpha;
          }
        }
        pf[mt][0] = hopper::pack_bf16(s[mt][0][0], s[mt][0][1]);
        pf[mt][1] = hopper::pack_bf16(s[mt][0][2], s[mt][0][3]);
        pf[mt][2] = hopper::pack_bf16(s[mt][1][0], s[mt][1][1]);
        pf[mt][3] = hopper::pack_bf16(s[mt][1][2], s[mt][1][3]);
      }

      warp_pv<MT, DMAX>(acc, pf, vs, rb, D, lane);
    }

    finish_warps<MT, NT>(acc, m_run, l_run, ring, G, D, head0, split,
                         splits, out, lse, part_acc, part_m, part_l);
  } else if (splits == 1) {
    empty_rows(G, D, head0, out, lse);
  }
}

template <int MT, int DMAX, int STAGES>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* lse, void* part_acc, void* part_m, void* part_l,
           int B, int HKV, int G, int T_len, int D, int splits,
           int tiles_per_split, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<MT, STAGES>(D);
  auto kernel = decode_mma_kernel<MT, DMAX, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * 1.4426950408889634f;
  kernel<<<dim3(splits, HKV, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(kv_len),
      static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), HKV, G, T_len, D, tiles_per_split,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return combine_mma(part_acc, part_m, part_l, kv_len, out, lse, B, HKV * G,
                     T_len, splits, tiles_per_split, D, stream);
}

}  // namespace mma

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

// Route "mma": q (B, HKV * G, D), k and v (B, HKV, T, D), out like q: bf16,
// dense, 16-byte aligned; D a multiple of 16, G <= 64, and the group padded
// to 16, 32 or 64 rows times D at most 4096 (the wrapper's `decode_route`
// checks all of it); kv_len (B,) int32; lse (B, HKV * G) f32.  With
// splits > 1, part_acc, part_m and part_l are scratch as for
// decode_attention_fwd (m in base 2 here).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape no instance takes.
extern "C" int decode_attention_mma(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* out, void* lse, void* part_acc,
                                    void* part_m, void* part_l, int B,
                                    int HKV, int G, int T_len, int D,
                                    int splits, int tiles_per_split,
                                    float scale, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         void*, void*, void*, void*, void*, int, int, int,
                         int, int, int, int, float, cudaStream_t);
  // One instance a group of up to 16, 32 or 64 rows and a head dim class,
  // the accumulator (rows x DMAX f32 over 128 threads) at most 128
  // registers a thread; a ring of 2 tiles at D > 128, else 3.
  const int mt = (G + 15) / 16;
  Launch fn = nullptr;
  if (D > 0 && D % 16 == 0 && G > 0) {
    if (mt == 1 && D <= 64) fn = &mma::launch<1, 64, 3>;
    else if (mt == 1 && D <= 128) fn = &mma::launch<1, 128, 3>;
    else if (mt == 1 && D <= 256) fn = &mma::launch<1, 256, 2>;
    else if (mt == 2 && D <= 64) fn = &mma::launch<2, 64, 3>;
    else if (mt == 2 && D <= 128) fn = &mma::launch<2, 128, 3>;
    else if (mt <= 4 && D <= 64) fn = &mma::launch<4, 64, 3>;
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, kv_len, out, lse, part_acc, part_m, part_l, B, HKV, G,
            T_len, D, splits, tiles_per_split, scale,
            static_cast<cudaStream_t>(stream));
}
