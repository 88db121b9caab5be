// Single-token (decode) attention on an int8 KV cache for Hopper (sm_90a):
// one query token per (batch, query head), masked at kv_len[b], with the
// output and the log-sum-exp m + log l of every head, by three routes:
// "gemv" in csrc/decode_attention_int8_gemv.cu, "mma" and "fma" here.
//
// Replaces no `pallas_call`: the reference has no Pallas kernel for this.
// It is the counterpart of the reference's XLA-fused
// `decode_attention_quant` (src/repro/models/attention.py), which exists to
// read the cache once, in int8: quantization is per-token symmetric, so the
// scales factor out of both dots,
//
//     logits[t] = k_s[t] * scale * (q . k_q[t])        t < kv_len[b]
//     out       = sum_t (p[t] * v_s[t]) * v_q[t]
//
// and XLA fuses the int8 -> bf16 converts into the two einsums.  The port's
// plain version (kernels/decode_attention/ref.py) upcasts the whole cache
// to bf16 and then f32 on every call; this kernel is what reads it as the
// reference does.
//
// On an H100 it is bound by bytes: int8 K and V up to kv_len, their f32
// scales (one a key each), q and the output, against about 4 * D flops a
// key and query head.  So the design is decode attention's
// (csrc/decode_attention.cu) with half its bytes: the same split of the
// keys over blocks of whole 64-key tiles (flash-decode, the wrapper's
// `split_plan`), the same combine of the splits by their m and l
// (csrc/decode_attention.cuh), no key at or past kv_len read.  A row with
// kv_len 0 gives zeros and lse = -1e30.
//
// "mma" -- the bf16 shapes route "gemv" does not take (larger groups, D =
// 80): D a multiple of 16, the group padded to 16, 32 or 64 rows times D
// at most 4096, 16-byte-aligned bases: route "mma" of the bf16 kernel with
// the cache in int8.  A block of 4 warps takes one (batch, kv head,
// split); 16-byte cp.async copies fill a ring of 2 (D > 128) or 3 tiles of
// int8 K and V and 4-byte ones their scales (a rank's run of the cache
// need not start on 16 bytes).  Each warp widens its own 16 keys and
// values of the landed tile to bf16 in a slab of shared memory of its own
// (exact: |x| <= 127; by integer and FADD instructions, `widen_int8x16`,
// not the conversion unit), and the bf16 kernel's fragment loads and
// mma.sync products then run on the slab unchanged: S = Q K^T, each column
// times k_s * scale in base 2, online softmax; p times v_s rounded to bf16
// as the A operand of P V (the reference rounds pv = p * v_s to q's type
// before its second einsum), l summed from the unrounded p without v_s.
// What held it back at a group of 1 is in route "gemv"'s note.
//
// "fma" -- everything else: f32 q, and bf16 shapes the other routes do not
// take (D a multiple of 4).  A block of 128 threads takes one (batch, kv
// head, split) and all `group` query heads, loads each 64-key tile of int8
// K and V in 4-byte words and their scales into shared memory, and works
// as decode attention's route "fma": two threads a key dot it with the
// group's queries in f32 and scale by k_s * scale; one warp a head takes
// the tile's max and sum; p * v_s (rounded to bf16 for bf16 q) times v_q
// for the (head, column) outputs each thread owns.
//
// Every route writes the output as acc / max(l, 1e-30) in q's type and lse
// = m + log(max(l, 1e-30)) in f32.  Build without --use_fast_math.

#include "decode_attention.cuh"

namespace {

// The byte `j` of `w` as a signed value.
__device__ __forceinline__ float int8_at(uint32_t w, int j) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * j)) >> 24);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                   const float* __restrict__ k_s,
                   const int8_t* __restrict__ v,
                   const float* __restrict__ v_s,
                   const int* __restrict__ kv_len, T* __restrict__ out,
                   float* __restrict__ lse, float* __restrict__ part_acc,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int HKV, int G, int T_len, int D, int tiles_per_split,
                   float scale) {
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int HQ = HKV * G;
  const int GD = G * D;
  const int tid = threadIdx.x;
  const int words = D / 4;         // 4-byte words of an int8 row
  const int k_stride = words + 1;  // padded: keys in other banks

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (G, D)
  float* Ss = Qs + GD;                          // (G, BT)
  float* m_s = Ss + G * BT;                     // (G,)
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* ksc = a_s + G;   // (BT,) k_s * scale of the tile's keys
  float* vsc = ksc + BT;  // (BT,) v_s
  uint32_t* Kw = reinterpret_cast<uint32_t*>(vsc + BT);  // (BT, k_stride)
  uint32_t* Vw = Kw + BT * k_stride;                     // (BT, words)
  const int8_t* Vt = reinterpret_cast<const int8_t*>(Vw);

  const long long head0 = static_cast<long long>(b) * HQ + hk * G;
  const long long kv0 = (static_cast<long long>(b) * HKV + hk) * T_len;
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k + kv0 * D);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v + kv0 * D);
  const float* ksb = k_s + kv0;
  const float* vsb = v_s + kv0;
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

  const int key = tid >> 1, half = tid & 1;
  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = t_begin; t0 < t_stop; t0 += BT) {
    const int n_valid = min(BT, t_stop - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BT * words; idx += kThreads) {
      const int r = idx / words, c = idx % words;
      uint32_t kr = 0u, vr = 0u;
      if (r < n_valid) {
        const long long off = static_cast<long long>(t0 + r) * words + c;
        kr = kb[off];
        vr = vb[off];
      }
      Kw[r * k_stride + c] = kr;
      Vw[r * words + c] = vr;
    }
    if (tid < BT) {
      const bool ok = tid < n_valid;
      ksc[tid] = ok ? ksb[t0 + tid] * scale : 0.f;
      vsc[tid] = ok ? vsb[t0 + tid] : 0.f;
    }
    __syncthreads();

    // Scores: two threads a key, each over every other word of the row.
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
      for (int c = half; c < words; c += 2) {
        const uint32_t w = Kw[key * k_stride + c];
        const float* qg = Qs + g * D + c * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) part = fmaf(qg[e], int8_at(w, e), part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0)
        Ss[g * BT + key] = key < n_valid ? part * ksc[key] : kNegInf;
    }
    __syncthreads();

    // Online softmax: one warp a head, two keys a lane; the value scales
    // go into p before its rounding, l takes p without them.
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
      Ss[g * BT + lane] = round_p<T>(p0 * vsc[lane]);
      Ss[g * BT + lane + 32] = round_p<T>(p1 * vsc[lane + 32]);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + (p v_s) v_q for the (head, column) outputs of
    // this thread.
#pragma unroll
    for (int j = 0; j < OMAX; ++j) {
      if (j >= n_out) break;
      const int o = tid + j * kThreads;
      if (o < GD) {
        const int g = o / D, d = o % D;
        const float* p = Ss + g * BT;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int t = 0;
        for (; t + 4 <= n_valid; t += 4) {
          a0 = fmaf(p[t], static_cast<float>(Vt[t * D + d]), a0);
          a1 = fmaf(p[t + 1], static_cast<float>(Vt[(t + 1) * D + d]), a1);
          a2 = fmaf(p[t + 2], static_cast<float>(Vt[(t + 2) * D + d]), a2);
          a3 = fmaf(p[t + 3], static_cast<float>(Vt[(t + 3) * D + d]), a3);
        }
        for (; t < n_valid; ++t)
          a0 = fmaf(p[t], static_cast<float>(Vt[t * D + d]), a0);
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
int launch(const void* q, const void* k, const void* k_s, const void* v,
           const void* v_s, const void* kv_len, void* out, void* lse,
           void* part_acc, void* part_m, void* part_l, int B, int HKV, int G,
           int T_len, int D, int splits, int tiles_per_split, float scale,
           cudaStream_t stream) {
  const size_t head =
      align16(sizeof(float) * (G * D + G * BT + 3 * G + 2 * BT));
  const size_t smem = head + sizeof(uint32_t) * BT * (2 * (D / 4) + 1);
  auto kernel = decode_int8_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, HKV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(k_s), static_cast<const int8_t*>(v),
      static_cast<const float*>(v_s), static_cast<const int*>(kv_len),
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

static_assert(kThreads == 2 * BT, "one scale a thread: k_s, then v_s");

// Bytes of one stage of the ring: the int8 K tile and V tile (BT rows of D
// bytes each), then their scales (BT f32 each).
__host__ __device__ inline int int8_stage_bytes(int D) {
  return 2 * BT * D + 2 * BT * static_cast<int>(sizeof(float));
}

// Shared memory of a block: the queries (16 MT padded rows of bf16), then
// the ring of STAGES stages, then each warp's slab of its 16 keys and 16
// values widened to bf16; after the loop the ring and the slabs hold the
// four warps' m, l, weights and accumulators.
template <int MT, int STAGES>
inline size_t int8_smem_bytes(int D) {
  const size_t rows = 16 * MT, rb = row_bytes(D);
  const size_t ring = STAGES * static_cast<size_t>(int8_stage_bytes(D))
                      + kWarps * 2 * 16 * rb;
  const size_t warps = finish_bytes(rows, D);
  return rows * rb + (ring > warps ? ring : warps);
}

// 16 int8 values widened to bf16, 32 bytes at `dst`, without the
// conversion unit (16 conversions a clock an SM on Hopper, against 64 for
// PRMT and LOP3 and 128 for FADD): each byte, offset to unsigned (x ^ 0x80
// = x + 128), goes into the low byte of 2^23's mantissa, so that its f32 is
// 2^23 + 128 + x, and one subtraction leaves x exactly.  |x| <= 127 has at
// most 7 significant bits, so the low half of that f32 is zero and its
// high half is x's bf16: two high halves make a bf16 pair.
__device__ __forceinline__ void widen_int8x16(const uint4& raw,
                                              uint8_t* dst) {
  const uint32_t r[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __float_as_uint(
          __uint_as_float(__byte_perm(r[i], 0x4B000000u, 0x7650 + j))
          - 8388736.f);
    w[2 * i] = __byte_perm(f[0], f[1], 0x7632);
    w[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 16) = make_uint4(w[4], w[5], w[6], w[7]);
}

template <int MT, int DMAX, int STAGES>
__global__ void __launch_bounds__(kThreads)
decode_int8_mma_kernel(const bf16* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const float* __restrict__ k_s,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ v_s,
                       const int* __restrict__ kv_len,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_m,
                       float* __restrict__ part_l, int HKV, int G, int T_len,
                       int D, int tiles_per_split, float scale_log2) {
  constexpr int ROWS = 16 * MT;
  constexpr int NT = DMAX / 8;  // n8 tiles of the output, at most
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int HQ = HKV * G;
  const int rb = row_bytes(D);
  const int q_chunks = D / 8;   // 16-byte chunks of a bf16 row
  const int c_chunks = D / 16;  // 16-byte chunks of an int8 row
  const int stage_bytes = int8_stage_bytes(D);

  extern __shared__ float4 smem4[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* ring = Qs + ROWS * rb;
  uint8_t* kw = ring + STAGES * stage_bytes + warp * 2 * 16 * rb;
  uint8_t* vw = kw + 16 * rb;  // this warp's slabs: keys, values in bf16

  const long long head0 = static_cast<long long>(b) * HQ + hk * G;
  const long long kv0 = (static_cast<long long>(b) * HKV + hk) * T_len;
  const int8_t* kb = k + kv0 * D;
  const int8_t* vb = v + kv0 * D;
  const float* ksb = k_s + kv0;
  const float* vsb = v_s + kv0;
  const int end = min(max(kv_len[b], 0), T_len);
  const int t_begin = split * tiles_per_split * BT;
  const int t_stop = min(end, t_begin + tiles_per_split * BT);
  const int n_tiles = t_stop > t_begin ? (t_stop - t_begin + BT - 1) / BT : 0;

  if (n_tiles > 0) {
    // The queries, rows past the group zero-filled: part of the first group.
    for (int idx = tid; idx < ROWS * q_chunks; idx += kThreads) {
      const int r = idx / q_chunks, c = idx % q_chunks;
      hopper::cp_async16(Qs + r * rb + c * 16,
                         q + (head0 + min(r, G - 1)) * D + c * 8, r < G);
    }
    auto load_tile = [&](int i) {
      const int t0 = t_begin + i * BT;
      uint8_t* ks = ring + (i % STAGES) * stage_bytes;
      uint8_t* vs = ks + BT * D;
      float* scales = reinterpret_cast<float*>(vs + BT * D);
      for (int idx = tid; idx < BT * c_chunks; idx += kThreads) {
        const int r = idx / c_chunks, c = idx % c_chunks;
        const bool ok = t0 + r < t_stop;
        const long long off =
            static_cast<long long>(ok ? t0 + r : t_begin) * D + c * 16;
        hopper::cp_async16(ks + r * D + c * 16, kb + off, ok);
        hopper::cp_async16(vs + r * D + c * 16, vb + off, ok);
      }
      // one scale a thread: the keys' for the first BT threads, the
      // values' for the rest
      const int r = tid % BT;
      const bool ok = t0 + r < t_stop;
      hopper::cp_async4(scales + tid, (tid < BT ? ksb : vsb)
                                          + (ok ? t0 + r : t_begin), ok);
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
      const uint8_t* ks = ring + (i % STAGES) * stage_bytes;
      const uint8_t* vs = ks + BT * D;
      const float* kss = reinterpret_cast<const float*>(vs + BT * D)
                         + warp * 16;
      const float* vss = kss + BT;

      // The warp's 16 keys and values into its slabs, in bf16.
      for (int idx = lane; idx < 16 * c_chunks; idx += 32) {
        const int r = idx / c_chunks, c = idx % c_chunks;
        const int at = (warp * 16 + r) * D + c * 16;
        widen_int8x16(*reinterpret_cast<const uint4*>(ks + at),
                      kw + r * rb + c * 32);
        widen_int8x16(*reinterpret_cast<const uint4*>(vs + at),
                      vw + r * rb + c * 32);
      }
      __syncwarp();
      // The scales of this lane's keys n * 8 + 2 (l % 4) + j, read from
      // shared memory where they are used (held in registers across the
      // products, they spill at D = 256).
      const float* ksl = kss + 2 * (lane & 3);
      const float* vsl = vss + 2 * (lane & 3);

      float s[MT][2][4];
      warp_scores<MT, DMAX>(s, Qs, kw, rb, D, lane);

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
            const float ks_log2 = ksl[n * 8 + (e & 1)] * scale_log2;
            s[mt][n][e] = key < t_stop ? s[mt][n][e] * ks_log2 : kNegInf;
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
        // p v_s, rounded to bf16: the A operand of P V
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float v0 = vsl[n * 8], v1 = vsl[n * 8 + 1];
          pf[mt][2 * n] = hopper::pack_bf16(s[mt][n][0] * v0,
                                            s[mt][n][1] * v1);
          pf[mt][2 * n + 1] = hopper::pack_bf16(s[mt][n][2] * v0,
                                                s[mt][n][3] * v1);
        }
      }

      warp_pv<MT, DMAX>(acc, pf, vw, rb, D, lane);
    }

    finish_warps<MT, NT>(acc, m_run, l_run, ring, G, D, head0, split,
                         splits, out, lse, part_acc, part_m, part_l);
  } else if (splits == 1) {
    empty_rows(G, D, head0, out, lse);
  }
}

template <int MT, int DMAX, int STAGES>
int launch(const void* q, const void* k, const void* k_s, const void* v,
           const void* v_s, const void* kv_len, void* out, void* lse,
           void* part_acc, void* part_m, void* part_l, int B, int HKV, int G,
           int T_len, int D, int splits, int tiles_per_split, float scale,
           cudaStream_t stream) {
  const size_t smem = int8_smem_bytes<MT, STAGES>(D);
  auto kernel = decode_int8_mma_kernel<MT, DMAX, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * 1.4426950408889634f;
  kernel<<<dim3(splits, HKV, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(k_s), static_cast<const int8_t*>(v),
      static_cast<const float*>(v_s), static_cast<const int*>(kv_len),
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

// Route "fma": q (B, HKV * G, D) of one type (dtype 0 = f32, 1 = bf16),
// out like q; k and v (B, HKV, T, D) int8, 4-byte aligned, D a multiple of
// 4; k_s and v_s (B, HKV, T) f32; kv_len (B,) int32; lse (B, HKV * G) f32;
// all dense.  G * D <= 4096, G <= 64.  With splits > 1, part_acc (B * HKV *
// G, splits, D), part_m and part_l (B * HKV * G, splits) f32 are scratch,
// and split s covers the keys of tiles [s * tiles_per_split, (s + 1) *
// tiles_per_split) of 64.  Returns cudaGetLastError() (or the error of
// setting the shared memory).
extern "C" int decode_attention_int8_fwd(
    const void* q, const void* k, const void* k_s, const void* v,
    const void* v_s, const void* kv_len, void* out, void* lse, void* part_acc,
    void* part_m, void* part_l, int B, int HKV, int G, int T_len, int D,
    int splits, int tiles_per_split, float scale, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, k_s, v, v_s, kv_len, out, lse, part_acc,
                         part_m, part_l, B, HKV, G, T_len, D, splits,
                         tiles_per_split, scale, st);
  return launch<__nv_bfloat16>(q, k, k_s, v, v_s, kv_len, out, lse, part_acc,
                               part_m, part_l, B, HKV, G, T_len, D, splits,
                               tiles_per_split, scale, st);
}

// Route "mma": q (B, HKV * G, D) bf16, out like q; k and v (B, HKV, T, D)
// int8; k_s and v_s (B, HKV, T) f32; all dense, q, k and v 16-byte aligned;
// D a multiple of 16, G <= 64, and the group padded to 16, 32 or 64 rows
// times D at most 4096 (the wrapper's `decode_quant_route` checks all of
// it); kv_len (B,) int32; lse (B, HKV * G) f32.  With splits > 1, part_acc,
// part_m and part_l are scratch as for decode_attention_int8_fwd (m in base
// 2 here).  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape no instance takes.
extern "C" int decode_attention_int8_mma(
    const void* q, const void* k, const void* k_s, const void* v,
    const void* v_s, const void* kv_len, void* out, void* lse, void* part_acc,
    void* part_m, void* part_l, int B, int HKV, int G, int T_len, int D,
    int splits, int tiles_per_split, float scale, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, void*, void*, void*, void*,
                         void*, int, int, int, int, int, int, int, float,
                         cudaStream_t);
  // The bf16 kernel's instances: a group of up to 16, 32 or 64 rows and a
  // head dim class; a ring of 2 tiles at D > 128, else 3.
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
  return fn(q, k, k_s, v, v_s, kv_len, out, lse, part_acc, part_m, part_l, B,
            HKV, G, T_len, D, splits, tiles_per_split, scale,
            static_cast<cudaStream_t>(stream));
}
