// Single-token (decode) attention on an int8 KV cache for Hopper (sm_90a),
// route "gemv": a small group's query heads on the CUDA cores.  The
// kernel's other routes, "mma" and "fma", and what the three compute are in
// csrc/decode_attention_int8.cu.
//
// Replaces no `pallas_call`: the counterpart of the reference's XLA-fused
// `decode_attention_quant` (src/repro/models/attention.py).  Bound by
// bytes on an H100: int8 K and V up to kv_len and their f32 scales, read
// once.
//
// It takes bf16 q, D of 64, 128 or 256, at most 4 query heads a kv head,
// 16-byte-aligned bases: qwen1.5-32b's decode (a group of 1).  What held
// route "mma" back there, measured on an H100 (tools/int8_decode_probe.py,
// its variants built from copies of csrc/decode_attention_int8.cu): at
// (8, 40, 40, 2184, 128) it took 0.085 ms against a bound of 0.031; with
// the widening's arithmetic skipped 0.080, the scales skipped 0.084, both
// 0.079, and a ring of 2 tiles, not 3, 0.075 (its 90 KB of shared memory
// a block -- the ring and each warp's two bf16 slabs -- hold 2 blocks, 8
// warps, an SM).  So occupancy first, then the widening through shared
// memory; what stays is the m16 tile's 15 padded rows of 16 at a group of
// 1.  This
// route does no padded work and keeps little in shared memory: a block of
// 4 warps takes one (batch, kv head, split); one thread issues two bulk
// copies (cp.async.bulk, TMA's 1-D form) of a tile's contiguous int8 K and
// V rows into a ring of 3 tiles (4 at D = 64, 2 at 256) and arms the
// stage's mbarrier with their bytes (a ragged last tile copies only its
// rows), the scales come by 4-byte cp.async (a rank's run of them need not
// start on 16 bytes): 51 KB a block at D = 128, 4 blocks an SM.  Each warp
// takes 16 keys of a tile.  Scores: 16 bytes of a key row a lane (8 lanes
// a row at D = 128), widened in registers by PRMT and FADD, dotted with the
// lane's 16 columns of each head's query (f32 in registers for the block),
// reduced over the row's lanes by shuffles, times k_s * scale in base 2.
// Online softmax, 16 lanes a head: p v_s rounded to bf16 (the reference
// rounds pv to q's type), l summed from the unrounded p without v_s.  P V:
// 4 columns of a value row a lane, widened the same way, 4 f32
// accumulators a head.  The four warps combine through shared memory; the
// splits' combine (route "mma"'s, m in base 2) is launched to overlap this
// kernel's tail.  Measured the same way: 0.046 ms (1.5x the bound; with
// its arithmetic skipped 0.042), a rank's run (8, 40, 40, 546, 128) 0.016
// against "mma"'s 0.030.

#include "decode_attention.cuh"

namespace {

namespace gemv {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BT = 64;             // keys a tile, as the other routes
constexpr int KEYS = BT / kWarps;  // a warp's keys of a tile
static_assert(kThreads == 2 * BT, "one scale a thread: k_s, then v_s");
static_assert(kThreads == mma::kThreads, "mma::empty_rows strides by it");

// How a warp's lanes lie on its 16 keys at head dim D.  Scores: 16 bytes
// of a key row a lane, KL lanes a row, KS rows (key slots) at once, KSTEPS
// times.  Softmax: KEYS lanes a head, HP heads a pass.  P V: VC columns a
// lane, VL lanes a row, VS rows at once, VSTEPS times.  The loads read
// consecutive bytes across the warp: no bank conflict.
template <int D>
struct Lanes {
  static constexpr int KL = D / 16;
  static constexpr int KS = 32 / KL;
  static constexpr int KSTEPS = KEYS / KS;
  static constexpr int HP = 32 / KEYS;
  static constexpr int VC = D <= 128 ? 4 : 8;
  static constexpr int VL = D / VC;
  static constexpr int VS = 32 / VL;
  static constexpr int VSTEPS = KEYS / VS;
  static_assert(KL * KS == 32 && KS * KSTEPS == KEYS, "D of 64, 128, 256");
  static_assert(VL * VS == 32 && VS * VSTEPS == KEYS, "D of 64, 128, 256");
};

// Bytes of one stage of the ring: the int8 K tile and V tile (BT rows of D
// bytes each, rows past t_stop left as they were), then their scales (BT
// f32 each, zeros past t_stop).
__host__ __device__ constexpr int stage_bytes(int D) {
  return 2 * BT * D + 2 * BT * static_cast<int>(sizeof(float));
}

// Shared memory of a block: STAGES mbarriers (128 bytes), the ring, then
// each warp's scores of its keys a head (p v_s after the softmax) and each
// head's alpha.  After the loop the ring holds the warps' accumulators, m,
// l and weights.
template <int D, int GH, int STAGES>
constexpr size_t smem_bytes() {
  return 128 + STAGES * static_cast<size_t>(stage_bytes(D))
         + sizeof(float) * kWarps * GH * (KEYS + 1);
}

// 4 int8 values (the bytes of w) widened to f32, exactly, without the
// conversion unit: each byte offset to unsigned (x ^ 0x80 = x + 128) goes
// into the low byte of 2^23's mantissa, so that its f32 is 2^23 + 128 + x,
// and one subtraction leaves x: a PRMT and an FADD a value.
__device__ __forceinline__ void widen_int8x4(uint32_t w, float* f) {
  const uint32_t r = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(r, 0x4B000000u, 0x7650 + j))
           - 8388736.f;
}

// The VC int8 values at `row` (4 or 8 bytes) widened to f32.
template <int VC>
__device__ __forceinline__ void widen_columns(const uint8_t* row, float* f) {
  if constexpr (VC == 4) {
    widen_int8x4(*reinterpret_cast<const uint32_t*>(row), f);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(row);
    widen_int8x4(w.x, f);
    widen_int8x4(w.y, f + 4);
  }
}

// GH heads held: the group's G, rounded up to 1, 2, 4 or 8, so that every
// loop over the heads is unrolled with no branch and their chains
// interleave; the heads past G have zero queries, and nothing of theirs is
// written.  (At least 2 blocks an SM: with that bound ptxas spills no
// instance; with none it spilled 8 bytes at (D, heads) = (128, 2) and (256,
// 4).)
template <int D, int GH, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
decode_int8_gemv_kernel(const bf16* __restrict__ q,
                        const int8_t* __restrict__ k,
                        const float* __restrict__ k_s,
                        const int8_t* __restrict__ v,
                        const float* __restrict__ v_s,
                        const int* __restrict__ kv_len,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_m,
                        float* __restrict__ part_l, int HKV, int G,
                        int T_len, int tiles_per_split, float scale_log2) {
  using L = Lanes<D>;
  constexpr int SB = stage_bytes(D);
  constexpr int NP = (GH + L::HP - 1) / L::HP;  // softmax passes
  static_assert(kWarps * GH * (D + 3) + GH
                    <= STAGES * SB / static_cast<int>(sizeof(float)),
                "the warps' partials fit in the ring");
  // The splits' combine may start once every block has (it waits for this
  // grid's memory before it reads a partial).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long head0 = static_cast<long long>(b) * HKV * G + hk * G;
  const long long kv0 = (static_cast<long long>(b) * HKV + hk) * T_len;
  const int end = min(max(kv_len[b], 0), T_len);
  const int t_begin = split * tiles_per_split * BT;
  const int t_stop = min(end, t_begin + tiles_per_split * BT);
  if (t_stop <= t_begin) {  // no key: no copy issued, no barrier waited on
    if (splits == 1) mma::empty_rows(G, D, head0, out, lse);
    return;
  }
  const int n_tiles = (t_stop - t_begin + BT - 1) / BT;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4) + 128;
  float* sc = reinterpret_cast<float*>(ring + STAGES * SB)
              + warp * GH * KEYS;  // (GH, KEYS) of this warp
  float* al = reinterpret_cast<float*>(ring + STAGES * SB)
              + kWarps * GH * KEYS + warp * GH;

  const int8_t* kb = k + kv0 * D;
  const int8_t* vb = v + kv0 * D;
  const float* ksb = k_s + kv0;
  const float* vsb = v_s + kv0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // Tile i into stage i % STAGES: its K and V rows below t_stop by two bulk
  // copies that one thread issues and the stage's barrier counts (the
  // ragged last tile copies only its rows: nothing at or past kv_len is
  // read), their scales by a 4-byte cp.async a thread of the first 128
  // (zeros past t_stop; a rank's run of the scales need not start on 16
  // bytes).
  auto load_tile = [&](int i) {
    const int t0 = t_begin + i * BT;
    const int n = min(BT, t_stop - t0);
    uint8_t* kt = ring + (i % STAGES) * SB;
    uint8_t* vt = kt + BT * D;
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(n * D);
      uint64_t* bar = &full[i % STAGES];
      hopper::mbar_expect_tx(bar, 2 * bytes);
      hopper::bulk_load(kt, kb + static_cast<long long>(t0) * D, bytes, bar);
      hopper::bulk_load(vt, vb + static_cast<long long>(t0) * D, bytes, bar);
    }
    const int r = tid % BT;
    const bool ok = r < n;
    hopper::cp_async4(reinterpret_cast<float*>(vt + BT * D) + tid,
                      (tid < BT ? ksb : vsb) + (ok ? t0 + r : t_begin), ok);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    hopper::cp_async_commit();
  }

  // This lane's 16 columns of each head's query, in f32 for the block.
  const int kl = lane % L::KL, slot = lane / L::KL;
  float qf[GH][16];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (g < G) {
      const uint4* src =
          reinterpret_cast<const uint4*>(q + (head0 + g) * D + kl * 16);
      lo = src[0];
      hi = src[1];
    }
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qf[g][2 * e] = __uint_as_float(w[e] << 16);
      qf[g][2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }

  // The softmax's lanes: key sk of the warp's KEYS, head HP p + hh in pass
  // p; m and l of a head live in the KEYS lanes of its group.
  const int sk = lane % KEYS, hh = lane / KEYS;
  float m_run[NP], l_run[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    m_run[p] = kNegInf;
    l_run[p] = 0.f;
  }
  const int vl = lane % L::VL, vslot = lane / L::VL;
  float acc[GH][L::VC];
#pragma unroll
  for (int g = 0; g < GH; ++g)
#pragma unroll
    for (int c = 0; c < L::VC; ++c) acc[g][c] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    hopper::cp_async_wait<STAGES - 2>();
    hopper::mbar_wait(&full[st], (i / STAGES) & 1);
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1);
    hopper::cp_async_commit();

    const int key0 = t_begin + i * BT + warp * KEYS;
    if (key0 >= t_stop) continue;  // no key of this warp in the tile
    const uint8_t* kt = ring + st * SB + warp * KEYS * D;
    const uint8_t* vt = kt + BT * D;
    const float* kss = reinterpret_cast<const float*>(ring + st * SB
                                                      + 2 * BT * D)
                       + warp * KEYS;
    const float* vss = kss + BT;

    // Scores: each slot's KL lanes dot 16 columns a lane and reduce, in
    // base 2 with k_s * scale; -1e30 past t_stop.
#pragma unroll
    for (int j = 0; j < L::KSTEPS; ++j) {
      const int r = j * L::KS + slot;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(kt + r * D + kl * 16);
      float kf[16];
      widen_int8x4(raw.x, kf);
      widen_int8x4(raw.y, kf + 4);
      widen_int8x4(raw.z, kf + 8);
      widen_int8x4(raw.w, kf + 12);
      const float ksc = kss[r] * scale_log2;
      const bool ok = key0 + r < t_stop;
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int c = 0; c < 16; c += 2) {
          d0 = fmaf(qf[g][c], kf[c], d0);
          d1 = fmaf(qf[g][c + 1], kf[c + 1], d1);
        }
        float d = d0 + d1;
#pragma unroll
        for (int off = 1; off < L::KL; off <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (kl == 0) sc[g * KEYS + r] = ok ? d * ksc : kNegInf;
      }
    }
    __syncwarp();

    // Online softmax over the warp's keys, HP heads a pass: p v_s rounded
    // to bf16 in place of the score (the reference rounds pv to q's type),
    // l from the unrounded p without v_s, alpha for the rescale.
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int g = L::HP * p + hh;
      const bool on = g < GH;  // a pass may hold fewer heads than HP
      const float s = on ? sc[g * KEYS + sk] : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 1; off < KEYS; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[p], mx);
      const float alpha = exp2f(m_run[p] - m_new);
      m_run[p] = m_new;
      const float e = exp2f(s - m_new);
      float sum = e;
#pragma unroll
      for (int off = 1; off < KEYS; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[p] = l_run[p] * alpha + sum;
      if (on) {
        sc[g * KEYS + sk] = round_p<bf16>(e * vss[sk]);
        if (sk == 0) al[g] = alpha;
      }
    }
    __syncwarp();

    // acc = acc * alpha + (p v_s) v_q over the warp's keys, VC columns a
    // lane.
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      const float a = al[g];
#pragma unroll
      for (int c = 0; c < L::VC; ++c) acc[g][c] *= a;
    }
    if constexpr (L::VS == 1) {
      // every lane on the same key: a head's p v_s of 4 keys in one load
#pragma unroll
      for (int j = 0; j < KEYS; j += 4) {
        float vf[4][L::VC];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          widen_columns<L::VC>(vt + (j + e) * D + vl * L::VC, vf[e]);
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          const float4 p4 = *reinterpret_cast<const float4*>(sc + g * KEYS
                                                             + j);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < L::VC; ++c)
              acc[g][c] = fmaf(pv[e], vf[e][c], acc[g][c]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < L::VSTEPS; ++j) {
        const int r = j * L::VS + vslot;
        float vf[L::VC];
        widen_columns<L::VC>(vt + r * D + vl * L::VC, vf);
#pragma unroll
        for (int g = 0; g < GH; ++g) {
          const float pv = sc[g * KEYS + r];
#pragma unroll
          for (int c = 0; c < L::VC; ++c)
            acc[g][c] = fmaf(pv, vf[c], acc[g][c]);
        }
      }
    }
  }

  // The warp's accumulators summed over its key slots of P V (D = 64).
  if constexpr (L::VS > 1) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
#pragma unroll
      for (int c = 0; c < L::VC; ++c)
#pragma unroll
        for (int off = L::VL; off < 32; off <<= 1)
          acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], off);
    }
  }

  // The warps combined through the ring (free once every copy has landed
  // and every warp is past its last tile), each warp's weight exp2(m_w -
  // M) taken once a head: the output and lse (one split) or the split's
  // partials (m in base 2, as route "mma"'s combine takes them).
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* Os = reinterpret_cast<float*>(ring);  // (kWarps, GH, D)
  float* wm = Os + kWarps * GH * D;               // (kWarps, GH)
  float* wl = wm + kWarps * GH;
  float* wt = wl + kWarps * GH;
  float* Ls = wt + kWarps * GH;  // the combined l a head
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int g = L::HP * p + hh;
    if (g < G && sk == 0) {
      wm[warp * GH + g] = m_run[p];
      wl[warp * GH + g] = l_run[p];
    }
  }
  if (vslot == 0) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int c = 0; c < L::VC; ++c)
        Os[(warp * GH + g) * D + vl * L::VC + c] = acc[g][c];
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * GH + g]);
    float Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = exp2f(wm[w * GH + g] - M);
      wt[w * GH + g] = wgt;
      Lsum = fmaf(wl[w * GH + g], wgt, Lsum);
    }
    Ls[g] = Lsum;
    if (splits == 1) {
      lse[head0 + g] = M * mma::kLn2 + logf(fmaxf(Lsum, 1e-30f));
    } else {
      part_m[(head0 + g) * splits + split] = M;
      part_l[(head0 + g) * splits + split] = Lsum;
    }
  }
  __syncthreads();
  for (int o = tid; o < G * D; o += kThreads) {
    const int g = o / D, d = o % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum = fmaf(Os[(w * GH + g) * D + d], wt[w * GH + g], sum);
    if (splits == 1)
      out[head0 * D + o] = __float2bfloat16(sum / fmaxf(Ls[g], 1e-30f));
    else
      part_acc[((head0 + g) * splits + split) * D + d] = sum;
  }
}

template <int D, int GH, int STAGES>
int launch(const void* q, const void* k, const void* k_s, const void* v,
           const void* v_s, const void* kv_len, void* out, void* lse,
           void* part_acc, void* part_m, void* part_l, int B, int HKV, int G,
           int T_len, int D_, int splits, int tiles_per_split, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D, GH, STAGES>();
  auto kernel = decode_int8_gemv_kernel<D, GH, STAGES>;
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
      static_cast<float*>(part_l), HKV, G, T_len, tiles_per_split,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return mma::combine_mma(part_acc, part_m, part_l, kv_len, out, lse, B,
                          HKV * G, T_len, splits, tiles_per_split, D_,
                          stream);
}

}  // namespace gemv

// The launcher's signature (as route "mma"'s).
using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, void*, void*, void*, void*,
                       void*, int, int, int, int, int, int, int, float,
                       cudaStream_t);

}  // namespace

// Route "gemv": the arguments of decode_attention_int8_mma; D of 64, 128 or
// 256, G <= 4, q, k and v 16-byte aligned (the wrapper's
// `decode_quant_route` checks it).  Partials as route "mma"'s (m in base
// 2), combined by its combine, launched to overlap this kernel's tail.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape no
// instance takes.
extern "C" int decode_attention_int8_gemv(
    const void* q, const void* k, const void* k_s, const void* v,
    const void* v_s, const void* kv_len, void* out, void* lse, void* part_acc,
    void* part_m, void* part_l, int B, int HKV, int G, int T_len, int D,
    int splits, int tiles_per_split, float scale, void* stream) {
  // Instances by head dim and the group rounded up to 1, 2 or 4 heads held
  // in registers (8 spill at D = 128: 56 bytes); a ring of 4 stages at D =
  // 64, 3 at 128, 2 at 256 (35.2, 51.1 and 67.0 KB of shared memory at one
  // head).
  Launch fn = nullptr;
  if (G > 0 && D == 64) {
    fn = G <= 1 ? &gemv::launch<64, 1, 4>
       : G <= 2 ? &gemv::launch<64, 2, 4>
       : G <= 4 ? &gemv::launch<64, 4, 4> : nullptr;
  } else if (G > 0 && D == 128) {
    fn = G <= 1 ? &gemv::launch<128, 1, 3>
       : G <= 2 ? &gemv::launch<128, 2, 3>
       : G <= 4 ? &gemv::launch<128, 4, 3> : nullptr;
  } else if (G > 0 && D == 256) {
    fn = G <= 1 ? &gemv::launch<256, 1, 2>
       : G <= 2 ? &gemv::launch<256, 2, 2>
       : G <= 4 ? &gemv::launch<256, 4, 2> : nullptr;
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, k_s, v, v_s, kv_len, out, lse, part_acc, part_m, part_l, B,
            HKV, G, T_len, D, splits, tiles_per_split, scale,
            static_cast<cudaStream_t>(stream));
}
