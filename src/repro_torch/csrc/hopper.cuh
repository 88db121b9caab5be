// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (csrc/gemm.cu and csrc/flash_attention.cu): mbarriers, TMA tile loads,
// wgmma shared-memory descriptors, the wgmma products those kernels issue,
// setmaxnreg, and the host helper that encodes a TMA tensor map; and the
// pieces of decode attention's route "mma" (csrc/decode_attention.cu, and
// on the int8 cache csrc/decode_attention_int8.cu): cp.async copies,
// ldmatrix and the warp-wide mma.sync m16n8k16 product; and the 1-D bulk
// copy that feeds the int8 cache's route "gemv".
//
// Written from the PTX of the instructions themselves; nothing here is a
// ready-made GEMM.  Every tile these helpers see lies in shared memory in
// 128-byte-swizzled "panels": rows of 64 bf16 values (128 bytes), each
// group of 8 rows a 1024-byte swizzle atom, the panel 1024-byte aligned.  A
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B and a box 64 values wide writes
// exactly that layout, and a wgmma descriptor with layout type 1 (128-byte
// swizzle) reads it back:
//
//  - an operand whose reduction (K) axis runs along the rows ("K-major": A
//    of a GEMM, Q and K of attention) takes SBO = 1024 bytes (the next 8
//    rows); a k16 step inside a panel adds 32 bytes to the start address,
//    and the next 64 K values are the next panel;
//  - an operand whose K axis runs down the rows ("MN-major": B of a GEMM as
//    it lies, (k, n) row-major; V of attention) is read with the transpose
//    immediate set, SBO = 1024 bytes (the next 8 k rows) and LBO = the
//    panel's size in bytes (the next 64 n values); a k16 step adds 16 rows,
//    2048 bytes.
//
// The accumulator of m64nNk16 is spread over the warpgroup's 128 threads:
// thread t (warp w = t / 32, lane l = t % 32) holds d[4j + e] for the
// 8-column group j of the tile, at row 16 w + l / 4 + 8 (e / 2) and column
// 8 j + 2 (l % 4) + (e % 2).  The same registers, rounded to bf16 in pairs,
// are the A operand of a register-sourced wgmma (a[0..3] = rows l/4 and
// l/4 + 8, columns 2 (l % 4) and 8 + 2 (l % 4) of a 16-wide k step).

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Shared memory addresses, mbarriers
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises; `count` arrivals (besides the transaction bytes
// of an expect_tx) complete a phase.
__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); a
// __syncthreads() after it makes them visible to the other threads.
__device__ inline void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// True once the phase of parity `parity` has completed (the instruction
// itself waits a while before it says no).
__device__ inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once: the producer's
// first pass over an empty ring.  An arrival that never comes (a fault in
// the kernel) traps after 2^28 tries, seconds on the card, so the launch
// fails with an error instead of hanging the device.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == (1u << 28)) __trap();
}

// ---------------------------------------------------------------------------
// TMA: one thread asks for a box; the bytes land on the barrier
// ---------------------------------------------------------------------------

__device__ inline void tma_load_2d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ inline void tma_load_3d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// TMA's 1-D form (cp.async.bulk, no tensor map): `bytes` contiguous bytes,
// a multiple of 16, from global to shared memory, both 16-byte aligned; the
// bytes land on `bar` as transactions, so arm it first (mbar_expect_tx).
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: descriptors, ordering, products
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand tile at `smem` (see the top of
// this file for LBO and SBO).  Fields: start address, LBO and SBO in
// 16-byte units, base offset 0 (every tile starts on a 1024-byte atom, and
// a k step moves the start by less than a row or by whole atoms), layout
// type 1 = 128-byte swizzle.
__device__ inline uint64_t desc_sw128(const void* smem, uint32_t lbo_bytes,
                                     uint32_t sbo_bytes) {
  return (static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4)) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// Orders this thread's earlier register and shared-memory writes before the
// wgmma that follows (needed before a wgmma whose accumulator or A
// registers ordinary instructions just wrote).
__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still running.
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that a wgmma in flight reads or writes: the compiler may
// not move, copy or reuse them across this point.
template <int N>
__device__ inline void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// PTX names every accumulator register of a wgmma, so each shape is written
// out: D is the warpgroup's 64 x N f32 accumulator fragment, `scale_d` 0
// overwrites it and 1 adds to it.  SS: A and B from shared memory (A
// K-major; B K-major, or MN-major with TRANS_B = 1).  RS: A from registers,
// B MN-major.
#define HOPPER_D8(i)                                                        \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HOPPER_D32(i) \
  HOPPER_D8(i), HOPPER_D8((i) + 8), HOPPER_D8((i) + 16), HOPPER_D8((i) + 24)

// D(64 x 64) += A(64 x 16, shared) B(16 x 64, shared)
template <int TRANS_B>
__device__ inline void wgmma_ss64(float (&d)[32], uint64_t desc_a,
                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_D32(0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D(64 x 64) += A(64 x 16, registers) B(16 x 64, shared, MN-major)
__device__ inline void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D(64 x 128) += A(64 x 16, shared) B(16 x 128, shared)
template <int TRANS_B>
__device__ inline void wgmma_ss128(float (&d)[64], uint64_t desc_a,
                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_D32(0), HOPPER_D32(32)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D(64 x 128) += A(64 x 16, registers) B(16 x 128, shared, MN-major)
__device__ inline void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4],
                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D32(0), HOPPER_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D(64 x 256) += A(64 x 16, shared) B(16 x 256, shared)
template <int TRANS_B>
__device__ inline void wgmma_ss256(float (&d)[128], uint64_t desc_a,
                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      "%127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : HOPPER_D32(0), HOPPER_D32(32), HOPPER_D32(64), HOPPER_D32(96)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

#undef HOPPER_D32
#undef HOPPER_D8

// bf16 pair (lo in the low half) as the 32-bit register a wgmma A operand
// takes; round to nearest even, as the reference's cast.
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// cp.async: 16-byte copies from global to shared memory that complete in the
// background, in commit groups, so that a ring of tiles is in flight while
// the threads compute on the tile that has arrived
// ---------------------------------------------------------------------------

// Copies 16 bytes; with `valid` false it reads nothing and writes 16 zero
// bytes (src-size 0), so that rows past an edge need no branch.  `src`
// must be 16-byte aligned and, even when not valid, a global address.
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// The same for 4 bytes (through L1: cp.async.cg takes 16 only), for rows
// of f32 that need not be 16-byte aligned; `src` 4-byte aligned.
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's commit groups are still in flight
// (a __syncthreads() after it makes every thread's copies visible).
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// mma.sync: a warp's 16 x 8 x 16 product of bf16 values into f32
// ---------------------------------------------------------------------------
//
// Fragments, lane l of the warp: A (16 x 16, row-major) a[0] = row l/4,
// columns 2 (l%4) + {0,1}; a[1] = row l/4 + 8, the same columns; a[2] and
// a[3] the same rows, columns + 8.  B (16 x 8, k x n) b[0] = rows 2 (l%4) +
// {0,1}, column l/4; b[1] = rows + 8.  C and D (16 x 8) d[0..1] = row l/4,
// columns 2 (l%4) + {0,1}; d[2..3] = row l/4 + 8.  So the D fragments of
// two n8 tiles side by side, rounded to bf16 in pairs, are the A fragment
// of a k16 step: P of attention goes from the scores to P V in registers.

// Four 8 x 8 matrices of 16-bit values from shared memory: lanes 8i .. 8i+7
// give the addresses of matrix i's rows (16 bytes each, 16-byte aligned);
// r[i] is matrix i as a fragment (lane l: row l/4, columns 2 (l%4) + {0,1}).
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}
// The same, each matrix transposed (lane l: rows 2 (l%4) + {0,1}, column
// l/4): a B fragment from rows that run along k (V as it lies).
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}

// d += a b, f32 accumulate (m16n8k16, A row-major, B column-major).
__device__ inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Warp specialisation: the producer warpgroup gives registers to the
// consumers.  All four warps of a warpgroup execute it together.
// ---------------------------------------------------------------------------

template <int R>
__device__ inline void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ inline void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The first 1024-byte-aligned address at or after `raw` in shared memory
// (swizzle atoms must start on one; the kernels ask for 1 KiB of slack).
__device__ inline uint8_t* align_1024(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---------------------------------------------------------------------------
// Host: encode a tensor map of bf16 values
// ---------------------------------------------------------------------------

// Launchers return the negated CUresult when a tensor map cannot be
// encoded, and a (positive) cudaError_t otherwise.
inline int encode_tensor_map(CUtensorMap* map, const void* base, int rank,
                             const uint64_t* dims,
                             const uint64_t* strides_bytes,
                             const uint32_t* box) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  // The driver's entry point, through the runtime: the library links no
  // libcuda of its own.
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  // Out-of-range elements of a box read as zeros (OOB_FILL_NONE): that
  // masks ragged edges in every axis.
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), dims, strides_bytes, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

}  // namespace hopper
