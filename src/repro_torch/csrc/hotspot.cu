// One HotSpot thermal step (5-point stencil) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hotspot_kernel` / `hotspot_pallas` in
// src/repro/kernels/stencil2d/kernel.py, which walks row slabs and is fed
// the halo rows above and below each slab as separate block-aligned inputs.
//
// On an H100 the step is bound by bytes: temp and power are read once and
// the result written once, 3 * rows * cols * 4 bytes.  Design: one thread per
// cell, a block covers a 64 x 4 tile with threads of a warp on neighbouring
// columns (coalesced rows).  The four neighbours are read straight from
// global memory with clamped addresses: a neighbour row is the centre row of
// the thread above or below and comes from L1/L2, so device memory sees each
// cell about once.  An out-of-grid neighbour is the cell itself (zero-flux
// edge), so ragged shapes need no padding.  The arithmetic keeps the
// reference's order of operations and uses the round-to-nearest intrinsics,
// which the compiler does not contract into fused multiply-adds.

#include <cuda_runtime.h>

namespace {

constexpr int kTileCols = 64;
constexpr int kTileRows = 4;

__global__ void __launch_bounds__(kTileCols * kTileRows)
hotspot_kernel(const float* __restrict__ temp, const float* __restrict__ power,
               float* __restrict__ out, int rows, int cols, float sdc,
               float rx, float ry, float rz, float amb) {
  const int col = blockIdx.x * kTileCols + threadIdx.x;
  const int row = blockIdx.y * kTileRows + threadIdx.y;
  if (row >= rows || col >= cols) return;
  const long long base = static_cast<long long>(row) * cols;
  const long long idx = base + col;
  const float centre = temp[idx];
  const float left = temp[base + (col > 0 ? col - 1 : col)];
  const float right = temp[base + (col < cols - 1 ? col + 1 : col)];
  const float up = temp[row > 0 ? idx - cols : idx];
  const float down = temp[row < rows - 1 ? idx + cols : idx];
  const float two_c = __fmul_rn(2.0f, centre);
  const float lr = __fmul_rn(__fsub_rn(__fadd_rn(left, right), two_c), rx);
  const float ud = __fmul_rn(__fsub_rn(__fadd_rn(up, down), two_c), ry);
  const float am = __fmul_rn(__fsub_rn(amb, centre), rz);
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(lr, ud), am), power[idx]);
  out[idx] = __fadd_rn(centre, __fmul_rn(sdc, sum));
}

}  // namespace

// temp, power, out: (rows, cols) f32, dense row-major; out must not alias
// temp.  Returns cudaGetLastError().
extern "C" int hotspot_step_f32(const void* temp, const void* power, void* out,
                                int rows, int cols, float sdc, float rx,
                                float ry, float rz, float amb, void* stream) {
  const dim3 block(kTileCols, kTileRows);
  const dim3 grid((cols + kTileCols - 1) / kTileCols,
                  (rows + kTileRows - 1) / kTileRows);
  hotspot_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(temp), static_cast<const float*>(power),
      static_cast<float*>(out), rows, cols, sdc, rx, ry, rz, amb);
  return static_cast<int>(cudaGetLastError());
}
