// Fused row-sparse optimizer step on the touched lines of a packed fat table.
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::fat_line_update (the Pallas TPU
// kernel: per grid step, line DMAs HBM->VMEM, lane-map matmuls, DMAs back).
// What it computes is the same: for every touched vocab-row slot of every
// line in `ulines`, one optimizer step (sgd / adagrad / rowwise_adagrad /
// adam with decoupled weight decay) on the slot's [table | state] lanes, in
// place.  The per-row math lives in fat_line_common.cuh, shared with the
// routed kernel (fat_line_update_routed.cu).
//
// Layout: fat is [L, T, 128] f32, byte-identical to the [L*R, W] row view;
// row slot s of line l starts at (l*R + s) * W.  Lanes [0, d) hold the
// table row, [d, need) the optimizer state, [need, W) zero padding.
//
// Operands:
//   ulines [U] int32, duplicate-free; the int32-max sentinel and any value
//          outside [0, L) skip the line without reading or writing it.
//   g      row form [U, d] (R == 1, touched == nullptr: every valid line is
//          touched) or packed form [U, R, d] with touched [U, R] (> 0 =
//          touched; untouched slots are never read or written).
//   corr   [2] f32 device pointer, adam bias corrections (1 - b1^t,
//          1 - b2^t); read on the device so the step count never syncs.
//
// Bound on the H100: memory bytes.  Per touched adam row the table and the
// two moments are read and written and the grad is read:
// (2 * 3 * d + d) * 4 B, 1,792 B at d = 64; the arithmetic is a few dozen
// flops per element.  First design: one warp per row slot, lanes striding
// over the d table lanes with coalesced 4-byte loads, no shared-memory
// staging.  Making it fast (vector loads, several rows per warp) is later
// work.

#include "fat_line_common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

struct Params {
  float* fat;
  const int32_t* ulines;
  const float* g;
  const float* touched;
  int64_t n_lines;
  int64_t n_slots;  // U * R
  int r;
  int w;
  fat_lines::StepParams step;
};

__global__ void fat_line_update_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (slot >= p.n_slots) return;
  const int64_t u = slot / p.r;
  const int s = (int)(slot - u * p.r);
  const int64_t line = p.ulines[u];
  if (line < 0 || line >= p.n_lines) return;  // sentinel / out of range
  if (p.touched != nullptr && !(p.touched[slot] > 0.0f)) return;

  float* row = p.fat + (line * p.r + s) * (int64_t)p.w;
  fat_lines::fat_row_step(row, row, p.g + slot * (int64_t)p.step.d, p.step, lane);
}

}  // namespace

extern "C" int fat_line_update_f32(
    float* fat, const int32_t* ulines, const float* g, const float* touched,
    const float* corr, int64_t n_lines, int64_t n_ulines, int r, int w, int d,
    int kind, float lr, float b1, float b2, float om_b1, float om_b2,
    float eps, float wd, void* stream) {
  Params p;
  p.fat = fat;
  p.ulines = ulines;
  p.g = g;
  p.touched = touched;
  p.n_lines = n_lines;
  p.n_slots = n_ulines * r;
  p.r = r;
  p.w = w;
  p.step = fat_lines::StepParams{corr, d, kind, lr, b1, b2, om_b1, om_b2, eps, wd};
  if (p.n_slots > 0) {
    const int64_t blocks = (p.n_slots + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    fat_line_update_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0,
                             (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
