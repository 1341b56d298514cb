// Fused row-sparse optimizer step on a packed fat table, from ROW-level
// summed grads and routing arrays (the dedup-lookup path).
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::fat_line_update_routed (the
// Pallas TPU kernel).  What it computes is the same: for every distinct row
// i < CR of the step,
//
//   lidx = row_lidx[i]; skip if lidx is outside [0, C)
//   line = ulines[lidx]; skip if it is the int32-max sentinel or outside [0, L)
//   s    = row_slot[i]
//   state = slot s of lines[lidx]          (the forward's gather of fat)
//   fat[line * R + s] = the kind's step on (state, g_u[i], corr)
//
// Untouched slots, and every line not named, stay bitwise unchanged.  The
// per-row math is fat_line_common.cuh's fat_row_step, the same function
// fat_line_update.cu calls, so both kernels write bitwise the same table for
// the same logical update.
//
// What the TPU design does and this one does not: the TPU kernel streams
// whole lines through VMEM in blocks of lines, routes the block's rows into
// packed lanes with 0/1 matmuls over an `sdiv`/`tsi` window of the row
// array (lane-padded to 128), and writes whole lines back under per-line
// DMA semaphores.  Each of those exists for Mosaic.  Here one warp owns one
// distinct row and writes only its own slot: distinct rows have distinct
// (line, slot) pairs, so rows sharing a line (R = 2..8) never race, and no
// line is written whole.
//
// Layout: fat [L, T, 128] and lines [C, T, 128] f32, byte-identical to the
// [L*R, W] and [C*R, W] row views.  g_u [CR, d] f32; ulines [C],
// row_lidx [CR], row_slot [CR] int32; corr [2] f32 on the device.
//
// Bound on the H100: memory bytes.  Per distinct rowwise-adagrad row at
// d = 16: the slot's 17 state lanes read (68 B) and written (68 B), the
// grad read (64 B), and the routing (row_lidx, row_slot, ulines: 12 B) —
// 212 B, a few flops per byte.  First design: one warp per row, lanes
// striding over the row's lanes with coalesced 4-byte loads; at d = 16
// half the warp idles.  Several rows per warp and vector loads are later
// work.

#include "fat_line_common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

struct Params {
  float* fat;
  const float* lines;
  const int32_t* ulines;
  const int32_t* row_lidx;
  const int32_t* row_slot;
  const float* g;
  int64_t n_lines;   // L
  int64_t n_ulines;  // C
  int64_t n_rows;    // CR
  int r;
  int w;
  fat_lines::StepParams step;
};

__global__ void fat_line_update_routed_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (i >= p.n_rows) return;
  const int64_t lidx = p.row_lidx[i];
  if (lidx < 0 || lidx >= p.n_ulines) return;  // padding row slot
  const int64_t line = p.ulines[lidx];
  // the sentinel row (negative ids) has a valid lidx but a sentinel line
  if (line < 0 || line >= p.n_lines) return;
  const int s = p.row_slot[i];
  if (s < 0 || s >= p.r) return;

  const float* src = p.lines + (lidx * p.r + s) * (int64_t)p.w;
  float* dst = p.fat + (line * p.r + s) * (int64_t)p.w;
  fat_lines::fat_row_step(src, dst, p.g + i * (int64_t)p.step.d, p.step, lane);
}

}  // namespace

extern "C" int fat_line_update_routed_f32(
    float* fat, const float* lines, const int32_t* ulines,
    const int32_t* row_lidx, const int32_t* row_slot, const float* g,
    const float* corr, int64_t n_lines, int64_t n_ulines, int64_t n_rows,
    int r, int w, int d, int kind, float lr, float b1, float b2, float om_b1,
    float om_b2, float eps, float wd, void* stream) {
  Params p;
  p.fat = fat;
  p.lines = lines;
  p.ulines = ulines;
  p.row_lidx = row_lidx;
  p.row_slot = row_slot;
  p.g = g;
  p.n_lines = n_lines;
  p.n_ulines = n_ulines;
  p.n_rows = n_rows;
  p.r = r;
  p.w = w;
  p.step = fat_lines::StepParams{corr, d, kind, lr, b1, b2, om_b1, om_b2, eps, wd};
  if (n_rows > 0) {
    const int64_t blocks = (n_rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    fat_line_update_routed_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0,
                                    (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
