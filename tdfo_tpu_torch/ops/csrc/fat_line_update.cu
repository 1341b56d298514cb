// Fused row-sparse optimizer step on the touched lines of a packed fat table.
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::fat_line_update (the Pallas TPU
// kernel: per grid step, line DMAs HBM->VMEM, lane-map matmuls, DMAs back).
// What it computes is the same: for every touched vocab-row slot of every
// line in `ulines`, one optimizer step (sgd / adagrad / rowwise_adagrad /
// adam with decoupled weight decay) on the slot's [table | state] lanes, in
// place.  The arithmetic follows tdfo_tpu/ops/sparse.py::_fat_apply_lines_xla
// operation by operation; build with -fmad=false so no multiply-add is
// contracted and the rounding matches the plain PyTorch version.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_SGD = 0;
constexpr int KIND_ADAGRAD = 1;
constexpr int KIND_ROWWISE_ADAGRAD = 2;
constexpr int KIND_ADAM = 3;

constexpr int WARPS_PER_BLOCK = 8;

struct Params {
  float* fat;
  const int32_t* ulines;
  const float* g;
  const float* touched;
  const float* corr;
  int64_t n_lines;
  int64_t n_slots;  // U * R
  int r;
  int w;
  int d;
  int kind;
  float lr, b1, b2, om_b1, om_b2, eps, wd;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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
  const float* g = p.g + slot * (int64_t)p.d;
  const int d = p.d;

  if (p.kind == KIND_SGD) {
    for (int j = lane; j < d; j += 32) {
      const float x = row[j];
      const float g2 = g[j] + p.wd * x;
      row[j] = x - p.lr * g2;
    }
  } else if (p.kind == KIND_ADAGRAD) {
    for (int j = lane; j < d; j += 32) {
      const float x = row[j];
      const float g2 = g[j] + p.wd * x;
      const float acc_n = row[d + j] + g2 * g2;
      const float delta = p.lr * g2 / (sqrtf(acc_n) + p.eps);
      row[j] = x - delta;
      row[d + j] = acc_n;
    }
  } else if (p.kind == KIND_ROWWISE_ADAGRAD) {
    float part = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float g2 = g[j] + p.wd * row[j];
      part += g2 * g2;
    }
    const float acc_n = row[d] + warp_sum(part) / (float)d;
    const float denom = sqrtf(acc_n) + p.eps;
    for (int j = lane; j < d; j += 32) {
      const float x = row[j];
      const float g2 = g[j] + p.wd * x;
      row[j] = x - p.lr * g2 / denom;
    }
    __syncwarp();  // every lane read row[j] before lane 0 writes the accumulator
    if (lane == 0) row[d] = acc_n;
  } else if (p.kind == KIND_ADAM) {
    const float c1 = p.corr[0];
    const float c2 = p.corr[1];
    for (int j = lane; j < d; j += 32) {
      const float x = row[j];
      const float gj = g[j];
      const float mu_n = p.b1 * row[d + j] + p.om_b1 * gj;
      const float nu_n = p.b2 * row[2 * d + j] + p.om_b2 * gj * gj;
      const float mu_hat = mu_n / c1;
      const float nu_hat = nu_n / c2;
      const float delta = p.lr * (mu_hat / (sqrtf(nu_hat) + p.eps) + p.wd * x);
      row[j] = x - delta;
      row[d + j] = mu_n;
      row[2 * d + j] = nu_n;
    }
  }
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
  p.corr = corr;
  p.n_lines = n_lines;
  p.n_slots = n_ulines * r;
  p.r = r;
  p.w = w;
  p.d = d;
  p.kind = kind;
  p.lr = lr;
  p.b1 = b1;
  p.b2 = b2;
  p.om_b1 = om_b1;
  p.om_b2 = om_b2;
  p.eps = eps;
  p.wd = wd;
  if (p.n_slots > 0) {
    const int64_t blocks = (p.n_slots + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    fat_line_update_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0,
                             (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
