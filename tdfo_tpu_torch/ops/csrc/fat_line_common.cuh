// The per-row optimizer math shared by the two fat-line kernels
// (fat_line_update.cu and fat_line_update_routed.cu).  Both call
// fat_row_step on one vocab-row slot, so the routed kernel writes bitwise
// the table fat_line_update writes for the same logical update.
//
// The arithmetic follows tdfo_tpu/ops/sparse.py::_fat_apply_lines_xla
// operation by operation; the kernels build with -fmad=false so no
// multiply-add is contracted and the rounding matches the plain PyTorch
// versions.
//
// One warp owns one row slot: lane j strides over the slot's lanes
// j, j + 32, ... with coalesced 4-byte loads.  `src` is where the slot's
// current [table | state] lanes are read, `dst` where the new ones go; they
// may be the same row (each lane reads its own lanes before writing them,
// and the rowwise accumulator is written after a __syncwarp).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fat_lines {

constexpr int KIND_SGD = 0;
constexpr int KIND_ADAGRAD = 1;
constexpr int KIND_ROWWISE_ADAGRAD = 2;
constexpr int KIND_ADAM = 3;

// Hyperparameters of one step.  om_b1, om_b2 are 1 - b1, 1 - b2 rounded on
// the host as PyTorch rounds them; corr [2] is a device pointer to adam's
// bias corrections (1 - b1^t, 1 - b2^t), read on the device so the step
// count never syncs.
struct StepParams {
  const float* corr;
  int d;
  int kind;
  float lr, b1, b2, om_b1, om_b2, eps, wd;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One optimizer step on one row slot, by the whole warp.  Lanes [0, d) of
// the slot hold the table row, [d, need) the optimizer state.
__device__ __forceinline__ void fat_row_step(const float* src, float* dst,
                                             const float* g, const StepParams& p,
                                             int lane) {
  const int d = p.d;
  if (p.kind == KIND_SGD) {
    for (int j = lane; j < d; j += 32) {
      const float x = src[j];
      const float g2 = g[j] + p.wd * x;
      dst[j] = x - p.lr * g2;
    }
  } else if (p.kind == KIND_ADAGRAD) {
    for (int j = lane; j < d; j += 32) {
      const float x = src[j];
      const float g2 = g[j] + p.wd * x;
      const float acc_n = src[d + j] + g2 * g2;
      const float delta = p.lr * g2 / (sqrtf(acc_n) + p.eps);
      dst[j] = x - delta;
      dst[d + j] = acc_n;
    }
  } else if (p.kind == KIND_ROWWISE_ADAGRAD) {
    float part = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float g2 = g[j] + p.wd * src[j];
      part += g2 * g2;
    }
    const float acc_n = src[d] + warp_sum(part) / (float)d;
    const float denom = sqrtf(acc_n) + p.eps;
    for (int j = lane; j < d; j += 32) {
      const float x = src[j];
      const float g2 = g[j] + p.wd * x;
      dst[j] = x - p.lr * g2 / denom;
    }
    __syncwarp();  // every lane read src[d] and src[j] before lane 0 writes
    if (lane == 0) dst[d] = acc_n;
  } else if (p.kind == KIND_ADAM) {
    const float c1 = p.corr[0];
    const float c2 = p.corr[1];
    for (int j = lane; j < d; j += 32) {
      const float x = src[j];
      const float gj = g[j];
      const float mu_n = p.b1 * src[d + j] + p.om_b1 * gj;
      const float nu_n = p.b2 * src[2 * d + j] + p.om_b2 * gj * gj;
      const float mu_hat = mu_n / c1;
      const float nu_hat = nu_n / c2;
      const float delta = p.lr * (mu_hat / (sqrtf(nu_hat) + p.eps) + p.wd * x);
      dst[j] = x - delta;
      dst[d + j] = mu_n;
      dst[2 * d + j] = nu_n;
    }
  }
}

}  // namespace fat_lines
