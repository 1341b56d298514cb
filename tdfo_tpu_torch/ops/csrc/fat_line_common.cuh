// The per-row optimizer math shared by the two fat-line kernels
// (fat_line_update.cu and fat_line_update_routed.cu).  Both build their row
// steps from the same element functions below (sgd_x, adagrad_step,
// rowwise_g2 / rowwise_x, adam_step) and sum rowwise_adagrad's mean over
// one tree, so the routed kernel writes bitwise the table fat_line_update
// writes for the same logical update.
//
// The arithmetic follows tdfo_tpu/ops/sparse.py::_fat_apply_lines_xla
// operation by operation; the kernels build with -fmad=false so no
// multiply-add is contracted and the rounding matches the plain PyTorch
// versions.
//
// fat_row_step: one warp owns one row slot; lane j strides over the slot's
// lanes j, j + 32, ... with coalesced 4-byte loads.  `src` is where the
// slot's current [table | state] lanes are read, `dst` where the new ones
// go; they may be the same row (each lane reads its own lanes before
// writing them, and the rowwise accumulator is written after a __syncwarp).
//
// The rowwise mean's tree (warp_sum): lane L's partial p_L sums the squared
// grads of lanes L, L + 32, ... in that order from 0.0f, then __shfl_xor
// levels 16, 8, 4, 2, 1 add p_L + p_{L^off}.  fat_row_group_step (the routed
// kernel's narrow rows, G threads of 4 lanes each) reproduces that tree: its
// thread t holds lanes 4t .. 4t + 3 (d <= 4G <= 32, one lane per partial),
// the shuffles add the levels of the thread bits (G/2 .. 1 = lane bits
// 4G/2 .. 4) and the last two levels (lane bits 2, 1) are local.  The
// levels above 4G add the exact zeros of the lanes past d and are skipped.

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

// ------------------------------------------------------- element functions

__device__ __forceinline__ float sgd_x(float x, float g, const StepParams& p) {
  const float g2 = g + p.wd * x;
  return x - p.lr * g2;
}

// x, acc -> new x, new acc
__device__ __forceinline__ void adagrad_step(float& x, float& acc, float g,
                                             const StepParams& p) {
  const float g2 = g + p.wd * x;
  const float acc_n = acc + g2 * g2;
  const float delta = p.lr * g2 / (sqrtf(acc_n) + p.eps);
  x = x - delta;
  acc = acc_n;
}

__device__ __forceinline__ float rowwise_g2(float x, float g, const StepParams& p) {
  return g + p.wd * x;
}

__device__ __forceinline__ float rowwise_x(float x, float g2, float denom,
                                           const StepParams& p) {
  return x - p.lr * g2 / denom;
}

// the new accumulator and the denominator from the old one and the tree sum
__device__ __forceinline__ float rowwise_acc(float acc, float sum,
                                             const StepParams& p) {
  return acc + sum / (float)p.d;
}

// x, mu, nu -> new x, mu, nu
__device__ __forceinline__ void adam_step(float& x, float& mu, float& nu, float g,
                                          float c1, float c2, const StepParams& p) {
  const float mu_n = p.b1 * mu + p.om_b1 * g;
  const float nu_n = p.b2 * nu + p.om_b2 * g * g;
  const float mu_hat = mu_n / c1;
  const float nu_hat = nu_n / c2;
  const float delta = p.lr * (mu_hat / (sqrtf(nu_hat) + p.eps) + p.wd * x);
  x = x - delta;
  mu = mu_n;
  nu = nu_n;
}

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
    for (int j = lane; j < d; j += 32) dst[j] = sgd_x(src[j], g[j], p);
  } else if (p.kind == KIND_ADAGRAD) {
    for (int j = lane; j < d; j += 32) {
      float x = src[j], acc = src[d + j];
      adagrad_step(x, acc, g[j], p);
      dst[j] = x;
      dst[d + j] = acc;
    }
  } else if (p.kind == KIND_ROWWISE_ADAGRAD) {
    float part = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float g2 = rowwise_g2(src[j], g[j], p);
      part += g2 * g2;
    }
    const float acc_n = rowwise_acc(src[d], warp_sum(part), p);
    const float denom = sqrtf(acc_n) + p.eps;
    for (int j = lane; j < d; j += 32) {
      const float x = src[j];
      dst[j] = rowwise_x(x, rowwise_g2(x, g[j], p), denom, p);
    }
    __syncwarp();  // every lane read src[d] and src[j] before lane 0 writes
    if (lane == 0) dst[d] = acc_n;
  } else if (p.kind == KIND_ADAM) {
    const float c1 = p.corr[0];
    const float c2 = p.corr[1];
    for (int j = lane; j < d; j += 32) {
      float x = src[j], mu = src[d + j], nu = src[2 * d + j];
      adam_step(x, mu, nu, g[j], c1, c2, p);
      dst[j] = x;
      dst[d + j] = mu;
      dst[2 * d + j] = nu;
    }
  }
}

// ------------------------------------------------ narrow rows, G per row

// The operands of one narrow row for one thread: lanes 4t .. 4t + 3 of the
// grad, the table and the per-element state (s1: adagrad's accumulator or
// adam's mu, s2: adam's nu), and the row's scalar rowwise accumulator.
struct RowLanes {
  float g[4], x[4], s1[4], s2[4];
  float acc;
};

// 16-byte load of 4 lanes (zeros where not live) / store
__device__ __forceinline__ void ld4(float (&a)[4], const float* src, bool live) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) v = *reinterpret_cast<const float4*>(src);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void st4(float* dst, const float (&a)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
}

// Issue the loads of one narrow row (no arithmetic).  The grad needs only
// the row index and the slot only its routing, so each has its own
// predicate and neither waits on the line lookup: `g_live` (the row exists
// and 4t < d), `src_live` (its slot in `lines` exists and 4t < d),
// `acc_live` (the slot exists: the rowwise accumulator, one per row).
template <int KIND>
__device__ __forceinline__ void load_row_lanes(RowLanes& r, const float* src,
                                               const float* g, int t, int d,
                                               bool g_live, bool src_live,
                                               bool acc_live) {
  ld4(r.g, g + 4 * t, g_live);
  ld4(r.x, src + 4 * t, src_live);
  if (KIND == KIND_ADAGRAD || KIND == KIND_ADAM) ld4(r.s1, src + d + 4 * t, src_live);
  if (KIND == KIND_ADAM) ld4(r.s2, src + 2 * d + 4 * t, src_live);
  if (KIND == KIND_ROWWISE_ADAGRAD) r.acc = acc_live ? src[d] : 0.0f;
}

// One optimizer step on one narrow row by its G threads (a G-aligned group
// of the warp; every lane of the warp calls it, since the rowwise kind
// shuffles).  Thread t writes lanes 4t .. 4t + 3 where `live`, and thread 0
// the rowwise accumulator where `row_ok`.  `src` (read by load_row_lanes)
// and `dst` must not be the same row.
template <int KIND, int G>
__device__ __forceinline__ void fat_row_group_step(RowLanes& r, float* dst, int t,
                                                   int d, bool row_ok, bool live,
                                                   const StepParams& p, float c1,
                                                   float c2) {
  if (KIND == KIND_SGD) {
#pragma unroll
    for (int e = 0; e < 4; ++e) r.x[e] = sgd_x(r.x[e], r.g[e], p);
  } else if (KIND == KIND_ADAGRAD) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adagrad_step(r.x[e], r.s1[e], r.g[e], p);
  } else if (KIND == KIND_ADAM) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adam_step(r.x[e], r.s1[e], r.s2[e], r.g[e], c1, c2, p);
  } else {  // rowwise_adagrad: warp_sum's tree, see the header note
    float g2[4], v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g2[e] = rowwise_g2(r.x[e], r.g[e], p);
      v[e] = 0.0f;
      v[e] += g2[e] * g2[e];  // the partial from 0.0f, as warp_sum's lanes
      if (!live) v[e] = 0.0f;
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += __shfl_xor_sync(0xffffffffu, v[e], off);
    }
    const float sum = (v[0] + v[2]) + (v[1] + v[3]);
    const float acc_n = rowwise_acc(r.acc, sum, p);
    const float denom = sqrtf(acc_n) + p.eps;
#pragma unroll
    for (int e = 0; e < 4; ++e) r.x[e] = rowwise_x(r.x[e], g2[e], denom, p);
    if (row_ok && t == 0) dst[d] = acc_n;
  }
  if (!live) return;
  st4(dst + 4 * t, r.x);
  if (KIND == KIND_ADAGRAD || KIND == KIND_ADAM) st4(dst + d + 4 * t, r.s1);
  if (KIND == KIND_ADAM) st4(dst + 2 * d + 4 * t, r.s2);
}

}  // namespace fat_lines
