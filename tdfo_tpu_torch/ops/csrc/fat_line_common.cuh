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
// Storage: a lane is f32 (`float`) or bf16 (`uint16_t`, its bit pattern).
// bf16 lanes widen exactly (bits << 16), the math runs in f32, and each
// written lane narrows through Narrow::put (the reference's _sr_writeback,
// tdfo_tpu/ops/pallas_kernels.py:841): stochastic rounding with the random
// low 16 bits of a murmur3-finalizer hash of (seed, the lane's element
// index in its TPU grid block, the block id), or round-to-nearest without
// a seed.  The TPU grid is rebuilt from the line's position k in `ulines`:
// block = k / lps, element index = (k % lps) * (T * 128) + the lane's
// offset in its line (slot s's lane j: s * W + j).  Only touched slots are
// written; stochastic rounding is the identity on bf16 values, so that
// equals the TPU kernel's whole-line writeback.
//
// Two ways to split a row slot over threads:
//   fat_row_step: one warp owns one row slot; lane j strides over the
//   slot's lanes j, j + 32, ... with coalesced 4-byte (f32) or 2-byte (bf16)
//   loads.  `src` is where the slot's current [table | state] lanes are
//   read, `dst` where the new ones go; they may be the same row (each lane
//   reads its own lanes before writing them, and the rowwise accumulator is
//   written after a __syncwarp).
//   fat_row_group_step: G threads (a G-aligned group of the warp, G = 2 ..
//   32, d <= 4G) own one row; thread t holds lanes 4t .. 4t + 3 of the
//   grad, the table and each per-element state, each one 16-byte (f32) or
//   8-byte (bf16) load; a warp updates 32 / G rows at once.
//
// The rowwise mean's tree (warp_sum): lane L's partial p_L sums the squared
// grads of lanes L, L + 32, ... in that order from 0.0f, then __shfl_xor
// levels 16, 8, 4, 2, 1 add p_L + p_{L^off}.  fat_row_group_step reproduces
// that tree.  Its thread t holds lanes 4t + e, i.e. warp lane 4 (t % 8) + e
// of pass t / 8.  Wide groups (G = 16, 32; d > 32) first fold the passes:
// every thread gathers the values of threads t % 8, t % 8 + 8, ... of its
// group and adds them in that order, so p_L = ((0 + sq[L]) + sq[L + 32]) +
// ... on every thread that holds lane L (adding a pass's exact zero where
// L + 32k >= d changes nothing).  Then the shuffles add the levels of the
// thread bits below 8 (min(G, 8) / 2 .. 1 = lane bits 16 .. 4) and the last
// two levels (lane bits 2, 1) are local.  The levels above 4G (G <= 4) add
// the exact zeros of the lanes past d and are skipped.

#pragma once

#include <cuda_bf16.h>
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

// The bf16 writeback of one step: seed, sr (0: round to nearest), the TPU
// grid's lines per block and the lanes per line (T * 128).
struct SrParams {
  uint32_t seed;
  int sr;
  int lps;
  int line_lanes;
};

// ----------------------------------------------------------- storage lanes

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}

// Where one slot's lanes land in the TPU grid, and how they narrow.  For
// f32 storage put() is a plain store and the rest is unused.
struct Narrow {
  uint32_t salt;  // seed + block * 0x85EBCA6B
  uint32_t base;  // element index of the slot's lane 0 in its block
  int sr;

  __device__ __forceinline__ static Narrow at(const SrParams& q, int64_t k, int slot_lane0) {
    Narrow n;
    const int64_t block = k / q.lps;
    n.salt = q.seed + (uint32_t)block * 0x85EBCA6Bu;
    n.base = (uint32_t)((k - block * q.lps) * q.line_lanes + slot_lane0);
    n.sr = q.sr;
    return n;
  }

  // the bf16 bits of lane `off` (relative to the slot's lane 0) holding v
  __device__ __forceinline__ uint16_t bits(int off, float v) const {
    if (!sr) return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    uint32_t h = (base + (uint32_t)off) * 0x9E3779B1u + salt;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return (uint16_t)(((__float_as_uint(v) + (h & 0xFFFFu)) & 0xFFFF0000u) >> 16);
  }

  __device__ __forceinline__ void put(float* dst, int off, float v) const { dst[off] = v; }
  __device__ __forceinline__ void put(uint16_t* dst, int off, float v) const {
    dst[off] = bits(off, v);
  }
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
template <typename S>
__device__ __forceinline__ void fat_row_step(const S* src, S* dst, const float* g,
                                             const StepParams& p, int lane,
                                             const Narrow& nw) {
  const int d = p.d;
  if (p.kind == KIND_SGD) {
    for (int j = lane; j < d; j += 32) nw.put(dst, j, sgd_x(widen(src[j]), g[j], p));
  } else if (p.kind == KIND_ADAGRAD) {
    for (int j = lane; j < d; j += 32) {
      float x = widen(src[j]), acc = widen(src[d + j]);
      adagrad_step(x, acc, g[j], p);
      nw.put(dst, j, x);
      nw.put(dst, d + j, acc);
    }
  } else if (p.kind == KIND_ROWWISE_ADAGRAD) {
    float part = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float g2 = rowwise_g2(widen(src[j]), g[j], p);
      part += g2 * g2;
    }
    const float acc_n = rowwise_acc(widen(src[d]), warp_sum(part), p);
    const float denom = sqrtf(acc_n) + p.eps;
    for (int j = lane; j < d; j += 32) {
      const float x = widen(src[j]);
      nw.put(dst, j, rowwise_x(x, rowwise_g2(x, g[j], p), denom, p));
    }
    __syncwarp();  // every lane read src[d] and src[j] before lane 0 writes
    if (lane == 0) nw.put(dst, d, acc_n);
  } else if (p.kind == KIND_ADAM) {
    const float c1 = p.corr[0];
    const float c2 = p.corr[1];
    for (int j = lane; j < d; j += 32) {
      float x = widen(src[j]), mu = widen(src[d + j]), nu = widen(src[2 * d + j]);
      adam_step(x, mu, nu, g[j], c1, c2, p);
      nw.put(dst, j, x);
      nw.put(dst, d + j, mu);
      nw.put(dst, 2 * d + j, nu);
    }
  }
}

// ------------------------------------------------------ rows, G per row

// The operands of one row for one thread: lanes 4t .. 4t + 3 of the
// grad, the table and the per-element state (s1: adagrad's accumulator or
// adam's mu, s2: adam's nu), and the row's scalar rowwise accumulator.
struct RowLanes {
  float g[4], x[4], s1[4], s2[4];
  float acc;
};

// 4 lanes (zeros where not live): one 16-byte load of f32, one 8-byte load
// of bf16
__device__ __forceinline__ void ld4(float (&a)[4], const float* src, bool live) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) v = *reinterpret_cast<const float4*>(src);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

__device__ __forceinline__ void ld4(float (&a)[4], const uint16_t* src, bool live) {
  uint2 v = make_uint2(0u, 0u);
  if (live) v = *reinterpret_cast<const uint2*>(src);
  a[0] = __uint_as_float(v.x << 16);
  a[1] = __uint_as_float(v.x & 0xFFFF0000u);
  a[2] = __uint_as_float(v.y << 16);
  a[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

__device__ __forceinline__ void st4(float* dst, int off, const float (&a)[4],
                                    const Narrow&) {
  *reinterpret_cast<float4*>(dst + off) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void st4(uint16_t* dst, int off, const float (&a)[4],
                                    const Narrow& nw) {
  const uint32_t lo = (uint32_t)nw.bits(off, a[0]) | ((uint32_t)nw.bits(off + 1, a[1]) << 16);
  const uint32_t hi = (uint32_t)nw.bits(off + 2, a[2]) | ((uint32_t)nw.bits(off + 3, a[3]) << 16);
  *reinterpret_cast<uint2*>(dst + off) = make_uint2(lo, hi);
}

// Issue the loads of one row (no arithmetic).  Each operand has its own
// predicate, so a caller can issue the grad's load before it knows where
// the row's state lies: `g_live` (the grad row exists and 4t < d),
// `src_live` (the state row exists and 4t < d), `acc_live` (read the
// rowwise accumulator, one per row).
template <int KIND, typename S>
__device__ __forceinline__ void load_row_lanes(RowLanes& r, const S* src,
                                               const float* g, int t, int d,
                                               bool g_live, bool src_live,
                                               bool acc_live) {
  ld4(r.g, g + 4 * t, g_live);
  ld4(r.x, src + 4 * t, src_live);
  if (KIND == KIND_ADAGRAD || KIND == KIND_ADAM) ld4(r.s1, src + d + 4 * t, src_live);
  if (KIND == KIND_ADAM) ld4(r.s2, src + 2 * d + 4 * t, src_live);
  if (KIND == KIND_ROWWISE_ADAGRAD) r.acc = acc_live ? widen(src[d]) : 0.0f;
}

// One optimizer step on one row by its G threads (a G-aligned group of the
// warp; every lane of the warp calls it, since the rowwise kind shuffles).
// Thread t writes lanes 4t .. 4t + 3 where `live`, and thread 0 the rowwise
// accumulator where `row_ok`; no store reaches past lane d (rowwise) or
// need.  `dst` may be the row load_row_lanes read (`src`): each thread
// writes only the lanes it loaded itself, and the rowwise accumulator must
// then have been read by thread 0 alone and passed to the group by shuffle
// (an in-place caller's duty: a shuffle does not order another thread's
// load whose value it has not used yet).
template <int KIND, int G, typename S>
__device__ __forceinline__ void fat_row_group_step(RowLanes& r, S* dst, int t,
                                                   int d, bool row_ok, bool live,
                                                   const StepParams& p, float c1,
                                                   float c2, const Narrow& nw) {
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
    if constexpr (G > 8) {  // fold the passes: lanes L, L + 32, ... in order
      const int base = ((threadIdx.x & 31) & ~(G - 1)) | (t & 7);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = __shfl_sync(0xffffffffu, v[e], base);
#pragma unroll
        for (int k = 1; k < G / 8; ++k) s += __shfl_sync(0xffffffffu, v[e], base + 8 * k);
        v[e] = s;
      }
    }
#pragma unroll
    for (int off = (G > 8 ? 8 : G) / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += __shfl_xor_sync(0xffffffffu, v[e], off);
    }
    const float sum = (v[0] + v[2]) + (v[1] + v[3]);
    const float acc_n = rowwise_acc(r.acc, sum, p);
    const float denom = sqrtf(acc_n) + p.eps;
#pragma unroll
    for (int e = 0; e < 4; ++e) r.x[e] = rowwise_x(r.x[e], g2[e], denom, p);
    if (row_ok && t == 0) nw.put(dst, d, acc_n);
  }
  if (!live) return;
  st4(dst, 4 * t, r.x, nw);
  if (KIND == KIND_ADAGRAD || KIND == KIND_ADAM) st4(dst, d + 4 * t, r.s1, nw);
  if (KIND == KIND_ADAM) st4(dst, 2 * d + 4 * t, r.s2, nw);
}

}  // namespace fat_lines
