// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): tile geometry, operand conversion, and the float4
// dot/axpy over one thread's share of a head row.
//
// Thread layout (the forward and dQ kernels; the dK/dV kernels of
// flash_attn_bwd.cu use tile products instead): a block of THREADS threads
// owns ROWS query rows of one (batch, head).  TPR = 4 consecutive threads
// share a row; the thread with sub-lane `sub` holds head dims 16*c + 4*sub
// .. +3 for c in [0, DHMAX/16), so a row lives in NCH = DHMAX/16 float4
// chunks per thread and a dot product over the row is a per-thread partial
// plus two __shfl_xor steps.  The streamed operand (keys and values) is
// staged in shared memory as f32, [tile][DHMAX]; the 4 sub-lanes of a row
// read 64 contiguous bytes and the 8 rows of a warp read the same tile row,
// so every shared read is one conflict-free broadcast wavefront.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int THREADS = 128;
constexpr int TPR = 4;                 // threads per row
constexpr int ROWS = THREADS / TPR;    // rows owned by a block (32)
constexpr int TILE = 32;               // rows of the streamed operand per stage
constexpr unsigned FULL = 0xffffffffu;
// jnp.finfo(jnp.float32).min: the mask fill of tdfo_tpu/ops/pallas_kernels.py:65
constexpr float NEG_INF = -3.4028234663852886e38f;

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the operand type and widened back: the reference's
// `p.astype(v.dtype)` / `ds.astype(k.dtype)` casts (identity for f32)
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
}

// Does chunk c of this sub-lane hold real head dims?  dh is a multiple of
// 8, so a chunk start below dh means all 4 of its dims are below dh.
__device__ __forceinline__ bool chunk_live(int c, int sub, int dh) {
  return 16 * c + 4 * sub < dh;
}

// One head row of global memory -> this thread's chunks (zeros where the
// row or the dims do not exist).
template <typename T, int NCH>
__device__ __forceinline__ void load_row(float (&r)[NCH][4], const T* row,
                                         bool live, int sub, int dh) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * c + 4 * sub + e;
      r[c][e] = (live && d < dh) ? to_f(row[d]) : 0.0f;
    }
  }
}

template <typename T, int NCH>
__device__ __forceinline__ void store_row(T* row, const float (&r)[NCH][4],
                                          float mul, bool live, int sub, int dh) {
  if (!live) return;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (!chunk_live(c, sub, dh)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) row[16 * c + 4 * sub + e] = from_f<T>(mul * r[c][e]);
  }
}

// Stage `TILE` rows [r0, r0 + TILE) of a [T, dh] head slice into shared
// memory as f32; rows past t are zero.
template <typename T, int DHMAX>
__device__ __forceinline__ void stage_tile(float (*dst)[DHMAX], const T* src,
                                           int r0, int t, int dh) {
  for (int i = threadIdx.x; i < TILE * dh; i += THREADS) {
    const int j = i / dh;
    const int d = i - j * dh;
    const int r = r0 + j;
    dst[j][d] = r < t ? to_f(src[(int64_t)r * dh + d]) : 0.0f;
  }
}

// Full dot product of this row with tile row `s` (every sub-lane of the row
// gets the sum).  Must be called by all 32 lanes of the warp.
template <int NCH>
__device__ __forceinline__ float row_dot(const float (&r)[NCH][4], const float* s,
                                         int sub, int dh) {
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (!chunk_live(c, sub, dh)) continue;
    const float4 x = *reinterpret_cast<const float4*>(s + 16 * c + 4 * sub);
    part = fmaf(r[c][0], x.x, part);
    part = fmaf(r[c][1], x.y, part);
    part = fmaf(r[c][2], x.z, part);
    part = fmaf(r[c][3], x.w, part);
  }
  part += __shfl_xor_sync(FULL, part, 1);
  part += __shfl_xor_sync(FULL, part, 2);
  return part;
}

// acc += a * (tile row s)
template <int NCH>
__device__ __forceinline__ void row_axpy(float (&acc)[NCH][4], float a,
                                         const float* s, int sub, int dh) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (!chunk_live(c, sub, dh)) continue;
    const float4 x = *reinterpret_cast<const float4*>(s + 16 * c + 4 * sub);
    acc[c][0] = fmaf(a, x.x, acc[c][0]);
    acc[c][1] = fmaf(a, x.y, acc[c][1]);
    acc[c][2] = fmaf(a, x.z, acc[c][2]);
    acc[c][3] = fmaf(a, x.w, acc[c][3]);
  }
}

}  // namespace flash
