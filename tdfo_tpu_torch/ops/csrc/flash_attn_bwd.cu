// Flash-attention backward (FlashAttention-2 recompute): dQ, and dK/dV,
// from (q, k, v, dO, lse, delta) without ever holding a [T, T] matrix.
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::_flash_bwd_dq_kernel (:222) and
// ::_flash_bwd_dkv_kernel (:261), launched by _flash_bwd_impl (:304,
// pallas_calls :329 and :348).  What they compute is the same:
//   p  = exp(where(valid, scale * q.k, NEG_INF) - lse): a fully masked row
//        (lse = +inf) and a masked key both give p = 0 (:244-246);
//   dp = dO.v; ds = p * (dp - delta), rounded to the K/Q dtype (:251, :291);
//   dQ = scale * sum_k ds * k (:258); dV = sum_q round(p) * dO (:283);
//   dK = scale * sum_q ds * q (:300).  delta = rowsum(dO * O) is computed
//   outside the kernels, as in the reference (:322-323).
// dQ runs one block per (b, h, 32-query tile) and streams key/value tiles;
// dK/dV runs one block per (b, h, 32-key tile) and streams query/dO tiles.
// Each block writes only its own rows, so there are no atomics and the
// result is deterministic, as in the reference's split.  Ragged tiles are
// masked in the kernel (keys >= T invalid; query rows >= T contribute 0),
// so no padded copies exist (the reference pads T, :307-320).
//
// Bound on the H100: operations.  dQ does 6*T^2*Dh flops per (b, h) and
// dK/dV 8*T^2*Dh (they recompute p), against O(T*Dh) bytes; in f32 the
// bound is the 67 TFLOP/s of the CUDA cores, in bf16 the 989 TFLOP/s of the
// tensor cores.  This first design uses the CUDA cores for both types, with
// the same layout as the forward (flash_common.cuh): four threads per owned
// row, the row's operands and accumulators in registers, the streamed tile
// in shared memory as f32, float4 broadcast reads.  Tensor cores (wgmma)
// and a fused single-pass dK/dV/dQ are later work.
//
// Operands: q, k, v, dO, dQ, dK, dV contiguous [B, H, T, Dh] of one type
// (f32 or bf16); valid [B, T] uint8; lse, delta [B, H, T] f32.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const uint8_t* valid;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int t, dh;
  float scale;
};

template <typename T, int DHMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int NCH = DHMAX / 16;
  __shared__ __align__(16) float ks[TILE][DHMAX];
  __shared__ __align__(16) float vs[TILE][DHMAX];
  __shared__ float kval[TILE];

  const int t = p.t, dh = p.dh;
  const int64_t bh = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int sub = threadIdx.x & (TPR - 1);
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool live = row < t;
  const int64_t off = bh * t * dh;
  const T* k = static_cast<const T*>(p.k) + off;
  const T* v = static_cast<const T*>(p.v) + off;
  const uint8_t* valid = p.valid + (int64_t)blockIdx.z * t;

  float qr[NCH][4], dor[NCH][4], acc[NCH][4];
  load_row<T, NCH>(qr, static_cast<const T*>(p.q) + off + (int64_t)row * dh,
                   live, sub, dh);
  load_row<T, NCH>(dor, static_cast<const T*>(p.dout) + off + (int64_t)row * dh,
                   live, sub, dh);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  // rows past T behave as fully masked rows: lse = +inf gives p = 0
  const float lse = live ? p.lse[bh * t + row] : INFINITY;
  const float delta = live ? p.delta[bh * t + row] : 0.0f;

  for (int k0 = 0; k0 < t; k0 += TILE) {
    __syncthreads();
    stage_tile<T, DHMAX>(ks, k, k0, t, dh);
    stage_tile<T, DHMAX>(vs, v, k0, t, dh);
    for (int j = threadIdx.x; j < TILE; j += THREADS)
      kval[j] = (k0 + j < t && valid[k0 + j]) ? 1.0f : 0.0f;
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float s = p.scale * row_dot<NCH>(qr, ks[j], sub, dh);
      const float dp = row_dot<NCH>(dor, vs[j], sub, dh);
      const float pj = expf((kval[j] > 0.0f ? s : NEG_INF) - lse);
      const float ds = round_as<T>(pj * (dp - delta));
      row_axpy<NCH>(acc, ds, ks[j], sub, dh);
    }
  }
  store_row<T, NCH>(static_cast<T*>(p.dq) + off + (int64_t)row * dh, acc,
                    p.scale, live, sub, dh);
}

template <typename T, int DHMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int NCH = DHMAX / 16;
  __shared__ __align__(16) float qs[TILE][DHMAX];
  __shared__ __align__(16) float dos[TILE][DHMAX];
  __shared__ float lses[TILE];
  __shared__ float deltas[TILE];

  const int t = p.t, dh = p.dh;
  const int64_t bh = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int sub = threadIdx.x & (TPR - 1);
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;  // key row
  const bool live = row < t;
  const int64_t off = bh * t * dh;
  const T* q = static_cast<const T*>(p.q) + off;
  const T* dout = static_cast<const T*>(p.dout) + off;
  const bool kv = live && p.valid[(int64_t)blockIdx.z * t + row];

  float kr[NCH][4], vr[NCH][4], dk[NCH][4], dv[NCH][4];
  load_row<T, NCH>(kr, static_cast<const T*>(p.k) + off + (int64_t)row * dh,
                   live, sub, dh);
  load_row<T, NCH>(vr, static_cast<const T*>(p.v) + off + (int64_t)row * dh,
                   live, sub, dh);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.0f;

  for (int q0 = 0; q0 < t; q0 += TILE) {
    __syncthreads();
    stage_tile<T, DHMAX>(qs, q, q0, t, dh);
    stage_tile<T, DHMAX>(dos, dout, q0, t, dh);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const bool in = q0 + i < t;
      lses[i] = in ? p.lse[bh * t + q0 + i] : INFINITY;
      deltas[i] = in ? p.delta[bh * t + q0 + i] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      const float s = p.scale * row_dot<NCH>(kr, qs[i], sub, dh);
      const float dp = row_dot<NCH>(vr, dos[i], sub, dh);
      const float pi = expf((kv ? s : NEG_INF) - lses[i]);
      row_axpy<NCH>(dv, round_as<T>(pi), dos[i], sub, dh);
      const float ds = round_as<T>(pi * (dp - deltas[i]));
      row_axpy<NCH>(dk, ds, qs[i], sub, dh);
    }
  }
  store_row<T, NCH>(static_cast<T*>(p.dk) + off + (int64_t)row * dh, dk,
                    p.scale, live, sub, dh);
  store_row<T, NCH>(static_cast<T*>(p.dv) + off + (int64_t)row * dh, dv,
                    1.0f, live, sub, dh);
}

template <typename T, int DHMAX>
void launch(const BwdParams& p, int b, int h, bool dq, cudaStream_t stream) {
  const dim3 grid((p.t + ROWS - 1) / ROWS, h, b);
  if (dq) flash_bwd_dq_kernel<T, DHMAX><<<grid, THREADS, 0, stream>>>(p);
  else flash_bwd_dkv_kernel<T, DHMAX><<<grid, THREADS, 0, stream>>>(p);
}

template <typename T>
void launch_dh(const BwdParams& p, int b, int h, bool dq, cudaStream_t stream) {
  if (p.dh <= 32) launch<T, 32>(p, b, h, dq, stream);
  else if (p.dh <= 64) launch<T, 64>(p, b, h, dq, stream);
  else launch<T, 128>(p, b, h, dq, stream);
}

int run(int dtype, const BwdParams& p, int b, int h, bool dq, void* stream) {
  if (p.dh <= 0 || p.dh > 128 || p.dh % 8 != 0 || p.t <= 0 || b <= 0 ||
      h <= 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) launch_dh<float>(p, b, h, dq, s);
  else if (dtype == DTYPE_BF16) launch_dh<__nv_bfloat16>(p, b, h, dq, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Note the (q, k) dot in the dK/dV kernel is taken as k.q: the same
// products, summed in the same per-thread order as the dQ kernel's q.k.

extern "C" int flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const uint8_t* valid, const float* lse,
                                 const float* delta, void* dq, int b, int h,
                                 int t, int dh, float scale, void* stream) {
  BwdParams p{q, k, v, dout, valid, lse, delta, dq, nullptr, nullptr, t, dh, scale};
  return run(dtype, p, b, h, true, stream);
}

extern "C" int flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const uint8_t* valid, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int b, int h, int t, int dh, float scale,
                                  void* stream) {
  BwdParams p{q, k, v, dout, valid, lse, delta, nullptr, dk, dv, t, dh, scale};
  return run(dtype, p, b, h, false, stream);
}
