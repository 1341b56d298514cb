// Flash-attention forward: softmax(Q K^T / sqrt(Dh), key mask) V with an
// online softmax, plus the per-row logsumexp the backward rebuilds P from.
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::_flash_kernel (:73), launched by
// _flash_fwd_impl (:151, pallas_call :174).  What it computes is the same,
// rule for rule:
//   s = scale * q.k (f32), masked keys -> NEG_INF = finfo(f32).min (:93);
//   running max m, shift = 0 while m_new <= NEG_INF/2 (:95), p = 0 on masked
//   keys (:97), correction guarded the same way (:98);
//   p rounded to the V dtype before P.V (:101), f32 accumulation;
//   out = acc / l where l > 0, else 0; lse = m + log(l), +inf on a fully
//   masked row (:111-113).
// What it does not carry over: the TPU's [B, H, 8, T] sublane-broadcast lse
// and mask layouts (Mosaic's (8, 128) tiling) and the padding of T to the
// block size (_pad_t, :138-168).  lse is [B, H, T] f32, and the kernel masks
// the ragged last tile itself (keys >= T are invalid, rows >= T are not
// written), so it allocates no padded copies.
//
// Bound on the H100: operations.  Per (b, h) the work is 4*T^2*Dh flops
// against (4*T*Dh + T) elements of traffic, so above T ~ 100 it is compute
// bound: in f32 against the 67 TFLOP/s of the CUDA cores (an exact f32
// product cannot use the tensor cores), in bf16 against the 989 TFLOP/s of
// the tensor cores.  This first design stays on the CUDA cores for both
// types (bf16 operands are widened on load; every bf16 x bf16 product is
// exact in f32): one block of 128 threads per (b, h, 32-query tile), four
// threads per query row holding q and the output accumulator in registers,
// K/V tiles of 32 keys staged in shared memory as f32 and read back as
// conflict-free float4 broadcasts (see flash_common.cuh).  It is far from
// the bf16 bound by design; wgmma, TMA and warp specialisation are later
// work.
//
// Operands: q, k, v, out contiguous [B, H, T, Dh] of one type (f32 or bf16),
// valid [B, T] uint8 (torch.bool), lse [B, H, T] f32 or nullptr (the
// inference call: no lse write, as with_lse=False at :134-135).

#include "flash_common.cuh"

namespace {

using namespace flash;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  void* out;
  float* lse;
  int t, dh;
  float scale;
};

template <typename T, int DHMAX>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FwdParams p) {
  constexpr int NCH = DHMAX / 16;
  __shared__ __align__(16) float ks[TILE][DHMAX];
  __shared__ __align__(16) float vs[TILE][DHMAX];
  __shared__ float kval[TILE];

  const int t = p.t, dh = p.dh;
  const int64_t bh = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int sub = threadIdx.x & (TPR - 1);
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool live = row < t;
  const T* q = static_cast<const T*>(p.q) + bh * t * dh;
  const T* k = static_cast<const T*>(p.k) + bh * t * dh;
  const T* v = static_cast<const T*>(p.v) + bh * t * dh;
  const uint8_t* valid = p.valid + (int64_t)blockIdx.z * t;

  float qr[NCH][4];
  float acc[NCH][4];
  load_row<T, NCH>(qr, q + (int64_t)row * dh, live, sub, dh);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  float m = NEG_INF;
  float l = 0.0f;

  for (int k0 = 0; k0 < t; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, DHMAX>(ks, k, k0, t, dh);
    stage_tile<T, DHMAX>(vs, v, k0, t, dh);
    for (int j = threadIdx.x; j < TILE; j += THREADS)
      kval[j] = (k0 + j < t && valid[k0 + j]) ? 1.0f : 0.0f;
    __syncthreads();

    float s[TILE];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float sj = p.scale * row_dot<NCH>(qr, ks[j], sub, dh);
      s[j] = kval[j] > 0.0f ? sj : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float shift = m_new <= NEG_INF * 0.5f ? 0.0f : m_new;
    const float corr = m <= NEG_INF * 0.5f ? 0.0f : expf(m - shift);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
    float lsum = 0.0f;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float pj = kval[j] > 0.0f ? expf(s[j] - shift) : 0.0f;
      lsum += pj;
      row_axpy<NCH>(acc, round_as<T>(pj), vs[j], sub, dh);
    }
    l = l * corr + lsum;
    m = m_new;
  }

  if (live) {
    T* o = static_cast<T*>(p.out) + (bh * t + row) * dh;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (!chunk_live(c, sub, dh)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[16 * c + 4 * sub + e] =
            from_f<T>(l > 0.0f ? acc[c][e] / fmaxf(l, 1e-30f) : 0.0f);
    }
    if (p.lse != nullptr && sub == 0)
      p.lse[bh * t + row] = l > 0.0f ? m + logf(fmaxf(l, 1e-30f)) : INFINITY;
  }
}

template <typename T, int DHMAX>
void launch(const FwdParams& p, int b, int h, cudaStream_t stream) {
  const dim3 grid((p.t + ROWS - 1) / ROWS, h, b);
  flash_fwd_kernel<T, DHMAX><<<grid, THREADS, 0, stream>>>(p);
}

template <typename T>
void launch_dh(const FwdParams& p, int b, int h, cudaStream_t stream) {
  if (p.dh <= 32) launch<T, 32>(p, b, h, stream);
  else if (p.dh <= 64) launch<T, 64>(p, b, h, stream);
  else launch<T, 128>(p, b, h, stream);
}

}  // namespace

extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, const uint8_t* valid, void* out,
                              float* lse, int b, int h, int t, int dh,
                              float scale, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || t <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  FwdParams p{q, k, v, valid, out, lse, t, dh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) launch_dh<float>(p, b, h, s);
  else if (dtype == DTYPE_BF16) launch_dh<__nv_bfloat16>(p, b, h, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
