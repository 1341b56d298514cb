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
// Each block writes only its own rows, so there are no atomics and the
// result is deterministic, as in the reference's split.  Ragged tiles are
// masked in the kernel (keys >= T invalid; query rows >= T contribute 0),
// so no padded copies exist (the reference pads T, :307-320).
//
// Bound on the H100: operations at long T, bytes and latency at short T.
// dQ does 6*T^2*Dh flops per (b, h) and dK/dV 8*T^2*Dh (they recompute p)
// against O(T*Dh) bytes; in f32 the bound is the 67 TFLOP/s of the CUDA
// cores (TF32 would miss the 1e-4 gradient gate), in bf16 the 989 TFLOP/s
// of the tensor cores: for dQ at T = 4096, Dh = 64, B = 1, H = 8, 0.769 ms
// in f32 and 0.0521 ms in bf16.  At the Bert4Rec shape (B = 256, H = 2,
// T = 20, Dh = 32, f32) both are bound by bytes (dQ 0.00198 ms, ~8 MB of
// operands): one tile per head, so a block's time is its operands' DRAM
// round trip and then a short chain of dependent shared-memory phases.
//
// dQ streams key tiles past a query tile: S = Q K^T and dP = dO V^T, then
// dS = p (dp - delta) elementwise, then dQ += dS K in registers.
//   * f32 (flash_bwd_dq_simt_kernel, CUDA cores): register micro-tiles
//     (QTile, flash_common.cuh).  Each thread forms MQ x MK micro-tiles of
//     S and dP from float4 shared reads as independent FMAs (no per-key
//     shuffle chain: lse and delta are given, so there is no row reduction
//     at all), writes dS to a [query][key] shared tile read back only by the
//     8 lanes sharing its rows (a __syncwarp), and runs dS K as a second
//     micro-tile product.  Only the live part is computed: row groups past T
//     idle, the key loop stops at T, dS K stops at the tile's last key
//     rounded up to 4, and rows past T are never staged.  The tile is 16
//     rows (4 heads a block) at T <= 16, 24 at T <= 24, else 32.
//   * bf16 (flash_bwd_dq_mma_kernel, tensor cores): four warps (eight from
//     T = 128) own 16 query rows each, whose Q and dO fragments are loaded
//     once by ldmatrix and stay in registers; S and dP are
//     mma.sync.m16n8k16 bf16 -> f32 with K and V by ldmatrix; dS is packed
//     to bf16 straight from the accumulators into A fragments (the
//     reference's rounding point) and dS K takes K by ldmatrix.trans.
//   * Both stage with 16-byte cp.async, key/value tiles into two buffers so
//     tile i + 1 loads while tile i computes; the key-mask load is issued
//     before the copies and stored after them.
//
// dK/dV is built from tile products.  Over each streamed query tile a block
// forms S^T = K Q^T and dP^T = V dO^T, then P and dS elementwise, then
// accumulates dV += round(P)^T dO and dK += dS^T Q in registers:
//   * f32 (flash_bwd_dkv_simt_kernel, CUDA cores): a slot of 4*TILE threads
//     owns TILE keys of one head.
//     Each thread holds an MK x MQ micro-tile of S^T and dP^T (independent
//     FMAs from float4 shared reads, no per-key shuffle chain) and K3 keys
//     x 4 dims of dK and dV.  TILE follows T (16, 32 or 64 rows); at T <= 16
//     a block packs 4 heads.  Only the live part of a tile is computed: the
//     micro-tiles covering the keys and query rows below T are dealt to the
//     slot's threads, the loop over query tiles stops at T, each tile's pass
//     over its rows stops at T, and rows past T are never staged.  At the
//     Bert4Rec shape (T = 20, Dh = 32: one tile, one load per block) the
//     time is the operands' DRAM round trip and then the two product
//     phases' latency; shared-memory reads, not FMAs, bound those phases.
//   * bf16 (flash_bwd_dkv_mma_kernel, tensor cores): four warps own 64 keys
//     of one head, 16 each, and run the same four products as
//     mma.sync.m16n8k16 bf16 -> f32 with ldmatrix operands from shared
//     memory; P and dS enter the second pair of products as bf16 packed
//     straight from the accumulators, which are the reference's rounding
//     points.
//   * Both stage the query and dO tiles (and lse, delta) with 16-byte
//     cp.async into two shared buffers, so tile i + 1 loads while tile i
//     computes; the key mask, a plain load, is issued after the copies.
// Every [B, H, T, Dh] operand of all four kernels must be 16-byte aligned
// (the wrapper copies one that is not); an unaligned one is refused.
// Later work, for long T: wgmma on 64-row warpgroup tiles, TMA staging, and
// head packing in the bf16 kernels (they run blocks of 64 rows or more at
// any T).
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
  int h;  // heads (the f32 kernels: bh -> batch row)
};

// ------------------------------------------------------------ dQ

// ---- f32: CUDA-core micro-tiles (QTile, flash_common.cuh)

template <int DHMAX, int TILE>
__host__ __device__ constexpr int dq_slot_floats(int nbuf) {
  using G = QTile<DHMAX, TILE>;
  return 2 * TILE * G::LD + nbuf * (2 * TILE * G::LD + TILE) + TILE * G::PLD;
}

template <int DHMAX, int TILE>
__global__ void __launch_bounds__(QTile<DHMAX, TILE>::NT * QTile<DHMAX, TILE>::HPB,
                                  QTile<DHMAX, TILE>::MINB)
    flash_bwd_dq_simt_kernel(BwdParams p, int nbh, int nbuf) {
  using G = QTile<DHMAX, TILE>;
  constexpr int NT = G::NT, TPG = G::TPG, MQ = G::MQ, MK = G::MK, NCH = G::NCH;
  constexpr int LD = G::LD, PLD = G::PLD;
  extern __shared__ __align__(16) float smem[];

  const int t = p.t, dh = p.dh;
  const int sl = threadIdx.x / NT, ts = threadIdx.x % NT;
  const int nqt = (t + TILE - 1) / TILE;
  const int64_t w = (int64_t)blockIdx.x * G::HPB + sl;  // this slot's query tile
  const bool slot_live = w < (int64_t)nbh * nqt;
  const int64_t bh = slot_live ? w / nqt : 0;
  const int q0 = slot_live ? (int)(w % nqt) * TILE : 0;
  const int tl = slot_live ? t : 0;  // an idle slot stages and stores nothing
  const int64_t off = bh * t * dh;
  const float* q = static_cast<const float*>(p.q) + off;
  const float* k = static_cast<const float*>(p.k) + off;
  const float* v = static_cast<const float*>(p.v) + off;
  const float* dout = static_cast<const float*>(p.dout) + off;
  const uint8_t* valid = p.valid + (bh / p.h) * t;

  float* Qs = smem + sl * dq_slot_floats<DHMAX, TILE>(nbuf);
  float* Os = Qs + TILE * LD;            // dO rows
  float* Ks = Os + TILE * LD;            // [nbuf][TILE][LD]
  float* Vs = Ks + nbuf * TILE * LD;     // [nbuf][TILE][LD]
  float* kv_s = Vs + nbuf * TILE * LD;   // [nbuf][TILE]
  float* Ds = kv_s + nbuf * TILE;        // [TILE queries][PLD]

  // Key tile k1 into buffer nb: K (across DHMAX columns, zeros past dh:
  // dS K runs over every chunk), V and the key mask, whose load is issued
  // before the copies and stored after them.
  auto stage_keys = [&](int k1, int nb) {
    const bool kvj = ts < TILE && k1 + ts < tl && valid[k1 + ts];
    stage_rows<float, TILE, LD, NT, false>(Ks + nb * TILE * LD, k, k1, tl, dh, DHMAX, ts);
    stage_rows<float, TILE, LD, NT, false>(Vs + nb * TILE * LD, v, k1, tl, dh, dh, ts);
    if (ts < TILE) kv_s[nb * TILE + ts] = kvj ? 1.0f : 0.0f;
    const int nk = max(0, min(TILE, tl - k1));
    zero_rows<LD, NT>(Ks + nb * TILE * LD, nk, min(TILE, (nk + 3) & ~3), DHMAX, ts);
  };
  const int nkt = (t + TILE - 1) / TILE;
  stage_rows<float, TILE, LD, NT, false>(Qs, q, q0, tl, dh, dh, ts);
  stage_rows<float, TILE, LD, NT, false>(Os, dout, q0, tl, dh, dh, ts);
  stage_keys(0, 0);
  cp_commit();

  const int qg = ts / TPG, r = ts % TPG, qb = qg * MQ;
  const int nrow = max(0, min(TILE, tl - q0));  // live query rows
  const bool glive = qb < nrow;
  const unsigned gm = 0xffu << (threadIdx.x & 24);  // this group's 8 lanes
  float lse[MQ], delta[MQ], acc[MQ][NCH][4];
#pragma unroll
  for (int n = 0; n < MQ; ++n) {
    const bool in = qb + n < nrow;
    lse[n] = in ? p.lse[bh * t + q0 + qb + n] : INFINITY;
    delta[n] = in ? p.delta[bh * t + q0 + qb + n] : 0.0f;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][i][e] = 0.0f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & (nbuf - 1);
    const int k0 = kt * TILE;
    // the next tile loads while this one computes
    if (kt + 1 < nkt) stage_keys(k0 + TILE, (kt + 1) & (nbuf - 1));
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Kb = Ks + buf * TILE * LD;
    const float* Vb = Vs + buf * TILE * LD;
    const float* kvb = kv_s + buf * TILE;
    if (glive) {
      // S and dP micro-tiles -> dS, [query][key] in shared memory.  Keys past
      // T (unstaged V rows) and masked keys give dS = 0, as p = 0 there.
      float s[MQ][MK], dp[MQ][MK];
      tile_dots2<MQ, MK, LD>(s, dp, Qs + qb * LD, Os + qb * LD, Kb + r * LD, Vb + r * LD,
                             TPG * LD, dh);
#pragma unroll
      for (int n = 0; n < MQ; ++n)
#pragma unroll
        for (int mm = 0; mm < MK; ++mm) {
          const int j = r + TPG * mm;
          const bool kv = kvb[j] > 0.0f;
          const float pj = expf((kv ? p.scale * s[n][mm] : NEG_INF) - lse[n]);
          Ds[(qb + n) * PLD + j] = kv ? pj * (dp[n][mm] - delta[n]) : 0.0f;  // ds.astype(k.dtype): f32
        }
      __syncwarp(gm);
      const int nk = min(TILE, tl - k0);
      pv_accum<MQ, NCH, TPG, LD, PLD>(acc, Ds + qb * PLD, Kb + 4 * r,
                                      min(TILE, (nk + 3) & ~3));
    }
    if (kt + 1 < nkt) __syncthreads();  // dS and this buffer are rewritten next
  }

  if (!glive) return;
  float* dq = static_cast<float*>(p.dq) + off;
#pragma unroll
  for (int n = 0; n < MQ; ++n) {
    if (qb + n >= nrow) continue;
    const int qi = q0 + qb + n;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int d = 4 * (r + TPG * i);
      if (d >= dh) continue;
      *reinterpret_cast<float4*>(dq + (int64_t)qi * dh + d) =
          make_float4(p.scale * acc[n][i][0], p.scale * acc[n][i][1],
                      p.scale * acc[n][i][2], p.scale * acc[n][i][3]);
    }
  }
}

// ---- bf16: tensor-core tiles (mma.sync m16n8k16, f32 accumulate)

// NW warps own 16 query rows each: 4 up to T = 128 (64-key tiles, 32 at
// Dh = 128), then 8 with 32-key tiles, whose S and dP fragments take half
// the registers (126 against 166 at Dh = 64): a third less time at T = 4096
// than 4 warps with 64-key tiles.
template <int DHMAX, int NW>  // NW: warps per block
struct DqMma {
  static constexpr int NTHR = 32 * NW;
  static constexpr int BQ = 16 * NW;                  // query rows per block, 16 per warp
  static constexpr int BK = NW == 4 && DHMAX < 128 ? 64 : 32;  // keys per streamed tile
  static constexpr int LDB = DHMAX + 8;               // bf16 row: ldmatrix rows hit distinct banks
  __host__ __device__ static constexpr int smem_bytes() {
    return (2 * BQ + 4 * BK) * LDB * 2 + 2 * BK * 4;
  }
};

template <int DHMAX, int NW>
__global__ void __launch_bounds__(DqMma<DHMAX, NW>::NTHR) flash_bwd_dq_mma_kernel(BwdParams p) {
  using bf16 = __nv_bfloat16;
  using G = DqMma<DHMAX, NW>;
  constexpr int BQ = G::BQ, BK = G::BK, LDB = G::LDB, NTHR = G::NTHR;
  constexpr int NK = DHMAX / 16, NDT = DHMAX / 8, NKT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LDB]
  bf16* Os = Qs + BQ * LDB;                        // [BQ][LDB]
  bf16* Ks = Os + BQ * LDB;                        // [2][BK][LDB]
  bf16* Vs = Ks + 2 * BK * LDB;                    // [2][BK][LDB]
  float* kv_s = reinterpret_cast<float*>(Vs + 2 * BK * LDB);  // [2][BK]

  const int t = p.t, dh = p.dh, dhp = (dh + 15) & ~15;
  const int64_t bh = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t off = bh * t * dh;
  const bf16* q = static_cast<const bf16*>(p.q) + off;
  const bf16* k = static_cast<const bf16*>(p.k) + off;
  const bf16* v = static_cast<const bf16*>(p.v) + off;
  const bf16* dout = static_cast<const bf16*>(p.dout) + off;
  const uint8_t* valid = p.valid + (int64_t)blockIdx.z * t;

  // key tile k1 into buffer nb (zeros past T) and its mask, as in the f32 kernel
  auto stage_keys = [&](int k1, int nb) {
    const bool kvj = tid < BK && k1 + tid < t && valid[k1 + tid];
    stage_rows<bf16, BK, LDB, NTHR>(Ks + nb * BK * LDB, k, k1, t, dh, dhp, tid);
    stage_rows<bf16, BK, LDB, NTHR>(Vs + nb * BK * LDB, v, k1, t, dh, dhp, tid);
    if (tid < BK) kv_s[nb * BK + tid] = kvj ? 1.0f : 0.0f;
  };
  stage_rows<bf16, BQ, LDB, NTHR>(Qs, q, q0, t, dh, dhp, tid);
  stage_rows<bf16, BQ, LDB, NTHR>(Os, dout, q0, t, dh, dhp, tid);
  stage_keys(0, 0);
  cp_commit();

  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  // rows g and g + 8 of this warp's strip; rows past T behave as fully
  // masked rows (lse = +inf gives p = 0)
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    lse[h] = qi < t ? p.lse[bh * t + qi] : INFINITY;
    delta[h] = qi < t ? p.delta[bh * t + qi] : 0.0f;
  }
  uint32_t aq[NK][4], ao[NK][4];
  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const int nkt = (t + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) stage_keys((kt + 1) * BK, buf ^ 1);  // loads while this tile computes
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (kt == 0) {
      load_a_strip<NK, LDB>(aq, Qs, warp * 16, dhp, lane);
      load_a_strip<NK, LDB>(ao, Os, warp * 16, dhp, lane);
    }
    const bf16* Kb = Ks + buf * BK * LDB;
    const bf16* Vb = Vs + buf * BK * LDB;
    const float* kvb = kv_s + buf * BK;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BK keys
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk * 16 >= dhp) break;
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4], bv[4];
        const int brow = np * 16 + (mi >> 1) * 8 + (lane & 7);
        const int bcol = kk * 16 + (mi & 1) * 8;
        ldsm_x4(bk, Kb + brow * LDB + bcol);
        ldsm_x4(bv, Vb + brow * LDB + bcol);
        mma_bf16(s[2 * np], aq[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq[kk], bk[2], bk[3]);
        mma_bf16(dp[2 * np], ao[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ao[kk], bv[2], bv[3]);
      }
    }
    // dS = p (dp - delta) on the fragments (e < 2: row g, e >= 2: row g + 8)
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kv = kvb[n * 8 + 2 * tq + (e & 1)] > 0.0f;
        const float pv = expf((kv ? p.scale * s[n][e] : NEG_INF) - lse[e >> 1]);
        s[n][e] = pv * (dp[n][e] - delta[e >> 1]);
      }
    // dQ += dS K: dS packed to bf16 (ds.astype(k.dtype)) as A fragments, K
    // by transposing ldmatrix
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      const uint32_t ad[4] = {pack_bf16(s[2 * kq][0], s[2 * kq][1]),
                              pack_bf16(s[2 * kq][2], s[2 * kq][3]),
                              pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]),
                              pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3])};
#pragma unroll
      for (int np = 0; np < DHMAX / 16; ++np) {
        if (np * 16 >= dhp) break;
        uint32_t bk[4];
        ldsm_x4_t(bk, Kb + (kq * 16 + (mi & 1) * 8 + (lane & 7)) * LDB + np * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * np], ad, bk[0], bk[1]);
        mma_bf16(acc[2 * np + 1], ad, bk[2], bk[3]);
      }
    }
    if (kt + 1 < nkt) __syncthreads();  // this buffer is rewritten next
  }

  bf16* dq = static_cast<bf16*>(p.dq) + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    if (qi >= t) continue;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n * 8 >= dh) break;
      *reinterpret_cast<uint32_t*>(dq + (int64_t)qi * dh + n * 8 + 2 * tq) =
          pack_bf16(p.scale * acc[n][2 * h], p.scale * acc[n][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ dK / dV

// ---- f32: CUDA-core tile products

template <int DHMAX, int TILE>
struct Simt {
  static constexpr int NT = TILE * 4;           // threads per slot (head tile)
  // slots (heads) per block: 4 at TILE 16; one at TILE 32, where 4 blocks
  // of 128 threads per SM hold the 512 Bert4Rec heads (Dh 32) in one wave
  // and each starts computing as soon as its own operands land (two heads
  // per 256-thread block ran slower there)
  static constexpr int HPB = TILE == 16 ? 4 : 1;
  static constexpr int MINB = TILE == 32 && DHMAX == 32 ? 4 : 1;  // blocks per SM
  static constexpr int LD = DHMAX + 4;          // f32 row of a staged tile
  static constexpr int PLD = TILE + 4;          // P / dS rows: [query][key]
  // S^T micro-tile: MK keys x MQ queries (shared memory serves 128 B per
  // clock against 128 FMA, so register reuse matters; at small T so do
  // short per-thread chains: 4 x 2 ran fastest at TILE 32 of the shapes
  // tried), and dK / dV slices of K3 keys x 4 dims.  A slot loops when a
  // live tile has more micro-tiles than threads.
  static constexpr int MK = TILE == 16 ? 2 : 4;
  static constexpr int MQ = TILE == 64 ? 4 : 2;
  static constexpr int DC = DHMAX / 4;          // 4-dim chunks of dK / dV
  static constexpr int K3 = TILE * DC / NT;     // dK / dV keys per thread
  __host__ __device__ static constexpr int slot_floats(int nbuf) {
    return 2 * TILE * LD + nbuf * (2 * TILE * LD + 2 * TILE) + 2 * TILE * PLD + TILE;
  }
};

template <int N>
__device__ __forceinline__ void lds_vec(float (&a)[N], const float* s) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(s + i);
      a[i] = v.x;
      a[i + 1] = v.y;
    }
  }
}

template <int DHMAX, int TILE>
__global__ void __launch_bounds__(Simt<DHMAX, TILE>::NT * Simt<DHMAX, TILE>::HPB,
                                  Simt<DHMAX, TILE>::MINB)
    flash_bwd_dkv_simt_kernel(BwdParams p, int nbh, int nbuf) {
  using G = Simt<DHMAX, TILE>;
  constexpr int NT = G::NT, LD = G::LD, PLD = G::PLD, MK = G::MK, MQ = G::MQ;
  constexpr int DC = G::DC, K3 = G::K3;
  extern __shared__ __align__(16) float smem[];

  const int t = p.t, dh = p.dh;
  const int sl = threadIdx.x / NT, ts = threadIdx.x % NT;
  const int nkt = (t + TILE - 1) / TILE;
  const int64_t w = (int64_t)blockIdx.x * G::HPB + sl;  // this slot's head tile
  const bool slot_live = w < (int64_t)nbh * nkt;
  const int64_t bh = slot_live ? w / nkt : 0;
  const int k0 = slot_live ? (int)(w % nkt) * TILE : 0;
  const int tl = slot_live ? t : 0;  // an idle slot stages and stores nothing
  const int64_t off = bh * t * dh;
  const float* q = static_cast<const float*>(p.q) + off;
  const float* k = static_cast<const float*>(p.k) + off;
  const float* v = static_cast<const float*>(p.v) + off;
  const float* dout = static_cast<const float*>(p.dout) + off;
  const uint8_t* valid = p.valid + (bh / p.h) * t;
  const float* lse = p.lse + bh * t;
  const float* delta = p.delta + bh * t;

  float* Ks = smem + sl * G::slot_floats(nbuf);
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;            // [nbuf][TILE][LD]
  float* Os = Qs + nbuf * TILE * LD;     // [nbuf][TILE][LD]
  float* lse_s = Os + nbuf * TILE * LD;  // [nbuf][TILE]
  float* del_s = lse_s + nbuf * TILE;    // [nbuf][TILE]
  float* Ps = del_s + nbuf * TILE;       // [TILE queries][PLD]
  float* Ds = Ps + TILE * PLD;
  float* kv_s = Ds + TILE * PLD;         // [TILE]

  // The key tile and the first query tile, one copy group.  The key mask
  // is a plain load: issued first, stored to shared memory after the copies
  // are issued, so its latency overlaps theirs.
  const int jm = ts < TILE && k0 + ts < tl ? k0 + ts : -1;
  const bool kvj = jm >= 0 && valid[jm];
  stage_rows<float, TILE, LD, NT, false>(Ks, k, k0, tl, dh, dh, ts);
  stage_rows<float, TILE, LD, NT, false>(Vs, v, k0, tl, dh, dh, ts);
  stage_rows<float, TILE, LD, NT, false>(Qs, q, 0, tl, dh, dh, ts);
  stage_rows<float, TILE, LD, NT, false>(Os, dout, 0, tl, dh, dh, ts);
  stage_stat<TILE, NT>(lse_s, lse, 0, tl, ts);
  stage_stat<TILE, NT>(del_s, delta, 0, tl, ts);
  cp_commit();
  if (ts < TILE) kv_s[ts] = kvj ? 1.0f : 0.0f;

  // Only the live part of a tile is computed: nk keys (the key tile's rows
  // below T) and, per query tile, nrow rows.  Phase 1 deals the nkg x nqg
  // micro-tiles covering them to the slot's threads in turn (queries qg,
  // qg + nqg, ... so neighbouring threads read neighbouring rows); the
  // dK / dV threads of keys >= T skip phase 3.
  const int nk = max(0, min(TILE, tl - k0));
  const int nkg = (nk + MK - 1) / MK;
  const int dc = ts % DC, kg3 = ts / DC;  // dK / dV slice
  const bool dlive = 4 * dc < dh && kg3 * K3 < nk;
  float dk[K3][4], dv[K3][4];
#pragma unroll
  for (int m = 0; m < K3; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[m][e] = dv[m][e] = 0.0f;

  for (int qt = 0; qt < nkt; ++qt) {
    const int buf = qt & (nbuf - 1);
    if (qt + 1 < nkt) {  // the next tile loads while this one computes
      const int nb = (qt + 1) & (nbuf - 1);
      const int q1 = (qt + 1) * TILE;
      stage_rows<float, TILE, LD, NT, false>(Qs + nb * TILE * LD, q, q1, tl, dh, dh, ts);
      stage_rows<float, TILE, LD, NT, false>(Os + nb * TILE * LD, dout, q1, tl, dh, dh, ts);
      stage_stat<TILE, NT>(lse_s + nb * TILE, lse, q1, tl, ts);
      stage_stat<TILE, NT>(del_s + nb * TILE, delta, q1, tl, ts);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Qb = Qs + buf * TILE * LD;
    const float* Ob = Os + buf * TILE * LD;

    // S^T and dP^T micro-tiles (keys kg*MK + m, queries qg + nqg*n) -> P and
    // dS, [query][key] in shared memory
    const int q0 = qt * TILE;
    const int nrow = max(0, min(TILE, tl - q0));  // live query rows
    const int nqg = (nrow + MQ - 1) / MQ;
    for (int mt = ts; mt < nkg * nqg; mt += NT) {
      const int kg = mt / nqg, qg = mt - kg * nqg;
      float sc[MK][MQ], dp[MK][MQ];
      tile_dots2<MK, MQ, LD>(sc, dp, Ks + kg * MK * LD, Vs + kg * MK * LD, Qb + qg * LD,
                             Ob + qg * LD, nqg * LD, dh);
#pragma unroll
      for (int n = 0; n < MQ; ++n) {
        const int qi = qg + nqg * n;
        if (qi >= nrow) continue;
        const float l = lse_s[buf * TILE + qi];
        const float dl = del_s[buf * TILE + qi];
#pragma unroll
        for (int m = 0; m < MK; ++m) {
          const int kj = kg * MK + m;
          const float pv = expf((kv_s[kj] > 0.0f ? p.scale * sc[m][n] : NEG_INF) - l);
          Ps[qi * PLD + kj] = pv;
          Ds[qi * PLD + kj] = pv * (dp[m][n] - dl);
        }
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's rows below T
    if (dlive) {
#pragma unroll 4
      for (int i = 0; i < nrow; ++i) {
        const float4 o = *reinterpret_cast<const float4*>(Ob + i * LD + 4 * dc);
        const float4 qq = *reinterpret_cast<const float4*>(Qb + i * LD + 4 * dc);
        float pk[K3], dsk[K3];
        lds_vec<K3>(pk, Ps + i * PLD + kg3 * K3);
        lds_vec<K3>(dsk, Ds + i * PLD + kg3 * K3);
#pragma unroll
        for (int m = 0; m < K3; ++m) {
          dv[m][0] = fmaf(pk[m], o.x, dv[m][0]);
          dv[m][1] = fmaf(pk[m], o.y, dv[m][1]);
          dv[m][2] = fmaf(pk[m], o.z, dv[m][2]);
          dv[m][3] = fmaf(pk[m], o.w, dv[m][3]);
          dk[m][0] = fmaf(dsk[m], qq.x, dk[m][0]);
          dk[m][1] = fmaf(dsk[m], qq.y, dk[m][1]);
          dk[m][2] = fmaf(dsk[m], qq.z, dk[m][2]);
          dk[m][3] = fmaf(dsk[m], qq.w, dk[m][3]);
        }
      }
    }
    if (qt + 1 < nkt) __syncthreads();  // P, dS and this buffer are rewritten next
  }
  if (!dlive) return;
  float* dk_o = static_cast<float*>(p.dk) + off;
  float* dv_o = static_cast<float*>(p.dv) + off;
#pragma unroll
  for (int m = 0; m < K3; ++m) {
    const int key = k0 + kg3 * K3 + m;
    if (key >= tl) continue;
    const int64_t o = (int64_t)key * dh + 4 * dc;
    const float4 a = make_float4(p.scale * dk[m][0], p.scale * dk[m][1],
                                 p.scale * dk[m][2], p.scale * dk[m][3]);
    *reinterpret_cast<float4*>(dk_o + o) = a;
    *reinterpret_cast<float4*>(dv_o + o) =
        make_float4(dv[m][0], dv[m][1], dv[m][2], dv[m][3]);
  }
}

// ---- bf16: tensor-core tile products (mma.sync m16n8k16, f32 accumulate)

template <int DHMAX>
struct Mma {
  static constexpr int BK = 64;                     // keys per block, 16 per warp
  static constexpr int BQ = DHMAX == 128 ? 32 : 64;  // queries per streamed tile
  static constexpr int LDB = DHMAX + 8;             // bf16 row: ldmatrix rows hit distinct banks
  __host__ __device__ static constexpr int smem_bytes() {
    return (2 * BK + 4 * BQ) * LDB * 2 + (4 * BQ + BK) * 4;
  }
};

template <int DHMAX>
__global__ void __launch_bounds__(128) flash_bwd_dkv_mma_kernel(BwdParams p) {
  using bf16 = __nv_bfloat16;
  using G = Mma<DHMAX>;
  constexpr int BK = G::BK, BQ = G::BQ, LDB = G::LDB;
  constexpr int NQT = BQ / 8, NDT = DHMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LDB;
  bf16* Qs = Vs + BK * LDB;        // [2][BQ][LDB]
  bf16* Os = Qs + 2 * BQ * LDB;    // [2][BQ][LDB]
  float* lse_s = reinterpret_cast<float*>(Os + 2 * BQ * LDB);  // [2][BQ]
  float* del_s = lse_s + 2 * BQ;   // [2][BQ]
  float* kv_s = del_s + 2 * BQ;    // [BK]

  const int t = p.t, dh = p.dh, dhp = (dh + 15) & ~15;
  const int64_t bh = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t off = bh * t * dh;
  const bf16* q = static_cast<const bf16*>(p.q) + off;
  const bf16* k = static_cast<const bf16*>(p.k) + off;
  const bf16* v = static_cast<const bf16*>(p.v) + off;
  const bf16* dout = static_cast<const bf16*>(p.dout) + off;
  const uint8_t* valid = p.valid + (int64_t)blockIdx.z * t;
  const float* lse = p.lse + bh * t;
  const float* delta = p.delta + bh * t;

  stage_rows<bf16, BK, LDB, 128>(Ks, k, k0, t, dh, dhp, tid);
  stage_rows<bf16, BK, LDB, 128>(Vs, v, k0, t, dh, dhp, tid);
  stage_rows<bf16, BQ, LDB, 128>(Qs, q, 0, t, dh, dhp, tid);
  stage_rows<bf16, BQ, LDB, 128>(Os, dout, 0, t, dh, dhp, tid);
  stage_stat<BQ, 128>(lse_s, lse, 0, t, tid);
  stage_stat<BQ, 128>(del_s, delta, 0, t, tid);
  cp_commit();
  for (int j = tid; j < BK; j += 128) kv_s[j] = (k0 + j < t && valid[k0 + j]) ? 1.0f : 0.0f;

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const int g = lane >> 2, tq = lane & 3;
  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;  // this thread's accumulator rows
  const int mi = lane >> 3;                       // ldmatrix: which 8x8 matrix
  const int nq = (t + BQ - 1) / BQ;

  for (int qt = 0; qt < nq; ++qt) {
    const int buf = qt & 1;
    if (qt + 1 < nq) {
      const int q1 = (qt + 1) * BQ;
      stage_rows<bf16, BQ, LDB, 128>(Qs + (buf ^ 1) * BQ * LDB, q, q1, t, dh, dhp, tid);
      stage_rows<bf16, BQ, LDB, 128>(Os + (buf ^ 1) * BQ * LDB, dout, q1, t, dh, dhp, tid);
      stage_stat<BQ, 128>(lse_s + (buf ^ 1) * BQ, lse, q1, t, tid);
      stage_stat<BQ, 128>(del_s + (buf ^ 1) * BQ, delta, q1, t, tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Qb = Qs + buf * BQ * LDB;
    const bf16* Ob = Os + buf * BQ * LDB;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float s[NQT][4], dp[NQT][4];
#pragma unroll
    for (int n = 0; n < NQT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DHMAX / 16; ++kk) {
      if (kk * 16 >= dhp) break;
      uint32_t ak[4], av[4];
      const int arow = warp * 16 + (lane & 15), acol = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ak, Ks + arow * LDB + acol);
      ldsm_x4(av, Vs + arow * LDB + acol);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t bq[4], bo[4];
        const int brow = np * 16 + (mi >> 1) * 8 + (lane & 7);
        const int bcol = kk * 16 + (mi & 1) * 8;
        ldsm_x4(bq, Qb + brow * LDB + bcol);
        ldsm_x4(bo, Ob + brow * LDB + bcol);
        mma_bf16(s[2 * np], ak, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16(dp[2 * np], av, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // P and dS, rounded to bf16 and packed as A operands
    const int q0 = qt * BQ;
    const bool kv0 = kv_s[kr0] > 0.0f, kv1 = kv_s[kr1] > 0.0f;
    uint32_t pa[NQT][2], da[NQT][2];
#pragma unroll
    for (int n = 0; n < NQT; ++n) {
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1);
        const bool qin = q0 + c < t;  // rows past T: fully masked
        const float l = qin ? lse_s[buf * BQ + c] : INFINITY;
        const float dl = qin ? del_s[buf * BQ + c] : 0.0f;
        const bool kvr = e < 2 ? kv0 : kv1;
        pv[e] = expf((kvr ? p.scale * s[n][e] : NEG_INF) - l);
        dsv[e] = pv[e] * (dp[n][e] - dl);
      }
      pa[n][0] = pack_bf16(pv[0], pv[1]);
      pa[n][1] = pack_bf16(pv[2], pv[3]);
      da[n][0] = pack_bf16(dsv[0], dsv[1]);
      da[n][1] = pack_bf16(dsv[2], dsv[3]);
    }
    // dV += P^T dO and dK += dS^T Q: A from the packed tiles, B by
    // transposing ldmatrix of the [query][dim] tiles
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      const uint32_t ap[4] = {pa[2 * kq][0], pa[2 * kq][1], pa[2 * kq + 1][0], pa[2 * kq + 1][1]};
      const uint32_t ad[4] = {da[2 * kq][0], da[2 * kq][1], da[2 * kq + 1][0], da[2 * kq + 1][1]};
#pragma unroll
      for (int np = 0; np < DHMAX / 16; ++np) {
        if (np * 16 >= dhp) break;
        uint32_t bo[4], bq[4];
        const int brow = kq * 16 + (mi & 1) * 8 + (lane & 7);
        const int bcol = np * 16 + (mi >> 1) * 8;
        ldsm_x4_t(bo, Ob + brow * LDB + bcol);
        ldsm_x4_t(bq, Qb + brow * LDB + bcol);
        mma_bf16(dv[2 * np], ap, bo[0], bo[1]);
        mma_bf16(dv[2 * np + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[2 * np], ad, bq[0], bq[1]);
        mma_bf16(dk[2 * np + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this buffer is rewritten next
  }
  bf16* dk_o = static_cast<bf16*>(p.dk) + off;
  bf16* dv_o = static_cast<bf16*>(p.dv) + off;
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    const int col = n * 8 + 2 * tq;
    if (col >= dh) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + (h ? kr1 : kr0);
      if (key >= t) continue;
      const int64_t o = (int64_t)key * dh + col;
      *reinterpret_cast<uint32_t*>(dk_o + o) =
          pack_bf16(p.scale * dk[n][2 * h], p.scale * dk[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv_o + o) = pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers

template <int DHMAX, int TILE>
void launch_dq_simt(const BwdParams& p, int b, int h, cudaStream_t stream) {
  using G = QTile<DHMAX, TILE>;
  const int nt = (p.t + TILE - 1) / TILE;
  const int nbuf = nt > 1 ? 2 : 1;
  const int bytes = G::HPB * dq_slot_floats<DHMAX, TILE>(nbuf) * 4;
  const int64_t slots = (int64_t)b * h * nt;
  const int64_t blocks = (slots + G::HPB - 1) / G::HPB;
  allow_smem(flash_bwd_dq_simt_kernel<DHMAX, TILE>, bytes);
  flash_bwd_dq_simt_kernel<DHMAX, TILE>
      <<<(unsigned)blocks, G::NT * G::HPB, bytes, stream>>>(p, b * h, nbuf);
}

template <int DHMAX>
void launch_dq_f32(const BwdParams& p, int b, int h, cudaStream_t stream) {
  // the tile height (and so the heads per block) follows T; two products
  // per micro-tile keep dQ at 32-row tiles above T = 24 (64 ran 10% slower
  // at T = 4096)
  if (p.t <= 16) launch_dq_simt<DHMAX, 16>(p, b, h, stream);
  else if (p.t <= 24) launch_dq_simt<DHMAX, 24>(p, b, h, stream);
  else launch_dq_simt<DHMAX, 32>(p, b, h, stream);
}

template <int DHMAX, int NW>
void launch_dq_mma(const BwdParams& p, int b, int h, cudaStream_t stream) {
  using G = DqMma<DHMAX, NW>;
  const dim3 grid((p.t + G::BQ - 1) / G::BQ, h, b);
  allow_smem(flash_bwd_dq_mma_kernel<DHMAX, NW>, G::smem_bytes());
  flash_bwd_dq_mma_kernel<DHMAX, NW><<<grid, G::NTHR, G::smem_bytes(), stream>>>(p);
}

template <int DHMAX>
void launch_dq_bf16(const BwdParams& p, int b, int h, cudaStream_t stream) {
  if (p.t < 128) launch_dq_mma<DHMAX, 4>(p, b, h, stream);
  else launch_dq_mma<DHMAX, 8>(p, b, h, stream);
}

template <int DHMAX, int TILE>
void launch_dkv_simt(const BwdParams& p, int b, int h, cudaStream_t stream) {
  using G = Simt<DHMAX, TILE>;
  const int nkt = (p.t + TILE - 1) / TILE;
  const int nbuf = nkt > 1 ? 2 : 1;
  const int bytes = G::HPB * G::slot_floats(nbuf) * 4;
  const int64_t slots = (int64_t)b * h * nkt;
  const int64_t blocks = (slots + G::HPB - 1) / G::HPB;
  allow_smem(flash_bwd_dkv_simt_kernel<DHMAX, TILE>, bytes);
  const unsigned threads = G::NT * G::HPB;
  flash_bwd_dkv_simt_kernel<DHMAX, TILE><<<(unsigned)blocks, threads, bytes, stream>>>(p, b * h, nbuf);
}

template <int DHMAX>
void launch_dkv_f32(const BwdParams& p, int b, int h, cudaStream_t stream) {
  // the key-tile height (and so the heads per block) follows T
  if (p.t <= 16) launch_dkv_simt<DHMAX, 16>(p, b, h, stream);
  else if (p.t <= 32 || DHMAX == 128) launch_dkv_simt<DHMAX, 32>(p, b, h, stream);
  else launch_dkv_simt<DHMAX, (DHMAX == 128 ? 32 : 64)>(p, b, h, stream);
}

template <int DHMAX>
void launch_dkv_bf16(const BwdParams& p, int b, int h, cudaStream_t stream) {
  using G = Mma<DHMAX>;
  const dim3 grid((p.t + G::BK - 1) / G::BK, h, b);
  allow_smem(flash_bwd_dkv_mma_kernel<DHMAX>, G::smem_bytes());
  flash_bwd_dkv_mma_kernel<DHMAX><<<grid, 128, G::smem_bytes(), stream>>>(p);
}

template <typename T>
void launch_dh(const BwdParams& p, int b, int h, bool dq, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  if (dq && F32) {
    if (p.dh <= 32) launch_dq_f32<32>(p, b, h, stream);
    else if (p.dh <= 64) launch_dq_f32<64>(p, b, h, stream);
    else launch_dq_f32<128>(p, b, h, stream);
  } else if (dq) {
    if (p.dh <= 32) launch_dq_bf16<32>(p, b, h, stream);
    else if (p.dh <= 64) launch_dq_bf16<64>(p, b, h, stream);
    else launch_dq_bf16<128>(p, b, h, stream);
  } else if (F32) {
    if (p.dh <= 32) launch_dkv_f32<32>(p, b, h, stream);
    else if (p.dh <= 64) launch_dkv_f32<64>(p, b, h, stream);
    else launch_dkv_f32<128>(p, b, h, stream);
  } else {
    if (p.dh <= 32) launch_dkv_bf16<32>(p, b, h, stream);
    else if (p.dh <= 64) launch_dkv_bf16<64>(p, b, h, stream);
    else launch_dkv_bf16<128>(p, b, h, stream);
  }
}

int run(int dtype, BwdParams p, int b, int h, bool dq, void* stream) {
  if (p.dh <= 0 || p.dh > 128 || p.dh % 8 != 0 || p.t <= 0 || b <= 0 ||
      h <= 0 || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  p.h = h;
  // the kernels stage and store with 16-byte accesses
  void* out0 = dq ? p.dq : p.dk;
  void* out1 = dq ? p.dq : p.dv;
  if (!(aligned16(p.q) && aligned16(p.k) && aligned16(p.v) && aligned16(p.dout) &&
        aligned16(out0) && aligned16(out1)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) launch_dh<float>(p, b, h, dq, s);
  else if (dtype == DTYPE_BF16) launch_dh<__nv_bfloat16>(p, b, h, dq, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const uint8_t* valid, const float* lse,
                                 const float* delta, void* dq, int b, int h,
                                 int t, int dh, float scale, void* stream) {
  BwdParams p{q, k, v, dout, valid, lse, delta, dq, nullptr, nullptr, t, dh, scale, h};
  return run(dtype, p, b, h, true, stream);
}

extern "C" int flash_attn_bwd_dkv(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const uint8_t* valid, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int b, int h, int t, int dh, float scale,
                                  void* stream) {
  BwdParams p{q, k, v, dout, valid, lse, delta, nullptr, dk, dv, t, dh, scale, h};
  return run(dtype, p, b, h, false, stream);
}
