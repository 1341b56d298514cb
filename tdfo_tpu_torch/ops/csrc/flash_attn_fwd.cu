// Flash-attention forward: softmax(Q K^T / sqrt(Dh), key mask) V with an
// online softmax, plus the per-row logsumexp the backward rebuilds P from.
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::_flash_kernel (:73), launched by
// _flash_fwd_impl (:151, pallas_call :174).  What it computes is the same,
// rule for rule:
//   s = scale * q.k (f32), masked keys -> NEG_INF = finfo(f32).min (:93);
//   running max m, shift = 0 while m_new <= NEG_INF/2 (:95), p = 0 on masked
//   keys (:97), correction guarded the same way (:98);
//   p rounded to the V dtype before P.V (:101), f32 accumulation, while l
//   sums the unrounded p;
//   out = acc / l where l > 0, else 0; lse = m + log(l), +inf on a fully
//   masked row (:111-113).
// What it does not carry over: the TPU's [B, H, 8, T] sublane-broadcast lse
// and mask layouts (Mosaic's (8, 128) tiling) and the padding of T to the
// block size (_pad_t, :138-168).  lse is [B, H, T] f32, and the kernel masks
// the ragged last tile itself (keys >= T are invalid, rows >= T are not
// written), so it allocates no padded copies.
//
// Bound on the H100.  Per (b, h) the work is 4*T^2*Dh flops against
// (4*T*Dh + T) elements of traffic.  At the Bert4Rec shape (B = 256, H = 2,
// T = 20, Dh = 32, f32) it is bytes and latency: 0.00158 ms of DRAM traffic,
// one tile per head, so a block's time is its operands' DRAM round trip and
// then a short chain of dependent shared-memory phases.  At long T it is
// operations: at T = 4096, Dh = 64, B = 1, H = 8 the bound is 0.513 ms in f32
// (67 TFLOP/s of the CUDA cores; an exact f32 product cannot use the tensor
// cores, and TF32 would miss the 2e-5 gate) and 0.0347 ms in bf16 (989
// TFLOP/s of the tensor cores).
//
//   * f32 (flash_fwd_simt_kernel, CUDA cores): register micro-tiles
//     (QTile, flash_common.cuh).  Per key tile each thread forms an MQ x MK
//     micro-tile of S from float4 shared reads as independent FMAs; the row
//     max is one 3-step shuffle over the 8 lanes sharing the rows, once per
//     tile; P goes to a [query][key] shared tile read back only by the same
//     8 lanes (a __syncwarp, no block barrier), and P.V is a second
//     micro-tile product into register accumulators; l stays a per-thread
//     partial until the end.  Only the live part is computed: row groups
//     past T idle, the key loop stops at T, P.V stops at the tile's last
//     key rounded up to 4, and rows past T are never staged.  At T <= one
//     tile (the Bert4Rec shape) the loop is one pass, with no rescaling.
//   * bf16 (flash_fwd_mma_kernel, tensor cores; the FlashAttention-2
//     forward layout): four warps (eight from T = 128) own 16 query rows
//     each, whose Q fragments are loaded once by ldmatrix and stay in
//     registers; S = Q K^T is mma.sync.m16n8k16 bf16 -> f32 with K by
//     ldmatrix; the online softmax runs on the accumulator fragments (a row
//     lies across a quad: two __shfl_xor per reduction); P is packed to
//     bf16 straight from the accumulators into A fragments (the reference's
//     rounding point) and P.V takes V by ldmatrix.trans.
//   * Both stage with 16-byte cp.async, K/V tiles into two buffers so tile
//     i + 1 loads while tile i computes; the key-mask load is issued before
//     the copies and stored after them.  Every [B, H, T, Dh] operand must be
//     16-byte aligned (the wrapper copies one that is not); an unaligned one
//     is refused.
// Later work, for long T: wgmma on 64-row warpgroup tiles, TMA staging and
// warp specialisation in the bf16 kernel.
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
  int h;  // heads (bh -> batch row)
};

// ---- f32: CUDA-core micro-tiles

template <int DHMAX, int TILE>
__host__ __device__ constexpr int fwd_slot_floats(int nbuf) {
  using G = QTile<DHMAX, TILE>;
  return TILE * G::LD + nbuf * (2 * TILE * G::LD + TILE) + TILE * G::PLD;
}

template <int DHMAX, int TILE>
__global__ void __launch_bounds__(QTile<DHMAX, TILE>::NT * QTile<DHMAX, TILE>::HPB,
                                  QTile<DHMAX, TILE>::MINB)
    flash_fwd_simt_kernel(FwdParams p, int nbh, int nbuf) {
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
  const uint8_t* valid = p.valid + (bh / p.h) * t;

  float* Qs = smem + sl * fwd_slot_floats<DHMAX, TILE>(nbuf);
  float* Ks = Qs + TILE * LD;            // [nbuf][TILE][LD]
  float* Vs = Ks + nbuf * TILE * LD;     // [nbuf][TILE][LD]
  float* kv_s = Vs + nbuf * TILE * LD;   // [nbuf][TILE]
  float* Ps = kv_s + nbuf * TILE;        // [TILE queries][PLD]

  // Key tile k1 into buffer nb: K, V (across DHMAX columns, zeros past dh:
  // P.V runs over every chunk) and the key mask, whose load is issued
  // before the copies and stored after them.
  auto stage_keys = [&](int k1, int nb) {
    const bool kvj = ts < TILE && k1 + ts < tl && valid[k1 + ts];
    stage_rows<float, TILE, LD, NT, false>(Ks + nb * TILE * LD, k, k1, tl, dh, dh, ts);
    stage_rows<float, TILE, LD, NT, false>(Vs + nb * TILE * LD, v, k1, tl, dh, DHMAX, ts);
    if (ts < TILE) kv_s[nb * TILE + ts] = kvj ? 1.0f : 0.0f;
    const int nk = max(0, min(TILE, tl - k1));
    zero_rows<LD, NT>(Vs + nb * TILE * LD, nk, min(TILE, (nk + 3) & ~3), DHMAX, ts);
  };
  const int nkt = (t + TILE - 1) / TILE;
  stage_rows<float, TILE, LD, NT, false>(Qs, q, q0, tl, dh, dh, ts);
  stage_keys(0, 0);
  cp_commit();

  const int qg = ts / TPG, r = ts % TPG, qb = qg * MQ;
  const int nrow = max(0, min(TILE, tl - q0));  // live query rows
  const bool glive = qb < nrow;
  const unsigned gm = 0xffu << (threadIdx.x & 24);  // this group's 8 lanes
  float acc[MQ][NCH][4], m[MQ], l[MQ];
#pragma unroll
  for (int n = 0; n < MQ; ++n) {
    m[n] = NEG_INF;
    l[n] = 0.0f;
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
      float s[MQ][MK], mt[MQ];
      tile_dots<MQ, MK, LD>(s, Qs + qb * LD, Kb + r * LD, TPG * LD, dh);
#pragma unroll
      for (int n = 0; n < MQ; ++n) {
        mt[n] = NEG_INF;
#pragma unroll
        for (int mm = 0; mm < MK; ++mm) {
          s[n][mm] = kvb[r + TPG * mm] > 0.0f ? p.scale * s[n][mm] : NEG_INF;
          mt[n] = fmaxf(mt[n], s[n][mm]);
        }
#pragma unroll
        for (int x = 1; x < TPG; x <<= 1) mt[n] = fmaxf(mt[n], __shfl_xor_sync(gm, mt[n], x));
      }
#pragma unroll
      for (int n = 0; n < MQ; ++n) {
        const float m_new = fmaxf(m[n], mt[n]);
        const float shift = m_new <= NEG_INF * 0.5f ? 0.0f : m_new;
        float lsum = 0.0f;
#pragma unroll
        for (int mm = 0; mm < MK; ++mm) {
          const int j = r + TPG * mm;
          const float pj = kvb[j] > 0.0f ? expf(s[n][mm] - shift) : 0.0f;
          lsum += pj;
          Ps[(qb + n) * PLD + j] = pj;  // p.astype(v.dtype): f32
        }
        if (kt > 0) {  // the first tile has nothing to rescale
          const float corr = m[n] <= NEG_INF * 0.5f ? 0.0f : expf(m[n] - shift);
          l[n] *= corr;
#pragma unroll
          for (int i = 0; i < NCH; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][i][e] *= corr;
        }
        l[n] += lsum;
        m[n] = m_new;
      }
      __syncwarp(gm);
      const int nk = min(TILE, tl - k0);
      pv_accum<MQ, NCH, TPG, LD, PLD>(acc, Ps + qb * PLD, Vb + 4 * r,
                                      min(TILE, (nk + 3) & ~3));
    }
    if (kt + 1 < nkt) __syncthreads();  // P and this buffer are rewritten next
  }

  if (!glive) return;
  float* o = static_cast<float*>(p.out) + off;
#pragma unroll
  for (int n = 0; n < MQ; ++n) {
#pragma unroll
    for (int x = 1; x < TPG; x <<= 1) l[n] += __shfl_xor_sync(gm, l[n], x);
    const int qi = q0 + qb + n;
    if (qb + n >= nrow) continue;
    const float ln = fmaxf(l[n], 1e-30f);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int d = 4 * (r + TPG * i);
      if (d >= dh) continue;
      float4 y;
      y.x = l[n] > 0.0f ? acc[n][i][0] / ln : 0.0f;
      y.y = l[n] > 0.0f ? acc[n][i][1] / ln : 0.0f;
      y.z = l[n] > 0.0f ? acc[n][i][2] / ln : 0.0f;
      y.w = l[n] > 0.0f ? acc[n][i][3] / ln : 0.0f;
      *reinterpret_cast<float4*>(o + (int64_t)qi * dh + d) = y;
    }
    if (p.lse != nullptr && r == 0)
      p.lse[bh * t + qi] = l[n] > 0.0f ? m[n] + logf(ln) : INFINITY;
  }
}

// ---- bf16: tensor-core tiles (mma.sync m16n8k16, f32 accumulate)

// NW warps own 16 query rows each: 4 below T = 128, then 8, so that a
// block's K/V tiles feed twice the rows once T fills 128 (6% less time at
// T = 4096, Dh = 64 than 4 warps).  Two 16-row strips per warp (K
// fragments reused, but 222 registers) and 32-key tiles ran slower.
template <int DHMAX, int NW>  // NW: warps per block
struct FwdMma {
  static constexpr int NTHR = 32 * NW;
  static constexpr int BQ = 16 * NW;        // query rows per block, 16 per warp
  static constexpr int BK = 64;             // keys per streamed tile
  static constexpr int LDB = DHMAX + 8;     // bf16 row: ldmatrix rows hit distinct banks
  __host__ __device__ static constexpr int smem_bytes() {
    return (BQ + 4 * BK) * LDB * 2 + 2 * BK * 4;
  }
};

template <int DHMAX, int NW>
__global__ void __launch_bounds__(FwdMma<DHMAX, NW>::NTHR) flash_fwd_mma_kernel(FwdParams p) {
  using bf16 = __nv_bfloat16;
  using G = FwdMma<DHMAX, NW>;
  constexpr int BQ = G::BQ, BK = G::BK, LDB = G::LDB, NTHR = G::NTHR;
  constexpr int NK = DHMAX / 16, NDT = DHMAX / 8, NKT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LDB]
  bf16* Ks = Qs + BQ * LDB;                        // [2][BK][LDB]
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
  const uint8_t* valid = p.valid + (int64_t)blockIdx.z * t;

  // key tile k1 into buffer nb (zeros past T) and its mask, as in the f32 kernel
  auto stage_keys = [&](int k1, int nb) {
    const bool kvj = tid < BK && k1 + tid < t && valid[k1 + tid];
    stage_rows<bf16, BK, LDB, NTHR>(Ks + nb * BK * LDB, k, k1, t, dh, dhp, tid);
    stage_rows<bf16, BK, LDB, NTHR>(Vs + nb * BK * LDB, v, k1, t, dh, dhp, tid);
    if (tid < BK) kv_s[nb * BK + tid] = kvj ? 1.0f : 0.0f;
  };
  stage_rows<bf16, BQ, LDB, NTHR>(Qs, q, q0, t, dh, dhp, tid);
  stage_keys(0, 0);
  cp_commit();

  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;
  uint32_t aq[NK][4];
  float o[NDT][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const int nkt = (t + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) stage_keys((kt + 1) * BK, buf ^ 1);  // loads while this tile computes
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (kt == 0) load_a_strip<NK, LDB>(aq, Qs, warp * 16, dhp, lane);
    const bf16* Kb = Ks + buf * BK * LDB;
    const bf16* Vb = Vs + buf * BK * LDB;
    // the mask of this thread's key columns n*8 + 2tq + j, as bit 2n + j
    uint32_t kvm = 0;
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(kv_s + buf * BK + n * 8 + 2 * tq);
      kvm |= (x.x > 0.0f ? 1u : 0u) << (2 * n);
      kvm |= (x.y > 0.0f ? 1u : 0u) << (2 * n + 1);
    }

    // S = Q K^T: this warp's 16 rows x BK keys
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (kk * 16 >= dhp) break;
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Kb + (np * 16 + (mi >> 1) * 8 + (lane & 7)) * LDB + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], aq[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq[kk], bk[2], bk[3]);
      }
    }
    // online softmax on the fragments: e < 2 is row g, e >= 2 row g + 8
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = (kvm >> (2 * n + (e & 1))) & 1u ? p.scale * s[n][e] : NEG_INF;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
    float shift[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(FULL, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      shift[h] = m_new <= NEG_INF * 0.5f ? 0.0f : m_new;
      if (kt > 0) {  // the first tile has nothing to rescale
        const float corr = m[h] <= NEG_INF * 0.5f ? 0.0f : expf(m[h] - shift[h]);
        l[h] *= corr;
#pragma unroll
        for (int n = 0; n < NDT; ++n) {
          o[n][2 * h] *= corr;
          o[n][2 * h + 1] *= corr;
        }
      }
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = (kvm >> (2 * n + (e & 1))) & 1u ? expf(s[n][e] - shift[e >> 1]) : 0.0f;
        lsum[e >> 1] += pv;
        s[n][e] = pv;
      }
    l[0] += lsum[0];
    l[1] += lsum[1];
    // O += P V: P packed to bf16 as A fragments, V by transposing ldmatrix
#pragma unroll
    for (int kq = 0; kq < BK / 16; ++kq) {
      const uint32_t ap[4] = {pack_bf16(s[2 * kq][0], s[2 * kq][1]),
                              pack_bf16(s[2 * kq][2], s[2 * kq][3]),
                              pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]),
                              pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3])};
#pragma unroll
      for (int np = 0; np < DHMAX / 16; ++np) {
        if (np * 16 >= dhp) break;
        uint32_t bv[4];
        ldsm_x4_t(bv, Vb + (kq * 16 + (mi & 1) * 8 + (lane & 7)) * LDB + np * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * np], ap, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], ap, bv[2], bv[3]);
      }
    }
    if (kt + 1 < nkt) __syncthreads();  // this buffer is rewritten next
  }

  bf16* out = static_cast<bf16*>(p.out) + off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    const int qi = q0 + warp * 16 + g + 8 * h;
    if (qi >= t) continue;
    const float ln = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n * 8 >= dh) break;
      const float y0 = l[h] > 0.0f ? o[n][2 * h] / ln : 0.0f;
      const float y1 = l[h] > 0.0f ? o[n][2 * h + 1] / ln : 0.0f;
      *reinterpret_cast<uint32_t*>(out + (int64_t)qi * dh + n * 8 + 2 * tq) = pack_bf16(y0, y1);
    }
    if (p.lse != nullptr && tq == 0)
      p.lse[bh * t + qi] = l[h] > 0.0f ? m[h] + logf(ln) : INFINITY;
  }
}

// ------------------------------------------------------------ launchers

template <int DHMAX, int TILE>
void launch_simt(const FwdParams& p, int b, int h, cudaStream_t stream) {
  using G = QTile<DHMAX, TILE>;
  const int nt = (p.t + TILE - 1) / TILE;
  const int nbuf = nt > 1 ? 2 : 1;
  const int bytes = G::HPB * fwd_slot_floats<DHMAX, TILE>(nbuf) * 4;
  const int64_t slots = (int64_t)b * h * nt;
  const int64_t blocks = (slots + G::HPB - 1) / G::HPB;
  allow_smem(flash_fwd_simt_kernel<DHMAX, TILE>, bytes);
  flash_fwd_simt_kernel<DHMAX, TILE>
      <<<(unsigned)blocks, G::NT * G::HPB, bytes, stream>>>(p, b * h, nbuf);
}

template <int DHMAX>
void launch_f32(const FwdParams& p, int b, int h, cudaStream_t stream) {
  // the tile height (and so the heads per block) follows T
  if (p.t <= 16) launch_simt<DHMAX, 16>(p, b, h, stream);
  else if (p.t <= 24) launch_simt<DHMAX, 24>(p, b, h, stream);
  else if (p.t <= 32 || DHMAX == 128) launch_simt<DHMAX, 32>(p, b, h, stream);
  else launch_simt<DHMAX, (DHMAX == 128 ? 32 : 64)>(p, b, h, stream);
}

template <int DHMAX, int NW>
void launch_mma(const FwdParams& p, int b, int h, cudaStream_t stream) {
  using G = FwdMma<DHMAX, NW>;
  const dim3 grid((p.t + G::BQ - 1) / G::BQ, h, b);
  allow_smem(flash_fwd_mma_kernel<DHMAX, NW>, G::smem_bytes());
  flash_fwd_mma_kernel<DHMAX, NW><<<grid, G::NTHR, G::smem_bytes(), stream>>>(p);
}

template <int DHMAX>
void launch_bf16(const FwdParams& p, int b, int h, cudaStream_t stream) {
  if (p.t < 128) launch_mma<DHMAX, 4>(p, b, h, stream);
  else launch_mma<DHMAX, 8>(p, b, h, stream);
}

}  // namespace

extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, const uint8_t* valid, void* out,
                              float* lse, int b, int h, int t, int dh,
                              float scale, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 8 != 0 || t <= 0 || b <= 0 || h <= 0 ||
      b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  // the kernels stage and store with 16-byte accesses
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  FwdParams p{q, k, v, valid, out, lse, t, dh, scale, h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    if (dh <= 32) launch_f32<32>(p, b, h, s);
    else if (dh <= 64) launch_f32<64>(p, b, h, s);
    else launch_f32<128>(p, b, h, s);
  } else if (dtype == DTYPE_BF16) {
    if (dh <= 32) launch_bf16<32>(p, b, h, s);
    else if (dh <= 64) launch_bf16<64>(p, b, h, s);
    else launch_bf16<128>(p, b, h, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
