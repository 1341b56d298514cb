// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the mask fill, asynchronous 16-byte staging of head
// rows into shared memory, the f32 micro-tile products of the CUDA-core
// kernels, and the ldmatrix / mma.sync building blocks of the bf16
// tensor-core kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr unsigned FULL = 0xffffffffu;
// jnp.finfo(jnp.float32).min: the mask fill of tdfo_tpu/ops/pallas_kernels.py:65
constexpr float NEG_INF = -3.4028234663852886e38f;

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// ------------------------------------------------------------ staging

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes global -> shared, asynchronously; `live` false writes
// zeros and reads nothing (`src` must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + ROWS) of a [t, dh] head slice (element type E) into
// shared rows of LD elements, columns [0, cols): 16-byte copies, zeros for
// columns >= dh (cols and dh are multiples of 16 bytes' worth of elements)
// and, with FILL, for rows >= t; without FILL those rows are left as they
// are (the caller never lets them reach a live result).
template <typename E, int ROWS, int LD, int NTHR, bool FILL = true>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int r0, int t,
                                           int dh, int cols, int tid) {
  constexpr int EPC = 16 / sizeof(E);
  const int cpr = cols / EPC;
  const int rows = FILL ? ROWS : max(0, min(ROWS, t - r0));
  for (int c = tid; c < rows * cpr; c += NTHR) {
    const int j = c / cpr;
    const int k = (c - j * cpr) * EPC;
    const int r = r0 + j;
    const bool live = r < t && k < dh;
    cp_async16(dst + j * LD + k, src + (live ? (int64_t)r * dh + k : 0), live);
  }
}

// Per-row statistics (lse or delta) of query rows [q0, q0 + ROWS): zeros
// past t (the kernels treat those rows as fully masked).
template <int ROWS, int NTHR>
__device__ __forceinline__ void stage_stat(float* dst, const float* src, int q0, int t,
                                           int tid) {
  for (int j = tid; j < ROWS; j += NTHR) {
    const bool in = q0 + j < t;
    cp_async4(dst + j, src + (in ? q0 + j : 0), in);
  }
}

// ------------------------------------------------------------ f32 micro-tiles

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// s[m][n] = a_m . b_n over dh dims, for M rows a_m = a + m*LD and N rows
// b_n = b + n*bstride of shared memory: float4 reads, M x N independent
// chains
template <int M, int N, int LD>
__device__ __forceinline__ void tile_dots(float (&s)[M][N], const float* a,
                                          const float* b, int bstride, int dh) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) s[m][n] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < dh; k += 4) {
    float4 af[M], bf[N];
#pragma unroll
    for (int m = 0; m < M; ++m) af[m] = *reinterpret_cast<const float4*>(a + m * LD + k);
#pragma unroll
    for (int n = 0; n < N; ++n) bf[n] = *reinterpret_cast<const float4*>(b + n * bstride + k);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < N; ++n) fma4(s[m][n], af[m], bf[n]);
  }
}

// s[m][n] = a_m . b_n and d[m][n] = c_m . e_n over dh dims, for MK rows
// a_m = a + m*LD (c likewise) and MQ rows b_n = b + n*bstride (e likewise)
// of shared memory: float4 reads, 2 x MK x MQ independent chains
template <int MK, int MQ, int LD>
__device__ __forceinline__ void tile_dots2(float (&s)[MK][MQ], float (&d)[MK][MQ],
                                           const float* a, const float* c,
                                           const float* b, const float* e,
                                           int bstride, int dh) {
#pragma unroll
  for (int m = 0; m < MK; ++m)
#pragma unroll
    for (int n = 0; n < MQ; ++n) s[m][n] = d[m][n] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < dh; k += 4) {
    float4 af[MK], cf[MK], bf[MQ], ef[MQ];
#pragma unroll
    for (int m = 0; m < MK; ++m) {
      af[m] = *reinterpret_cast<const float4*>(a + m * LD + k);
      cf[m] = *reinterpret_cast<const float4*>(c + m * LD + k);
    }
#pragma unroll
    for (int n = 0; n < MQ; ++n) {
      bf[n] = *reinterpret_cast<const float4*>(b + n * bstride + k);
      ef[n] = *reinterpret_cast<const float4*>(e + n * bstride + k);
    }
#pragma unroll
    for (int m = 0; m < MK; ++m)
#pragma unroll
      for (int n = 0; n < MQ; ++n) {
        fma4(s[m][n], af[m], bf[n]);
        fma4(d[m][n], cf[m], ef[n]);
      }
  }
}

// Geometry of the f32 forward and dQ kernels: a slot of NT threads owns a
// tile of TILE query rows of one head and streams TILE-key tiles.  Groups of
// TPG = 8 neighbouring lanes share MQ = 2 query rows: each thread holds an
// MQ x MK micro-tile of S (keys r, r + 8, ... for its lane r in the group)
// and MQ rows x NCH float4 chunks of the output (dims 4r, 4r + 32, ...), so
// the 8 lanes of a group read 8 neighbouring key rows or 128 contiguous
// bytes of one row, and a row statistic is a 3-step shuffle in the group.
// TILE follows T (16, 24, 32 or 64: the Bert4Rec T = 20 takes 24, 3-4% less
// time than 32); at T <= 16 a block packs 4 heads.
template <int DHMAX, int TILE>
struct QTile {
  static constexpr int NT = TILE * 4;   // threads per slot
  static constexpr int HPB = TILE == 16 ? 4 : 1;
  // the Bert4Rec shape (T = 20, Dh = 32): 4 resident blocks per SM hold
  // its 512 heads in one wave
  static constexpr int MINB = (TILE == 24 || TILE == 32) && DHMAX == 32 ? 4 : 1;
  static constexpr int TPG = 8;
  static constexpr int MQ = 2;
  static constexpr int MK = TILE / TPG;
  static constexpr int NCH = DHMAX / (4 * TPG);
  static constexpr int LD = DHMAX + 4;  // f32 row of a staged tile
  static constexpr int PLD = TILE + 4;  // P / dS rows: [query][key]
};

// acc[n][i] += sum_{j < nk4} P[n][j] * V[j][4*TPG*i .. +3] for the MQ rows
// of P (`pr`, rows PLD apart) and the chunks of V at `vr` (rows LD apart);
// nk4 is a multiple of 4 and every P and V row below it is finite.
template <int MQ, int NCH, int TPG, int LD, int PLD>
__device__ __forceinline__ void pv_accum(float (&acc)[MQ][NCH][4], const float* pr,
                                         const float* vr, int nk4) {
#pragma unroll 2
  for (int j = 0; j < nk4; j += 4) {
    float pj[MQ][4];
#pragma unroll
    for (int n = 0; n < MQ; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(pr + n * PLD + j);
      pj[n][0] = x.x;
      pj[n][1] = x.y;
      pj[n][2] = x.z;
      pj[n][3] = x.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(vr + (j + jj) * LD + 4 * TPG * i);
#pragma unroll
        for (int n = 0; n < MQ; ++n) {
          acc[n][i][0] = fmaf(pj[n][jj], x.x, acc[n][i][0]);
          acc[n][i][1] = fmaf(pj[n][jj], x.y, acc[n][i][1]);
          acc[n][i][2] = fmaf(pj[n][jj], x.z, acc[n][i][2]);
          acc[n][i][3] = fmaf(pj[n][jj], x.w, acc[n][i][3]);
        }
      }
  }
}

// Rows [nk, nk4) of a staged tile, which pv_accum reads but staging left
// out (keys past T), set to 0 across `cols` floats.
template <int LD, int NTHR>
__device__ __forceinline__ void zero_rows(float* dst, int nk, int nk4, int cols, int tid) {
  for (int i = tid; i < (nk4 - nk) * cols; i += NTHR)
    dst[(nk + i / cols) * LD + i % cols] = 0.0f;
}

// ------------------------------------------------------------ bf16 tensor cores

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a 16-row strip: rows [r0, r0 + 16) of a [rows][LDB]
// bf16 tile, the head-dim steps kk*16 < dhp (the rest stay 0), for
// operands that stay in registers across every streamed tile
template <int NK, int LDB>
__device__ __forceinline__ void load_a_strip(uint32_t (&a)[NK][4], const __nv_bfloat16* s,
                                             int r0, int dhp, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    a[kk][0] = a[kk][1] = a[kk][2] = a[kk][3] = 0u;
    if (kk * 16 < dhp)
      ldsm_x4(a[kk], s + (r0 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
  }
}

// Bytes of dynamic shared memory above the default 48 KB need an opt-in.
template <typename K>
void allow_smem(K kernel, int bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace flash
