// Fused row-sparse optimizer step on a packed fat table, from ROW-level
// summed grads and routing arrays (the dedup-lookup path).
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::fat_line_update_routed (the
// Pallas TPU kernel).  What it computes is the same: for every distinct row
// i < CR of the step,
//
//   lidx = row_lidx[i]; skip if lidx is outside [0, C)
//   line = ulines[lidx]; skip if it is the int32-max sentinel or outside [0, L)
//   s    = row_slot[i]
//   state = slot s of lines[lidx]          (the forward's gather of fat)
//   fat[line * R + s] = the kind's step on (state, g_u[i], corr)
//
// Untouched slots, and every line not named, stay bitwise unchanged.  The
// per-element math and rowwise_adagrad's sum tree are fat_line_common.cuh's,
// the same fat_line_update.cu uses, so both kernels write bitwise the same
// table for the same logical update.
//
// What the TPU design does and this one does not: the TPU kernel streams
// whole lines through VMEM in blocks of lines, routes the block's rows into
// packed lanes with 0/1 matmuls over an `sdiv`/`tsi` window of the row
// array (lane-padded to 128), and writes whole lines back under per-line
// DMA semaphores.  Each of those exists for Mosaic.  Here a thread group
// owns one distinct row and writes only its own slot: distinct rows have
// distinct (line, slot) pairs, so rows sharing a line (R = 2..8) never
// race, and no line is written whole.
//
// Layout: fat [L, T, 128] and lines [C, T, 128], both f32 or both bf16,
// byte-identical to the [L*R, W] and [C*R, W] row views.  g_u [CR, d] f32;
// ulines [C], row_lidx [CR], row_slot [CR] int32; corr [2] f32 on the
// device.  bf16 lines (fat_line_update_routed_bf16) compute in f32 and
// narrow each written lane as the TPU kernel's _sr_writeback does
// (fat_line_common.cuh), the grid position taken from row_lidx (the line's
// index in `ulines`) and the TPU kernel's lines per grid step,
// routed_lines_per_step; where fat_line_update is given the same lps the
// two kernels write bitwise the same table.
//
// Bound on the H100: memory bytes, and before that latency.  Per distinct
// rowwise-adagrad row at d = 16 the kernel moves 212 B (the slot's 17 state
// lanes read and written, 68 B each; the grad, 64 B; the routing row_lidx,
// row_slot and ulines, 12 B) for a few flops per byte, but each row is a
// chain of dependent loads (row_lidx -> the slot in lines, and row_lidx ->
// ulines -> where to write), scattered 68-128-byte pieces.  The design
// keeps as many of those chains in flight as the card holds:
//   * narrow rows (d <= 32, d a multiple of 4): G = 2, 4 or 8 threads per
//     row (compile time, from d), each with one 16-byte load of the grad,
//     of the table lanes and of each per-element state; a warp updates
//     32 / G rows (8 at the DLRM shape: d = 16, G = 4);
//   * the grad and the slot loads are issued before any math and before the
//     line lookup returns (the grad needs only i, the slot only row_lidx),
//     so one row costs two dependent round trips, not three;
//   * the grid is what the card keeps resident (occupancy x SMs), looping
//     over rows with the next pass's routing loaded during this pass's math;
//   * wider rows (and unaligned operands) take one warp per row, lanes
//     striding over the slot as fat_line_update does.
// No shared memory or TMA: a row is read once and written once, and staging
// scattered pieces buys nothing.

#include <type_traits>

#include "fat_line_common.cuh"

namespace {

using namespace fat_lines;

constexpr int THREADS = 256;

template <typename S>
struct Params {
  S* fat;
  const S* lines;
  const int32_t* ulines;
  const int32_t* row_lidx;
  const int32_t* row_slot;
  const float* g;
  int64_t n_lines;   // L
  int64_t n_ulines;  // C
  int64_t n_rows;    // CR
  int r;
  int w;
  StepParams step;
  SrParams sr;  // bf16 storage only
};

template <typename S>
__device__ __forceinline__ Narrow narrow_at(const Params<S>& p, int64_t lidx, int slot) {
  Narrow nw{};
  if constexpr (std::is_same<S, uint16_t>::value) nw = Narrow::at(p.sr, lidx, slot * p.w);
  return nw;
}

// Narrow rows: G threads per row, 32 / G rows per warp.  The loop over
// passes is warp-uniform (every lane reaches the rowwise shuffles).
template <int KIND, int G, typename S>
__global__ void __launch_bounds__(THREADS) fat_line_update_routed_kernel(Params<S> p) {
  constexpr int RPW = 32 / G;                // rows per warp
  constexpr int RPB = RPW * (THREADS / 32);  // rows per block and pass
  const int lane = threadIdx.x & 31;
  const int t = lane % G;
  const int d = p.step.d;
  const bool tl = 4 * t < d;
  const int64_t n = p.n_rows;
  const int64_t stride = (int64_t)gridDim.x * RPB;
  float c1 = 1.0f, c2 = 1.0f;
  if (KIND == KIND_ADAM) {
    c1 = p.step.corr[0];
    c2 = p.step.corr[1];
  }
  int64_t w0 = (int64_t)blockIdx.x * RPB + (threadIdx.x >> 5) * RPW;
  int64_t i = w0 + lane / G;
  int32_t lidx = i < n ? p.row_lidx[i] : -1;
  int32_t slot = i < n ? p.row_slot[i] : -1;
  for (; w0 < n; w0 += stride, i += stride) {
    const bool in = i < n;
    const bool lok = in && lidx >= 0 && lidx < p.n_ulines && slot >= 0 && slot < p.r;
    const S* src = p.lines + ((int64_t)lidx * p.r + slot) * (int64_t)p.w;
    RowLanes rl;
    load_row_lanes<KIND>(rl, src, p.g + i * (int64_t)d, t, d, in && tl, lok && tl, lok);
    // the sentinel row (negative ids) has a valid lidx but a sentinel line
    const int64_t line = lok ? (int64_t)p.ulines[lidx] : -1;
    const int64_t inext = i + stride;  // the next pass's routing, in flight
    const int32_t lidx_n = inext < n ? p.row_lidx[inext] : -1;
    const int32_t slot_n = inext < n ? p.row_slot[inext] : -1;
    const bool row_ok = lok && line >= 0 && line < p.n_lines;
    S* dst = p.fat + (line * p.r + slot) * (int64_t)p.w;
    fat_row_group_step<KIND, G>(rl, dst, t, d, row_ok, row_ok && tl, p.step, c1, c2,
                                narrow_at(p, lidx, slot));
    lidx = lidx_n;
    slot = slot_n;
  }
}

// Wide rows (d > 32, d not a multiple of 4, or unaligned operands): one
// warp per row, as fat_line_update, over the same resident grid.
template <typename S>
__global__ void __launch_bounds__(THREADS) fat_line_update_routed_kernel_wide(Params<S> p) {
  constexpr int WPB = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int64_t n = p.n_rows;
  const int64_t stride = (int64_t)gridDim.x * WPB;
  int64_t i = (int64_t)blockIdx.x * WPB + (threadIdx.x >> 5);
  int32_t lidx = i < n ? p.row_lidx[i] : -1;
  int32_t slot = i < n ? p.row_slot[i] : -1;
  for (; i < n; i += stride) {
    const int32_t lidx_n = i + stride < n ? p.row_lidx[i + stride] : -1;
    const int32_t slot_n = i + stride < n ? p.row_slot[i + stride] : -1;
    if (lidx >= 0 && lidx < p.n_ulines && slot >= 0 && slot < p.r) {
      const int64_t line = p.ulines[lidx];
      if (line >= 0 && line < p.n_lines) {
        const S* src = p.lines + ((int64_t)lidx * p.r + slot) * (int64_t)p.w;
        S* dst = p.fat + (line * p.r + slot) * (int64_t)p.w;
        fat_row_step(src, dst, p.g + i * (int64_t)p.step.d, p.step, lane,
                     narrow_at(p, lidx, slot));
      }
    }
    lidx = lidx_n;
    slot = slot_n;
  }
}

// Blocks the card keeps resident for one kernel instance (occupancy x
// SMs), cached per instance and device: the cache is a static of each
// KERNEL instantiation, as fat_line_update.cu keys its own.
template <auto KERNEL>
int resident_blocks() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, THREADS, 0);
    cache[dev] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  return cache[dev];
}

template <auto KERNEL, typename S>
void launch_grid(const Params<S>& p, int rows_per_block, cudaStream_t s) {
  const int64_t need = (p.n_rows + rows_per_block - 1) / rows_per_block;
  const int64_t most = resident_blocks<KERNEL>();
  KERNEL<<<(unsigned)(need < most ? need : most), THREADS, 0, s>>>(p);
}

template <int KIND, typename S>
void launch_kind(const Params<S>& p, bool narrow, cudaStream_t s) {
  const int d = p.step.d;
  if (!narrow) launch_grid<fat_line_update_routed_kernel_wide<S>>(p, THREADS / 32, s);
  else if (d <= 8) launch_grid<fat_line_update_routed_kernel<KIND, 2, S>>(p, THREADS / 2, s);
  else if (d <= 16) launch_grid<fat_line_update_routed_kernel<KIND, 4, S>>(p, THREADS / 4, s);
  else launch_grid<fat_line_update_routed_kernel<KIND, 8, S>>(p, THREADS / 8, s);
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <typename S>
int launch(S* fat, const S* lines, const int32_t* ulines, const int32_t* row_lidx,
           const int32_t* row_slot, const float* g, const float* corr,
           int64_t n_lines, int64_t n_ulines, int64_t n_rows, int r, int w, int d,
           int kind, float lr, float b1, float b2, float om_b1, float om_b2,
           float eps, float wd, SrParams sr, void* stream) {
  Params<S> p;
  p.fat = fat;
  p.lines = lines;
  p.ulines = ulines;
  p.row_lidx = row_lidx;
  p.row_slot = row_slot;
  p.g = g;
  p.n_lines = n_lines;
  p.n_ulines = n_ulines;
  p.n_rows = n_rows;
  p.r = r;
  p.w = w;
  p.step = StepParams{corr, d, kind, lr, b1, b2, om_b1, om_b2, eps, wd};
  p.sr = sr;
  if (n_rows <= 0) return (int)cudaGetLastError();
  // narrow rows take 16-byte (f32) or 8-byte (bf16) loads of 4 lanes: every
  // row and state offset must be a multiple of 4 lanes from 16-byte-aligned
  // bases
  const bool narrow = d > 0 && d <= 32 && d % 4 == 0 && w % 4 == 0 &&
                      aligned16(fat) && aligned16(lines) && aligned16(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_SGD: launch_kind<KIND_SGD>(p, narrow, s); break;
    case KIND_ADAGRAD: launch_kind<KIND_ADAGRAD>(p, narrow, s); break;
    case KIND_ROWWISE_ADAGRAD: launch_kind<KIND_ROWWISE_ADAGRAD>(p, narrow, s); break;
    case KIND_ADAM: launch_kind<KIND_ADAM>(p, narrow, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fat_line_update_routed_f32(
    float* fat, const float* lines, const int32_t* ulines,
    const int32_t* row_lidx, const int32_t* row_slot, const float* g,
    const float* corr, int64_t n_lines, int64_t n_ulines, int64_t n_rows,
    int r, int w, int d, int kind, float lr, float b1, float b2, float om_b1,
    float om_b2, float eps, float wd, void* stream) {
  return launch<float>(fat, lines, ulines, row_lidx, row_slot, g, corr, n_lines,
                       n_ulines, n_rows, r, w, d, kind, lr, b1, b2, om_b1, om_b2,
                       eps, wd, SrParams{0u, 0, 1, 0}, stream);
}

// bf16 fat and lines (uint16_t bit patterns).  sr != 0: stochastic
// rounding keyed by seed; lps: routed_lines_per_step; line_lanes: T * 128.
extern "C" int fat_line_update_routed_bf16(
    uint16_t* fat, const uint16_t* lines, const int32_t* ulines,
    const int32_t* row_lidx, const int32_t* row_slot, const float* g,
    const float* corr, int64_t n_lines, int64_t n_ulines, int64_t n_rows,
    int r, int w, int d, int kind, float lr, float b1, float b2, float om_b1,
    float om_b2, float eps, float wd, uint32_t seed, int sr, int lps,
    int line_lanes, void* stream) {
  return launch<uint16_t>(fat, lines, ulines, row_lidx, row_slot, g, corr, n_lines,
                          n_ulines, n_rows, r, w, d, kind, lr, b1, b2, om_b1, om_b2,
                          eps, wd, SrParams{seed, sr, lps, line_lanes}, stream);
}
