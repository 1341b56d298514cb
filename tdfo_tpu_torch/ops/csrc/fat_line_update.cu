// Fused row-sparse optimizer step on the touched lines of a packed fat table.
//
// Replaces tdfo_tpu/ops/pallas_kernels.py::fat_line_update (the Pallas TPU
// kernel: per grid step, line DMAs HBM->VMEM, lane-map matmuls, DMAs back).
// What it computes is the same: for every touched vocab-row slot of every
// line in `ulines`, one optimizer step (sgd / adagrad / rowwise_adagrad /
// adam with decoupled weight decay) on the slot's [table | state] lanes, in
// place.  The per-row math lives in fat_line_common.cuh, shared with the
// routed kernel (fat_line_update_routed.cu).
//
// Layout: fat is [L, T, 128] f32 or bf16, byte-identical to the [L*R, W]
// row view; row slot s of line l starts at (l*R + s) * W.  Lanes [0, d) hold the
// table row, [d, need) the optimizer state, [need, W) zero padding.
//
// Operands:
//   ulines [U] int32, duplicate-free; the int32-max sentinel and any value
//          outside [0, L) skip the line without reading or writing it.
//   g      row form [U, d] (R == 1, touched == nullptr: every valid line is
//          touched) or packed form [U, R, d] with touched [U, R] (> 0 =
//          touched; untouched slots are never read or written).
//   corr   [2] f32 device pointer, adam bias corrections (1 - b1^t,
//          1 - b2^t); read on the device so the step count never syncs.
//
// bf16 lines (fat_line_update_bf16) compute in f32 and narrow every
// written lane as the TPU kernel's _sr_writeback does (fat_line_common.cuh:
// the grid position comes from the line's index u in `ulines` and the
// wrapper's lps, the TPU kernel's lines per grid step).
//
// Bound on the H100: memory bytes, and before that latency.  Per touched
// adam row the table and the two moments are read and written and the grad
// is read: (2 * 3 * d + d) * 4 B, 1,792 B at d = 64 in f32; 1,024 B in bf16
// (2 * 3 * d * 2 + d * 4); the arithmetic is a few dozen flops per element
// (three IEEE divisions and a square root for adam; bf16 adds the rounding
// hash, 13 integer operations per written lane).  Each row slot is a chain
// of dependent loads (ulines[u] -> where the row lies -> its lanes),
// scattered 128-768-byte pieces of a table far larger than L2.  The design
// keeps as many chains in flight as the card holds:
//   * G = d/4 threads per row (2 .. 32, rounded up to a power of two; d a
//     multiple of 4, d <= 128), each with one 16-byte (f32) or 8-byte
//     (bf16) load of the grad, of the table lanes and of each per-element
//     state, all issued before any arithmetic; a warp updates 32 / G rows
//     (2 at the TwoTower shape, d = 64, G = 16);
//   * the grad needs only the slot, so its load does not wait for the line;
//   * the grid is what the card keeps resident (occupancy x SMs, 64-thread
//     blocks); each group loops over slots with a stride and loads the next
//     pass's ulines[u] and touched value during this pass's math, so a pass
//     after the first costs one round trip, not two;
//   * in place: each thread writes only the lanes it loaded; rowwise's
//     accumulator is read by the group's thread 0 alone and shuffled to the
//     others, so its write cannot overtake another thread's read;
//   * rows with d % 4 != 0 or d > 128, operands off 16 bytes and steps of
//     2^30 slots or more take one warp per row slot, lanes striding over
//     the slot (fat_row_step), chosen inside the launch.
// No shared memory or TMA: a row is read once and written once, and staging
// scattered pieces buys nothing.  Design variants are edits of this source
// in tdfo_tpu_torch/tools/fat_line_variants.py; an 8-lane bf16 thread with
// 16-byte loads, two passes in flight per group and tighter register caps
// measured slower (PERF.md).

#include <type_traits>

#include "fat_line_common.cuh"

namespace {

using namespace fat_lines;

// Row groups: 64-thread blocks, at least 20 resident per SM (the register
// cap this sets, 48, fits every instance without spills); measured against
// 128- and 256-thread blocks and tighter caps (tools/fat_line_variants.py).
constexpr int THREADS = 64;
constexpr int MIN_BLOCKS = 20;
constexpr int WPB = THREADS / 32;  // warps per block
constexpr int WIDE_THREADS = 256;  // the warp-per-row kernel

template <typename S>
struct Params {
  S* fat;
  const int32_t* ulines;
  const float* g;
  const float* touched;
  int64_t n_lines;
  int64_t n_slots;  // U * R
  int r;
  int w;
  StepParams step;
  SrParams sr;  // bf16 storage only
};

template <typename S>
__device__ __forceinline__ Narrow narrow_at(const Params<S>& p, int64_t u, int s) {
  Narrow nw{};
  if constexpr (std::is_same<S, uint16_t>::value) nw = Narrow::at(p.sr, u, s * p.w);
  return nw;
}

// The line of `slot` (-1 past the end) and its touched value (1 in the row
// form); the two loads are independent.
template <typename S>
__device__ __forceinline__ int slot_line(const Params<S>& p, int slot, int n, float& tch) {
  tch = 1.0f;
  if (slot >= n) return -1;
  if (p.touched != nullptr) tch = p.touched[slot];
  return p.ulines[p.r == 1 ? slot : slot / p.r];
}

// G threads per row slot, 32 / G slots per warp, over a resident grid (the
// launch keeps U * R below 2^30, so slot indices are 32-bit).  The loop
// over passes is warp-uniform (every lane reaches the shuffles).
template <int KIND, int G, typename S>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fat_line_update_kernel(Params<S> p) {
  constexpr int RPW = 32 / G;     // row slots per warp
  constexpr int RPB = RPW * WPB;  // row slots per block and pass
  const int lane = threadIdx.x & 31;
  const int t = lane % G;
  const int d = p.step.d;
  const bool tl = 4 * t < d;
  const int n = (int)p.n_slots;
  const int stride = (int)gridDim.x * RPB;
  float c1 = 1.0f, c2 = 1.0f;
  if (KIND == KIND_ADAM) {
    c1 = p.step.corr[0];
    c2 = p.step.corr[1];
  }
  int w0 = (int)blockIdx.x * RPB + (threadIdx.x >> 5) * RPW;
  int slot = w0 + lane / G;
  float tch;
  int line = slot_line(p, slot, n, tch);
  for (; w0 < n; w0 += stride, slot += stride) {
    const int u = p.r == 1 ? slot : slot / p.r;
    const int s = slot - u * p.r;
    // sentinel / out of range / untouched (a NaN mask value is untouched)
    const bool ok = line >= 0 && line < p.n_lines && tch > 0.0f;
    S* row = p.fat + ((int64_t)(ok ? line : 0) * p.r + s) * (int64_t)p.w;
    // the grad needs only the slot: on the first pass its load goes out
    // before the line arrives
    RowLanes rl;
    load_row_lanes<KIND>(rl, row, p.g + (int64_t)slot * d, t, d, slot < n && tl, ok && tl,
                         ok && t == 0);
    float tch_n;  // the next pass's slot, in flight during this pass's math
    const int line_n = slot_line(p, slot + stride, n, tch_n);
    if (KIND == KIND_ROWWISE_ADAGRAD) rl.acc = __shfl_sync(0xffffffffu, rl.acc, lane & ~(G - 1));
    fat_row_group_step<KIND, G>(rl, row, t, d, ok, ok && tl, p.step, c1, c2,
                                narrow_at(p, u, s));
    line = line_n;
    tch = tch_n;
  }
}

// Rows the groups cannot take (d % 4 != 0, d > 128, operands off 16
// bytes, 2^30 slots or more): one warp per row slot, lanes striding over
// it.
template <typename S>
__global__ void __launch_bounds__(WIDE_THREADS) fat_line_update_kernel_wide(Params<S> p) {
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * (WIDE_THREADS / 32) + (threadIdx.x >> 5);
  if (slot >= p.n_slots) return;
  const int64_t u = slot / p.r;
  const int s = (int)(slot - u * p.r);
  const int64_t line = p.ulines[u];
  if (line < 0 || line >= p.n_lines) return;  // sentinel / out of range
  if (p.touched != nullptr && !(p.touched[slot] > 0.0f)) return;
  S* row = p.fat + (line * p.r + s) * (int64_t)p.w;
  fat_row_step(row, row, p.g + slot * (int64_t)p.step.d, p.step, lane, narrow_at(p, u, s));
}

// Blocks the card keeps resident for one kernel instance (occupancy x
// SMs), cached per instance and device.
template <int KIND, int G, typename S>
int resident_blocks() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fat_line_update_kernel<KIND, G, S>,
                                                  THREADS, 0);
    cache[dev] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  return cache[dev];
}

template <int KIND, int G, typename S>
void launch_group(const Params<S>& p, cudaStream_t s) {
  constexpr int RPB = 32 / G * WPB;
  const int64_t need = (p.n_slots + RPB - 1) / RPB;
  const int64_t most = resident_blocks<KIND, G, S>();
  fat_line_update_kernel<KIND, G, S><<<(unsigned)(need < most ? need : most), THREADS, 0, s>>>(p);
}

template <int KIND, typename S>
void launch_kind(const Params<S>& p, cudaStream_t s) {
  const int d = p.step.d;
  if (d <= 8) launch_group<KIND, 2>(p, s);
  else if (d <= 16) launch_group<KIND, 4>(p, s);
  else if (d <= 32) launch_group<KIND, 8>(p, s);
  else if (d <= 64) launch_group<KIND, 16>(p, s);
  else launch_group<KIND, 32>(p, s);
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <typename S>
int launch(S* fat, const int32_t* ulines, const float* g, const float* touched,
           const float* corr, int64_t n_lines, int64_t n_ulines, int r, int w, int d,
           int kind, float lr, float b1, float b2, float om_b1, float om_b2,
           float eps, float wd, SrParams sr, void* stream) {
  Params<S> p;
  p.fat = fat;
  p.ulines = ulines;
  p.g = g;
  p.touched = touched;
  p.n_lines = n_lines;
  p.n_slots = n_ulines * r;
  p.r = r;
  p.w = w;
  p.step = StepParams{corr, d, kind, lr, b1, b2, om_b1, om_b2, eps, wd};
  p.sr = sr;
  if (p.n_slots <= 0) return (int)cudaGetLastError();
  if (kind < KIND_SGD || kind > KIND_ADAM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // groups take 16-byte (f32) or 8-byte (bf16) loads of 4 lanes: every row
  // and state offset must be a multiple of 4 lanes from 16-byte-aligned
  // bases
  const bool group = d > 0 && d <= 128 && d % 4 == 0 && w % 4 == 0 &&
                     aligned16(fat) && aligned16(g) && p.n_slots < (1 << 30);
  if (!group) {
    const int64_t blocks = (p.n_slots + WIDE_THREADS / 32 - 1) / (WIDE_THREADS / 32);
    fat_line_update_kernel_wide<S><<<(unsigned)blocks, WIDE_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  switch (kind) {
    case KIND_SGD: launch_kind<KIND_SGD>(p, s); break;
    case KIND_ADAGRAD: launch_kind<KIND_ADAGRAD>(p, s); break;
    case KIND_ROWWISE_ADAGRAD: launch_kind<KIND_ROWWISE_ADAGRAD>(p, s); break;
    default: launch_kind<KIND_ADAM>(p, s); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fat_line_update_f32(
    float* fat, const int32_t* ulines, const float* g, const float* touched,
    const float* corr, int64_t n_lines, int64_t n_ulines, int r, int w, int d,
    int kind, float lr, float b1, float b2, float om_b1, float om_b2,
    float eps, float wd, void* stream) {
  return launch<float>(fat, ulines, g, touched, corr, n_lines, n_ulines, r, w, d,
                       kind, lr, b1, b2, om_b1, om_b2, eps, wd,
                       SrParams{0u, 0, 1, 0}, stream);
}

// bf16 lines (uint16_t bit patterns).  sr != 0: stochastic rounding keyed
// by seed; lps: the TPU grid's lines per block; line_lanes: T * 128.
extern "C" int fat_line_update_bf16(
    uint16_t* fat, const int32_t* ulines, const float* g, const float* touched,
    const float* corr, int64_t n_lines, int64_t n_ulines, int r, int w, int d,
    int kind, float lr, float b1, float b2, float om_b1, float om_b2,
    float eps, float wd, uint32_t seed, int sr, int lps, int line_lanes,
    void* stream) {
  return launch<uint16_t>(fat, ulines, g, touched, corr, n_lines, n_ulines, r, w,
                          d, kind, lr, b1, b2, om_b1, om_b2, eps, wd,
                          SrParams{seed, sr, lps, line_lanes}, stream);
}
