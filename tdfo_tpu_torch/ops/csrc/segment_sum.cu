// Deterministic segment sum: out[s, c] = sum of xs[k, c] over the members k
// of segment s, added left to right from 0.0 in the order they stand in xs.
//
// The port's own kernel; it replaces no TPU kernel.  Every site that sums
// float contributions by index (gradient dedupe, the dense lazy tier's
// per-row sums, the embedding gradient, the AUC histograms) used
// index_add_, whose CUDA form adds with atomics in whatever order the
// threads arrive, so two runs of one program differed in the last bits.
// Here each output element is one thread's sequential loop, so the sum is
// the one the CPU's index_add_ computes (it adds in input order), bit for
// bit, on every run.
//
// Operands (built by tdfo_tpu_torch/ops/kernels/segment_sum.py):
//   xs      [K, d] rows already gathered in stable segment order (members
//           of one segment are contiguous and keep their input order);
//   offsets [n + 1] int64: segment s owns rows [offsets[s], offsets[s+1]);
//   out     [n, d], written whole (an empty segment writes 0.0).
// bf16 and f16 inputs are summed in f32 and rounded once, at the store, as
// the CPU's index_add_ does on a [N, d] bf16/f16 tensor.
//
// Bound on the H100: memory bytes.  One thread per (segment, column):
// adjacent threads take adjacent columns, so a warp reads a row of xs in
// one or two transactions and writes a row of out the same way.  A long
// segment is a long serial loop of independent loads (the accumulator is
// the only dependency), which the compiler unrolls.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <>
struct Io<__half> {
  static __device__ __forceinline__ float load(const __half* p) { return __half2float(*p); }
  static __device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ xs, const int64_t* __restrict__ offsets,
                   T* __restrict__ out, int64_t n_seg, int64_t d) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_seg * d) return;
  const int64_t s = i / d;
  const int64_t c = i - s * d;
  const int64_t lo = offsets[s], hi = offsets[s + 1];
  float acc = 0.0f;
  const T* p = xs + lo * d + c;
#pragma unroll 4
  for (int64_t k = lo; k < hi; ++k, p += d) acc += Io<T>::load(p);
  Io<T>::store(out + i, acc);
}

template <typename T>
int launch(const void* xs, const int64_t* offsets, void* out, int64_t n_seg, int64_t d,
           void* stream) {
  const int64_t total = n_seg * d;
  if (total <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<T><<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xs), offsets, static_cast<T*>(out), n_seg, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16.  Returns a cudaError_t code (0 = launched).
extern "C" int segment_sum(const void* xs, const int64_t* offsets, void* out, int64_t n_seg,
                           int64_t d, int dtype, void* stream) {
  switch (dtype) {
    case 0: return launch<float>(xs, offsets, out, n_seg, d, stream);
    case 1: return launch<__nv_bfloat16>(xs, offsets, out, n_seg, d, stream);
    case 2: return launch<__half>(xs, offsets, out, n_seg, d, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
