// One bitonic compare-exchange pass over a (rows, 128) int32 block,
// repeated `reps` times in the kernel: the sort-pass microbenchmark.
//
// Replaces tools/sort_micro.py::_lane_pass_kernel (:47) and
// _row_pass_kernel (:68), launched by _run_pass (:86-97). Both keep the
// whole (4096, 128) block in VMEM across their R = 64 repeats and time one
// pass as the launch over R. A pass pairs each element with one partner;
// the lower of the two positions keeps the min and the upper the max:
//
//   lane pass, stride s < 128: element l of a row pairs with l ^ s
//   row pass, stride S rows:   rows [g, g + S) pair with [g + S, g + 2S),
//                              g a multiple of 2S, lane for lane
//
// What bounds it on the H100: the block is read once and written once
// (4 MB at 2^19 keys, about 1.3 us at 3.35 TB/s); each repeat is one int32
// min or max per element, 2^19 operations. At R = 64 the operations bound
// it, as they did the TPU kernel. What the design does about it: the data
// stay in registers across the repeats, the counterpart of VMEM. In the lane
// pass one warp owns a row and each thread holds its four elements lane,
// lane + 32, lane + 64, lane + 96, so a stride under 32 exchanges through
// __shfl_xor_sync and a stride of 32 or 64 pairs two registers of the same
// thread, with neither a shuffle nor shared memory. In the row pass one
// thread loads both elements of a pair and exchanges them in registers.
//
// A compare-exchange is idempotent: min(min(a, b), max(a, b)) = min(a, b),
// and the compiler may fold R repeats into one. The barrier that keeps each
// repeat real is `opaque` below, an empty asm statement that tells the
// compiler it rewrites the values, so it can neither fold nor hoist them.
// It emits no instruction.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;             // elements per row
constexpr int kPerThread = kLanes / 32;  // lane pass: a row's elements per thread
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }

__device__ __forceinline__ void exchange(int& lo, int& hi) {
  const int a = lo;
  lo = min(a, hi);
  hi = max(a, hi);
}

// One warp per row; thread `lane` holds elements lane + 32 k, k < 4.
template <int kStride>
__global__ void __launch_bounds__(kThreads)
lane_pass_kernel(const int* __restrict__ x, int* __restrict__ out, int rows, int reps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only
  const int* src = x + static_cast<size_t>(row) * kLanes;
  int v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) v[k] = src[k * 32 + lane];
  for (int r = 0; r < reps; ++r) {
    if constexpr (kStride < 32) {
      const bool lower = (lane & kStride) == 0;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int p = __shfl_xor_sync(kFull, v[k], kStride);
        v[k] = lower ? min(v[k], p) : max(v[k], p);
      }
    } else if constexpr (kStride == 32) {  // elements l and l + 32: registers k, k + 1
      exchange(v[0], v[1]);
      exchange(v[2], v[3]);
    } else {                                // kStride == 64: registers k, k + 2
      exchange(v[0], v[2]);
      exchange(v[1], v[3]);
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) opaque(v[k]);
  }
  int* dst = out + static_cast<size_t>(row) * kLanes;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) dst[k * 32 + lane] = v[k];
}

// One thread per pair of elements (row r, lane) and (row r + S, lane).
__global__ void __launch_bounds__(kThreads)
row_pass_kernel(const int* __restrict__ x, int* __restrict__ out, int rows, int stride_rows,
                int reps) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows / 2 * kLanes) return;
  const int lane = i % kLanes;
  const int pair_row = i / kLanes;  // < rows / 2
  const int r = pair_row / stride_rows * 2 * stride_rows + pair_row % stride_rows;
  const size_t lo_at = static_cast<size_t>(r) * kLanes + lane;
  const size_t hi_at = lo_at + static_cast<size_t>(stride_rows) * kLanes;
  int lo = x[lo_at], hi = x[hi_at];
  for (int k = 0; k < reps; ++k) {
    exchange(lo, hi);
    opaque(lo);
    opaque(hi);
  }
  out[lo_at] = lo;
  out[hi_at] = hi;
}

template <int kStride>
cudaError_t launch_lane(const int* x, int* out, int rows, int reps, cudaStream_t stream) {
  const int warps = kThreads / 32;
  lane_pass_kernel<kStride><<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(x, out, rows,
                                                                              reps);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 = launched). x and out
// are (rows, 128) int32; the caller checks the shapes and that stride is a
// power of two below 128 (lane pass) or divides rows / 2 (row pass).
extern "C" int moss_sort_lane_pass(const int* x, int* out, int rows, int stride, int reps,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (stride) {
    case 1: return static_cast<int>(launch_lane<1>(x, out, rows, reps, s));
    case 2: return static_cast<int>(launch_lane<2>(x, out, rows, reps, s));
    case 4: return static_cast<int>(launch_lane<4>(x, out, rows, reps, s));
    case 8: return static_cast<int>(launch_lane<8>(x, out, rows, reps, s));
    case 16: return static_cast<int>(launch_lane<16>(x, out, rows, reps, s));
    case 32: return static_cast<int>(launch_lane<32>(x, out, rows, reps, s));
    case 64: return static_cast<int>(launch_lane<64>(x, out, rows, reps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int moss_sort_row_pass(const int* x, int* out, int rows, int stride_rows, int reps,
                                  void* stream) {
  const int pairs = rows / 2 * kLanes;
  row_pass_kernel<<<(pairs + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, out, rows, stride_rows, reps);
  return static_cast<int>(cudaGetLastError());
}
