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
// min or max per element, 2^19 operations, on the ALU pipe (64 lanes a clock
// an SM, half the FP32 rate), and a pass at a stride that pairs two threads
// one shuffle an element besides (32 lanes a clock an SM). At R = 64 the
// operations bound it, as they did the TPU kernel. What the design does about
// it: the data stay in registers across the repeats, the counterpart of VMEM.
// In the lane pass one warp owns a row and thread `lane` holds the int2s at
// elements 2 lane and 64 + 2 lane, so the block is read and written in
// 8-byte accesses by 512 CTAs of 8 warps, one wave; strides 1 and 64 (32 of
// a 2^19-key network's 112 lane passes) pair two registers of one thread,
// and 2-32 exchange through __shfl_xor_sync. One map serves all seven
// strides, as a network that keeps its block in registers from pass to pass
// needs. Maps of more elements a thread keep more strides in registers but
// make a launch's read and write dearer, and the s = 64 pass with them
// (PERF.md). The row pass runs on the same grid with the same access width:
// a warp takes 64 lanes of one pair of rows, thread `lane` the int2 at the
// same two lanes of both rows, and exchanges them in registers. Its index
// math is a mask and an add, no run-time divide by the stride, and its
// repeats unroll 16 deep. One thread a pair of 4-byte elements, on twice the
// CTAs and with a divide by the stride, cost a launch about 0.0005 ms more
// on the H100 (PERF.md).
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

constexpr int kLanes = 128;  // elements per row
constexpr unsigned kFull = 0xffffffffu;

// The lane pass's map of elements to threads: a warp a row, thread `lane`
// holding elements 64 k + 2 lane + c, k < 2, c < 2, in v[k][c]: its int2 k.
// The CTA is 8 warps, 8 rows.
constexpr int kLaneVec = 2;                          // adjacent elements of an int2
constexpr int kLaneVecs = kLanes / (32 * kLaneVec);  // int2s a thread: 2
constexpr int kLaneWarps = 8;
constexpr int kLaneThreads = 32 * kLaneWarps;

// The row pass's map: a warp takes 64 lanes of one pair of rows, thread
// `lane` the int2 at lanes 64 h + 2 lane of each row, h the warp's half of
// the pair. The CTA is 8 warps, 4 pairs of rows.
constexpr int kRowVec = 2;                           // adjacent elements of an int2
constexpr int kRowHalves = kLanes / (32 * kRowVec);  // warps a pair of rows: 2
constexpr int kRowWarps = 8;
constexpr int kRowThreads = 32 * kRowWarps;
static_assert(kRowHalves == 2, "row_pass_kernel takes a warp's half of its pair as warp & 1");

__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }

__device__ __forceinline__ void exchange(int& lo, int& hi) {
  const int a = lo;
  lo = min(a, hi);
  hi = max(a, hi);
}

// One repeat of the pass on a thread's registers. Stride 1 pairs the two
// elements of an int2 and 64 the two int2s of a thread, with neither a
// shuffle nor shared memory; 2-32 pair lane l with l ^ (stride / 2) through
// __shfl_xor_sync, the lower keeping the min.
template <int kStride>
__device__ __forceinline__ void lane_step(int (&v)[kLaneVecs][kLaneVec], bool lower) {
  if constexpr (kStride == 1) {
#pragma unroll
    for (int k = 0; k < kLaneVecs; ++k) exchange(v[k][0], v[k][1]);
  } else if constexpr (kStride < 32 * kLaneVec) {
#pragma unroll
    for (int k = 0; k < kLaneVecs; ++k)
#pragma unroll
      for (int c = 0; c < kLaneVec; ++c) {
        const int p = __shfl_xor_sync(kFull, v[k][c], kStride / kLaneVec);
        v[k][c] = lower ? min(v[k][c], p) : max(v[k][c], p);
      }
  } else {
#pragma unroll
    for (int c = 0; c < kLaneVec; ++c) exchange(v[0][c], v[1][c]);
  }
#pragma unroll
  for (int k = 0; k < kLaneVecs; ++k)
#pragma unroll
    for (int c = 0; c < kLaneVec; ++c) opaque(v[k][c]);
}

// One warp per row. The repeats are unrolled 16 deep where a pass stays in
// registers, so that the loop's own ALU instructions stay small beside its
// IMNMXs; the shuffled strides keep the compiler's unrolling.
template <int kStride>
__global__ void __launch_bounds__(kLaneThreads)
lane_pass_kernel(const int* __restrict__ x, int* __restrict__ out, int rows, int reps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLaneWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only
  const bool lower = (lane & (kStride / kLaneVec)) == 0;  // read by the shuffled strides only
  const size_t at = static_cast<size_t>(row) * kLanes + kLaneVec * lane;
  int v[kLaneVecs][kLaneVec];
#pragma unroll
  for (int k = 0; k < kLaneVecs; ++k) {
    const int2 u = *reinterpret_cast<const int2*>(x + at + k * 32 * kLaneVec);
    v[k][0] = u.x, v[k][1] = u.y;
  }
  if constexpr (kStride == 1 || kStride == 32 * kLaneVec) {
#pragma unroll 16
    for (int r = 0; r < reps; ++r) lane_step<kStride>(v, lower);
  } else {
    for (int r = 0; r < reps; ++r) lane_step<kStride>(v, lower);
  }
#pragma unroll
  for (int k = 0; k < kLaneVecs; ++k)
    *reinterpret_cast<int2*>(out + at + k * 32 * kLaneVec) = make_int2(v[k][0], v[k][1]);
}

// One warp per 64 lanes of a pair of rows, thread `lane` holding the int2 at
// lanes 64 h + 2 lane of both rows (h = warp & 1), exchanged in registers:
// the lane pass's grid and access width. The lower row of pair p is
// p + (p & -S): p = q S + m gives 2 q S + m, with S a power of two.
__global__ void __launch_bounds__(kRowThreads)
row_pass_kernel(const int* __restrict__ x, int* __restrict__ out, int rows, int stride_rows,
                int reps) {
  const int warp = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (warp >= rows / 2 * kRowHalves) return;  // whole warps only
  const int pair = warp >> 1;
  const int row = pair + (pair & -stride_rows);
  const size_t lo_at = static_cast<size_t>(row) * kLanes + (warp & 1) * 32 * kRowVec +
                       kRowVec * (threadIdx.x & 31);
  const size_t hi_at = lo_at + static_cast<size_t>(stride_rows) * kLanes;
  int2 lo = *reinterpret_cast<const int2*>(x + lo_at);
  int2 hi = *reinterpret_cast<const int2*>(x + hi_at);
#pragma unroll 16
  for (int k = 0; k < reps; ++k) {
    exchange(lo.x, hi.x);
    exchange(lo.y, hi.y);
    opaque(lo.x), opaque(lo.y), opaque(hi.x), opaque(hi.y);
  }
  *reinterpret_cast<int2*>(out + lo_at) = lo;
  *reinterpret_cast<int2*>(out + hi_at) = hi;
}

// The lane pass's grid and block, and an empty kernel launched on them: its
// time is the launch's alone, beside the pass's with r = 0 (the read and the
// write) and with r repeats.
dim3 lane_grid(int rows) { return dim3((rows + kLaneWarps - 1) / kLaneWarps); }

__global__ void __launch_bounds__(kLaneThreads)
lane_empty_kernel(const int* __restrict__, int* __restrict__, int, int) {}

template <int kStride>
cudaError_t launch_lane(const int* x, int* out, int rows, int reps, cudaStream_t stream) {
  lane_pass_kernel<kStride><<<lane_grid(rows), kLaneThreads, 0, stream>>>(x, out, rows, reps);
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

// The empty kernel on the lane pass's grid for `rows` rows, with its arguments.
extern "C" int moss_sort_lane_empty(const int* x, int* out, int rows, int stride, int reps,
                                    void* stream) {
  lane_empty_kernel<<<lane_grid(rows), kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moss_sort_row_pass(const int* x, int* out, int rows, int stride_rows, int reps,
                                  void* stream) {
  const int warps = rows / 2 * kRowHalves;
  row_pass_kernel<<<(warps + kRowWarps - 1) / kRowWarps, kRowThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, out, rows, stride_rows, reps);
  return static_cast<int>(cudaGetLastError());
}
