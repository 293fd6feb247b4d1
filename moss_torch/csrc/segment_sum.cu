// Per-Gaussian sums of the backward kernel's per-pair gradient rows.
//
// Replaces the scatter-add VJP of moss_tpu/ops/binning.py::_gather_rows
// (_gather_rows_bwd, :51-60), which sums per-pair gradients into Gaussian
// slots. The pair list is in tile order; ops/binning.bin_pairs keeps, for each
// Gaussian g, the positions of its pairs as gaussian_pairs[offsets[g] :
// offsets[g + 1]] (the inverse of its key sort, so no second sort).
//
// What bounds it on the H100: bytes (40 B read per pair, 40 B written per
// Gaussian, 10 adds per pair). Segments are short: on the training input
// 104,964 pairs over 45,695 live Gaussians, 2.3 a Gaussian, so a warp per
// Gaussian leaves most lanes idle.
// What the design does: ten lanes per Gaussian, one column each, three
// Gaussians a warp (lanes 30 and 31 idle). Each lane walks its Gaussian's
// segment in order, so the ten lanes of a pair read its 40 contiguous bytes
// and the warp's 30 sums are stored as 120 contiguous bytes. A segment
// longer than kLong pairs (a large splat over many tiles) is summed by the
// whole warp instead: lane l adds pairs l, l + 32, ... of the segment in
// that order, then a butterfly of shuffles adds the lanes. Which path a
// Gaussian takes depends on its segment length only, and neither uses
// atomics, so the sums have the same bits on every run ("no float atomics
// into Gaussian slots"). A Gaussian with no pair gets a zero row.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 10;       // columns of a gradient row (csrc/rasterize_bwd.cu kGrads)
constexpr int kPerWarp = 3;     // Gaussians of a warp, kCols lanes each
constexpr int kLong = 32;       // longer segments take the whole warp
constexpr int kThreads = 256;   // 24 Gaussians per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ rows,          // (num_pairs, 10)
                   const int* __restrict__ gaussian_pairs,  // (num_pairs,)
                   const int* __restrict__ offsets,         // (P + 1,)
                   int num_gaussians,
                   float* __restrict__ out)                 // (P, 10)
{
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kCols;  // 0..2; 3 for lanes 30 and 31
  const int col = lane - grp * kCols;
  const int g = warp * kPerWarp + grp;
  const bool mine = grp < kPerWarp && g < num_gaussians;
  int begin = 0, end = 0;
  if (mine) {
    begin = offsets[g];
    end = offsets[g + 1];
  }
  const bool is_long = end - begin > kLong;
  float acc = 0.0f;
  if (mine && !is_long) {
#pragma unroll 4
    for (int j = begin; j < end; ++j)
      acc += rows[static_cast<size_t>(gaussian_pairs[j]) * kCols + col];
  }

  // the long segments of this warp's Gaussians, one after the other (the
  // bit of a group's first lane)
  unsigned longs = __ballot_sync(kFull, is_long && col == 0);
  while (longs) {
    const int first = __ffs(longs) - 1;
    longs &= longs - 1;
    const int b = __shfl_sync(kFull, begin, first);
    const int e = __shfl_sync(kFull, end, first);
    float part[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) part[k] = 0.0f;
    for (int j = b + lane; j < e; j += 32) {
      const float2* row = reinterpret_cast<const float2*>(
          rows + static_cast<size_t>(gaussian_pairs[j]) * kCols);
#pragma unroll
      for (int k = 0; k < kCols / 2; ++k) {
        const float2 v = row[k];
        part[2 * k] += v.x;
        part[2 * k + 1] += v.y;
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part[k] += __shfl_xor_sync(kFull, part[k], off);
      if (lane == first + k) acc = part[k];
    }
  }
  if (mine) out[static_cast<size_t>(g) * kCols + col] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int moss_segment_sum(const float* rows, const int* gaussian_pairs,
                                const int* offsets, int num_gaussians, float* out,
                                void* stream) {
  const int warps = (num_gaussians + kPerWarp - 1) / kPerWarp;
  const int blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  segment_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, gaussian_pairs, offsets, num_gaussians, out);
  return static_cast<int>(cudaGetLastError());
}
