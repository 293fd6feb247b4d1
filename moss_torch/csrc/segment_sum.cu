// Per-Gaussian sums of the backward kernel's per-pair gradient rows.
//
// Replaces the scatter-add VJP of moss_tpu/ops/binning.py::_gather_rows
// (_gather_rows_bwd, :51-60), which sums per-pair gradients into Gaussian
// slots. The pair list is in tile order; ops/binning.bin_pairs keeps, for each
// Gaussian g, the positions of its pairs as gaussian_pairs[offsets[g] :
// offsets[g + 1]] (the inverse of its key sort, so no second sort). One warp
// per Gaussian: lane l adds rows l, l + 32, ... of the segment in that order,
// then a butterfly of shuffles adds the lanes. No atomics, so the sum has the
// same bits on every run ("no float atomics into Gaussian slots").
//
// What bounds it on the H100: bytes (40 B read per pair, 40 B written per
// Gaussian, 10 adds per pair). The rows are read in Gaussian order, so each
// lane's 40-byte row is a gather; they sit in L2 from the backward kernel.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 10;       // columns of a gradient row (csrc/rasterize_bwd.cu kGrads)
constexpr int kThreads = 256;   // 8 Gaussians per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ rows,          // (num_pairs, 10)
                   const int* __restrict__ gaussian_pairs,  // (num_pairs,)
                   const int* __restrict__ offsets,         // (P + 1,)
                   int num_gaussians,
                   float* __restrict__ out)                 // (P, 10)
{
  const int g = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= num_gaussians) return;  // whole warps only
  const int begin = offsets[g];
  const int end = offsets[g + 1];
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int j = begin + lane; j < end; j += 32) {
    const float* row = rows + static_cast<size_t>(gaussian_pairs[j]) * kCols;
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] += row[k];
  }
  float mine = 0.0f;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    if (lane == k) mine = acc[k];
  }
  if (lane < kCols) out[static_cast<size_t>(g) * kCols + lane] = mine;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int moss_segment_sum(const float* rows, const int* gaussian_pairs,
                                const int* offsets, int num_gaussians, float* out,
                                void* stream) {
  const int blocks = (num_gaussians * 32 + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  segment_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, gaussian_pairs, offsets, num_gaussians, out);
  return static_cast<int>(cudaGetLastError());
}
