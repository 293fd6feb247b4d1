// Forward alpha blend of depth-sorted Gaussian splats, one CTA per 16x16 tile.
//
// Replaces moss_tpu/ops/rasterize_tpu.py::_fwd_kernel (:288-380), its launcher
// _run_fwd (:571-595) and its chunk math _chunk_blend (:211-277). Same
// contract as the plain version (moss_torch/ops/rasterize_ref.py):
//
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = mean_x - px at integer
//           pixel coordinates                      (skip if power > 0)
//   alpha = min(0.99, op * expf(power))            (skip if alpha < 1/255)
//   stop when T (1 - alpha) < 1e-4; the splat that triggers the stop is skipped
//   w = alpha T; accumulate w * (r, g, b, depth) and w
//
// and writes six f32 planes (r, g, b, depth, alpha = sum w, final_T); the
// background is added outside.
//
// What bounds it on the H100: f32 operations. Every pixel evaluates every
// pair of its tile until it saturates (about 14 f32 operations and one expf
// per evaluation, 13 more per contribution), while the bytes are small: the
// pair list, ten floats per Gaussian, and six output planes (about 10 MB at
// 512x512 / 46k Gaussians). What the design does about it: one thread per
// pixel keeps T and the five sums in registers; the tile's pairs are staged
// through shared memory in batches of 256 (one pair per thread, read by all
// 256 threads as broadcasts), so each Gaussian's data leaves device memory
// once per tile, not once per pixel; a pixel leaves its loop when it stops,
// and the whole CTA stops staging when __syncthreads_count says all 256
// pixels are done. The conic stays on the f32 FMA pipes, never the tensor
// cores: TF32 would corrupt exp(power) through cancellation, the Hopper twin
// of the MXU finding in PERF.md. expf (not __expf), and no --use_fast_math.
//
// The skip and stop tests live in csrc/blend_common.cuh, shared with the
// backward kernel, which must stop every pixel exactly where this one does.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace moss;  // kTile, kBlock (one pair per thread per batch), blend_step

__global__ void __launch_bounds__(kBlock)
rasterize_fwd_kernel(const int* __restrict__ tile_offsets,   // (num_tiles + 1,)
                     const int* __restrict__ pair_gaussian,  // (num_pairs,)
                     const float* __restrict__ mean2d,       // (P, 2)
                     const float* __restrict__ conic,        // (P, 3)
                     const float* __restrict__ opacity,      // (P,)
                     const float* __restrict__ color,        // (P, 3)
                     const float* __restrict__ depth,        // (P,)
                     int height, int width, int grid_w,
                     float* __restrict__ out)                // (6, H, W)
{
  __shared__ float s_mx[kBlock], s_my[kBlock];
  __shared__ float s_a[kBlock], s_b[kBlock], s_c[kBlock], s_op[kBlock];
  __shared__ float s_r[kBlock], s_g[kBlock], s_bl[kBlock], s_d[kBlock];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % grid_w) * kTile + t % kTile;
  const int py = (tile / grid_w) * kTile + t / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_offsets[tile];
  const int end = tile_offsets[tile + 1];

  bool done = !inside;
  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;

  for (int base = start; base < end; base += kBlock) {
    // also the barrier that keeps the previous batch's readers ahead of this
    // batch's writers
    if (__syncthreads_count(done) == kBlock) break;
    const int k = base + t;
    if (k < end) {
      const int g = pair_gaussian[k];
      s_mx[t] = mean2d[2 * g];
      s_my[t] = mean2d[2 * g + 1];
      s_a[t] = conic[3 * g];
      s_b[t] = conic[3 * g + 1];
      s_c[t] = conic[3 * g + 2];
      s_op[t] = opacity[g];
      s_r[t] = color[3 * g];
      s_g[t] = color[3 * g + 1];
      s_bl[t] = color[3 * g + 2];
      s_d[t] = depth[g];
    }
    __syncthreads();
    const int n = min(kBlock, end - base);
    for (int j = 0; !done && j < n; ++j) {
      float dx, dy, alpha, test_T;
      const int step = blend_step(s_mx[j], s_my[j], s_a[j], s_b[j], s_c[j], s_op[j], fx, fy,
                                  T, dx, dy, alpha, test_T);
      if (step == kSkip) continue;
      if (step == kStop) {
        done = true;
        break;
      }
      const float w = alpha * T;
      acc_r += w * s_r[j];
      acc_g += w * s_g[j];
      acc_b += w * s_bl[j];
      acc_d += w * s_d[j];
      acc_a += w;
      T = test_T;
    }
  }

  if (inside) {
    const int plane = height * width;
    const int pix = py * width + px;
    out[pix] = acc_r;
    out[plane + pix] = acc_g;
    out[2 * plane + pix] = acc_b;
    out[3 * plane + pix] = acc_d;
    out[4 * plane + pix] = acc_a;
    out[5 * plane + pix] = T;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int moss_rasterize_fwd(const int* tile_offsets, const int* pair_gaussian,
                                  const float* mean2d, const float* conic,
                                  const float* opacity, const float* color,
                                  const float* depth, int height, int width,
                                  int grid_w, int num_tiles, float* out,
                                  void* stream) {
  rasterize_fwd_kernel<<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_offsets, pair_gaussian, mean2d, conic, opacity, color, depth, height,
      width, grid_w, out);
  return static_cast<int>(cudaGetLastError());
}
