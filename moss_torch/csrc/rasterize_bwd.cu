// Backward of the alpha blend: per-pair gradients, one CTA per 16x16 tile.
//
// Replaces moss_tpu/ops/rasterize_tpu.py::_bwd_kernel (:383-568) and its
// launcher _run_bwd (:598-626). It reads the pair list of the forward
// (ops/binning.bin_pairs, 16x16 tiles) and the upstream image gradients
// gimg (6, H, W): g_r, g_g, g_b, g_depth, g_alpha and, in plane 5,
//
//   Qtail = g_r r + g_g g + g_b b + g_d depth + g_a alpha + g_T final_T,
//
// folded outside the kernel as rasterize_tpu.py:645 does. Every pixel walks
// its tile's pairs in the forward's order with the forward's arithmetic
// (csrc/blend_common.cuh), so it has T before each pair without dividing by
// (1 - alpha), and keeps the running prefix of w dL/dw. With
// s_after = Qtail - prefix (inclusive),
//
//   dL/dpower = (dL/dw T - s_after / (1 - alpha)) alpha   (alpha < 0.99)
//
// and the per-pair gradients follow (rasterize_tpu.py:436-505). The ten
// columns of a pair's row are d(mean_x, mean_y, conic a, b, c, opacity,
// r, g, b, depth). Rows of pairs that no pixel reached (after a whole-tile
// stop) are left as the caller zeroed them; nothing is added with atomics.
//
// What bounds it on the H100: f32 operations, as for the forward (about 14
// per (pair, pixel) evaluation, about 38 more per contribution), against a
// few MB of pair list, Gaussian data, gradient planes and per-pair rows.
// What the design does about it: one thread per pixel keeps T, the prefix
// and its six gradient planes in registers; pairs are staged through shared
// memory 128 at a time. The sum of a pair's ten values over the tile's 256
// pixels runs in a fixed order: a butterfly of warp shuffles (skipped when
// no pixel of the warp blends the pair, the common case for small splats),
// then the eight warps' partials from shared memory, summed in warp order
// by one thread per pair. So two runs give the same bits. A warp leaves the
// batch when all its pixels have stopped, the CTA when all 256 have.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace moss;

constexpr int kBatch = 128;            // pairs staged per round
constexpr int kWarps = kBlock / 32;
constexpr int kGrads = 10;             // columns of a pair's gradient row
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kBlock)
rasterize_bwd_kernel(const int* __restrict__ tile_offsets,   // (num_tiles + 1,)
                     const int* __restrict__ pair_gaussian,  // (num_pairs,)
                     const float* __restrict__ mean2d,       // (P, 2)
                     const float* __restrict__ conic,        // (P, 3)
                     const float* __restrict__ opacity,      // (P,)
                     const float* __restrict__ color,        // (P, 3)
                     const float* __restrict__ depth,        // (P,)
                     const float* __restrict__ gimg,         // (6, H, W)
                     int height, int width, int grid_w,
                     float* __restrict__ pair_grads)         // (num_pairs, 10)
{
  __shared__ float s_mx[kBatch], s_my[kBatch];
  __shared__ float s_a[kBatch], s_b[kBatch], s_c[kBatch], s_op[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_bl[kBatch], s_d[kBatch];
  // per-warp sums of each staged pair's ten values (40 KB)
  __shared__ float s_part[kWarps][kBatch * kGrads];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int px = (tile % grid_w) * kTile + t % kTile;
  const int py = (tile / grid_w) * kTile + t / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_offsets[tile];
  const int end = tile_offsets[tile + 1];

  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_d = 0.0f, g_a = 0.0f, q_tail = 0.0f;
  if (inside) {
    const int plane = height * width;
    const int pix = py * width + px;
    g_r = gimg[pix];
    g_g = gimg[plane + pix];
    g_b = gimg[2 * plane + pix];
    g_d = gimg[3 * plane + pix];
    g_a = gimg[4 * plane + pix];
    q_tail = gimg[5 * plane + pix];
  }

  bool done = !inside;
  float T = 1.0f;
  float prefix = 0.0f;

  for (int base = start; base < end; base += kBatch) {
    // also the barrier that keeps the previous batch's readers ahead of this
    // batch's writers
    if (__syncthreads_count(done) == kBlock) break;
    const int n = min(kBatch, end - base);
    if (t < n) {
      const int g = pair_gaussian[base + t];
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

    int j = 0;
    for (; j < n; ++j) {
      if (__all_sync(kFull, done)) break;  // warp-uniform: the shuffles below need all lanes
      float v[kGrads];
#pragma unroll
      for (int k = 0; k < kGrads; ++k) v[k] = 0.0f;
      bool hit = false;
      if (!done) {
        float dx, dy, alpha, test_T;
        const int step = blend_step(s_mx[j], s_my[j], s_a[j], s_b[j], s_c[j], s_op[j], fx, fy,
                                    T, dx, dy, alpha, test_T);
        if (step == kStop) {
          done = true;
        } else if (step == kBlend) {
          hit = true;
          const float w = alpha * T;
          const float dl_dw = s_r[j] * g_r + s_g[j] * g_g + s_bl[j] * g_b + s_d[j] * g_d + g_a;
          prefix += w * dl_dw;
          const float s_after = q_tail - prefix;
          const float dp =
              alpha < kAlphaMax ? (dl_dw * T - s_after / (1.0f - alpha)) * alpha : 0.0f;
          v[0] = dp * dx;
          v[1] = dp * dy;
          v[2] = dp * dx * dx;
          v[3] = dp * dx * dy;
          v[4] = dp * dy * dy;
          v[5] = dp;
          v[6] = w * g_r;
          v[7] = w * g_g;
          v[8] = w * g_b;
          v[9] = w * g_d;
          T = test_T;
        }
      }
      float mine = 0.0f;  // lane k < kGrads keeps the warp's sum of v[k]
      if (__any_sync(kFull, hit)) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], off);
          if (lane == k) mine = v[k];
        }
      }
      if (lane < kGrads) s_part[warp][j * kGrads + lane] = mine;
    }
    // a warp whose pixels all stopped adds nothing to the batch's later pairs
    for (int k = j * kGrads + lane; k < n * kGrads; k += 32) s_part[warp][k] = 0.0f;
    __syncthreads();

    if (t < n) {
      float s[kGrads];
#pragma unroll
      for (int k = 0; k < kGrads; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += s_part[w][t * kGrads + k];
        s[k] = acc;
      }
      // s = sums of dp dx, dp dy, dp dx^2, dp dx dy, dp dy^2, dp, w g_rgb, w g_d
      const float a = s_a[t], b = s_b[t], c = s_c[t];
      float* row = pair_grads + static_cast<size_t>(base + t) * kGrads;
      row[0] = -(a * s[0] + b * s[1]);        // mean_x
      row[1] = -(c * s[1] + b * s[0]);        // mean_y
      row[2] = -0.5f * s[2];                  // conic a
      row[3] = -s[3];                         // conic b
      row[4] = -0.5f * s[4];                  // conic c
      row[5] = s[5] / fmaxf(s_op[t], 1e-12f); // opacity
      row[6] = s[6];
      row[7] = s[7];
      row[8] = s[8];
      row[9] = s[9];
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// pair_grads must be zeroed by the caller.
extern "C" int moss_rasterize_bwd(const int* tile_offsets, const int* pair_gaussian,
                                  const float* mean2d, const float* conic,
                                  const float* opacity, const float* color,
                                  const float* depth, const float* gimg, int height,
                                  int width, int grid_w, int num_tiles, float* pair_grads,
                                  void* stream) {
  rasterize_bwd_kernel<<<num_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_offsets, pair_gaussian, mean2d, conic, opacity, color, depth, gimg, height,
      width, grid_w, pair_grads);
  return static_cast<int>(cudaGetLastError());
}
