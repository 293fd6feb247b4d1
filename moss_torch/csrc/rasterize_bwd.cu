// Backward of the alpha blend: per-pair gradients, one CTA per tile segment
// of at most S pairs (S = seg_len, csrc/blend_common.cuh).
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
// and the per-pair gradients follow (rasterize_tpu.py:436-505). A tile cut
// into segments by the forward (csrc/rasterize_fwd.cu) is walked one CTA a
// segment, with no exchange between CTAs: segment k starts from the
// forward's state (ops/split_blend.py (e)), T_k where the segment is live,
// else 0, so it stops exactly where the forward's blend did, and
// s_after = (Qtail - g . cum_k) - its own prefix, g . cum_k being the sum of
// w dL/dw over the segments before it. A tile of at most S pairs is one
// segment with T = 1 and the prefix from 0: the unsplit kernel bit for bit.
// A pair lies in one segment, so its row is still summed over the tile's
// 256 pixels by one CTA. The ten
// columns of a pair's row are d(mean_x, mean_y, conic a, b, c, opacity,
// r, g, b, depth). Rows of pairs that no pixel reached (after a whole-tile
// stop) are left as the caller zeroed them; nothing is added with atomics.
//
// What bounds it on the H100: f32 operations, as for the forward (about 14
// per (pair, pixel) evaluation, about 38 more per contribution), against a
// few MB of pair list, Gaussian data, gradient planes and per-pair rows. In
// practice a CTA walks its pairs one after another, and the stages below
// showed that walk (the staging and the loop, with no blend math) taking most
// of the time on inputs with tiles of thousands of pairs, hence the segments.
// What the design does about it: one thread per pixel keeps T, the prefix
// and its six gradient planes in registers; pairs are staged through shared
// memory 128 at a time. The sum of a pair's ten values over the tile's 256
// pixels runs in a fixed order: a butterfly of warp shuffles (skipped when
// no pixel of the warp blends the pair, the common case for small splats),
// then the eight warps' partials from shared memory, summed in warp order
// by one thread per pair. So two runs give the same bits. A warp leaves the
// batch when all its pixels have stopped, the CTA when all 256 have.
//
// The kernel is a template on a stage, for the cost accounting of
// moss_torch/tools/bwd_kernel_floor.py, the port of the stage-ablated
// copies of _bwd_kernel in tools/bwd_kernel_floor.py::make_kernel.kern (:97).
// Each stage (its Python name in brackets) adds work to the one before it:
//
//   kLoad (load)            the batch loop, the staging of pair data into
//                           shared memory, the gimg loads and the row writes
//                           (rows = the staged values); no blend math, so it
//                           walks every pair: it has no T to stop on
//   kRecompute (recompute)  + blend_step and T, with the forward's stops
//   kSuffix (suffix)        + dL/dw, the prefix, s_after and dL/dpower
//   kProduction (full)      + the ten values, the warp butterfly, the
//                           cross-warp sum and the row assembly: the
//                           production kernel (moss_rasterize_bwd)
//   kProductionSoa          full's math with the rows written column-major,
//     (full_soa)            (10, num_pairs), so a block's stores of one
//                           column are coalesced (the counterpart of the
//                           TPU's transpose-free `fullT`)
//
// nvcc deletes a computation whose result never reaches memory, so each
// ablated stage adds its last quantity into a per-pixel sum and writes it
// once: the staged geometry for kLoad, w for kRecompute, dL/dpower for
// kSuffix. A tile's first segment starts its sum from the pixel's six
// gradient values and writes it to `observe` (H, W); a later segment starts
// from 0 and writes to observe_part (slots, 256), which
// rasterize_bwd_observe_kernel then adds to `observe` in segment order. kLoad
// has no T: it walks every pair of every segment and reads no state.
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

enum Stage { kLoad = 0, kRecompute = 1, kSuffix = 2, kProduction = 3, kProductionSoa = 4 };

template <int kStage>
__global__ void __launch_bounds__(kBlock)
rasterize_bwd_kernel(const int* __restrict__ tile_offsets,   // (num_tiles + 1,)
                     const int* __restrict__ pair_gaussian,  // (num_pairs,)
                     const float* __restrict__ mean2d,       // (P, 2)
                     const float* __restrict__ conic,        // (P, 3)
                     const float* __restrict__ opacity,      // (P,)
                     const float* __restrict__ color,        // (P, 3)
                     const float* __restrict__ depth,        // (P,)
                     const float* __restrict__ gimg,         // (6, H, W)
                     int height, int width, int grid_w, int num_tiles, int seg_len,
                     const float* __restrict__ state,        // (slots, kStatePlanes, 256)
                     float* __restrict__ pair_grads,         // (num_pairs, 10); soa: (10, num_pairs)
                     float* __restrict__ observe,            // (H, W), ablated stages only
                     float* __restrict__ observe_part,       // (slots, 256), ablated stages only
                     int num_pairs)
{
  constexpr bool kMoments = kStage >= kProduction;
  __shared__ float s_mx[kBatch], s_my[kBatch];
  __shared__ float s_a[kBatch], s_b[kBatch], s_c[kBatch], s_op[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_bl[kBatch], s_d[kBatch];
  // per-warp sums of each staged pair's ten values (40 KB)
  __shared__ float s_part[kMoments ? kWarps : 1][kMoments ? kBatch * kGrads : 1];

  Segment seg;
  if (!segment_of(blockIdx.x, tile_offsets, num_tiles, seg_len, seg)) return;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int px = (seg.tile % grid_w) * kTile + t % kTile;
  const int py = (seg.tile / grid_w) * kTile + t / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = seg.start;
  const int end = seg.end;

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
  // what an ablated stage writes
  float sink = seg.k == 0 ? g_r + g_g + g_b + g_d + g_a + q_tail : 0.0f;

  float T = 1.0f;
  float q_base = q_tail;  // Qtail less the segments before this one
  if (kStage != kLoad && seg.k > 0 && inside) {
    const float* st = state + static_cast<size_t>(blockIdx.x) * kStatePlanes * kBlock + t;
    T = st[kTIn * kBlock];
    const float prior = g_r * st[kAcc * kBlock] + g_g * st[(kAcc + 1) * kBlock]
        + g_b * st[(kAcc + 2) * kBlock] + g_d * st[(kAcc + 3) * kBlock]
        + g_a * st[(kAcc + 4) * kBlock];
    q_base = q_tail - prior;
  }
  bool done = !inside || T < kTEps;
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
      if constexpr (kStage == kLoad) {
        if (!done) sink += s_mx[j] + s_my[j] + s_a[j] + s_b[j] + s_c[j] + s_op[j];
        continue;
      }
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
          if constexpr (kStage == kRecompute) {
            sink += w;
          } else {
            const float dl_dw =
                s_r[j] * g_r + s_g[j] * g_g + s_bl[j] * g_b + s_d[j] * g_d + g_a;
            prefix += w * dl_dw;
            const float s_after = q_base - prefix;
            const float dp =
                alpha < kAlphaMax ? (dl_dw * T - s_after / (1.0f - alpha)) * alpha : 0.0f;
            if constexpr (kStage == kSuffix) {
              sink += dp;
            } else {
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
            }
          }
          T = test_T;
        }
      }
      if constexpr (kMoments) {
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
    }
    if constexpr (kMoments) {
      // a warp whose pixels all stopped adds nothing to the batch's later pairs
      for (int k = j * kGrads + lane; k < n * kGrads; k += 32) s_part[warp][k] = 0.0f;
      __syncthreads();
    }

    if (t < n) {
      float row[kGrads];
      if constexpr (kMoments) {
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
      } else {  // the staged pair, which makes the staging observable
        row[0] = s_mx[t];
        row[1] = s_my[t];
        row[2] = s_a[t];
        row[3] = s_b[t];
        row[4] = s_c[t];
        row[5] = s_op[t];
        row[6] = s_r[t];
        row[7] = s_g[t];
        row[8] = s_bl[t];
        row[9] = s_d[t];
      }
      if constexpr (kStage == kProductionSoa) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k)
          pair_grads[static_cast<size_t>(k) * num_pairs + base + t] = row[k];
      } else {
        float* out = pair_grads + static_cast<size_t>(base + t) * kGrads;
#pragma unroll
        for (int k = 0; k < kGrads; ++k) out[k] = row[k];
      }
    }
  }
  if constexpr (!kMoments) {
    if (seg.k > 0) observe_part[static_cast<size_t>(blockIdx.x) * kBlock + t] = sink;
    else if (inside) observe[py * width + px] = sink;
  }
}

// An ablated stage's observer: the later segments' sums added to the first's,
// in segment order, one CTA per split tile.
__global__ void __launch_bounds__(kBlock)
rasterize_bwd_observe_kernel(const int* __restrict__ tile_offsets, int height, int width,
                             int grid_w, int num_tiles, int seg_len,
                             const float* __restrict__ observe_part, float* __restrict__ observe)
{
  const Segment seg = tile_segment(tile_offsets, blockIdx.x, 0, seg_len);
  const int t = threadIdx.x;
  const int px = (seg.tile % grid_w) * kTile + t % kTile;
  const int py = (seg.tile / grid_w) * kTile + t / kTile;
  if (seg.count == 1 || px >= width || py >= height) return;
  float v = observe[py * width + px];
  for (int k = 1; k < seg.count; ++k)
    v += observe_part[static_cast<size_t>(segment_slot(seg, k, num_tiles)) * kBlock + t];
  observe[py * width + px] = v;
}

template <int kStage>
int launch_stage(const int* tile_offsets, const int* pair_gaussian, const float* mean2d,
                 const float* conic, const float* opacity, const float* color,
                 const float* depth, const float* gimg, int height, int width, int grid_w,
                 int num_tiles, int seg_len, int num_slots, const float* state,
                 float* pair_grads, float* observe, float* observe_part, int num_pairs,
                 cudaStream_t stream) {
  rasterize_bwd_kernel<kStage><<<num_slots, kBlock, 0, stream>>>(
      tile_offsets, pair_gaussian, mean2d, conic, opacity, color, depth, gimg, height, width,
      grid_w, num_tiles, seg_len, state, pair_grads, observe, observe_part, num_pairs);
  if (kStage < kProduction && num_pairs > seg_len) {
    if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    rasterize_bwd_observe_kernel<<<num_tiles, kBlock, 0, stream>>>(
        tile_offsets, height, width, grid_w, num_tiles, seg_len, observe_part, observe);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// pair_grads must be zeroed by the caller. state: the forward's
// (moss_rasterize_fwd with the same seg_len and num_slots).
extern "C" int moss_rasterize_bwd(const int* tile_offsets, const int* pair_gaussian,
                                  const float* mean2d, const float* conic,
                                  const float* opacity, const float* color,
                                  const float* depth, const float* gimg, int height,
                                  int width, int grid_w, int num_tiles, int num_pairs,
                                  int seg_len, int num_slots, const float* state,
                                  float* pair_grads, void* stream) {
  return launch_stage<kProduction>(tile_offsets, pair_gaussian, mean2d, conic, opacity, color,
                                   depth, gimg, height, width, grid_w, num_tiles, seg_len,
                                   num_slots, state, pair_grads, nullptr, nullptr, num_pairs,
                                   static_cast<cudaStream_t>(stream));
}

// The kernel at stage `stage` (0 load, 1 recompute, 2 suffix, 3 full,
// 4 full_soa); as moss_rasterize_bwd, plus observe (H, W), written by
// stages 0-2 at every pixel inside the image (after a second kernel that
// adds the later segments' observe_part (num_slots, 256) when a tile can be
// split), and num_pairs, also the row count of full_soa's column-major rows.
extern "C" int moss_rasterize_bwd_stage(int stage, const int* tile_offsets,
                                        const int* pair_gaussian, const float* mean2d,
                                        const float* conic, const float* opacity,
                                        const float* color, const float* depth,
                                        const float* gimg, int height, int width, int grid_w,
                                        int num_tiles, int num_pairs, int seg_len,
                                        int num_slots, const float* state, float* pair_grads,
                                        float* observe, float* observe_part, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define MOSS_STAGE(k)                                                                         \
  launch_stage<k>(tile_offsets, pair_gaussian, mean2d, conic, opacity, color, depth, gimg,  \
                  height, width, grid_w, num_tiles, seg_len, num_slots, state, pair_grads,  \
                  observe, observe_part, num_pairs, s)
  switch (stage) {
    case kLoad: return MOSS_STAGE(kLoad);
    case kRecompute: return MOSS_STAGE(kRecompute);
    case kSuffix: return MOSS_STAGE(kSuffix);
    case kProduction: return MOSS_STAGE(kProduction);
    case kProductionSoa: return MOSS_STAGE(kProductionSoa);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MOSS_STAGE
}
