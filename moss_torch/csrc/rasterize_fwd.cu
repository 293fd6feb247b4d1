// Forward alpha blend of depth-sorted Gaussian splats, one CTA per tile
// segment of at most S pairs (S = seg_len, csrc/blend_common.cuh).
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
// What bounds it on the H100: one CTA walks its pairs one after another, so
// a tile of thousands of pairs (a body's silhouette) holds the whole launch
// while most SMs idle; the math is about 14 f32 operations and one expf per
// (pair, pixel) evaluation, 13 more per contribution. What the design does
// about it: a tile longer than S pairs is cut into segments, each walked by
// its own CTA, in two launches of rasterize_fwd_kernel
// (moss_torch/ops/split_blend.py, steps a-e):
//
//   kHead  every tile's first segment blends from T = 1: a tile of one
//          segment writes its planes, a split one its segment state and L_0,
//          its exit T or 0 if it stopped (the number (a) would give, both
//          walking from T = 1). At the same time (a) for the segments between
//          a split tile's first and last: the per-pixel product L_k of
//          (1 - alpha) from T = 1, 0 where that walk would stop
//   kTail  (b, c) for the segments after the first: T_k = L_0 ... L_{k-1}
//          in segment order, then the full blend from T_k into the segment
//          state. The last of a tile's CTAs to finish (an integer ticket;
//          the head zeroed it) runs (d, e) for the tile: per pixel, in
//          segment order, the sums up to the first stop, the entering T of
//          the segments after it set to 0 and each segment's sums replaced by
//          those before it, for the backward
//
// The second runs only when some tile can be split (more pairs than S in
// all). A long tile costs two walks of S pairs and its merge; the price is
// (a), walked for segments that an earlier stop makes moot (a tile that
// saturates in its first segment), which the measured S trades against.
//
// A tile of at most S pairs runs the first launch's walk from T = 1, the
// unsplit kernel bit for bit. In a walk, one thread per pixel keeps T and the
// five sums in registers; pairs are staged through shared memory in batches
// of 256 (one pair per thread, read by all 256 threads as broadcasts); a
// pixel leaves its loop when it stops, and the CTA stops staging when
// __syncthreads_count says all 256 pixels are done (a pixel outside the image
// or entering a segment with T < 1e-4 is done from the start). The conic
// stays on the f32 FMA pipes, never the tensor cores: TF32 would corrupt
// exp(power) through cancellation, the Hopper twin of the MXU finding in
// PERF.md. expf (not __expf), and no --use_fast_math; no float atomics, and
// the merge runs in segment order whichever CTA runs it, so two runs give
// the same bits.
//
// The skip and stop tests live in csrc/blend_common.cuh, shared with the
// backward kernel, which must stop every pixel exactly where this one does.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace moss;  // kTile, kBlock (one pair per thread per batch), blend_step, Segment

enum Pass { kHead = 0, kTail = 1 };

// (d) and (e) for the pixel of thread t of a split tile, after every segment
// has written its state. L2 loads: the other segments' CTAs wrote it in this
// launch.
__device__ __forceinline__ void merge_segments(const Segment& seg, int num_tiles, int t,
                                               int pix, int plane, float* out, float* state) {
  float sum[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float T = 1.0f;
  bool live = true;
  for (int k = 0; k < seg.count; ++k) {
    const int slot = segment_slot(seg, k, num_tiles);
    if (live) {
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        float* acc = segment_state(state, slot, kAcc + c) + t;
        const float a = __ldcg(acc);
        *acc = sum[c];
        sum[c] += a;
      }
      T = __ldcg(segment_state(state, slot, kTOut) + t);
      live = __ldcg(segment_state(state, slot, kStopped) + t) == 0.0f;
    } else {
      segment_state(state, slot, kTIn)[t] = 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) out[c * plane + pix] = sum[c];
  out[5 * plane + pix] = T;
}

// Pair data staged for one batch, one pair a thread.
struct Batch {
  float mx[kBlock], my[kBlock], a[kBlock], b[kBlock], c[kBlock], op[kBlock];
  float r[kBlock], g[kBlock], bl[kBlock], d[kBlock];
};

// The walk of pairs [start, end) from T with the blend step: kSums, (c) with
// its five sums in acc; otherwise (a), T alone. A template, so that neither
// walk tests which it is at every pair.
template <bool kSums>
__device__ __forceinline__ void walk(int start, int end, const int* __restrict__ pair_gaussian,
                                     const float* __restrict__ mean2d,
                                     const float* __restrict__ conic,
                                     const float* __restrict__ opacity,
                                     const float* __restrict__ color,
                                     const float* __restrict__ depth, float fx, float fy,
                                     Batch& s, float& T, bool& done, bool& stopped,
                                     float (&acc)[5]) {
  const int t = threadIdx.x;
  for (int base = start; base < end; base += kBlock) {
    // also the barrier that keeps the previous batch's readers ahead of this
    // batch's writers
    if (__syncthreads_count(done) == kBlock) break;
    const int k = base + t;
    if (k < end) {
      const int g = pair_gaussian[k];
      s.mx[t] = mean2d[2 * g];
      s.my[t] = mean2d[2 * g + 1];
      s.a[t] = conic[3 * g];
      s.b[t] = conic[3 * g + 1];
      s.c[t] = conic[3 * g + 2];
      s.op[t] = opacity[g];
      if (kSums) {
        s.r[t] = color[3 * g];
        s.g[t] = color[3 * g + 1];
        s.bl[t] = color[3 * g + 2];
        s.d[t] = depth[g];
      }
    }
    __syncthreads();
    const int n = min(kBlock, end - base);
    for (int j = 0; !done && j < n; ++j) {
      float dx, dy, alpha, test_T;
      const int step = blend_step(s.mx[j], s.my[j], s.a[j], s.b[j], s.c[j], s.op[j], fx, fy, T,
                                  dx, dy, alpha, test_T);
      if (step == kSkip) continue;
      if (step == kStop) {
        done = stopped = true;
        break;
      }
      if (kSums) {
        const float w = alpha * T;
        acc[0] += w * s.r[j];
        acc[1] += w * s.g[j];
        acc[2] += w * s.bl[j];
        acc[3] += w * s.d[j];
        acc[4] += w;
      }
      T = test_T;
    }
  }
}

template <int kPass>
__global__ void __launch_bounds__(kBlock)
rasterize_fwd_kernel(const int* __restrict__ tile_offsets,   // (num_tiles + 1,)
                     const int* __restrict__ pair_gaussian,  // (num_pairs,)
                     const float* __restrict__ mean2d,       // (P, 2)
                     const float* __restrict__ conic,        // (P, 3)
                     const float* __restrict__ opacity,      // (P,)
                     const float* __restrict__ color,        // (P, 3)
                     const float* __restrict__ depth,        // (P,)
                     int height, int width, int grid_w, int num_tiles, int seg_len,
                     float* __restrict__ out,                // (6, H, W)
                     float* __restrict__ state,              // (slots, kStatePlanes, 256)
                     int* __restrict__ tickets)              // (num_tiles,)
{
  __shared__ Batch s;
  __shared__ bool s_last;

  Segment seg;
  if (!segment_of(blockIdx.x, tile_offsets, num_tiles, seg_len, seg)) return;
  if (kPass == kHead ? seg.k > 0 && seg.k == seg.count - 1 : seg.k == 0) return;
  const bool local = kPass == kHead && seg.k > 0;  // (a)
  const int t = threadIdx.x;
  const int px = (seg.tile % grid_w) * kTile + t % kTile;
  const int py = (seg.tile / grid_w) * kTile + t / kTile;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);

  float T = 1.0f;
  if (kPass == kTail && inside) {
    for (int j = 0; j < seg.k; ++j)
      T *= segment_state(state, segment_slot(seg, j, num_tiles), kLocal)[t];
  }
  const float t_in = T;
  bool stopped = inside && T < kTEps;  // counts as a stop before the first pair
  bool done = !inside || stopped;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (local) {
    walk<false>(seg.start, seg.end, pair_gaussian, mean2d, conic, opacity, color, depth, fx, fy,
                s, T, done, stopped, acc);
  } else {
    walk<true>(seg.start, seg.end, pair_gaussian, mean2d, conic, opacity, color, depth, fx, fy,
               s, T, done, stopped, acc);
  }

  if (local) {
    segment_state(state, blockIdx.x, kLocal)[t] = stopped ? 0.0f : T;
    return;
  }
  const int plane = height * width;
  const int pix = py * width + px;
  if (seg.count == 1) {
    if (inside) {
#pragma unroll
      for (int c = 0; c < 5; ++c) out[c * plane + pix] = acc[c];
      out[5 * plane + pix] = T;
    }
    return;
  }
  if (kPass == kHead) {
    segment_state(state, blockIdx.x, kLocal)[t] = stopped ? 0.0f : T;
    if (t == 0) tickets[seg.tile] = 0;
  }
  segment_state(state, blockIdx.x, kTIn)[t] = t_in;
  segment_state(state, blockIdx.x, kTOut)[t] = T;
  segment_state(state, blockIdx.x, kStopped)[t] = stopped ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < 5; ++c) segment_state(state, blockIdx.x, kAcc + c)[t] = acc[c];
  if (kPass == kTail) {
    __threadfence();  // this segment's state, seen by whichever CTA merges
    __syncthreads();
    if (t == 0) s_last = atomicAdd(tickets + seg.tile, 1) == seg.count - 2;
    __syncthreads();
    if (s_last) {
      __threadfence();
      if (inside) merge_segments(seg, num_tiles, t, pix, plane, out, state);
    }
  }
}

}  // namespace

// Launches on `stream` and returns the first launch's cudaGetLastError()
// (0 = launched). num_slots = num_tiles + ceil(num_pairs / seg_len); state
// holds num_slots x kStatePlanes x 256 floats and tickets num_tiles ints,
// both written and read only for split tiles. When no tile can be split
// (num_pairs <= seg_len) only the first launch runs.
extern "C" int moss_rasterize_fwd(const int* tile_offsets, const int* pair_gaussian,
                                  const float* mean2d, const float* conic,
                                  const float* opacity, const float* color,
                                  const float* depth, int height, int width,
                                  int grid_w, int num_tiles, int num_pairs, int seg_len,
                                  int num_slots, float* out, float* state, int* tickets,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define MOSS_PASS(p)                                                                        \
  rasterize_fwd_kernel<p><<<num_slots, kBlock, 0, s>>>(                                    \
      tile_offsets, pair_gaussian, mean2d, conic, opacity, color, depth, height, width,   \
      grid_w, num_tiles, seg_len, out, state, tickets);                                   \
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err)
  MOSS_PASS(kHead);
  if (num_pairs > seg_len) MOSS_PASS(kTail);  // some tile can be split
#undef MOSS_PASS
  return 0;
}
