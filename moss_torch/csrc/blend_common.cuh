// The per-(pair, pixel) blend step and the segment scheme shared by
// csrc/rasterize_fwd.cu and csrc/rasterize_bwd.cu.
//
// The backward recomputes the forward pixel by pixel, in the forward's order.
// A pixel that stops one pair earlier or later than the forward did gets
// gradients that are wrong by O(1), so both kernels take the skip and stop
// tests, and the arithmetic they rest on, from this one function. Contract
// (moss_torch/ops/rasterize_ref.py):
//
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = mean_x - px at integer
//           pixel coordinates                      (skip if power > 0)
//   alpha = min(0.99, op * expf(power))            (skip if alpha < 1/255)
//   stop when T (1 - alpha) < 1e-4; the splat that triggers the stop is skipped
//
// expf (not __expf), no --use_fast_math, and no FMA contraction in power and
// alpha: the skip tests are then the plain version's bit for bit where
// PyTorch's exp is CUDA's expf (on the card).
#pragma once

namespace moss {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // one thread per pixel
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

enum BlendStep { kSkip = 0, kBlend = 1, kStop = 2 };

// One pair at one pixel with transmittance T. Sets dx and dy always, alpha
// and test_T = T (1 - alpha) when it returns kBlend.
__device__ __forceinline__ int blend_step(float mx, float my, float a, float b,
                                          float c, float op, float fx, float fy,
                                          float T, float& dx, float& dy,
                                          float& alpha, float& test_T) {
  dx = __fsub_rn(mx, fx);
  dy = __fsub_rn(my, fy);
  // each product and sum rounded on its own, in the plain version's order:
  // a contracted FMA rounds once where PyTorch rounds twice, and a pair whose
  // alpha lies within an ulp of 1/255 is then blended by one and skipped by
  // the other (seen at 800x800 on a trained static cloud: one pixel, one
  // Gaussian's gradient off by 1%)
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx), __fmul_rn(__fmul_rn(c, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
  if (power > 0.0f) return kSkip;
  alpha = fminf(kAlphaMax, __fmul_rn(op, expf(power)));
  if (alpha < kAlphaMin) return kSkip;
  test_T = T * (1.0f - alpha);
  if (test_T < kTEps) return kStop;
  return kBlend;
}

// The segment scheme of the split kernels (moss_torch/ops/split_blend.py has
// the whole of it). A tile of more than seg_len (S) pairs is cut into
// ceil(count / S) consecutive segments of its depth-ordered pairs, one CTA
// each: CTA b < num_tiles walks segment 0 of tile b, CTA num_tiles + m the
// segment that starts at pair m S, if that pair starts a segment other than
// its tile's first. So a launch of num_tiles + ceil(num_pairs / S) CTAs, a
// number the host knows, covers every segment once; the others return.
// A tile of at most S pairs is one segment and runs as an unsplit kernel.
struct Segment {
  int tile;
  int k;              // its place among its tile's segments
  int count;          // its tile's segments
  int start, end;     // its pairs [start, end)
  int first_anchor;   // ceil(tile start / S): the slot of segment j >= 1 is
                      // num_tiles + first_anchor + j - 1
};

// Per (slot, plane, pixel) state of the segments of split tiles, written by
// the forward's passes and read by the backward (ops/split_blend.py (a)-(e)).
enum StatePlane {
  kLocal = 0,    // (a) L_k, the segment's own product of (1 - alpha)
  kTIn = 1,      // T_k on entry; after the merge, 0 where the segment is not live
  kTOut = 2,     // (c) T on exit
  kStopped = 3,  // (c) 1 if the pixel stopped in or before the segment, else 0
  kAcc = 4,      // (c) five sums w r, w g, w b, w depth, w; after the merge the
                 // sums over the segments before this one
  kStatePlanes = 9
};

__device__ __forceinline__ int segment_slot(const Segment& s, int j, int num_tiles) {
  return j == 0 ? s.tile : num_tiles + s.first_anchor + j - 1;
}

__device__ __forceinline__ float* segment_state(float* state, int slot, int plane) {
  return state + (static_cast<size_t>(slot) * kStatePlanes + plane) * kBlock;
}

// Tile t as segment k (k not checked against count).
__device__ __forceinline__ Segment tile_segment(const int* tile_offsets, int t, int k,
                                                int seg_len) {
  Segment s;
  const int start = tile_offsets[t];
  const int end = tile_offsets[t + 1];
  s.tile = t;
  s.k = k;
  s.count = end > start ? (end - start - 1) / seg_len + 1 : 1;
  s.first_anchor = static_cast<int>((static_cast<long long>(start) + seg_len - 1) / seg_len);
  const long long first = start + static_cast<long long>(k) * seg_len;
  s.start = static_cast<int>(first);
  s.end = static_cast<int>(first + seg_len < end ? first + seg_len : end);
  return s;
}

// The segment CTA b walks; false if it has none. The same for every thread.
__device__ __forceinline__ bool segment_of(int b, const int* tile_offsets, int num_tiles,
                                           int seg_len, Segment& s) {
  if (b < num_tiles) {
    s = tile_segment(tile_offsets, b, 0, seg_len);
    return true;
  }
  const long long a = static_cast<long long>(b - num_tiles) * seg_len;
  if (a >= tile_offsets[num_tiles]) return false;
  int lo = 0, hi = num_tiles;  // tile_offsets[lo] <= a < tile_offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_offsets[mid] <= a) lo = mid; else hi = mid;
  }
  s = tile_segment(tile_offsets, lo, 0, seg_len);
  const int k = static_cast<int>(a / seg_len) - s.first_anchor + 1;
  if (k >= s.count) return false;
  s = tile_segment(tile_offsets, lo, k, seg_len);
  return true;
}

}  // namespace moss
