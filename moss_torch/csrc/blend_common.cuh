// The per-(pair, pixel) blend step shared by csrc/rasterize_fwd.cu and
// csrc/rasterize_bwd.cu.
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
// expf (not __expf), and no --use_fast_math.
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
  dx = mx - fx;
  dy = my - fy;
  const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
  if (power > 0.0f) return kSkip;
  alpha = fminf(kAlphaMax, op * expf(power));
  if (alpha < kAlphaMin) return kSkip;
  test_T = T * (1.0f - alpha);
  if (test_T < kTEps) return kStop;
  return kBlend;
}

}  // namespace moss
