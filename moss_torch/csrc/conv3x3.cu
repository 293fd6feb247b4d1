// 3x3 SAME convolution + bias (+ relu) over one NHWC image, accumulated in
// f32: the LPIPS VGG layer as a direct convolution.
//
// Replaces tools/conv_pallas_proto.py::_conv_kernel (:28), launched by
// conv3x3_fused (:49-82). Contract (conv3x3_fused and ref_conv, :85-89):
// x (H, W, Cin), w (3, 3, Cin, Cout) HWIO and b (Cout,) all in x's type
// (the caller casts w and b to it, as :66 and :82 do), zero padding of one
// pixel on each side, products of the inputs summed in f32, then
// y = sum + float(b), relu if asked, rounded once to the output type.
// Two input types, f32 and bf16; in f32 every product and sum is an f32
// FMA (no TF32).
//
// What bounds it on the H100: operations. A VGG16 layer does 2 H W Cin
// Cout 9 FLOPs against a few MB of activations and weights: in bf16 the
// tensor cores' 989 TFLOP/s would make it a few tens of microseconds. This
// kernel is the simple correct one and runs on the f32 CUDA cores (67
// TFLOP/s); tensor cores (mma.sync or wgmma) are later work.
// What the design does: a block owns an 8 x 16 pixel tile and 64 output
// channels. For each chunk of 8 input channels it stages the tile with its
// one-pixel halo (10 x 18 x 8, zero where the halo leaves the image or the
// channel count) and the chunk's 3 x 3 x 8 x 64 weights in shared memory,
// as f32. Each thread keeps 4 neighbouring pixels of a row x 8 output
// channels in 32 f32 registers: per input channel and kernel row it reads
// 6 inputs and 24 weights for 96 FMAs. The TPU's row-band blocking (bh)
// has no counterpart: rows and columns at the image edge are masked.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8, kTileW = 16;  // output pixels of a block
constexpr int kCo = 64;                 // output channels of a block
constexpr int kCi = 8;                  // input channels staged per round
constexpr int kPix = 4;                 // pixels of a thread (one row)
constexpr int kCoT = 8;                 // output channels of a thread
constexpr int kThreads = (kTileH * kTileW / kPix) * (kCo / kCoT);  // 256
constexpr int kInH = kTileH + 2, kInW = kTileW + 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype / .to do
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const Tin* __restrict__ x,    // (H, W, cin)
               const Tin* __restrict__ w,    // (3, 3, cin, cout)
               const Tin* __restrict__ b,    // (cout,)
               Tout* __restrict__ out,       // (H, W, cout)
               int H, int W, int cin, int cout, int relu)
{
  __shared__ float s_in[kCi][kInH][kInW];
  __shared__ __align__(16) float s_w[9][kCi][kCo];

  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int y0 = (blockIdx.x / tiles_w) * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * kCo;
  const int t = threadIdx.x;
  const int strip = t & 31;             // a warp's 32 strips cover the tile
  const int cg = t >> 5;                // the warp's 8 output channels
  const int sy = strip / (kTileW / kPix);
  const int sx = (strip % (kTileW / kPix)) * kPix;

  float acc[kPix][kCoT];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int o = 0; o < kCoT; ++o) acc[p][o] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCi) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = t; i < kCi * kInH * kInW; i += kThreads) {
      const int c = i % kCi, p = i / kCi;
      const int iy = p / kInW, ix = p % kInW;
      const int yy = y0 - 1 + iy, xx = x0 - 1 + ix;
      float v = 0.0f;
      if (ci0 + c < cin && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = to_float(x[(static_cast<size_t>(yy) * W + xx) * cin + ci0 + c]);
      s_in[c][iy][ix] = v;
    }
    for (int i = t; i < 9 * kCi * kCo; i += kThreads) {
      const int co = i % kCo, c = (i / kCo) % kCi, k = i / (kCo * kCi);
      float v = 0.0f;
      if (ci0 + c < cin && co0 + co < cout)
        v = to_float(w[(static_cast<size_t>(k) * cin + ci0 + c) * cout + co0 + co]);
      s_w[k][c][co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kCi; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float in[kPix + 2];
#pragma unroll
        for (int j = 0; j < kPix + 2; ++j) in[j] = s_in[c][sy + ky][sx + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(&s_w[ky * 3 + kx][c][cg * kCoT]);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[kCoT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int o = 0; o < kCoT; ++o) acc[p][o] = fmaf(in[p + kx], wv[o], acc[p][o]);
        }
      }
    }
  }

  const int yy = y0 + sy;
  if (yy >= H) return;
#pragma unroll
  for (int o = 0; o < kCoT; ++o) {
    const int co = co0 + cg * kCoT + o;
    if (co >= cout) continue;
    const float bias = to_float(b[co]);
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int xx = x0 + sx + p;
      if (xx >= W) continue;
      float y = acc[p][o] + bias;
      if (relu) y = fmaxf(y, 0.0f);
      out[(static_cast<size_t>(yy) * W + xx) * cout + co] = from_float<Tout>(y);
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* w, const void* b, void* out, int H, int W, int cin,
           int cout, int relu, cudaStream_t stream) {
  const dim3 grid(((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW),
                  (cout + kCo - 1) / kCo);
  conv3x3_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), static_cast<const Tin*>(b),
      static_cast<Tout*>(out), H, W, cin, cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// x, w, b are f32 (in_bf16 = 0) or bf16 (1); out f32 (out_bf16 = 0) or bf16.
extern "C" int moss_conv3x3(const void* x, const void* w, const void* b, void* out, int H,
                            int W, int cin, int cout, int relu, int in_bf16, int out_bf16,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || cin <= 0 || cout <= 0) return 0;
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, H, W, cin, cout, relu, s)
                    : launch<__nv_bfloat16, float>(x, w, b, out, H, W, cin, cout, relu, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(x, w, b, out, H, W, cin, cout, relu, s)
                  : launch<float, float>(x, w, b, out, H, W, cin, cout, relu, s);
}
