// Reductions and scans of the blend kernels on CUDA cores and on tensor
// cores: the microbenchmark that asks which unit should run them.
//
// Replaces tools/mxu_micro.py's nine Pallas kernels (launched by `run`,
// :219-236), in seven kernels (twelve instantiations) behind four entry
// points:
//
//   moss_mxu_moments  moments_cuda_kernel, moments_tc_kernel<mode>:
//                     kern_moments_vpu (:58), kern_moments_mxu (:81)
//   moss_mxu_reshape  reshape_kernel: kern_reshape_only (:94)
//   moss_mxu_acc      acc_cuda_kernel, acc_tc_kernel<mode>: kern_acc_vpu
//                     (:102), kern_acc_mxu (:116)
//   moss_mxu_scan     scan_cuda_kernel<op>, scan_tc_kernel<op, mode>:
//                     kern_cumsum_vpu (:153), kern_cumsum_mxu (:175),
//                     kern_cumprod_vpu (:192), kern_cumprod_logmxu (:203)
//
// Every kernel works on one chunk x (K = 128 splats, 8 x 128 = 1024 pixels)
// f32, repeats its function `reps` times (rep i works on x + i, or on the
// alpha of rep i for the cumprod) and sums the repeats, over a grid of
// `tiles` identical copies of the chunk: a launch does tiles x reps
// chunk-ops, as the TPU grid did. A chunk is 512 KB, more than a block's
// 227 KB of shared memory, so each chunk-op is split over `parts` CTAs
// along the axis the function does not contract (splats for the moments,
// pixels for the others); the grid is (parts, tiles), and each entry point
// has a moss_mxu_*_parts query that gives its kernel's parts. All tiles
// compute the same values. Only the CTAs of tile 0 store the output, behind
// a runtime test of blockIdx.y, so that 256 copies of the output are not
// what is timed; every CTA writes a checksum of its part of the output into
// obs[tile][part], so the compiler cannot drop a tile's work, and the
// caller checks that the observers are bitwise equal across tiles.
//
// Units and rounding. The CUDA-core forms are f32 FMA. The tensor-core
// forms use mma.sync, written out in PTX:
//   bf16    one pass of m16n8k16 bf16 products with f32 sums; operands
//           rounded to nearest even (cvt.rn.bf16x2.f32), the TPU's DEFAULT
//   split2  hi = bf16(g), lo = bf16(g - hi): two bf16 passes
//   tf32x3  3xTF32 for the TPU's HIGHEST: big = tf32(a), small =
//           tf32(a - big), products small.big + big.small + big.big with
//           m16n8k8 tf32; tf32() is cvt.rna.tf32.f32, round to nearest with
//           ties away from zero
// The scans' CUDA-core forms are per-pixel sequential loops over K, the
// form the blend kernels use, not the TPU's two-level Hillis-Steele scan.
//
// What bounds them on the H100: operations. The chunk is read from L2 once
// per CTA and held in registers or shared memory across the repeats (the
// counterpart of VMEM). A chunk-op does 2 K 1024 8 = 2.1 MFLOP of moments or
// accumulator contraction, about 1.5 MFLOP on the CUDA cores (67 TFLOP/s
// f32) and one tensor-core pass (989 TFLOP/s bf16, 495 TF32); the triangular
// product of a tensor-core scan is 36 of the 64 16x16 blocks of L (128 x
// 128) against 1024 pixels, 18.9 MFLOP a pass, 72x the scan's adds: the
// bound of a scan is its own f32 work, which the tensor-core forms do with
// 72x the operations. The log-space cumprod adds a log1pf and an expf per
// element and rep.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;     // splats in a chunk
constexpr int kW = 128;     // pixels in a row of the chunk
constexpr int kPix = 1024;  // 8 x 128 pixels
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kCuda = 0, kBf16 = 1, kTf32x3 = 2, kSplit2 = 3 };
enum Op { kAdd = 0, kMul = 1 };

// ---- rounding and tensor-core helpers ------------------------------------

// Two f32 values rounded to nearest even into a bf16 pair; `lo` lands in the
// low half, the operand element of the lower index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_round(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(v));
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// tf32(v) as the bits of an f32 whose low 13 mantissa bits are 0
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// big and small of 3xTF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 sums. Fragments
// (g = lane / 4, t = lane % 4): a[0] row g, cols 2t, 2t+1; a[1] row g+8;
// a[2] row g, cols 2t+8, 2t+9; a[3] row g+8, those cols. b[0] rows 2t,
// 2t+1, col g; b[1] rows 2t+8, 2t+9. c[0], c[1] row g, cols 2t, 2t+1;
// c[2], c[3] row g+8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 sums. Fragments:
// a[0] row g, col t; a[1] row g+8, col t; a[2] row g, col t+4; a[3] row g+8,
// col t+4. b0 row t, col g; b1 row t+4. c as in mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory loads that are repeated in every rep: the compiler would
// otherwise hoist the invariant values out of the reps loop into registers
// and spill them.
__device__ __forceinline__ float lds(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

__device__ __forceinline__ float4 lds4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// ---- the reps of a tensor-core contraction --------------------------------

// A elements of a lane per k-step: 8 bf16 (m16n8k16), 4 tf32 (m16n8k8)
template <int kMode>
constexpr int kAPer = kMode == kBf16 ? 8 : 4;

// c += sum over reps i of A_i @ B, for a warp's fragments preloaded in
// fragment order: xa[s] the A elements of k-step s (A_i = xa + i, rounded as
// kMode rounds it: bf16 pairs packed as a[e] = (xa[2e], xa[2e+1]), or 3xTF32
// big and small), bb[s] the B fragment (tf32x3: its big part, bs its small
// part). A rep's product gets its own fragments and is added to c in IEEE
// f32 adds: the tensor cores' own accumulation is not rounded to nearest,
// and all reps in one accumulator drift from the plain version by 1e-5 of
// the max.
template <int kMode, int kSteps>
__device__ __forceinline__ void tc_reps(const float (&xa)[kSteps][kAPer<kMode>],
                                        const uint32_t (&bb)[kSteps][2],
                                        const uint32_t (&bs)[kSteps][2], int reps, float (&c)[4]) {
  for (int i = 0; i < reps; ++i) {
    const float fi = static_cast<float>(i);
    float cb[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kMode == kBf16) {
        uint32_t a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = pack_bf16(xa[s][2 * e] + fi, xa[s][2 * e + 1] + fi);
        mma_bf16(cb, a, bb[s][0], bb[s][1]);
      } else {
        uint32_t big[4], small[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(xa[s][e] + fi, big[e], small[e]);
        mma_tf32(cs, small, bb[s][0], bb[s][1]);
        mma_tf32(cs, big, bs[s][0], bs[s][1]);
        mma_tf32(cb, big, bb[s][0], bb[s][1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += kMode == kBf16 ? cb[e] : cb[e] + cs[e];
  }
}

// ---- the observer ---------------------------------------------------------

// Sum of v over the block in a fixed order (a warp butterfly, then the
// warps' sums in order by thread 0), written to obs[tile][part] by thread 0.
template <int kThreads>
__device__ __forceinline__ void observe(float v, float* obs) {
  __shared__ float warp_sum[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
    obs[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// basis[p][n] of tools/mxu_micro.py::_basis (:48-55): [1, px, py, px^2,
// px py, py^2, 0, 0], px = p % 128, py = p / 128; exact in f32
__device__ __forceinline__ float basis(int p, int n) {
  const float px = static_cast<float>(p % kW), py = static_cast<float>(p / kW);
  switch (n) {
    case 0: return 1.f;
    case 1: return px;
    case 2: return py;
    case 3: return px * px;
    case 4: return px * py;
    case 5: return py * py;
    default: return 0.f;
  }
}

// ---- moments: out (K, 8) = sum_i (x + i).reshape(K, 1024) @ basis ----------

constexpr int kMomThreads = 256;
constexpr int kMomCudaParts = kK / (kMomThreads / 32);  // a warp per splat: 16
constexpr int kMomTcParts = kK / 16;                    // 16 splats a CTA: 8

// CUDA cores: one warp per splat row, lane l holds pixels l + 32 j; six
// moments per rep by FMA, a warp butterfly, then the sum over reps. Output
// columns [S0, Sx, Sy, Sxx, Sxy, Syy, S0, Sx] as kern_moments_vpu (:77).
__global__ void __launch_bounds__(kMomThreads)
moments_cuda_kernel(const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ obs, int reps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * (kMomThreads / 32) + warp;
  float xv[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) xv[j] = x[k * kPix + lane + 32 * j];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < reps; ++i) {
    const float fi = static_cast<float>(i);
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float px = static_cast<float>(lane + 32 * (j & 3));
      const float py = static_cast<float>(j >> 2);
      const float v = xv[j] + fi;
      const float vx = v * px, vy = v * py;
      s[0] += v;
      s[1] += vx;
      s[2] += vy;
      s[3] = fmaf(vx, px, s[3]);
      s[4] = fmaf(vx, py, s[4]);
      s[5] = fmaf(vy, py, s[5]);
    }
#pragma unroll
    for (int m = 0; m < 6; ++m) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[m] += __shfl_xor_sync(kFull, s[m], o);
      acc[m] += s[m];
    }
  }
  const float row[8] = {acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], acc[0], acc[1]};
  float sum = 0.f;
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sum += row[n];
      if (blockIdx.y == 0) out[k * 8 + n] = row[n];
    }
  }
  observe<kMomThreads>(sum, obs);
}

// Tensor cores: a CTA takes 16 splats (one m-tile) and its 8 warps split the
// 1024-pixel depth in slices of 128; each warp keeps its A fragments of x in
// registers and the basis fragments (made from the index), accumulates all
// reps into one C fragment, and the warps' C are summed in a fixed order.
template <int kMode>
__global__ void __launch_bounds__(kMomThreads)
moments_tc_kernel(const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ obs, int reps) {
  constexpr int kStep = kMode == kBf16 ? 16 : 8;  // depth of one mma
  constexpr int kSteps = 128 / kStep;             // over a warp's 128 pixels
  __shared__ float red[kMomThreads / 32][16][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* r0 = x + (blockIdx.x * 16 + g) * kPix;  // splat rows g and g + 8
  const float* r8 = r0 + 8 * kPix;
  float xa[kSteps][kAPer<kMode>];
  uint32_t bb[kSteps][2], bs[kSteps][2] = {};  // basis fragments (tf32x3: big, small)
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int p = warp * 128 + s * kStep;
    if constexpr (kMode == kBf16) {
      const int c0 = p + 2 * t, c8 = c0 + 8;
      const float v[8] = {r0[c0], r0[c0 + 1], r8[c0], r8[c0 + 1],
                          r0[c8], r0[c8 + 1], r8[c8], r8[c8 + 1]};
#pragma unroll
      for (int e = 0; e < 8; ++e) xa[s][e] = v[e];
      bb[s][0] = pack_bf16(basis(c0, g), basis(c0 + 1, g));
      bb[s][1] = pack_bf16(basis(c8, g), basis(c8 + 1, g));
    } else {
      const int c0 = p + t, c4 = c0 + 4;
      xa[s][0] = r0[c0];
      xa[s][1] = r8[c0];
      xa[s][2] = r0[c4];
      xa[s][3] = r8[c4];
      split_tf32(basis(c0, g), bb[s][0], bs[s][0]);
      split_tf32(basis(c4, g), bb[s][1], bs[s][1]);
    }
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  tc_reps<kMode>(xa, bb, bs, reps, c);
  red[warp][g][2 * t] = c[0];
  red[warp][g][2 * t + 1] = c[1];
  red[warp][g + 8][2 * t] = c[2];
  red[warp][g + 8][2 * t + 1] = c[3];
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < 128) {
    const int r = threadIdx.x >> 3, n = threadIdx.x & 7;
#pragma unroll
    for (int w = 0; w < kMomThreads / 32; ++w) v += red[w][r][n];
    if (blockIdx.y == 0) out[(blockIdx.x * 16 + r) * 8 + n] = v;
  }
  observe<kMomThreads>(v, obs);
}

// ---- reshape only: out (K, 128) = sum over the 8 rows of sum_i (x + i) ----

constexpr int kReshapeThreads = 256;
constexpr int kReshapeParts = kK * kW / kReshapeThreads;  // 64

// A thread per output element (k, w) holds its 8 rows: the floor of reading
// the chunk and adding, with no contraction.
__global__ void __launch_bounds__(kReshapeThreads)
reshape_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ obs,
               int reps) {
  const int e = blockIdx.x * kReshapeThreads + threadIdx.x;  // k * 128 + w
  const float* src = x + (e / kW) * kPix + e % kW;
  float xv[8], acc[8];
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    xv[h] = src[h * kW];
    acc[h] = 0.f;
  }
  for (int i = 0; i < reps; ++i) {
    const float fi = static_cast<float>(i);
#pragma unroll
    for (int h = 0; h < 8; ++h) acc[h] = acc[h] + (xv[h] + fi);
  }
  float v = acc[0];
#pragma unroll
  for (int h = 1; h < 8; ++h) v += acc[h];
  if (blockIdx.y == 0) out[e] = v;
  observe<kReshapeThreads>(v, obs);
}

// ---- accumulators: out (8, 1024) = sum_i s (8, K) @ (x + i) (K, 1024) ----

constexpr int kAccCudaThreads = 128;
constexpr int kAccTcThreads = 256;
constexpr int kAccParts = kPix / 128;  // 128 pixels a CTA: 8

// CUDA cores: a thread per pixel holds its column of x in registers; s rows
// 0-4 sit in shared memory, two vector loads per splat and rep (broadcast to
// the warp); five FMAs per splat and rep. Rows 5-7 repeat rows 0-2, as
// kern_acc_vpu does (:112).
__global__ void __launch_bounds__(kAccCudaThreads)
acc_cuda_kernel(const float* __restrict__ x, const float* __restrict__ sw,
                float* __restrict__ out, float* __restrict__ obs, int reps) {
  __shared__ float4 s_sh[kK][2];  // s[0..3][k], then s[4][k]
  for (int k = threadIdx.x; k < kK; k += kAccCudaThreads) {
    s_sh[k][0] = make_float4(sw[k], sw[kK + k], sw[2 * kK + k], sw[3 * kK + k]);
    s_sh[k][1] = make_float4(sw[4 * kK + k], 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int p = blockIdx.x * kAccCudaThreads + threadIdx.x;
  float xv[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) xv[k] = x[k * kPix + p];
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < reps; ++i) {
    const float fi = static_cast<float>(i);
    float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float v = xv[k] + fi;
      const float4 s03 = lds4(&s_sh[k][0]), s4 = lds4(&s_sh[k][1]);
      a[0] = fmaf(s03.x, v, a[0]);
      a[1] = fmaf(s03.y, v, a[1]);
      a[2] = fmaf(s03.z, v, a[2]);
      a[3] = fmaf(s03.w, v, a[3]);
      a[4] = fmaf(s4.x, v, a[4]);
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) acc[j] += a[j];
  }
  const float col[8] = {acc[0], acc[1], acc[2], acc[3], acc[4], acc[0], acc[1], acc[2]};
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    sum += col[n];
    if (blockIdx.y == 0) out[n * kPix + p] = col[n];
  }
  observe<kAccCudaThreads>(sum, obs);
}

// Tensor cores: out^T (1024 x 8) = w^T (1024 x K) @ s^T (K x 8), M = pixels.
// A warp takes 16 pixels and the whole depth of 128 splats; its A fragments
// are pixel-major while x is stored splat-major, so each lane gathers its
// elements by index into registers once, before the reps (no ldmatrix: its
// .trans form exists for 16-bit elements only).
template <int kMode>
__global__ void __launch_bounds__(kAccTcThreads)
acc_tc_kernel(const float* __restrict__ x, const float* __restrict__ sw,
              float* __restrict__ out, float* __restrict__ obs, int reps) {
  constexpr int kStep = kMode == kBf16 ? 16 : 8;
  constexpr int kSteps = kK / kStep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * 128 + warp * 16 + g;  // pixel rows g and g + 8
  const float* srow = sw + g * kK;                  // s row n = g
  float xa[kSteps][kAPer<kMode>];
  uint32_t bb[kSteps][2], bs[kSteps][2] = {};
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int k0 = s * kStep;
    if constexpr (kMode == kBf16) {
      const int c0 = k0 + 2 * t, c8 = c0 + 8;  // splat columns
      xa[s][0] = x[c0 * kPix + p0];
      xa[s][1] = x[(c0 + 1) * kPix + p0];
      xa[s][2] = x[c0 * kPix + p0 + 8];
      xa[s][3] = x[(c0 + 1) * kPix + p0 + 8];
      xa[s][4] = x[c8 * kPix + p0];
      xa[s][5] = x[(c8 + 1) * kPix + p0];
      xa[s][6] = x[c8 * kPix + p0 + 8];
      xa[s][7] = x[(c8 + 1) * kPix + p0 + 8];
      bb[s][0] = pack_bf16(srow[c0], srow[c0 + 1]);
      bb[s][1] = pack_bf16(srow[c8], srow[c8 + 1]);
    } else {
      const int c0 = k0 + t, c4 = c0 + 4;
      xa[s][0] = x[c0 * kPix + p0];
      xa[s][1] = x[c0 * kPix + p0 + 8];
      xa[s][2] = x[c4 * kPix + p0];
      xa[s][3] = x[c4 * kPix + p0 + 8];
      split_tf32(srow[c0], bb[s][0], bs[s][0]);
      split_tf32(srow[c4], bb[s][1], bs[s][1]);
    }
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  tc_reps<kMode>(xa, bb, bs, reps, c);
  // c[0], c[1]: pixel p0, rows n = 2t, 2t+1; c[2], c[3]: pixel p0 + 8
  if (blockIdx.y == 0) {
    out[2 * t * kPix + p0] = c[0];
    out[(2 * t + 1) * kPix + p0] = c[1];
    out[2 * t * kPix + p0 + 8] = c[2];
    out[(2 * t + 1) * kPix + p0 + 8] = c[3];
  }
  observe<kAccTcThreads>(((c[0] + c[1]) + c[2]) + c[3], obs);
}

// ---- scans over the splat axis: out (K, 1024) = sum_i scan_k(g_i) ---------
// kAdd: g_i = x + i, an inclusive cumsum. kMul: a_i = clip(x * c_i, 0, 0.9)
// with c_i = f32(0.01 (i + 1)), g_i = (a_i > 0.003 ? 1 - a_i : 1), an
// inclusive cumprod; its tensor-core form is exp(L @ log g_i), log g_i =
// (a_i > 0.003 ? log1p(-a_i) : 0), in split2.

constexpr int kScanCudaThreads = 64;
constexpr int kScanTcThreads = 256;
constexpr int kScanParts = kPix / 64;  // 64 pixels a CTA: 16

__device__ __forceinline__ float alpha_of(float xv, float ci) {
  return fminf(fmaxf(xv * ci, 0.f), 0.9f);
}

__device__ __forceinline__ float rep_scale(int i) {
  return static_cast<float>(0.01 * static_cast<double>(i + 1));
}

// CUDA cores: a thread per pixel walks K = 128 in order; the CTA's 64
// columns of x sit in shared memory, read again in every rep, and the
// thread's 128 sums in registers.
template <int kOp>
__global__ void __launch_bounds__(kScanCudaThreads)
scan_cuda_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ obs,
                 int reps) {
  __shared__ float xs[kK][kScanCudaThreads];
  const int p0 = blockIdx.x * kScanCudaThreads;
  for (int k = 0; k < kK; ++k) xs[k][threadIdx.x] = x[k * kPix + p0 + threadIdx.x];
  __syncthreads();
  float acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = 0.f;
  for (int i = 0; i < reps; ++i) {
    if constexpr (kOp == kAdd) {
      const float fi = static_cast<float>(i);
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        run = run + (lds(&xs[k][threadIdx.x]) + fi);
        acc[k] += run;
      }
    } else {
      const float ci = rep_scale(i);
      float run = 1.f;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const float a = alpha_of(lds(&xs[k][threadIdx.x]), ci);
        run = run * (a > 0.003f ? 1.f - a : 1.f);
        acc[k] += run;
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    sum += acc[k];
    if (blockIdx.y == 0) out[k * kPix + p0 + threadIdx.x] = acc[k];
  }
  observe<kScanCudaThreads>(sum, obs);
}

// The bf16 fragment of the lower-triangular ones L at (row r, col c) of a
// diagonal 16 x 16 block: 1 where c <= r
__device__ __forceinline__ uint32_t tri_pair(int r, int c) {
  return pack_bf16(c <= r ? 1.f : 0.f, c + 1 <= r ? 1.f : 0.f);
}

// Tensor cores: out (128 x 64 pixels of a CTA) = L (128 x 128) @ g. A warp
// takes 8 pixels (one n-tile) and all 8 m-tiles; L is exact in bf16 and made
// in registers; blocks above the diagonal are zero and skipped (36 of 64
// remain). kMode kBf16: one pass of bf16(g); kSplit2: hi and lo passes.
template <int kOp, int kMode>
__global__ void __launch_bounds__(kScanTcThreads)
scan_tc_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ obs,
               int reps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pb = blockIdx.x * 64 + warp * 8;  // the warp's first pixel
  // B fragments (rows = splats, col g = pixel pb + g): b0 rows 2t, 2t+1;
  // b1 rows 2t+8, 2t+9 of each 16-splat step
  float xv[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int k0 = 16 * s + 2 * t;
    xv[s][0] = x[k0 * kPix + pb + g];
    xv[s][1] = x[(k0 + 1) * kPix + pb + g];
    xv[s][2] = x[(k0 + 8) * kPix + pb + g];
    xv[s][3] = x[(k0 + 9) * kPix + pb + g];
  }
  const uint32_t ones = pack_bf16(1.f, 1.f);
  const uint32_t diag[4] = {tri_pair(g, 2 * t), tri_pair(g + 8, 2 * t),
                            tri_pair(g, 2 * t + 8), tri_pair(g + 8, 2 * t + 8)};
  const uint32_t full[4] = {ones, ones, ones, ones};
  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  for (int i = 0; i < reps; ++i) {
    uint32_t hi[8][2], lo[8][2];
    const float fi = static_cast<float>(i);
    const float ci = rep_scale(i);
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kOp == kAdd) {
          v[e] = xv[s][e] + fi;
        } else {
          const float a = alpha_of(xv[s][e], ci);
          v[e] = a > 0.003f ? log1pf(-a) : 0.f;
        }
      }
      if constexpr (kMode == kSplit2) {
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = bf16_round(v[e]);
        hi[s][0] = pack_bf16(h[0], h[1]);
        hi[s][1] = pack_bf16(h[2], h[3]);
        lo[s][0] = pack_bf16(v[0] - h[0], v[1] - h[1]);
        lo[s][1] = pack_bf16(v[2] - h[2], v[3] - h[3]);
      } else {
        hi[s][0] = pack_bf16(v[0], v[1]);
        hi[s][1] = pack_bf16(v[2], v[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s <= m; ++s) {
        mma_bf16(c, s == m ? diag : full, hi[s][0], hi[s][1]);
        if constexpr (kMode == kSplit2) mma_bf16(c, s == m ? diag : full, lo[s][0], lo[s][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] += kOp == kMul ? expf(c[e]) : c[e];
    }
  }
  // c[0], c[1]: splat 16 m + g, pixels pb + 2t, +1; c[2], c[3]: splat + 8
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = 16 * m + g;
    if (blockIdx.y == 0) {
      out[r * kPix + pb + 2 * t] = acc[m][0];
      out[r * kPix + pb + 2 * t + 1] = acc[m][1];
      out[(r + 8) * kPix + pb + 2 * t] = acc[m][2];
      out[(r + 8) * kPix + pb + 2 * t + 1] = acc[m][3];
    }
    sum += ((acc[m][0] + acc[m][1]) + acc[m][2]) + acc[m][3];
  }
  observe<kScanTcThreads>(sum, obs);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int parts, int threads, int tiles, cudaStream_t stream, Args... args) {
  kernel<<<dim3(parts, tiles), threads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int moments_parts(int mode) {
  return mode == kCuda ? kMomCudaParts : mode == kBf16 || mode == kTf32x3 ? kMomTcParts : -1;
}

int acc_parts(int mode) {
  return mode == kCuda || mode == kBf16 || mode == kTf32x3 ? kAccParts : -1;
}

int scan_parts(int op, int mode) {
  const bool known = (op == kAdd && (mode == kCuda || mode == kBf16 || mode == kSplit2)) ||
                     (op == kMul && (mode == kCuda || mode == kSplit2));
  return known ? kScanParts : -1;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for an unknown op or mode. x is (128,
// 8, 128) f32; s (8, 128) f32; out is (128, 8), (128, 128), (8, 1024) or
// (128, 1024) f32; obs is (tiles, parts) f32, parts from the entry point's
// moss_mxu_*_parts query with the same op and mode (-1 for an unknown one).
// mode: 0 CUDA cores, 1 bf16, 2 tf32x3, 3 split2; op: 0 cumsum, 1 masked
// cumprod (its split2 form is log-space).
extern "C" int moss_mxu_moments_parts(int mode) { return moments_parts(mode); }

extern "C" int moss_mxu_moments(const float* x, float* out, float* obs, int reps, int tiles,
                                int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int parts = moments_parts(mode);
  if (mode == kCuda)
    return launch(moments_cuda_kernel, parts, kMomThreads, tiles, s, x, out, obs, reps);
  if (mode == kBf16)
    return launch(moments_tc_kernel<kBf16>, parts, kMomThreads, tiles, s, x, out, obs, reps);
  if (mode == kTf32x3)
    return launch(moments_tc_kernel<kTf32x3>, parts, kMomThreads, tiles, s, x, out, obs, reps);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int moss_mxu_reshape_parts() { return kReshapeParts; }

extern "C" int moss_mxu_reshape(const float* x, float* out, float* obs, int reps, int tiles,
                                void* stream) {
  return launch(reshape_kernel, kReshapeParts, kReshapeThreads, tiles,
                static_cast<cudaStream_t>(stream), x, out, obs, reps);
}

extern "C" int moss_mxu_acc_parts(int mode) { return acc_parts(mode); }

extern "C" int moss_mxu_acc(const float* x, const float* sw, float* out, float* obs, int reps,
                            int tiles, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCuda:
      return launch(acc_cuda_kernel, kAccParts, kAccCudaThreads, tiles, s, x, sw, out, obs, reps);
    case kBf16:
      return launch(acc_tc_kernel<kBf16>, kAccParts, kAccTcThreads, tiles, s, x, sw, out, obs,
                    reps);
    case kTf32x3:
      return launch(acc_tc_kernel<kTf32x3>, kAccParts, kAccTcThreads, tiles, s, x, sw, out, obs,
                    reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int moss_mxu_scan_parts(int op, int mode) { return scan_parts(op, mode); }

extern "C" int moss_mxu_scan(const float* x, float* out, float* obs, int reps, int tiles, int op,
                             int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int parts = kScanParts;
  if (op == kAdd && mode == kCuda)
    return launch(scan_cuda_kernel<kAdd>, parts, kScanCudaThreads, tiles, s, x, out, obs, reps);
  if (op == kMul && mode == kCuda)
    return launch(scan_cuda_kernel<kMul>, parts, kScanCudaThreads, tiles, s, x, out, obs, reps);
  if (op == kAdd && mode == kBf16)
    return launch(scan_tc_kernel<kAdd, kBf16>, parts, kScanTcThreads, tiles, s, x, out, obs,
                  reps);
  if (op == kAdd && mode == kSplit2)
    return launch(scan_tc_kernel<kAdd, kSplit2>, parts, kScanTcThreads, tiles, s, x, out, obs,
                  reps);
  if (op == kMul && mode == kSplit2)
    return launch(scan_tc_kernel<kMul, kSplit2>, parts, kScanTcThreads, tiles, s, x, out, obs,
                  reps);
  return static_cast<int>(cudaErrorInvalidValue);
}
