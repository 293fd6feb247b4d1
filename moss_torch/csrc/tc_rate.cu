// The tensor cores' rate at N = 8 in TF32 and bf16, by instruction form, and
// a check of what a TF32 operand register carries: the measurements that
// chose reduce_scan.cu's 3xTF32 and bf16 moments designs
// (moss_torch/tools/tc_rate.py).
//
//   kMma     mma.sync m16n8k8 tf32, eight independent accumulators a warp
//   kWgmma8  wgmma m64n8k8 tf32, A from registers, B from shared memory
//   kWgmma16 wgmma m64n16k8 tf32, the same
//   kMmaBf16 mma.sync m16n8k16 bf16, eight independent accumulators a warp
//
// Each warp (or warpgroup) runs `iters` rounds of eight products on
// constant operands (a round of wgmmas is one commit group, one group kept in
// flight), so a launch of `blocks` CTAs of `threads` times the tensor cores
// alone. The check multiplies operands given as tf32(v) by cvt.rna and as the
// unmasked bits(v) + 0x1000 that reduce_scan.cu's split_operand hands over:
// the tensor cores read only an operand's 19 high bits when the two products
// are bitwise equal.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Form { kMma = 0, kWgmma8 = 1, kWgmma16 = 2, kNone = 3, kMmaBf16 = 4 };
// the operand work beside the products: none, the 3xTF32 split, or the bf16
// moments' x + i and packs
enum Work { kNoWork = 0, kSplitWork = 1, kBf16Work = 2 };

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d (64 x N) += a (64 x 8, registers: warp w rows 16 w + the mma.sync
// fragment) . B (8 x N, shared, K-major without swizzle)
__device__ __forceinline__ void wgmma8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                 "+f"(d[6]), "+f"(d[7])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// a K-major B without swizzle: 8 rows of 16 B a core matrix, the next K core
// matrix 128 B on (LBO), the next 8 rows of N 256 B on (SBO)
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// A round: eight products of kForm (none for kNone) and the operand work
// kWork, on registers the products do not read, so the two can overlap:
// kSplitWork the 3xTF32 split of eight values (reduce_scan.cu's
// split_operand, 5 instructions each, and an add into a sum: the operand
// work that goes with eight products in the 3xTF32 kernels, 6 an element
// against their 7); kBf16Work the bf16 moments' work for eight m16n8k16
// products, 64 values x + i rounded into 32 bf16 pairs (64 adds, 32
// cvt.rn.bf16x2, as moments_bf16_kernel's A fragments take them), the pairs
// folded by xor into a sum (16 three-input LOP3s on the integer pipe).
template <int kForm, int kWork>
__global__ void __launch_bounds__(256) rate_kernel(float* out, int iters) {
  constexpr int kN = kForm == kWgmma16 ? 16 : 8;
  __shared__ __align__(128) float bs[16 * 8];
  for (int e = threadIdx.x; e < 16 * 8; e += blockDim.x) bs[e] = 1.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t one = __float_as_uint(1.f);
  const uint32_t a[4] = {kForm == kMmaBf16 ? pack_bf16(1.f + lane, 1.f) : __float_as_uint(1.f + lane),
                         one, one, one};
  float d[8][kN / 2];  // mma.sync: eight accumulators; wgmma: eight, one group
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) d[j][i] = 0.f;
  float xs[8], sums[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) xs[j] = 0.001f * (lane + 32 * j), sums[j] = 0.f;
  float xb[32];  // the bf16 work's values: 64 sums a round from these and two offsets
#pragma unroll
  for (int j = 0; j < 32; ++j) xb[j] = kWork == kBf16Work ? 0.001f * (lane + 32 * j) : 0.f;
  uint32_t folded = 0u;
  const uint64_t desc = b_desc(bs);
  for (int it = 0; it < iters; ++it) {
    if constexpr (kForm == kMma) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(d[j], a, one, one);
    } else if constexpr (kForm == kMmaBf16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_bf16(d[j], a, a[0], a[0]);
    } else if constexpr (kForm != kNone) {
#pragma unroll
      for (int j = 0; j < 8; ++j) fence_regs(d[j]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (kForm == kWgmma8) wgmma8(d[j], a, desc); else wgmma16(d[j], a, desc);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if constexpr (kWork == kBf16Work) {
      const float f[2] = {static_cast<float>(it), static_cast<float>(it) + 0.5f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // product j's A: values xb[8 (j / 2) + e] + f[j % 2]
        const float* v = xb + 8 * (j >> 1);
        const float fj = f[j & 1];
        const uint32_t p0 = pack_bf16(v[0] + fj, v[1] + fj), p1 = pack_bf16(v[2] + fj, v[3] + fj);
        const uint32_t p2 = pack_bf16(v[4] + fj, v[5] + fj), p3 = pack_bf16(v[6] + fj, v[7] + fj);
        folded ^= p0 ^ p1;
        folded ^= p2 ^ p3;
      }
    }
    if constexpr (kWork == kSplitWork) {
      const float fi = static_cast<float>(it);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = xs[j] + fi;
        const uint32_t big = __float_as_uint(v) + 0x1000u;
        const float r = v - __uint_as_float(big & 0xffffe000u);
        sums[j] += __uint_as_float(__float_as_uint(r) + 0x1000u);
      }
    }
    if constexpr (kForm == kWgmma8 || kForm == kWgmma16) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 8; ++j) fence_regs(d[j]);
    }
  }
  if constexpr (kForm == kWgmma8 || kForm == kWgmma16)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = __uint_as_float(folded & 0x3fffffffu);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s += sums[j];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s += d[j][i];
  }
  if (blockIdx.x == 0) out[threadIdx.x] = s;
}

__device__ __forceinline__ uint32_t cvt_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// One warp: d_rna = A.B with operands by cvt.rna, d_bits the same with the
// unmasked bits(v) + 0x1000. a: (16, 8) row-major, b: (8, 8) as [n][k]; d:
// (2, 16, 8).
__global__ void low_bits_kernel(const float* a, const float* b, float* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float av[4] = {a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + t + 4], a[(g + 8) * 8 + t + 4]};
  const float bv[2] = {b[g * 8 + t], b[g * 8 + t + 4]};
  for (int form = 0; form < 2; ++form) {
    uint32_t ar[4], br[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) ar[e] = form ? __float_as_uint(av[e]) + 0x1000u : cvt_rna(av[e]);
#pragma unroll
    for (int e = 0; e < 2; ++e) br[e] = form ? __float_as_uint(bv[e]) + 0x1000u : cvt_rna(bv[e]);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(c, ar, br[0], br[1]);
    float* o = d + form * 128;
    o[g * 8 + 2 * t] = c[0];
    o[g * 8 + 2 * t + 1] = c[1];
    o[(g + 8) * 8 + 2 * t] = c[2];
    o[(g + 8) * 8 + 2 * t + 1] = c[3];
  }
}

}  // namespace

// Launch `blocks` CTAs of `threads` (a multiple of 128, at most 256) of form
// `form` (enum Form) with the operand work `work` (enum Work) beside it, for
// `iters` rounds; out takes 256 floats. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown pair: the TF32 forms take work 0 or
// 1, kMmaBf16 0 or 2, kNone 1 or 2.
extern "C" int moss_tc_rate(int form, int work, float* out, int blocks, int threads, int iters,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 g(blocks), b(threads);
  if (form == kMma && work == kNoWork) rate_kernel<kMma, kNoWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kMma && work == kSplitWork)
    rate_kernel<kMma, kSplitWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kWgmma8 && work == kNoWork)
    rate_kernel<kWgmma8, kNoWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kWgmma8 && work == kSplitWork)
    rate_kernel<kWgmma8, kSplitWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kWgmma16 && work == kNoWork)
    rate_kernel<kWgmma16, kNoWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kWgmma16 && work == kSplitWork)
    rate_kernel<kWgmma16, kSplitWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kMmaBf16 && work == kNoWork)
    rate_kernel<kMmaBf16, kNoWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kMmaBf16 && work == kBf16Work)
    rate_kernel<kMmaBf16, kBf16Work><<<g, b, 0, s>>>(out, iters);
  else if (form == kNone && work == kSplitWork)
    rate_kernel<kNone, kSplitWork><<<g, b, 0, s>>>(out, iters);
  else if (form == kNone && work == kBf16Work)
    rate_kernel<kNone, kBf16Work><<<g, b, 0, s>>>(out, iters);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The low-bits check on a (16, 8) and b (8, 8) f32; d (2, 16, 8) f32.
extern "C" int moss_tc_low_bits(const float* a, const float* b, float* d, void* stream) {
  low_bits_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, d);
  return static_cast<int>(cudaGetLastError());
}
