// Reductions and scans of the blend kernels on CUDA cores and on tensor
// cores: the microbenchmark that asks which unit should run them.
//
// Replaces tools/mxu_micro.py's nine Pallas kernels (launched by `run`,
// :219-236), in ten kernels (twelve production forms and their stages)
// behind four entry points:
//
//   moss_mxu_moments  moments_cuda_kernel<stage>, moments_bf16_kernel<stage>,
//                     moments_tf32x3_kernel<stage>: kern_moments_vpu (:58),
//                     kern_moments_mxu (:81)
//   moss_mxu_reshape  reshape_kernel<stage>: kern_reshape_only (:94)
//   moss_mxu_acc      acc_cuda_kernel<stage>, acc_bf16_kernel<stage>,
//                     acc_tf32x3_kernel<stage>: kern_acc_vpu (:102),
//                     kern_acc_mxu (:116)
//   moss_mxu_scan     cumsum_cuda_kernel<stage>, cumprod_cuda_kernel<stage>,
//                     scan_tc_kernel<op, mode>: kern_cumsum_vpu (:153),
//                     kern_cumsum_mxu (:175), kern_cumprod_vpu (:192),
//                     kern_cumprod_logmxu (:203)
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
//           m16n8k8 tf32; tf32() rounds to nearest with ties away from zero,
//           cvt.rna.tf32.f32's rounding (split_operand)
// The scans' CUDA-core forms are per-pixel sequential loops over K, the
// form the blend kernels use, not the TPU's two-level Hillis-Steele scan.
// Their walks over K carry up to 16 reps side by side (one running sum or
// product each, one walk shared by both, scan_walk), so a thread reads each
// x once a walk and its sums over reps need no array of 128 registers and no
// shared-memory copy of x: 3 instructions an element and rep for the cumsum,
// 6 for the cumprod (masked_one_minus), issue-bound.
//
// The CUDA-core moments and accumulators hold their chunk in registers and
// are bound by FP32-pipe issue, one warp instruction a clock a scheduler, an
// FMA counting one. The moments take the TPU kernel's separable form: each
// column's 8 rows summed weighted by 1, py and py^2, then the columns
// weighted by px, 33 instructions per 8 elements. The accumulators are
// register-blocked, a lane 4 pixels and a warp 16 splats, so that one
// broadcast load of s feeds 4 pixels' FMAs: 6.5 instructions an element,
// which issue below that rate, since an FMA whose three operands all come
// from the register file issues slower (acc_splat).
// Their stages (enum CudaStage) time the loads, the store and the observer
// alone.
//
// What bounds them on the H100: operations. The chunk is read from L2 once
// per CTA and held in registers or shared memory across the repeats (the
// counterpart of VMEM). A chunk-op does 2 K 1024 8 = 2.1 MFLOP of moments or
// accumulator contraction, about 1.5 MFLOP on the CUDA cores (67 TFLOP/s
// f32) and one tensor-core pass (989 TFLOP/s bf16, 495 TF32); the bound of a
// scan is its own f32 work. The log-space cumprod's tensor-core product is 36
// of the 64 16x16 blocks of L (128 x 128) against 1024 pixels, 18.9 MFLOP a
// pass, 72x the scan's adds; the cumsums multiply only the 8 diagonal blocks
// and carry each slab's total (15 blocks for bf16's all-ones carry, 8 for
// split2's shuffled one). The log-space cumprod adds a logarithm and an
// exponential per element and rep: 1.07e9 a launch, each one op in the bound
// (moss_torch/tools/mxu_micro.py OPS), beside which the tool also gives their
// time at the MUFU rate (16 a clock an SM). What held it: the libm log1pf and
// expf, several dozen FMA-pipe instructions each, so the kernel issued
// instructions for them and not for its tensor-core product (stage times,
// enum ScanStage). It now works in base 2: a degree-7 polynomial log2 on the
// FMA pipe (log2_1m_near, log2_1m_far: within the error a term may take; the exponent of 1 - a
// only in the reps where some alpha exceeds 0.5) and one MUFU ex2.
//
// The 3xTF32 moments and accumulators: three m16n8k8 products a k-step on
// an operand split in every rep. Their bound is the products at the TF32
// peak (0.052 ms a launch). What holds them is instruction issue: on the
// H100 mma.sync runs TF32 at 63% of that peak alone, and its products and
// the split's integer and f32 work do not overlap (tools/tc_rate.py: the
// two together take the sum of their times), so a kernel's time is about
// its products stage plus its split stage (enum Tf32Stage). The split is
// per element and rep, and no tensor-core design removes it; cvt.rna
// compiles to four instructions (an add, an Inf test, a select, a mask), so
// a split by it takes nine an element. split_operand makes it five (x + i,
// two integer adds, a mask, a subtract) and hands the tensor cores the
// unmasked sums, whose low bits they do not read. Held in registers beside
// A, the B fragments take a kernel to 163 registers (one CTA, 8 warps, an
// SM), so B lies in shared memory, 16 B a lane and k-step, loaded once for
// two reps (tf32x3_reps: the shared-memory load costs issue like the split,
// about 0.02 ms a launch at one load a rep), which leaves both kernels 2
// CTAs an SM; x comes in float4 or float2 loads, in an order of the
// contraction axis that makes a lane's elements adjacent (mom_pixel,
// acc_pixel); the moments' basis fragments are made
// without a branch on the lane's column. wgmma, Hopper's asynchronous
// product, is not used: at N = 8 it ran m64n8k8 TF32 at 148 TFLOP/s against
// mma.sync m16n8k8's 313, and beside the split's work it took longer than
// mma.sync did (tools/tc_rate.py).
//
// The bf16 moments and accumulators: one m16n8k16 product a k-step on x + i
// rounded to bf16 pairs in every rep (1.5 instructions an element: the add
// and half a cvt.rn.bf16x2), their bound the products at the bf16 peak
// (0.0087 ms a launch). x comes in vector loads: for the moments float4s, in
// an order of the contraction axis that gives a lane's four A columns of a
// k-step four adjacent pixels (mom_bf16_pixel); for the accumulators
// float2s, in an order of the m-tile's rows that gives a lane's rows g and g
// + 8 two adjacent pixels (acc_pixel). Two reps run their product chains side
// by side (bf16_reps, shared by both), so one chain's latency hides behind
// the other's; their stages (enum Bf16Stage) time the loads, the operand
// work and the products alone.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// 3xTF32 operands as the tensor cores take them. tf32(v), rounded to nearest
// with ties away from zero, is (bits(v) + 0x1000) with the low 13 bits
// cleared: cvt.rna.tf32.f32's value for every input but a NaN whose payload
// lies in the low bits, which no operand here holds; cvt.rna compiles to four
// instructions (it tests for Inf and NaN), this to one add. The tensor cores
// read only the 19 high bits of a tf32 operand register (tools/tc_rate.py
// checks it on the card), so the unmasked sum is the operand, and the mask is
// applied only where tf32(v) is needed as an f32 value: the small part's
// v - big.
__device__ __forceinline__ uint32_t tf32_operand(float v) { return __float_as_uint(v) + 0x1000u; }

__device__ __forceinline__ float tf32_value(uint32_t operand) {
  return __uint_as_float(operand & 0xffffe000u);
}

// big = tf32(v) and small = tf32(v - big) as operand registers: an add, a
// mask, a subtract and an add
__device__ __forceinline__ void split_operand(float v, uint32_t& big, uint32_t& small) {
  big = tf32_operand(v);
  small = tf32_operand(v - tf32_value(big));
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
// col t+4. b0 row t, col g; b1 row t+4. c as in mma_bf16. Volatile: a
// product whose operands do not change over the reps (the products stage)
// must not be hoisted out of them.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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

__device__ __forceinline__ uint4 lds_u4(const uint4* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// ---- the reps of a bf16 tensor-core contraction ---------------------------

// Stages of the bf16 tensor-core moments and accumulators
// (moments_bf16_kernel, acc_bf16_kernel), for timing what holds them back:
// kBf16Full the production kernel; kBf16Loads the chunk read, the store and
// the observer with no reps: each lane sums its elements of m-tile rows g and
// g + 8 once into its C elements of column 2t; kBf16Operands x + i and the
// bf16 packs of every rep with no products: each C element sums the pair
// registers of its slot as f32 (c0 a0, c1 a2, c2 a1, c3 a3); kBf16Products
// the packs made once, before the reps, and the products of every rep (a
// rep's sums start from a 0 read from shared memory, so the compiler cannot
// find the reps' products equal).
enum Bf16Stage { kBf16Full = 0, kBf16Loads = 1, kBf16Operands = 2, kBf16Products = 3 };

constexpr int kBf16Steps = 128 / 16;  // k-steps of m16n8k16 down a warp's 128-deep contraction: 8
constexpr int kBf16InFlight = 2;      // reps whose product chains run side by side

// The A fragment of a k-step (mma_bf16) from a lane's elements of m-tile rows
// g (u) and g + 8 (v), columns 2t, 2t + 1, 2t + 8, 2t + 9 in that order, plus
// fi, rounded to bf16 pairs
__device__ __forceinline__ void bf16_a(const float4& u, const float4& v, float fi,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(u.x + fi, u.y + fi);
  a[1] = pack_bf16(v.x + fi, v.y + fi);
  a[2] = pack_bf16(u.z + fi, u.w + fi);
  a[3] = pack_bf16(v.z + fi, v.w + fi);
}

// c += kReps reps' bf16 products of a warp, reps i0, i0 + 1, ...: per rep,
// cb = sum over the k-steps of A_i @ B in the tensor cores from 0 (A_i the
// packs of x + i, xu and xv: rows g and g + 8 (bf16_a); B the fragments bb),
// the reps' chains interleaved k-step by k-step, then c += cb in IEEE f32
// adds, rep after rep: the tensor cores' own accumulation is not rounded to
// nearest, and all reps in one accumulator would drift from the plain
// version by 1e-5 of the max. op: the packs of x made once (kBf16Products);
// zeros: that stage's 0.
template <int kStage, int kReps>
__device__ __forceinline__ void bf16_reps(const float4 (&xu)[kBf16Steps],
                                          const float4 (&xv)[kBf16Steps],
                                          const uint32_t (&op)[kBf16Steps][4],
                                          const uint32_t (&bb)[kBf16Steps][2], int i0,
                                          const float* zeros, float (&c)[4]) {
  float cb[kReps][4], fi[kReps];
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    fi[r] = static_cast<float>(i0 + r);
    const float z = kStage == kBf16Products ? lds(zeros + ((i0 + r) & 31)) : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[r][e] = z;
  }
#pragma unroll
  for (int s = 0; s < kBf16Steps; ++s) {
#pragma unroll
    for (int r = 0; r < kReps; ++r) {
      uint32_t a[4];
      if constexpr (kStage == kBf16Products) {
        a[0] = op[s][0], a[1] = op[s][1], a[2] = op[s][2], a[3] = op[s][3];
      } else {
        bf16_a(xu[s], xv[s], fi[r], a);
      }
      if constexpr (kStage == kBf16Operands) {
        cb[r][0] += __uint_as_float(a[0]);
        cb[r][1] += __uint_as_float(a[2]);
        cb[r][2] += __uint_as_float(a[1]);
        cb[r][3] += __uint_as_float(a[3]);
      } else {
        mma_bf16(cb[r], a, bb[s][0], bb[s][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kReps; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += cb[r][e];
}

// c += the bf16 products of reps 0, ..., reps - 1 (bf16_reps), kBf16InFlight
// at a time, the rest one at a time; or, for kBf16Loads, each lane's elements
// of rows g (into c[0]) and g + 8 (into c[2]) summed once
template <int kStage>
__device__ __forceinline__ void bf16_all_reps(const float4 (&xu)[kBf16Steps],
                                              const float4 (&xv)[kBf16Steps],
                                              const uint32_t (&bb)[kBf16Steps][2], int reps,
                                              const float* zeros, float (&c)[4]) {
  if constexpr (kStage == kBf16Loads) {
#pragma unroll
    for (int s = 0; s < kBf16Steps; ++s) {
      c[0] = (((c[0] + xu[s].x) + xu[s].y) + xu[s].z) + xu[s].w;
      c[2] = (((c[2] + xv[s].x) + xv[s].y) + xv[s].z) + xv[s].w;
    }
  } else {
    uint32_t op[kBf16Steps][4] = {};
    if constexpr (kStage == kBf16Products) {
#pragma unroll
      for (int s = 0; s < kBf16Steps; ++s) bf16_a(xu[s], xv[s], 0.f, op[s]);
    }
    int i = 0;
    for (; i + kBf16InFlight <= reps; i += kBf16InFlight)
      bf16_reps<kStage, kBf16InFlight>(xu, xv, op, bb, i, zeros, c);
    for (; i < reps; ++i) bf16_reps<kStage, 1>(xu, xv, op, bb, i, zeros, c);
  }
}

// ---- the reps of a 3xTF32 contraction --------------------------------------

// Stages of the 3xTF32 kernels (moments_tf32x3_kernel, acc_tf32x3_kernel),
// for timing what holds them back: kTf32Full the production kernel;
// kTf32Products the operand split once, before the reps (big = tf32(x), and
// big in place of small), the products and B loads as in full (a rep's sums
// start from a 0 read from shared memory, so the compiler cannot find the
// reps' products equal and do them once);
// kTf32Split the operand work of every rep (x + i, big and small) with no
// products and no B loads: each C element sums the small operand registers of
// the A element in its slot (c0 a0, c1 a2, c2 a1, c3 a3), as f32 values
// (tf32(v - big) plus the low bits the tensor cores drop).
enum Tf32Stage { kTf32Full = 0, kTf32Products = 1, kTf32Split = 2 };

constexpr int kTf32Steps = 16;  // k-steps of 8 a warp walks in a rep

// zeros[32] of shared memory, set by the CTA before its reps
__device__ __forceinline__ void set_rep_zeros(float* zeros) {
  if (threadIdx.x < 32) zeros[threadIdx.x] = 0.f;
}

// the start of rep i's sums: 0, read from zeros in the products stage
template <int kStage>
__device__ __forceinline__ float rep_zero(const float* zeros, int i) {
  return kStage == kTf32Products ? lds(zeros + (i & 31)) : 0.f;
}

// c += kReps reps' 3xTF32 products of a warp, reps i0, i0 + 1, ...: A = xa
// + i, split into big and small in its rep (xa: the lane's A elements of
// each k-step, in registers), B from bt (shared memory; k-step s at bt[32
// s]: big b0, b1, small b0, b1), loaded once for the kReps reps. For each
// rep, cs = small.B_big + big.B_small and cb = big.B_big run down the k-steps
// in the tensor cores from 0, then c += cb + cs in IEEE f32 adds, rep after
// rep; a k-step's B is loaded while the previous one's products run.
// zeros: the products stage's 0 (rep_zero).
template <int kStage, int kReps>
__device__ __forceinline__ void tf32x3_reps(const float (&xa)[kTf32Steps][4], const uint4* bt,
                                            int i0, const float* zeros, float (&c)[4]) {
  float cb[kReps][4], cs[kReps][4], fi[kReps];
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    const float z = rep_zero<kStage>(zeros, i0 + r);
    fi[r] = static_cast<float>(i0 + r);
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[r][e] = cs[r][e] = z;
  }
  uint4 b = kStage == kTf32Split ? uint4{} : lds_u4(bt);
#pragma unroll
  for (int s = 0; s < kTf32Steps; ++s) {
    const uint4 next = kStage == kTf32Split || s + 1 == kTf32Steps ? b : lds_u4(bt + 32 * (s + 1));
#pragma unroll
    for (int r = 0; r < kReps; ++r) {
      uint32_t big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kStage == kTf32Products) {
          big[e] = small[e] = __float_as_uint(xa[s][e]);
        } else {
          split_operand(xa[s][e] + fi[r], big[e], small[e]);
        }
      }
      if constexpr (kStage == kTf32Split) {
        cs[r][0] += __uint_as_float(small[0]);
        cs[r][1] += __uint_as_float(small[2]);
        cs[r][2] += __uint_as_float(small[1]);
        cs[r][3] += __uint_as_float(small[3]);
      } else {
        mma_tf32(cs[r], small, b.x, b.y);
        mma_tf32(cs[r], big, b.z, b.w);
        mma_tf32(cb[r], big, b.x, b.y);
      }
    }
    b = next;
  }
#pragma unroll
  for (int r = 0; r < kReps; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += cb[r][e] + cs[r][e];
}

// c += the 3xTF32 products of reps 0, ..., reps - 1, two at a time (one B
// load a k-step for both), an odd last one alone
template <int kStage>
__device__ __forceinline__ void tf32x3_all_reps(const float (&xa)[kTf32Steps][4], const uint4* bt,
                                                int reps, const float* zeros, float (&c)[4]) {
  int i = 0;
  for (; i + 1 < reps; i += 2) tf32x3_reps<kStage, 2>(xa, bt, i, zeros, c);
  if (i < reps) tf32x3_reps<kStage, 1>(xa, bt, i, zeros, c);
}

// B of a k-step for one lane as bt holds it: the big and small operands of
// b0 and b1
__device__ __forceinline__ uint4 b_fragment(float b0, float b1) {
  uint4 r;
  split_operand(b0, r.x, r.z);
  split_operand(b1, r.y, r.w);
  return r;
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

// ---- moments: out (K, 8) = sum_i (x + i).reshape(K, 1024) @ basis ----------

constexpr int kMomThreads = 256;
constexpr int kMomCudaParts = kK / (kMomThreads / 32);  // a warp per splat: 16
constexpr int kMomTcParts = kK / 16;                    // 16 splats a CTA: 8

// Stages of the CUDA-core moments, accumulator and reshape kernels
// (moments_cuda_kernel, acc_cuda_kernel, reshape_kernel), for timing what
// holds them back: kCudaFull the production kernel; kCudaLoads the chunk
// read, the store and the observer with no reps: each thread sums its
// elements of x once into the first output (the moments' S0, the
// accumulators' row 0; the repeated columns or rows as in full), every other
// output 0; the reshape's each output its 8 rows of x.
enum CudaStage { kCudaFull = 0, kCudaLoads = 1 };

constexpr int kMomCudaCols = 4;  // adjacent pixel columns a lane of moments_cuda_kernel takes
static_assert(kMomCudaCols * 32 == kW, "a warp's lanes cover a row of the chunk in float4s");

// CUDA cores, the separable form of kern_moments_vpu (:58-78): one warp per
// splat row; lane l takes the columns 4 l, ..., 4 l + 3 of the 8 rows (8
// float4 loads). Per rep and column: g = x + i for its 8 rows; the row sums
// s0 = sum g, s1 = sum py g and s2 = sum py^2 g, in row order (py the row, an
// FMA immediate; row 0 has py = 0, row 1 needs no multiply); then the lane
// sums S0 += s0, Sy += s1, Syy += s2 and, by FMA with px = 4 l + c and px^2,
// Sx, Sxx and Sxy: 33 FP32-pipe instructions per 8 elements. The lane sums
// run across all reps, columns in order within a rep; one warp butterfly
// (xor 16, 8, 4, 2, 1) after the last rep, not one a rep.
// Output columns [S0, Sx, Sy, Sxx, Sxy, Syy, S0, Sx] as kern_moments_vpu (:77).
template <int kStage>
__global__ void __launch_bounds__(kMomThreads)
moments_cuda_kernel(const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ obs, int reps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * (kMomThreads / 32) + warp;
  const float4* src = reinterpret_cast<const float4*>(x + k * kPix) + lane;
  float xv[8][kMomCudaCols];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float4 u = src[r * (kW / 4)];
    xv[r][0] = u.x, xv[r][1] = u.y, xv[r][2] = u.z, xv[r][3] = u.w;
  }
  float px[kMomCudaCols], px2[kMomCudaCols];
#pragma unroll
  for (int c = 0; c < kMomCudaCols; ++c) {
    px[c] = static_cast<float>(kMomCudaCols * lane + c);
    px2[c] = px[c] * px[c];
  }
  float S[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // S0, Sx, Sy, Sxx, Sxy, Syy
  if constexpr (kStage == kCudaLoads) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < kMomCudaCols; ++c) S[0] += xv[r][c];
  } else {
    for (int i = 0; i < reps; ++i) {
      const float fi = static_cast<float>(i);
#pragma unroll
      for (int c = 0; c < kMomCudaCols; ++c) {
        float g[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) g[r] = xv[r][c] + fi;
        float s0 = g[0];
#pragma unroll
        for (int r = 1; r < 8; ++r) s0 += g[r];
        float s1 = g[1], s2 = g[1];
#pragma unroll
        for (int r = 2; r < 8; ++r) {
          s1 = fmaf(static_cast<float>(r), g[r], s1);
          s2 = fmaf(static_cast<float>(r * r), g[r], s2);
        }
        S[0] += s0;
        S[2] += s1;
        S[5] += s2;
        S[1] = fmaf(px[c], s0, S[1]);
        S[3] = fmaf(px2[c], s0, S[3]);
        S[4] = fmaf(px[c], s1, S[4]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 6; ++m)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) S[m] += __shfl_xor_sync(kFull, S[m], o);
  const float row[8] = {S[0], S[1], S[2], S[3], S[4], S[5], S[0], S[1]};
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

// A CTA's 16 splats from its 8 warps' C fragments (splat rows g, g + 8 of
// the m-tile, columns 2t, 2t + 1), summed over the warps in a fixed order;
// tile 0 stores, every CTA observes.
__device__ __forceinline__ void moments_store(const float (&c)[4], float* __restrict__ out,
                                              float* __restrict__ obs) {
  __shared__ float red[kMomThreads / 32][16][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
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

// The pixel of column col (0-15) of k-step s in warp w's 128-pixel slice of
// moments_bf16_kernel: lane t's columns 2t, 2t + 1, 2t + 8 and 2t + 9 take
// the adjacent pixels 16 s + 4 t, ..., + 3 of the slice, so a lane loads each
// splat row's elements of a k-step as one float4, and the A pairs (2t, 2t +
// 1) and (2t + 8, 2t + 9) are its halves. The sum over pixels does not
// depend on which k-step or column a pixel takes, so long as A and B agree;
// k-step s still takes the 16 pixels 16 s, ..., 16 s + 15 of the slice, as
// the column order col -> 16 s + col does, and on the H100 a product's sum
// came out bitwise the same in both orders.
__host__ __device__ constexpr int mom_bf16_pixel(int w, int s, int col) {
  return 128 * w + 16 * s + 4 * ((col & 7) >> 1) + (col & 1) + 2 * (col >> 3);
}

// Tensor cores, bf16: a CTA takes 16 splats (one m-tile) and its 8 warps
// split the 1024-pixel depth in slices of 128 (8 k-steps of m16n8k16, pixel
// row w for warp w); each lane keeps its 64 elements of x in registers (16
// float4 loads, mom_bf16_pixel's order) and its basis fragments, made from
// the lane's column n = g with no divide and no branch on n; reps run two at
// a time (an odd last one alone), each rep's sum added to the warp's, and
// the warps' sums are summed in a fixed order. Two CTAs an SM (registers at
// most 128).
template <int kStage>
__global__ void __launch_bounds__(kMomThreads, 2)
moments_bf16_kernel(const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ obs, int reps) {
  __shared__ float zeros[32];
  if constexpr (kStage == kBf16Products) {
    set_rep_zeros(zeros);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // splat rows g and g + 8, pixels mom_bf16_pixel(warp, s, 2t), ..., + 3
  const float* r0 = x + (blockIdx.x * 16 + g) * kPix + mom_bf16_pixel(warp, 0, 2 * t);
  float4 xu[kBf16Steps], xv[kBf16Steps];
#pragma unroll
  for (int s = 0; s < kBf16Steps; ++s) {
    xu[s] = *reinterpret_cast<const float4*>(r0 + 16 * s);
    xv[s] = *reinterpret_cast<const float4*>(r0 + 8 * kPix + 16 * s);
  }
  // the basis column n = g at pixel column px of row py = warp: fy px^ex,
  // fy = py^ey (0 for n >= 6), exact in f32 and rounded to bf16
  const int ex = g == 3 ? 2 : g == 1 || g == 4 ? 1 : 0;
  const int ey = g == 5 ? 2 : g == 2 || g == 4 ? 1 : 0;
  const float py = static_cast<float>(warp);
  const float fy = g >= 6 ? 0.f : ey == 2 ? py * py : ey == 1 ? py : 1.f;
  auto value = [&](int px) {
    const float f = static_cast<float>(px);
    return fy * ((ex >= 1 ? f : 1.f) * (ex == 2 ? f : 1.f));
  };
  uint32_t bb[kBf16Steps][2];  // B rows 2t, 2t + 1 and 2t + 8, 2t + 9: pixels px, ..., + 3
#pragma unroll
  for (int s = 0; s < kBf16Steps; ++s) {
    const int px = mom_bf16_pixel(0, s, 2 * t);
    bb[s][0] = pack_bf16(value(px), value(px + 1));
    bb[s][1] = pack_bf16(value(px + 2), value(px + 3));
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  bf16_all_reps<kStage>(xu, xv, bb, reps, zeros, c);
  moments_store(c, out, obs);
}

// The pixel of column col (0-7) of k-step s in warp w's 128-pixel slice of
// moments_tf32x3_kernel: lane t's columns t and t + 4 take the pixels 32 t,
// ..., 32 t + 31 of the slice, two adjacent ones a k-step, so a lane loads
// its rows of x as float4s. The sum over pixels does not depend on which
// k-step or column a pixel takes, so long as A and B agree.
__host__ __device__ constexpr int mom_pixel(int w, int s, int col) {
  return 128 * w + 32 * (col & 3) + 2 * s + (col >> 2);
}

// shared memory of moments_tf32x3_kernel beyond its static red and
// warp_sum: the lanes' basis fragments
constexpr int kMomTf32Smem = (kMomThreads / 32) * kTf32Steps * 32 * 16;  // 64 KB

// Tensor cores, 3xTF32: a CTA takes 16 splats (one m-tile) and its 8 warps
// split the 1024-pixel depth in slices of 128 (16 k-steps of m16n8k8); each
// lane keeps its 64 A elements of x in registers (16 float4 loads,
// mom_pixel's order) and its basis fragments (big and small, 16 B a k-step)
// in shared memory, read again for every two reps (tf32x3_reps); a warp's
// reps add into its sum, and the warps' sums are summed in a fixed order.
// Two CTAs an SM (registers at most 128).
template <int kStage>
__global__ void __launch_bounds__(kMomThreads, 2)
moments_tf32x3_kernel(const float* __restrict__ x, float* __restrict__ out,
                      float* __restrict__ obs, int reps) {
  extern __shared__ uint4 bt[];  // [warp][k-step][lane]
  __shared__ float zeros[32];
  set_rep_zeros(zeros);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint4* my_bt = bt + warp * kTf32Steps * 32 + lane;
  {
    // the lane's basis column n = g as fy px^ex (fy = py^ey, 0 for n >= 6),
    // py = warp across the slice: no branch on the lane's column (a switch
    // on it, as basis() has, ran every case a warp holds, per value)
    const int ex = g == 3 ? 2 : g == 1 || g == 4 ? 1 : 0;
    const int ey = g == 5 ? 2 : g == 2 || g == 4 ? 1 : 0;
    const float py = static_cast<float>(warp);
    const float fy = g >= 6 ? 0.f : ey == 2 ? py * py : ey == 1 ? py : 1.f;
    auto value = [&](int p) {
      const float px = static_cast<float>(p % kW);
      return fy * ((ex >= 1 ? px : 1.f) * (ex == 2 ? px : 1.f));
    };
#pragma unroll
    for (int s = 0; s < kTf32Steps; ++s)
      my_bt[32 * s] = b_fragment(value(mom_pixel(warp, s, t)), value(mom_pixel(warp, s, t + 4)));
  }
  // a0, a2: splat row g, pixels mom_pixel(warp, s, t) and (.., t + 4) (adjacent);
  // a1, a3: row g + 8
  const float* r0 = x + (blockIdx.x * 16 + g) * kPix + mom_pixel(warp, 0, t);
  float xa[kTf32Steps][4];
#pragma unroll
  for (int j = 0; j < kTf32Steps / 2; ++j) {
    const float4 u = *reinterpret_cast<const float4*>(r0 + 4 * j);
    const float4 v = *reinterpret_cast<const float4*>(r0 + 8 * kPix + 4 * j);
    xa[2 * j][0] = u.x, xa[2 * j][2] = u.y, xa[2 * j + 1][0] = u.z, xa[2 * j + 1][2] = u.w;
    xa[2 * j][1] = v.x, xa[2 * j][3] = v.y, xa[2 * j + 1][1] = v.z, xa[2 * j + 1][3] = v.w;
  }
  if constexpr (kStage == kTf32Products) {
#pragma unroll
    for (int s = 0; s < kTf32Steps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[s][e] = tf32_value(tf32_operand(xa[s][e]));
  }
  __syncthreads();
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  tf32x3_all_reps<kStage>(xa, my_bt, reps, zeros, c);
  moments_store(c, out, obs);
}

// ---- reshape only: out (K, 128) = sum over the 8 rows of sum_i (x + i) ----

constexpr int kReshapeThreads = 256;
constexpr int kReshapeCols = 4;  // adjacent columns a thread takes: a float4 of each row
constexpr int kReshapeParts = kK * kW / (kReshapeThreads * kReshapeCols);  // 16
constexpr int kReshapeTiles = 16;  // tiles a CTA walks, one after another
static_assert(kW % kReshapeCols == 0, "a thread's columns lie in one row of the chunk");

// A thread's 4 columns of the 8 rows of one tile's chunk. The load is a
// volatile asm statement, so the compiler can neither merge two tiles' reads
// (they read the same addresses) nor move a read past the reps before it.
__device__ __forceinline__ void reshape_rows(const float* src, float4 (&xv)[8]) {
#pragma unroll
  for (int h = 0; h < 8; ++h)
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(xv[h].x), "=f"(xv[h].y), "=f"(xv[h].z), "=f"(xv[h].w)
                 : "l"(src + h * kW));
}

// One tile of reshape_kernel: per column c and row h the sum a = a + (x + i)
// for i = 0, ..., reps - 1 in order (i carried as an exact float), then the 8
// rows summed in row order; only tile 0 stores; each warp's sum of its
// threads' (v.x + v.y) + (v.z + v.w) goes to warp_sum, the tile's row of the
// CTA's observers. kCudaLoads sums the 8 rows of x once.
template <int kStage>
__device__ __forceinline__ void reshape_tile(const float4 (&xv)[8], int reps, int tile,
                                             float* out, float* warp_sum) {
  float a[8][kReshapeCols];
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    if constexpr (kStage == kCudaLoads) {
      a[h][0] = xv[h].x, a[h][1] = xv[h].y, a[h][2] = xv[h].z, a[h][3] = xv[h].w;
    } else {
      a[h][0] = a[h][1] = a[h][2] = a[h][3] = 0.f;
    }
  }
  if constexpr (kStage == kCudaFull) {
    float fi = 0.f;
#pragma unroll 2
    for (int i = 0; i < reps; ++i) {
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        a[h][0] = a[h][0] + (xv[h].x + fi);
        a[h][1] = a[h][1] + (xv[h].y + fi);
        a[h][2] = a[h][2] + (xv[h].z + fi);
        a[h][3] = a[h][3] + (xv[h].w + fi);
      }
      fi += 1.f;
    }
  }
  float4 v = make_float4(a[0][0], a[0][1], a[0][2], a[0][3]);
#pragma unroll
  for (int h = 1; h < 8; ++h) v.x += a[h][0], v.y += a[h][1], v.z += a[h][2], v.w += a[h][3];
  const int e = (blockIdx.x * kReshapeThreads + threadIdx.x) * kReshapeCols;  // k * 128 + w
  if (tile == 0) *reinterpret_cast<float4*>(out + e) = v;
  float s = (v.x + v.y) + (v.z + v.w);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
}

// CUDA cores, bound by FP32-pipe issue: 2 FADDs an element and rep. Here a
// thread takes 4 adjacent columns w of one splat k (a float4 of each of the 8
// rows, 32 chains) and a CTA the part of 1,024 outputs it names for
// kReshapeTiles tiles in turn, so the grid is (parts, tiles / 16); the form
// with one output a thread took 16,384 CTAs of 8 scalar loads. A tile's 8
// loads come before its reps and overlap none of them: a CTA re-reads its
// part's 32 KB at every tile, and those reads cost what they cost the CTA's
// first tile only where the SM's L1 still holds the part (PERF.md). The
// warps' sums of every tile wait in shared memory, and one barrier after the
// last tile lets thread j add tile j's in warp order: no barrier holds a
// tile's warps together.
template <int kStage>
__global__ void __launch_bounds__(kReshapeThreads, 2)
reshape_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ obs,
               int reps, int tiles) {
  constexpr int kWarps = kReshapeThreads / 32;
  static_assert(kReshapeTiles <= kReshapeThreads, "a thread sums each tile's observer");
  __shared__ float warp_sum[kReshapeTiles][kWarps];
  const int e = (blockIdx.x * kReshapeThreads + threadIdx.x) * kReshapeCols;
  const float* src = x + (e / kW) * kPix + e % kW;
  const int t0 = blockIdx.y * kReshapeTiles, t1 = min(tiles, t0 + kReshapeTiles);
  for (int t = t0; t < t1; ++t) {
    float4 xv[8];
    reshape_rows(src, xv);
    reshape_tile<kStage>(xv, reps, t, out, warp_sum[t - t0]);
  }
  __syncthreads();
  if (threadIdx.x < t1 - t0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sum[threadIdx.x][w];
    obs[(t0 + threadIdx.x) * gridDim.x + blockIdx.x] = s;
  }
}

// ---- accumulators: out (8, 1024) = sum_i s (8, K) @ (x + i) (K, 1024) ----

constexpr int kAccCudaThreads = 256;
constexpr int kAccTcThreads = 256;
constexpr int kAccParts = kPix / 128;  // 128 pixels a CTA: 8
// acc_bf16_kernel: 4 warps of 16 pixels, 64 pixels a CTA, 16 CTAs a chunk-op
constexpr int kAccBf16Threads = 128;
constexpr int kAccBf16Pixels = 16 * kAccBf16Threads / 32;
constexpr int kAccBf16Parts = kPix / kAccBf16Pixels;
constexpr int kAccCudaWarps = kAccCudaThreads / 32;
constexpr int kAccCudaSplats = kK / kAccCudaWarps;  // splats a warp of acc_cuda_kernel takes: 16
constexpr int kAccCudaPix = 128 / 32;               // adjacent pixels a lane takes: 4
static_assert(kAccCudaPix == 4, "a lane loads its pixels of a splat as one float4");

// The 20 FMAs of one splat into a lane's sums a[n][c] (row n, pixel c), s
// the splat's five weights, v its four values x + i: row n walks the pixels
// up for even n and down for odd n, so that each FMA shares s[n] or v[c]
// with the one before it and the compiler can take that operand from the
// operand reuse cache. An FMA that reads all three of its operands from the
// register file issues slower on the H100 than one with an immediate or
// uniform-register operand; this order leaves fewer of them.
__device__ __forceinline__ void acc_splat(const float (&s)[5], const float (&v)[kAccCudaPix],
                                          float (&a)[5][kAccCudaPix]) {
#pragma unroll
  for (int n = 0; n < 5; ++n)
#pragma unroll
    for (int q = 0; q < kAccCudaPix; ++q) {
      const int c = (n & 1) ? kAccCudaPix - 1 - q : q;
      a[n][c] = fmaf(s[n], v[c], a[n][c]);
    }
}

// CUDA cores, register-blocked: a CTA takes 128 pixels and all 128 splats;
// warp w takes the splats 16 w, ..., 16 w + 15 and lane l the 4 adjacent
// pixels 4 l, ..., 4 l + 3 (16 float4 loads, 64 registers of x). s rows 0-4
// sit in shared memory; per splat and rep two broadcast loads of s feed 4
// adds x + i and 20 FMAs (acc_splat), 0.5 loads an element. A lane's 20
// sums run across all reps, splats in order within a rep; then the 8 warps'
// partial sums are added through shared memory in warp order. At most 128
// registers: 2 CTAs an SM. Rows 5-7 repeat rows 0-2, as kern_acc_vpu does
// (:112).
template <int kStage>
__global__ void __launch_bounds__(kAccCudaThreads, 2)
acc_cuda_kernel(const float* __restrict__ x, const float* __restrict__ sw,
                float* __restrict__ out, float* __restrict__ obs, int reps) {
  __shared__ float4 s_sh[kK][2];  // s[0..3][k], then s[4][k]
  __shared__ float4 red[kAccCudaWarps][5][32];
  for (int k = threadIdx.x; k < kK; k += kAccCudaThreads) {
    s_sh[k][0] = make_float4(sw[k], sw[kK + k], sw[2 * kK + k], sw[3 * kK + k]);
    s_sh[k][1] = make_float4(sw[4 * kK + k], 0.f, 0.f, 0.f);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = x + kAccCudaSplats * warp * kPix + blockIdx.x * 128 + kAccCudaPix * lane;
  float xv[kAccCudaSplats][kAccCudaPix];
#pragma unroll
  for (int j = 0; j < kAccCudaSplats; ++j) {
    const float4 u = *reinterpret_cast<const float4*>(src + j * kPix);
    xv[j][0] = u.x, xv[j][1] = u.y, xv[j][2] = u.z, xv[j][3] = u.w;
  }
  __syncthreads();
  float a[5][kAccCudaPix] = {};
  if constexpr (kStage == kCudaLoads) {
#pragma unroll
    for (int j = 0; j < kAccCudaSplats; ++j)
#pragma unroll
      for (int c = 0; c < kAccCudaPix; ++c) a[0][c] += xv[j][c];
  } else {
    const float4* my_s = &s_sh[kAccCudaSplats * warp][0];
    for (int i = 0; i < reps; ++i) {
      const float fi = static_cast<float>(i);
#pragma unroll
      for (int j = 0; j < kAccCudaSplats; ++j) {
        const float4 s03 = lds4(my_s + 2 * j);
        const float s[5] = {s03.x, s03.y, s03.z, s03.w,
                            lds(reinterpret_cast<const float*>(my_s + 2 * j + 1))};
        float v[kAccCudaPix];
#pragma unroll
        for (int c = 0; c < kAccCudaPix; ++c) v[c] = xv[j][c] + fi;
        acc_splat(s, v, a);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 5; ++n) red[warp][n][lane] = make_float4(a[n][0], a[n][1], a[n][2], a[n][3]);
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x < 5 * 32) {  // row n, pixels 4 l, ..., 4 l + 3 of the CTA's 128
    const int n = threadIdx.x >> 5, l = threadIdx.x & 31;
    float4 v = red[0][n][l];
#pragma unroll
    for (int w = 1; w < kAccCudaWarps; ++w) {
      const float4 u = red[w][n][l];
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    }
    if (blockIdx.y == 0) {
      const int p = blockIdx.x * 128 + kAccCudaPix * l;
      *reinterpret_cast<float4*>(out + n * kPix + p) = v;
      if (n < 3) *reinterpret_cast<float4*>(out + (n + 5) * kPix + p) = v;
    }
    sum = (v.x + v.y) + (v.z + v.w);
  }
  observe<kAccCudaThreads>(sum, obs);
}

// The pixel, within its CTA's pixels, of row r (0-15) of warp w's m-tile in
// acc_bf16_kernel and acc_tf32x3_kernel: a lane's rows g and g + 8 are
// adjacent pixels, so it loads them as one float2. A pixel's row enters no
// sum: each output element sums over the splats of its own pixel.
__host__ __device__ constexpr int acc_pixel(int w, int r) {
  return 16 * w + 2 * (r & 7) + (r >> 3);
}

// Tensor cores, bf16: out^T (1024 x 8) = w^T (1024 x K) @ s^T (K x 8), M =
// pixels. A warp takes 16 pixels (acc_pixel's order: rows g and g + 8 the
// adjacent pixels p and p + 1) and the whole depth of 128 splats (8 k-steps
// of m16n8k16, splats 16 s + col); its A fragments are pixel-major while x is
// stored splat-major (no ldmatrix: its .trans form exists for 16-bit
// elements only), so each lane loads its 64 elements of x once, before the
// reps, as 32 float2s, a splat's pixels p and p + 1 each, and keeps its s^T
// fragments; reps run two at a time (an odd last one alone, bf16_all_reps).
// A CTA of 4 warps and 4 CTAs an SM (registers at most 128), so that one
// CTA's read of its 32 KB of x, bound by the L2 (the kBf16Loads stage),
// overlaps the other CTAs' reps: with 2 CTAs of 8 warps an SM the same body
// took longer than the parent's, at 4 CTAs of 4 warps less (PERF.md).
template <int kStage>
__global__ void __launch_bounds__(kAccBf16Threads, 512 / kAccBf16Threads)
acc_bf16_kernel(const float* __restrict__ x, const float* __restrict__ sw,
                float* __restrict__ out, float* __restrict__ obs, int reps) {
  __shared__ float zeros[32];
  if constexpr (kStage == kBf16Products) {
    set_rep_zeros(zeros);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // rows g and g + 8: pixels p and p + 1
  const int p = blockIdx.x * kAccBf16Pixels + acc_pixel(warp, g);
  const float* srow = sw + g * kK;  // s row n = g
  // pixel p (xu) and p + 1 (xv) of splats c0, c0 + 1, c8, c8 + 1 (bf16_a's columns)
  float4 xu[kBf16Steps], xv[kBf16Steps];
  uint32_t bb[kBf16Steps][2];
#pragma unroll
  for (int s = 0; s < kBf16Steps; ++s) {
    const int c0 = s * 16 + 2 * t, c8 = c0 + 8;  // splat columns
    const float2 u0 = *reinterpret_cast<const float2*>(x + c0 * kPix + p);
    const float2 u1 = *reinterpret_cast<const float2*>(x + (c0 + 1) * kPix + p);
    const float2 u8 = *reinterpret_cast<const float2*>(x + c8 * kPix + p);
    const float2 u9 = *reinterpret_cast<const float2*>(x + (c8 + 1) * kPix + p);
    xu[s] = make_float4(u0.x, u1.x, u8.x, u9.x);
    xv[s] = make_float4(u0.y, u1.y, u8.y, u9.y);
    bb[s][0] = pack_bf16(srow[c0], srow[c0 + 1]);
    bb[s][1] = pack_bf16(srow[c8], srow[c8 + 1]);
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  bf16_all_reps<kStage>(xu, xv, bb, reps, zeros, c);
  // c[0], c[1]: pixel p, rows n = 2t, 2t + 1; c[2], c[3]: pixel p + 1
  if (blockIdx.y == 0) {
    *reinterpret_cast<float2*>(out + 2 * t * kPix + p) = make_float2(c[0], c[2]);
    *reinterpret_cast<float2*>(out + (2 * t + 1) * kPix + p) = make_float2(c[1], c[3]);
  }
  observe<kAccBf16Threads>(((c[0] + c[1]) + c[2]) + c[3], obs);
}

// Tensor cores, 3xTF32: out^T (1024 x 8) = w^T (1024 x K) @ s^T (K x 8), M =
// pixels. A warp takes 16 pixels (acc_pixel's order) and the whole depth of
// 128 splats (16 k-steps of m16n8k8, column col of k-step s splat 8 s +
// col); each lane keeps its 64 A elements of x in registers (32 float2
// loads) and the CTA's s^T fragments (big and small, 8 KB) lie in shared
// memory, read again for every two reps by all 8 warps (tf32x3_reps). Two
// CTAs an SM (registers at most 128).
template <int kStage>
__global__ void __launch_bounds__(kAccTcThreads, 2)
acc_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ sw,
                  float* __restrict__ out, float* __restrict__ obs, int reps) {
  __shared__ uint4 bt[kTf32Steps * 32];  // [k-step][lane]: s[g][8 s + t], s[g][8 s + t + 4]
  __shared__ float zeros[32];
  set_rep_zeros(zeros);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int e = threadIdx.x; e < kTf32Steps * 32; e += kAccTcThreads) {
    const float* b = sw + ((e & 31) >> 2) * kK + 8 * (e >> 5) + (e & 3);
    bt[e] = b_fragment(b[0], b[4]);
  }
  const int p = blockIdx.x * 128 + acc_pixel(warp, g);  // rows g, g + 8: pixels p, p + 1
  float xa[kTf32Steps][4];
#pragma unroll
  for (int s = 0; s < kTf32Steps; ++s) {
    const float2 u = *reinterpret_cast<const float2*>(x + (8 * s + t) * kPix + p);
    const float2 v = *reinterpret_cast<const float2*>(x + (8 * s + t + 4) * kPix + p);
    xa[s][0] = u.x, xa[s][1] = u.y, xa[s][2] = v.x, xa[s][3] = v.y;
    if constexpr (kStage == kTf32Products) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[s][e] = tf32_value(tf32_operand(xa[s][e]));
    }
  }
  __syncthreads();
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  tf32x3_all_reps<kStage>(xa, bt + lane, reps, zeros, c);
  // c[0], c[1]: pixel p, rows n = 2t, 2t + 1; c[2], c[3]: pixel p + 1
  if (blockIdx.y == 0) {
    *reinterpret_cast<float2*>(out + 2 * t * kPix + p) = make_float2(c[0], c[2]);
    *reinterpret_cast<float2*>(out + (2 * t + 1) * kPix + p) = make_float2(c[1], c[3]);
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

__device__ __forceinline__ float rep_scale(int i) {
  return static_cast<float>(0.01 * static_cast<double>(i + 1));
}

// a = clip(x c_i, 0, 0.9), fminf(fmaxf(x c_i, 0), 0.9), in two instructions:
// a saturating multiply (the clip at 0, after the product's rounding; NaN to
// 0 as fmaxf does) and the min. Equal to the fminf-fmaxf form on every
// input, but -0, which both send through the mask as 0
__device__ __forceinline__ float alpha_sat(float xv, float ci) {
  float a;
  asm("mul.sat.f32 %0, %1, %2;" : "=f"(a) : "f"(xv), "f"(ci));
  return fminf(a, 0.9f);
}

// c ? x : y as a select, never a branch
__device__ __forceinline__ float select(bool c, float x, float y) {
  float r;
  asm("{\n.reg .pred p;\nsetp.ne.s32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}"
      : "=f"(r) : "f"(x), "f"(y), "r"(static_cast<int>(c)));
  return r;
}

// log2(1 - a) for a in (0, 0.9] on the FMA pipe, no libm call and no
// MUFU. 1 - a = 2^e (1 + f) with f in [-0.5, 0): for a <= 0.5, e = 0 and
// f = -a exactly (1 - a itself would be rounded); above, 1 - a is exact and
// e and 1 + f in [0.5, 1) are its exponent and mantissa. log2(1 + f) =
// f P(f), P the degree-7 polynomial kLog2Poly fitted to log2(1 + f) / f on
// [-0.5, 0], in Horner form. Error against float64 over a in (0.003, 0.9],
// modelled in float32 arithmetic (tests/test_torch_mxu_micro.py): times
// 1 - a, the most a term can move a cumprod, within the 8e-8 a term may take
// for 128 terms to stay within RTOL = 1e-5 of the max
// (moss_torch/tools/mxu_micro.py). The coefficients are
// ops/reduce_scan.py::LOG2_POLY, which the test reads from the table in
// log2_poly.
__device__ __forceinline__ float log2_poly(float f) {  // P(f)
  constexpr float kLog2Poly[8] = {1.4426864f, -0.7218736f, 0.4700032f, -0.46861637f,
                                  -0.29185253f, -1.9971113f, -2.669445f, -2.283522f};
  float p = kLog2Poly[7];
#pragma unroll
  for (int j = 6; j >= 0; --j) p = fmaf(p, f, kLog2Poly[j]);
  return p;
}

// log2(1 - a) for a in [0, 0.5]: f = -a, f P(f)
__device__ __forceinline__ float log2_1m_near(float a) { return -a * log2_poly(-a); }

// log2(1 - a) for a in [0.5, 0.9]: the exponent e of the exact 1 - a, then
// e + f P(f) in one rounding
__device__ __forceinline__ float log2_1m_far(float a) {
  const int bits = __float_as_int(1.f - a);
  const float e = __int_as_float(0x4b000000 | (bits >> 23)) - 8388734.f;  // exponent - 126
  const float f = __int_as_float((bits & 0x007fffff) | 0x3f000000) - 1.f;
  return fmaf(f, log2_poly(f), e);
}

// 2^v, one MUFU op (ex2.approx: 2 ulp; flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp2_fast(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// ---- the CUDA-core scans: the reps inside the walk over the splats ----------

constexpr int kWalkGroup = 16;  // reps a walk over K carries side by side, at most
constexpr int kWalkBatch = 8;   // splats whose x a thread loads a batch ahead
// dynamic shared memory of the CUDA-core scans when their reps take more than
// one walk: the sums of the walks before, [splat][thread]
constexpr int kWalkSmem = kK * kScanCudaThreads * 4;  // 32 KB

// The walks a launch of `reps` takes: reps / 16 of 16, then one each of 8,
// 4, 2 and 1 as the rest's bits say
__host__ __device__ constexpr int scan_walks(int reps) {
  return reps / kWalkGroup + (reps & 8 ? 1 : 0) + (reps & 4 ? 1 : 0) + (reps & 2 ? 1 : 0) +
         (reps & 1 ? 1 : 0);
}

// The masked factor a > 0.003 ? 1 - a : 1 in two FMA-pipe instructions,
// bitwise, where a compare and a select are two on the half-rate ALU pipe:
// the mask a > 0.003 as 1.0 or 0.0 by (a - 0.003) 2^40 in one rounding,
// saturated to [0, 1] (f32 values near 0.003 lie 2^-32 apart, so an a above
// it gives at least 256), then fma(-a, mask, 1), 1 - a rounded once or
// exactly 1
__device__ __forceinline__ float masked_one_minus(float a) {
  constexpr float kScale = 1099511627776.f;  // 2^40
  float mask;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;" : "=f"(mask) : "f"(a), "f"(kScale), "f"(-0.003f * kScale));
  return __fmaf_rn(-a, mask, 1.f);
}

// rep i's constant: the i of x + i (kAdd), the alpha's scale c_i (kMul)
template <int kOp>
__device__ __forceinline__ float rep_const(int i) {
  return kOp == kAdd ? static_cast<float>(i) : rep_scale(i);
}

// One element of one rep: run, the rep's running sum (kAdd: run + (x + i))
// or product (kMul: run (1 - a) or run), then s, the splat's sum over reps,
// + run; each rounded apart, but where fma (the cumprod's last splat, whose
// product feeds only the add; a constant once the splat loop is unrolled)
// s + run g in one FMA
template <int kOp>
__device__ __forceinline__ void walk_step(float xv, float c, bool fma, float& run, float& s) {
  if constexpr (kOp == kAdd) {
    run = __fadd_rn(run, __fadd_rn(xv, c));
    s = __fadd_rn(s, run);
  } else if (fma) {
    s = __fmaf_rn(run, masked_one_minus(alpha_sat(xv, c)), s);
  } else {
    run = __fmul_rn(run, masked_one_minus(alpha_sat(xv, c)));
    s = __fadd_rn(s, run);
  }
}

// One walk of a thread's pixel over K for the reps i0, ..., i0 + kReps - 1:
// a running sum or product each, so per splat x is read once (from L2, a
// batch of kWalkBatch loaded while the batch before is worked) and each rep
// adds its running value to the splat's sum, in rep order (walk_step). The
// sum starts at 0 in the first walk (kFirst), else at the walks before's
// (part: the thread's column of the shared-memory sums, splat k at
// part[64 k]); the last walk (kLast) adds it to `total` in splat order and
// tile 0 stores it to op (the thread's column of out), the others leave it
// in part. Each output is ((0 + r_0) + r_1) + ... with rep i's r_i formed as
// a per-rep walk forms it. kFirst and kLast are template arguments: as
// runtime flags they cost a branch or a select a splat.
template <int kOp, int kReps, bool kEnd, bool kFirst, bool kLast>
__device__ __forceinline__ void walk_batch(const float (&xb)[kWalkBatch], int k0,
                                           const float (&c)[kReps], float (&run)[kReps],
                                           float* part, float* __restrict__ op, float& total) {
#pragma unroll
  for (int j = 0; j < kWalkBatch; ++j) {
    const int k = k0 + j;
    float s = kFirst ? 0.f : part[k * kScanCudaThreads];
#pragma unroll
    for (int r = 0; r < kReps; ++r)
      walk_step<kOp>(xb[j], c[r], kEnd && j + 1 == kWalkBatch, run[r], s);
    if constexpr (kLast) {
      total += s;
      if (blockIdx.y == 0) op[k * kPix] = s;
    } else {
      part[k * kScanCudaThreads] = s;
    }
  }
}

template <int kOp, int kReps, bool kFirst, bool kLast>
__device__ __forceinline__ void scan_walk(const float* __restrict__ xp, float* part, int i0,
                                          float* __restrict__ op, float& total) {
  float c[kReps], run[kReps];
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    c[r] = rep_const<kOp>(i0 + r);
    run[r] = kOp == kAdd ? 0.f : 1.f;
  }
  float xb[kWalkBatch];
#pragma unroll
  for (int j = 0; j < kWalkBatch; ++j) xb[j] = xp[j * kPix];
  int k0 = 0;
#pragma unroll 1
  for (; k0 + kWalkBatch < kK; k0 += kWalkBatch) {
    float xn[kWalkBatch];  // the next batch's x
#pragma unroll
    for (int j = 0; j < kWalkBatch; ++j) xn[j] = xp[(k0 + kWalkBatch + j) * kPix];
    walk_batch<kOp, kReps, false, kFirst, kLast>(xb, k0, c, run, part, op, total);
#pragma unroll
    for (int j = 0; j < kWalkBatch; ++j) xb[j] = xn[j];
  }
  walk_batch<kOp, kReps, true, kFirst, kLast>(xb, k0, c, run, part, op, total);
}

// the walk of reps i0, ..., i0 + kReps - 1, the first of the launch's walks
// where i0 = 0, its last where they end at `reps`
template <int kOp, int kReps>
__device__ __forceinline__ void walk(const float* __restrict__ xp, float* part, int i0, int reps,
                                     float* __restrict__ op, float& total) {
  const bool first = i0 == 0, last = i0 + kReps == reps;
  if (first && last)
    scan_walk<kOp, kReps, true, true>(xp, part, i0, op, total);
  else if (first)
    scan_walk<kOp, kReps, true, false>(xp, part, i0, op, total);
  else if (last)
    scan_walk<kOp, kReps, false, true>(xp, part, i0, op, total);
  else
    scan_walk<kOp, kReps, false, false>(xp, part, i0, op, total);
}

// CUDA cores, a scan over the splats: a thread per pixel, 64 a CTA, walks K
// with up to 16 reps inside (scan_walk): the cumsum 3 instructions an element
// and rep (x + i, the running add, the add into the sum); the masked cumprod
// 6 (the saturating multiply and the min of alpha_sat, the mask's two FMAs,
// the product, the add; one of them, the min, on the half-rate ALU pipe), 16
// on the thread's running values side by side, and a few dozen registers. A
// launch of more reps walks again, the sums of the walks before in shared
// memory (kWalkSmem, given only then). Its stages (enum CudaStage):
// kCudaLoads reads x, stores it as the output (tile 0) and observes it.
template <int kOp, int kStage>
__device__ __forceinline__ void cuda_scan(const float* __restrict__ x, float* __restrict__ out,
                                          float* __restrict__ obs, int reps) {
  extern __shared__ float part[];
  const int p = blockIdx.x * kScanCudaThreads + threadIdx.x;
  const float* xp = x + p;
  float* op = out + p;
  float total = 0.f;
  if constexpr (kStage == kCudaLoads) {
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      const float v = xp[k * kPix];
      total += v;
      if (blockIdx.y == 0) op[k * kPix] = v;
    }
  } else if (reps == 0) {
    if (blockIdx.y == 0)
      for (int k = 0; k < kK; ++k) op[k * kPix] = 0.f;
  } else {
    float* my = part + threadIdx.x;
    int i = 0;
    for (; i + kWalkGroup <= reps; i += kWalkGroup)
      walk<kOp, kWalkGroup>(xp, my, i, reps, op, total);
    // the rest in walks of 8, 4, 2 and 1
    if (reps - i >= 8) {
      walk<kOp, 8>(xp, my, i, reps, op, total);
      i += 8;
    }
    if (reps - i >= 4) {
      walk<kOp, 4>(xp, my, i, reps, op, total);
      i += 4;
    }
    if (reps - i >= 2) {
      walk<kOp, 2>(xp, my, i, reps, op, total);
      i += 2;
    }
    if (reps - i >= 1) walk<kOp, 1>(xp, my, i, reps, op, total);
  }
  observe<kScanCudaThreads>(total, obs);
}

// the inclusive cumsum of x + i (replaces kern_cumsum_vpu, :153)
template <int kStage>
__global__ void __launch_bounds__(kScanCudaThreads)
cumsum_cuda_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ obs,
                   int reps) {
  cuda_scan<kAdd, kStage>(x, out, obs, reps);
}

// the masked cumprod of rep i's alpha (replaces kern_cumprod_vpu, :192)
template <int kStage>
__global__ void __launch_bounds__(kScanCudaThreads)
cumprod_cuda_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ obs,
                    int reps) {
  cuda_scan<kMul, kStage>(x, out, obs, reps);
}

// The bf16 fragment of the lower-triangular ones L at (row r, col c) of a
// diagonal 16 x 16 block: 1 where c <= r
__device__ __forceinline__ uint32_t tri_pair(int r, int c) {
  return pack_bf16(c <= r ? 1.f : 0.f, c + 1 <= r ? 1.f : 0.f);
}

// The B fragments of a slab of v (rows 2t, 2t+1 in v[0], v[1]; 2t+8, 2t+9 in
// v[2], v[3]): hi = bf16(v); for split2 also lo = bf16(v - bf16(v)), bf16(v)
// read back from hi's halves
template <int kMode>
__device__ __forceinline__ void slab_operand(const float (&v)[4], uint32_t (&hi)[2],
                                             uint32_t (&lo)[2]) {
  hi[0] = pack_bf16(v[0], v[1]);
  hi[1] = pack_bf16(v[2], v[3]);
  if constexpr (kMode == kSplit2) {
    lo[0] = pack_bf16(v[0] - __uint_as_float(hi[0] << 16),
                      v[1] - __uint_as_float(hi[0] & 0xffff0000u));
    lo[1] = pack_bf16(v[2] - __uint_as_float(hi[1] << 16),
                      v[3] - __uint_as_float(hi[1] & 0xffff0000u));
  }
}

// The tensor-core scans' B fragments of x: a warp takes 8 pixels (one
// n-tile, col g = pixel pb + g) and all 128 splats as eight 16-splat slabs;
// xv[s] holds rows 2t, 2t+1, 2t+8, 2t+9 of slab s
__device__ __forceinline__ void load_scan_b(const float* __restrict__ x, int pb, int g, int t,
                                            float (&xv)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int k0 = 16 * s + 2 * t;
    xv[s][0] = x[k0 * kPix + pb + g];
    xv[s][1] = x[(k0 + 1) * kPix + pb + g];
    xv[s][2] = x[(k0 + 8) * kPix + pb + g];
    xv[s][3] = x[(k0 + 9) * kPix + pb + g];
  }
}

// Tile 0 stores a warp's sums, every CTA observes. kCLayout: acc[m] is the C
// fragment of slab m (splats 16 m + g and + 8, pixels pb + 2t, + 1); else the
// B fragment, as xv (splats 16 m + 2t, + 1, + 8, + 9, pixel pb + g).
template <bool kCLayout>
__device__ __forceinline__ void store_scan(const float (&acc)[8][4], float* __restrict__ out,
                                           float* __restrict__ obs, int pb, int g, int t) {
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    if constexpr (kCLayout) {
      const int r = 16 * m + g;
      if (blockIdx.y == 0) {
        out[r * kPix + pb + 2 * t] = acc[m][0];
        out[r * kPix + pb + 2 * t + 1] = acc[m][1];
        out[(r + 8) * kPix + pb + 2 * t] = acc[m][2];
        out[(r + 8) * kPix + pb + 2 * t + 1] = acc[m][3];
      }
    } else {
      const int k0 = 16 * m + 2 * t;
      if (blockIdx.y == 0) {
        out[k0 * kPix + pb + g] = acc[m][0];
        out[(k0 + 1) * kPix + pb + g] = acc[m][1];
        out[(k0 + 8) * kPix + pb + g] = acc[m][2];
        out[(k0 + 9) * kPix + pb + g] = acc[m][3];
      }
    }
    sum += ((acc[m][0] + acc[m][1]) + acc[m][2]) + acc[m][3];
  }
  observe<kScanTcThreads>(sum, obs);
}

// ---- the tensor-core cumsums: a diagonal block a slab and a carried total ----
//
// out = L @ g, L the lower-triangular ones, slab by slab: slab s's output is
// the diagonal 16 x 16 block of L against slab s, its in-slab inclusive scan
// (one m16n8k16 product, two for split2: hi, then lo), on the C operand
// carry, the total of slabs 0, ..., s - 1. The 28 all-ones blocks below the
// diagonal, 28 of the 36 products a pass of L @ g, are not multiplied
// against an m-tile: an all-ones block against a slab is the slab's column
// total in all 16 rows, which the carry holds. Two ways to carry it, both
// measured on the H100 (PERF.md), each mode keeping the faster:
//   shuffles (split2): row 15 of slab s's result is the total through slab
//     s, the next slab's carry; two shuffles a slab hand it from the lanes
//     of row 15 (g = 7: lane 28 + t) to the lanes of its columns. 8 products
//     a pass (16 for split2), 14 shuffles.
//   all-ones product (bf16): the carry is a C fragment of its own, and each
//     slab but the last adds its all-ones product to it. 15 products a pass
//     (30), no shuffle.
// Every output adds slabs 0, 1, ..., s in order, hi before lo, in the tensor
// cores: the products and C values of the whole triangular product, in its
// order, so the output is bitwise that product's (row 15 of the diagonal
// block is all ones). A rep's result is added to the sum over reps in IEEE
// f32. What
// holds them: the operand and sum work (x + i, the packs, split2's split, the
// adds into the sums) and the carry, which do not overlap the products
// (stages: enum CumsumStage).

// Stages of the tensor-core cumsums (scan_tc_kernel<kAdd, mode, stage>), for
// timing what holds them back: kCsFull the production kernel; kCsProducts the
// diagonal products and the carry on x's operand made once, before the reps
// (a rep's carry starts from a 0 read from shared memory, so the compiler
// cannot do the reps' equal products once); kCsOperand x + i, the rounding
// and split2's split of every rep, no product: each operand register summed
// as an f32, the hi pair's into its odd splat, the lo pair's into its even
// one (0 there for bf16), as out (splat, pixel); kCsOtherCarry the
// production kernel with the mode's other carry.
enum CumsumStage { kCsFull = 0, kCsProducts = 1, kCsOperand = 2, kCsOtherCarry = 3 };

// acc += kReps reps' cumsums of a warp, reps i0, i0 + 1, ..., slab by slab,
// the reps side by side; kOnes: the carry by the all-ones product (A = full),
// else by the shuffles. xv: x's B elements (load_scan_b); op: x's hi and lo
// fragments by slab, made once (kCsProducts); zeros: the products stage's 0
// (rep_zero's role).
template <int kMode, int kStage, bool kOnes, int kReps>
__device__ __forceinline__ void cumsum_reps(const float (&xv)[8][4], const uint32_t (&op)[8][4],
                                            const uint32_t (&diag)[4], const uint32_t (&full)[4],
                                            int i0, const float* zeros, float (&acc)[8][4]) {
  const int t = threadIdx.x & 3;
  float carry[kReps][4], fi[kReps];
#pragma unroll
  for (int r = 0; r < kReps; ++r) {
    fi[r] = static_cast<float>(i0 + r);
    const float z = kStage == kCsProducts ? lds(zeros + ((i0 + r) & 31)) : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) carry[r][e] = z;
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int r = 0; r < kReps; ++r) {
      uint32_t hi[2], lo[2];
      if constexpr (kStage == kCsProducts) {
        hi[0] = op[s][0], hi[1] = op[s][1], lo[0] = op[s][2], lo[1] = op[s][3];
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = xv[s][e] + fi[r];
        slab_operand<kMode>(v, hi, lo);
      }
      if constexpr (kStage == kCsOperand) {
        acc[s][1] += __uint_as_float(hi[0]);
        acc[s][3] += __uint_as_float(hi[1]);
        if constexpr (kMode == kSplit2) {
          acc[s][0] += __uint_as_float(lo[0]);
          acc[s][2] += __uint_as_float(lo[1]);
        }
      } else {
        float d[4] = {carry[r][0], carry[r][1], carry[r][2], carry[r][3]};
        mma_bf16(d, diag, hi[0], hi[1]);
        if constexpr (kMode == kSplit2) mma_bf16(d, diag, lo[0], lo[1]);
        if (s < 7) {
          if constexpr (kOnes) {
            mma_bf16(carry[r], full, hi[0], hi[1]);
            if constexpr (kMode == kSplit2) mma_bf16(carry[r], full, lo[0], lo[1]);
          } else {  // row 15: c[2], c[3] of lane 28 + t
            carry[r][0] = carry[r][2] = __shfl_sync(kFull, d[2], 28 + t);
            carry[r][1] = carry[r][3] = __shfl_sync(kFull, d[3], 28 + t);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][e] += d[e];
      }
    }
  }
}

// Tensor cores: out (128 x 64 pixels of a CTA) = sum_i L @ r(x + i), r the
// bf16 rounding (kBf16) or hi + lo (kSplit2); a warp takes 8 pixels, two reps
// at a time (an odd last one alone).
template <int kMode, int kStage>
__device__ __forceinline__ void cumsum_tc(const float* __restrict__ x, float* __restrict__ out,
                                          float* __restrict__ obs, int reps) {
  constexpr bool kOnes = (kMode == kBf16) != (kStage == kCsOtherCarry);
  __shared__ float zeros[32];
  // the all-ones A fragment, read from shared memory: as a constant it was
  // made again, four moves, before every product that took it
  __shared__ uint4 ones;
  if constexpr (kStage == kCsProducts) set_rep_zeros(zeros);
  if (kOnes && threadIdx.x == 0) {
    const uint32_t o = pack_bf16(1.f, 1.f);
    ones = make_uint4(o, o, o, o);
  }
  if constexpr (kStage == kCsProducts || kOnes) __syncthreads();
  uint32_t full[4] = {};
  if constexpr (kOnes) {
    const uint4 f = lds_u4(&ones);
    full[0] = f.x, full[1] = f.y, full[2] = f.z, full[3] = f.w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pb = blockIdx.x * 64 + warp * 8;  // the warp's first pixel
  float xv[8][4];
  load_scan_b(x, pb, g, t, xv);
  uint32_t op[8][4] = {};
  if constexpr (kStage == kCsProducts) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t hi[2], lo[2] = {0u, 0u};
      slab_operand<kMode>(xv[s], hi, lo);
      op[s][0] = hi[0], op[s][1] = hi[1], op[s][2] = lo[0], op[s][3] = lo[1];
    }
  }
  const uint32_t diag[4] = {tri_pair(g, 2 * t), tri_pair(g + 8, 2 * t),
                            tri_pair(g, 2 * t + 8), tri_pair(g + 8, 2 * t + 8)};
  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  int i = 0;
  for (; i + 1 < reps; i += 2)
    cumsum_reps<kMode, kStage, kOnes, 2>(xv, op, diag, full, i, zeros, acc);
  if (i < reps) cumsum_reps<kMode, kStage, kOnes, 1>(xv, op, diag, full, i, zeros, acc);
  store_scan<kStage != kCsOperand>(acc, out, obs, pb, g, t);
}

// ---- the log-space cumprod ---------------------------------------------------

// Stages of the log-space cumprod (scan_tc_kernel<kMul, kSplit2>), for
// timing what holds it back: kScanFull the production kernel; kScanProducts
// the split2 L product of the masked -a, no log, no exp (out = its sum);
// kScanLogs the masked log2(1 - a) summed, no product, no exp; kScanExps
// 2^(masked -a) summed, no log, no product. The ablated stages keep the
// alpha, the mask, the sums over reps, the stores and the observer, so the
// compiler drops nothing; kScanLogs and kScanExps leave each value where
// its operand lies (the B fragment), as out (splat, pixel).
enum ScanStage { kScanFull = 0, kScanProducts = 1, kScanLogs = 2, kScanExps = 3 };

// Tensor cores: out (128 x 64 pixels of a CTA) = exp2(L @ log2 g) in split2,
// the whole triangular product: a warp takes 8 pixels (one n-tile) and all 8
// m-tiles; L is exact in bf16 and made in registers; blocks above the
// diagonal are zero and skipped (36 of 64 remain). It works in base 2: g =
// log2(1 - a) by log2_1m_* on the FMA pipe, the cumprod 2^(L @ g) by one ex2
// (MUFU) per element; the libm log1pf and expf it replaces were several
// dozen instructions each.
template <int kStage>
__device__ __forceinline__ void log_cumprod_tc(const float* __restrict__ x,
                                               float* __restrict__ out,
                                               float* __restrict__ obs, int reps) {
  constexpr bool kProducts = kStage == kScanFull || kStage == kScanProducts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pb = blockIdx.x * 64 + warp * 8;  // the warp's first pixel
  float xv[8][4];
  load_scan_b(x, pb, g, t, xv);
  const uint32_t ones = pack_bf16(1.f, 1.f);
  const uint32_t diag[4] = {tri_pair(g, 2 * t), tri_pair(g + 8, 2 * t),
                            tri_pair(g, 2 * t + 8), tri_pair(g + 8, 2 * t + 8)};
  const uint32_t full[4] = {ones, ones, ones, ones};
  float acc[8][4];  // C fragments; B fragments for kScanLogs and kScanExps
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  // the largest x of the thread: a rep's alphas reach past 0.5 only where
  // xmax ci does (the clip and the rounding of x ci keep the order)
  float xmax = xv[0][0];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) xmax = fmaxf(xmax, xv[s][e]);
  float c[8][4];
  // One rep. kFar: some lane's alpha exceeds 0.5, so its log needs the
  // exponent of 1 - a (log2_1m_far); a warp-uniform choice between two
  // straight-line bodies, the far one taken in few reps (none below c_i =
  // 0.5 / max x)
  auto rep = [&](int i, auto far) {
    constexpr bool kFar = decltype(far)::value;
    const float ci = rep_scale(i);
    // slab s (splats 16 s ... 16 s + 15) of the operand, then its products
    // into the sums c[m] of every m >= s: the tensor cores work on slab s
    // while the FMA pipe makes slab s + 1. Each c[m] still adds s = 0, 1,
    // ..., m in order, hi before lo
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][e] = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = alpha_sat(xv[s][e], ci);
        float g;  // log2(1 - a), or -a for the stages without logs
        if constexpr (kStage == kScanFull || kStage == kScanLogs) {
          g = log2_1m_near(a);
          if constexpr (kFar) g = select(a > 0.5f, log2_1m_far(a), g);
        } else {
          g = -a;
        }
        v[e] = select(a > 0.003f, g, 0.f);
        if constexpr (kStage == kScanLogs) acc[s][e] += v[e];
        if constexpr (kStage == kScanExps) acc[s][e] += exp2_fast(v[e]);
      }
      if constexpr (!kProducts) continue;
      uint32_t hi[2], lo[2];
      slab_operand<kSplit2>(v, hi, lo);
#pragma unroll
      for (int m = s; m < 8; ++m) {
        mma_bf16(c[m], s == m ? diag : full, hi[0], hi[1]);
        mma_bf16(c[m], s == m ? diag : full, lo[0], lo[1]);
      }
    }
    if constexpr (kProducts) {
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][e] += kStage == kScanFull ? exp2_fast(c[m][e]) : c[m][e];
    }
  };
  for (int i = 0; i < reps; ++i) {
    const bool far = (kStage == kScanFull || kStage == kScanLogs) &&
                     __any_sync(kFull, xmax * rep_scale(i) > 0.5f);
    if (far)
      rep(i, std::true_type{});
    else
      rep(i, std::false_type{});
  }
  store_scan<kProducts>(acc, out, obs, pb, g, t);
}

// The tensor-core scans: kAdd the cumsums (cumsum_tc, stage enum
// CumsumStage), kMul the log-space cumprod in split2 (log_cumprod_tc, enum
// ScanStage)
template <int kOp, int kMode, int kStage = 0>
__global__ void __launch_bounds__(kScanTcThreads)
scan_tc_kernel(const float* __restrict__ x, float* __restrict__ out, float* __restrict__ obs,
               int reps) {
  if constexpr (kOp == kAdd)
    cumsum_tc<kMode, kStage>(x, out, obs, reps);
  else
    log_cumprod_tc<kStage>(x, out, obs, reps);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int parts, int threads, int tiles, cudaStream_t stream, Args... args) {
  kernel<<<dim3(parts, tiles), threads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// launch with `smem` bytes of dynamic shared memory, which may pass 48 KB
template <typename Kernel, typename... Args>
int launch_smem(Kernel kernel, int smem, int parts, int threads, int tiles, cudaStream_t stream,
                Args... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(parts, tiles), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int moments_tf32x3(int stage, const float* x, float* out, float* obs, int reps, int tiles,
                   cudaStream_t s) {
  switch (stage) {
    case kTf32Full:
      return launch_smem(moments_tf32x3_kernel<kTf32Full>, kMomTf32Smem, kMomTcParts, kMomThreads,
                         tiles, s, x, out, obs, reps);
    case kTf32Products:
      return launch_smem(moments_tf32x3_kernel<kTf32Products>, kMomTf32Smem, kMomTcParts,
                         kMomThreads, tiles, s, x, out, obs, reps);
    case kTf32Split:
      return launch_smem(moments_tf32x3_kernel<kTf32Split>, kMomTf32Smem, kMomTcParts,
                         kMomThreads, tiles, s, x, out, obs, reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int acc_tf32x3(int stage, const float* x, const float* sw, float* out, float* obs, int reps,
               int tiles, cudaStream_t s) {
  switch (stage) {
    case kTf32Full:
      return launch(acc_tf32x3_kernel<kTf32Full>, kAccParts, kAccTcThreads, tiles, s, x, sw, out,
                    obs, reps);
    case kTf32Products:
      return launch(acc_tf32x3_kernel<kTf32Products>, kAccParts, kAccTcThreads, tiles, s, x, sw,
                    out, obs, reps);
    case kTf32Split:
      return launch(acc_tf32x3_kernel<kTf32Split>, kAccParts, kAccTcThreads, tiles, s, x, sw, out,
                    obs, reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kMode>
int cumsum_stage(int stage, const float* x, float* out, float* obs, int reps, int tiles,
                 cudaStream_t s) {
  switch (stage) {
    case kCsFull:
      return launch(scan_tc_kernel<kAdd, kMode, kCsFull>, kScanParts, kScanTcThreads, tiles, s, x,
                    out, obs, reps);
    case kCsProducts:
      return launch(scan_tc_kernel<kAdd, kMode, kCsProducts>, kScanParts, kScanTcThreads, tiles, s,
                    x, out, obs, reps);
    case kCsOperand:
      return launch(scan_tc_kernel<kAdd, kMode, kCsOperand>, kScanParts, kScanTcThreads, tiles, s,
                    x, out, obs, reps);
    case kCsOtherCarry:
      return launch(scan_tc_kernel<kAdd, kMode, kCsOtherCarry>, kScanParts, kScanTcThreads, tiles,
                    s, x, out, obs, reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int moments_cuda(int stage, const float* x, float* out, float* obs, int reps, int tiles,
                 cudaStream_t s) {
  switch (stage) {
    case kCudaFull:
      return launch(moments_cuda_kernel<kCudaFull>, kMomCudaParts, kMomThreads, tiles, s, x, out,
                    obs, reps);
    case kCudaLoads:
      return launch(moments_cuda_kernel<kCudaLoads>, kMomCudaParts, kMomThreads, tiles, s, x, out,
                    obs, reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int acc_cuda(int stage, const float* x, const float* sw, float* out, float* obs, int reps,
             int tiles, cudaStream_t s) {
  switch (stage) {
    case kCudaFull:
      return launch(acc_cuda_kernel<kCudaFull>, kAccParts, kAccCudaThreads, tiles, s, x, sw, out,
                    obs, reps);
    case kCudaLoads:
      return launch(acc_cuda_kernel<kCudaLoads>, kAccParts, kAccCudaThreads, tiles, s, x, sw, out,
                    obs, reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int reshape_cuda(int stage, const float* x, float* out, float* obs, int reps, int tiles,
                 cudaStream_t s) {
  const dim3 grid(kReshapeParts, (tiles + kReshapeTiles - 1) / kReshapeTiles);
  if (stage == kCudaFull)
    reshape_kernel<kCudaFull><<<grid, kReshapeThreads, 0, s>>>(x, out, obs, reps, tiles);
  else if (stage == kCudaLoads)
    reshape_kernel<kCudaLoads><<<grid, kReshapeThreads, 0, s>>>(x, out, obs, reps, tiles);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int moments_bf16(int stage, const float* x, float* out, float* obs, int reps, int tiles,
                 cudaStream_t s) {
  switch (stage) {
    case kBf16Full:
      return launch(moments_bf16_kernel<kBf16Full>, kMomTcParts, kMomThreads, tiles, s, x, out,
                    obs, reps);
    case kBf16Loads:
      return launch(moments_bf16_kernel<kBf16Loads>, kMomTcParts, kMomThreads, tiles, s, x, out,
                    obs, reps);
    case kBf16Operands:
      return launch(moments_bf16_kernel<kBf16Operands>, kMomTcParts, kMomThreads, tiles, s, x,
                    out, obs, reps);
    case kBf16Products:
      return launch(moments_bf16_kernel<kBf16Products>, kMomTcParts, kMomThreads, tiles, s, x,
                    out, obs, reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int acc_bf16(int stage, const float* x, const float* sw, float* out, float* obs, int reps,
             int tiles, cudaStream_t s) {
  const int n = kAccBf16Threads;
  switch (stage) {
    case kBf16Full:
      return launch(acc_bf16_kernel<kBf16Full>, kAccBf16Parts, n, tiles, s, x, sw, out, obs, reps);
    case kBf16Loads:
      return launch(acc_bf16_kernel<kBf16Loads>, kAccBf16Parts, n, tiles, s, x, sw, out, obs, reps);
    case kBf16Operands:
      return launch(acc_bf16_kernel<kBf16Operands>, kAccBf16Parts, n, tiles, s, x, sw, out, obs,
                    reps);
    case kBf16Products:
      return launch(acc_bf16_kernel<kBf16Products>, kAccBf16Parts, n, tiles, s, x, sw, out, obs,
                    reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int scan_cuda(int op, int stage, const float* x, float* out, float* obs, int reps, int tiles,
              cudaStream_t s) {
  const dim3 grid(kScanParts, tiles);
  const int smem = stage == kCudaFull && scan_walks(reps) > 1 ? kWalkSmem : 0;
  if (op == kAdd && stage == kCudaFull)
    cumsum_cuda_kernel<kCudaFull><<<grid, kScanCudaThreads, smem, s>>>(x, out, obs, reps);
  else if (op == kAdd && stage == kCudaLoads)
    cumsum_cuda_kernel<kCudaLoads><<<grid, kScanCudaThreads, smem, s>>>(x, out, obs, reps);
  else if (op == kMul && stage == kCudaFull)
    cumprod_cuda_kernel<kCudaFull><<<grid, kScanCudaThreads, smem, s>>>(x, out, obs, reps);
  else if (op == kMul && stage == kCudaLoads)
    cumprod_cuda_kernel<kCudaLoads><<<grid, kScanCudaThreads, smem, s>>>(x, out, obs, reps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int moments_parts(int mode) {
  return mode == kCuda ? kMomCudaParts : mode == kBf16 || mode == kTf32x3 ? kMomTcParts : -1;
}

int acc_parts(int mode) {
  return mode == kBf16 ? kAccBf16Parts : mode == kCuda || mode == kTf32x3 ? kAccParts : -1;
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
  if (mode == kCuda) return moments_cuda(kCudaFull, x, out, obs, reps, tiles, s);
  if (mode == kBf16) return moments_bf16(kBf16Full, x, out, obs, reps, tiles, s);
  if (mode == kTf32x3) return moments_tf32x3(kTf32Full, x, out, obs, reps, tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int moss_mxu_reshape_parts() { return kReshapeParts; }

extern "C" int moss_mxu_reshape(const float* x, float* out, float* obs, int reps, int tiles,
                                void* stream) {
  return reshape_cuda(kCudaFull, x, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

extern "C" int moss_mxu_acc_parts(int mode) { return acc_parts(mode); }

extern "C" int moss_mxu_acc(const float* x, const float* sw, float* out, float* obs, int reps,
                            int tiles, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCuda: return acc_cuda(kCudaFull, x, sw, out, obs, reps, tiles, s);
    case kBf16: return acc_bf16(kBf16Full, x, sw, out, obs, reps, tiles, s);
    case kTf32x3: return acc_tf32x3(kTf32Full, x, sw, out, obs, reps, tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int moss_mxu_scan_parts(int op, int mode) { return scan_parts(op, mode); }

extern "C" int moss_mxu_scan(const float* x, float* out, float* obs, int reps, int tiles, int op,
                             int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int parts = kScanParts;
  if (mode == kCuda && (op == kAdd || op == kMul))
    return scan_cuda(op, kCudaFull, x, out, obs, reps, tiles, s);
  if (op == kAdd && mode == kBf16) return cumsum_stage<kBf16>(kCsFull, x, out, obs, reps, tiles, s);
  if (op == kAdd && mode == kSplit2)
    return cumsum_stage<kSplit2>(kCsFull, x, out, obs, reps, tiles, s);
  if (op == kMul && mode == kSplit2)
    return launch(scan_tc_kernel<kMul, kSplit2>, parts, kScanTcThreads, tiles, s, x, out, obs,
                  reps);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Stage `stage` (enum ScanStage) of the log-space cumprod, launched as
// moss_mxu_scan(op 1, mode 3) is, with its observer (tiles, its parts);
// cudaErrorInvalidValue for an unknown stage.
extern "C" int moss_mxu_scan_stage(const float* x, float* out, float* obs, int reps, int tiles,
                                   int stage, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kScanFull:
      return launch(scan_tc_kernel<kMul, kSplit2, kScanFull>, kScanParts, kScanTcThreads, tiles,
                    s, x, out, obs, reps);
    case kScanProducts:
      return launch(scan_tc_kernel<kMul, kSplit2, kScanProducts>, kScanParts, kScanTcThreads,
                    tiles, s, x, out, obs, reps);
    case kScanLogs:
      return launch(scan_tc_kernel<kMul, kSplit2, kScanLogs>, kScanParts, kScanTcThreads, tiles,
                    s, x, out, obs, reps);
    case kScanExps:
      return launch(scan_tc_kernel<kMul, kSplit2, kScanExps>, kScanParts, kScanTcThreads, tiles,
                    s, x, out, obs, reps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Stage `stage` (enum CumsumStage) of the tensor-core cumsum of mode `mode`
// (1 bf16, 3 split2), launched as moss_mxu_scan(op 0, mode) is, with its
// observer (tiles, its parts); cudaErrorInvalidValue for an unknown mode or
// stage.
extern "C" int moss_mxu_cumsum_stage(const float* x, float* out, float* obs, int reps, int tiles,
                                     int mode, int stage, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kBf16) return cumsum_stage<kBf16>(stage, x, out, obs, reps, tiles, s);
  if (mode == kSplit2) return cumsum_stage<kSplit2>(stage, x, out, obs, reps, tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Stage `stage` (enum Tf32Stage) of the 3xTF32 moments or accumulator
// kernel, launched as moss_mxu_moments or moss_mxu_acc with mode 2 is, with
// its observer (tiles, their parts); cudaErrorInvalidValue for an unknown
// stage.
extern "C" int moss_mxu_moments_stage(const float* x, float* out, float* obs, int reps,
                                      int tiles, int stage, void* stream) {
  return moments_tf32x3(stage, x, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

extern "C" int moss_mxu_acc_stage(const float* x, const float* sw, float* out, float* obs,
                                  int reps, int tiles, int stage, void* stream) {
  return acc_tf32x3(stage, x, sw, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

// Stage `stage` (enum CudaStage) of the CUDA-core moments, accumulator,
// reshape, cumsum or cumprod kernel, launched as moss_mxu_moments or
// moss_mxu_acc with mode 0, moss_mxu_reshape, or moss_mxu_scan with op 0 or 1
// and mode 0, is, with its observer (tiles, their parts);
// cudaErrorInvalidValue for an unknown stage.
extern "C" int moss_mxu_moments_cuda_stage(const float* x, float* out, float* obs, int reps,
                                           int tiles, int stage, void* stream) {
  return moments_cuda(stage, x, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

extern "C" int moss_mxu_acc_cuda_stage(const float* x, const float* sw, float* out, float* obs,
                                       int reps, int tiles, int stage, void* stream) {
  return acc_cuda(stage, x, sw, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

extern "C" int moss_mxu_reshape_cuda_stage(const float* x, float* out, float* obs, int reps,
                                           int tiles, int stage, void* stream) {
  return reshape_cuda(stage, x, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

extern "C" int moss_mxu_cumsum_cuda_stage(const float* x, float* out, float* obs, int reps,
                                          int tiles, int stage, void* stream) {
  return scan_cuda(kAdd, stage, x, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

extern "C" int moss_mxu_cumprod_cuda_stage(const float* x, float* out, float* obs, int reps,
                                           int tiles, int stage, void* stream) {
  return scan_cuda(kMul, stage, x, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

// Stage `stage` (enum Bf16Stage) of the bf16 moments or accumulator kernel,
// launched as moss_mxu_moments or moss_mxu_acc with mode 1 is, with its
// observer (tiles, their parts); cudaErrorInvalidValue for an unknown stage.
extern "C" int moss_mxu_moments_bf16_stage(const float* x, float* out, float* obs, int reps,
                                           int tiles, int stage, void* stream) {
  return moments_bf16(stage, x, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

extern "C" int moss_mxu_acc_bf16_stage(const float* x, const float* sw, float* out, float* obs,
                                       int reps, int tiles, int stage, void* stream) {
  return acc_bf16(stage, x, sw, out, obs, reps, tiles, static_cast<cudaStream_t>(stream));
}

// CTAs an SM of a kernel's production form at its block size and with no
// dynamic shared memory, as the runtime's occupancy query gives them: 0 the
// CUDA-core moments, 1 the CUDA-core accumulators, 2 the CUDA-core cumprod
// (its launches of at most 16 reps), 3 the bf16 moments, 4 the CUDA-core
// cumsum (as the cumprod), 5 the bf16 accumulators, 6 the reshape; -1 for an
// unknown kernel, or the query's error negated.
extern "C" int moss_mxu_ctas_per_sm(int kernel) {
  int n = 0;
  cudaError_t e;
  if (kernel == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, moments_cuda_kernel<kCudaFull>,
                                                      kMomThreads, 0);
  else if (kernel == 1)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, acc_cuda_kernel<kCudaFull>,
                                                      kAccCudaThreads, 0);
  else if (kernel == 2)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cumprod_cuda_kernel<kCudaFull>,
                                                      kScanCudaThreads, 0);
  else if (kernel == 3)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, moments_bf16_kernel<kBf16Full>,
                                                      kMomThreads, 0);
  else if (kernel == 4)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cumsum_cuda_kernel<kCudaFull>,
                                                      kScanCudaThreads, 0);
  else if (kernel == 5)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, acc_bf16_kernel<kBf16Full>,
                                                      kAccBf16Threads, 0);
  else if (kernel == 6)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, reshape_kernel<kCudaFull>,
                                                      kReshapeThreads, 0);
  else
    return -1;
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The tensor-core moments' and accumulators' layouts, on the host, for
// their Python copies: family 0 writes mom_pixel(w, s, col) for w < 8, s <
// 16, col < 8 into out (1,024 ints, in that order), family 1 acc_pixel(w, r)
// for w < 8, r < 16 (128), family 2 mom_bf16_pixel(w, s, col) for w < 8, s <
// 8, col < 16 (1,024); returns the count written, -1 for an unknown family.
extern "C" int moss_mxu_tc_order(int family, int* out) {
  constexpr int kWarps = kMomThreads / 32;
  if (family == 2) {
    for (int w = 0; w < kWarps; ++w)
      for (int s = 0; s < kBf16Steps; ++s)
        for (int col = 0; col < 16; ++col)
          out[(w * kBf16Steps + s) * 16 + col] = mom_bf16_pixel(w, s, col);
    return kWarps * kBf16Steps * 16;
  }
  if (family == 0) {
    for (int w = 0; w < kWarps; ++w)
      for (int s = 0; s < kTf32Steps; ++s)
        for (int col = 0; col < 8; ++col)
          out[(w * kTf32Steps + s) * 8 + col] = mom_pixel(w, s, col);
    return kWarps * kTf32Steps * 8;
  }
  if (family == 1) {
    for (int w = 0; w < kAccTcThreads / 32; ++w)
      for (int r = 0; r < 16; ++r) out[w * 16 + r] = acc_pixel(w, r);
    return kAccTcThreads / 32 * 16;
  }
  return -1;
}

