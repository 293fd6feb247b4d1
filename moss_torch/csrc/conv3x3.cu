// 3x3 SAME convolution + bias (+ relu) over one NHWC image, accumulated in
// f32: the LPIPS VGG layer. Two kernels:
//
//   conv3x3_tc_kernel  bf16 inputs, an implicit GEMM on the tensor cores
//                      (wgmma, A from registers, B from shared memory);
//   conv3x3_kernel     f32 inputs, and bf16 shapes the tensor-core kernel
//                      does not take (Cin or Cout not a multiple of 8): a
//                      direct conv on the f32 CUDA cores.
//
// Replaces tools/conv_pallas_proto.py::_conv_kernel (:28), launched by
// conv3x3_fused (:49-82). Contract (conv3x3_fused and ref_conv, :85-89):
// x (H, W, Cin), w (3, 3, Cin, Cout) HWIO and b (Cout,) all in x's type
// (the caller casts w and b to it, as :66 and :82 do), zero padding of one
// pixel on each side, products of the inputs summed in f32, then
// y = sum + float(b), relu if asked, rounded once to the output type.
//
// What bounds it on the H100: operations. A VGG16 layer does 2 H W Cin Cout
// 9 FLOPs against a few MB of activations and weights, so in bf16 only the
// tensor cores (989 TFLOP/s dense) come near its bound; the f32 CUDA cores
// (67 TFLOP/s) reach a fifteenth of it.
//
// The tensor-core kernel. GEMM view: M = the output pixels of a CTA tile
// (4 rows of 16 per consumer warpgroup, one row per warp), N = kBN output
// channels, K = 9 taps x Cin, walked in steps (chunk of 64 input channels,
// tap). One producer warp feeds a ring of kStages weight slots by TMA, each
// guarded by two mbarriers (data in, slot free): a step's slot receives
// w[tap] for the chunk, a (64, kBN) slice of the HWIO weights as they lie
// (N-contiguous rows), which TMA's 128-byte swizzle lays out as the
// canonical MN-major operand that wgmma reads with its transpose bit, so no
// call re-lays out w. At a chunk's first tap the step's copy also brings the
// chunk's halo tile, (rows + 2) x 18 pixels x 64 channels, one 128-byte row a
// pixel, into one of two halo buffers; TMA's out-of-bounds zero fill gives the
// padding, the image edge and the channels past Cin. The halo tile serves all
// nine taps: a tap's A fragment is an ldmatrix of the tile at rows shifted
// by (dy, dx), undoing the swizzle (piece q of pixel p at q ^ (p & 7)), which
// is why A comes from registers (a shifted window of a halo tile is no
// canonical wgmma layout). The consumers run four m64nNk16 wgmmas a step
// and keep one step's wgmmas in flight while they load the next step's A.
// CTAs are persistent: each walks several tiles and the ring runs on across
// them, so the producer fetches the next tile while the consumers finish this
// one. The epilogue adds the bias in f32, applies relu, rounds once and masks
// the ragged edges (H, W not multiples of the tile, Cout not a multiple of
// kBN). Every output element is summed by one thread in a fixed order (no
// split-K, no atomics): two calls give the same bits. Three tiles (8 x 16
// pixels x 128 or 64 channels, 4 x 16 x 64), chosen per layer by the caller;
// the smallest keeps the 32 x 32 layer's 128 tiles on most SMs.
// What holds it below the tensor cores' rate is timed by its stages (enum
// Stage; moss_torch/tools/conv_proto.py, PERF.md): on the 128-channel tile
// the products alone (ldmatrix and wgmma, no copies) take most of the full
// kernel's time and the copies alone clearly less, and the ldmatrix of A
// adds little to either; the wgmmas alone run faster the more steps a tile
// has, so a fixed cost per tile (the ring's fill, the drain at each chunk's
// end, the epilogue, which no other warpgroup's products hide) is the
// largest loss on the short-K layers. The 128-channel tile's 163 registers
// keep it at one CTA an SM.
//
// The f32 path stays on the CUDA cores: its gate is an absolute 1e-4
// (tools/conv_pallas_proto.py:102), which one-pass TF32 cannot meet at
// K = 576, and 3xTF32 lost to the CUDA cores at small K on this card
// (tools/mxu_micro.py's port). conv3x3_kernel: a CTA owns rows x 16 pixels
// and 8-64 output channels (kF32Tiles); each thread keeps 4 pixels x 4 or 8
// channels in registers and does 16-32 FMAs per shared-memory weight load.
// What bounds it: at check()'s shapes (2,048-4,096 pixels, K = 72-576) the
// f32 operations take 2.5 us at the CUDA cores' peak, but one 8 x 16 x 64
// CTA per pixel tile is 16-32 CTAs on 132 SMs, each walking all of K alone:
// latency and occupancy, not operations or bytes. So the host picks, per
// shape, the tile whose channels fit Cout (no FMAs on zero weights) and
// splits the K walk over the `split` CTAs of a thread-block cluster
// (ops/conv3x3.py::f32_tile) until the grid covers the SMs. K is walked in
// steps of 8 input channels and all three kernel rows, or one row where the
// CTAs of a cluster cannot share the chunks of 8 channels evenly; each CTA
// sums its contiguous run of steps, copying the next step's halo and
// weights by cp.async (zero filled at the edges) while it does this step's
// FMAs. The partials meet in distributed shared memory: CTA rank q adds the
// q-th slice of the tile over ranks 0, 1, ... in that order, then the bias,
// relu and one rounding. One launch, no atomics and no second pass; every
// output element is summed in an order fixed by the shape, so two calls
// give the same bits. Large layers get a split of 1: one CTA per tile, as
// before, with the copies overlapped and a third of the steps.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype / .to do
}

// ---------------------------------------------------------------------------
// CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kPix = 4;       // pixels of a thread (one row)
constexpr int kTileW = 16;    // pixels of a tile row
constexpr int kCi = 8;        // input channels of a step
constexpr int kInW = kTileW + 2;
constexpr int kMaxSplit = 8;  // CTAs of a cluster (the portable limit)
constexpr int kMaxThreads = 256;

// A CTA tile: rows x 16 pixels x `channels` output channels, each thread
// kPix pixels x `per_thread` channels
struct F32Tile {
  int rows, channels, per_thread;
  __host__ __device__ constexpr int threads() const {
    return rows * (kTileW / kPix) * (channels / per_thread);
  }
  // one step's halo (rows + ky - 1 rows x 18 pixels x 8 channels) and its
  // ky kernel rows' weights (ky x 3 x 8 x channels), f32
  __host__ __device__ constexpr int stage_floats(int ky) const {
    return (rows + ky - 1) * kInW * kCi + ky * 3 * kCi * channels;
  }
  __host__ __device__ constexpr int partial_floats() const { return rows * kTileW * channels; }
  constexpr int smem_bytes(int split, int ky) const {
    const int stages = 2 * stage_floats(ky);
    return 4 * (split > 1 && partial_floats() > stages ? partial_floats() : stages);
  }
  // kernel rows a step takes: all three where the split's CTAs can share
  // the chunks of 8 input channels evenly (fewer steps, the halo copied
  // once per chunk), else one, so that the K walk cuts finely enough
  static constexpr int ky_per_step(int cin, int split) {
    return ((cin + kCi - 1) / kCi) % split == 0 ? 3 : 1;
  }
};

// by tile code (ops/conv3x3.py::f32_tile picks one per shape)
constexpr F32Tile kF32Tiles[] = {{8, 64, 8}, {4, 64, 8}, {8, 32, 8}, {4, 32, 8}, {8, 16, 4},
                                 {4, 16, 4}, {2, 16, 4}, {8, 8, 4},  {4, 8, 4}};
constexpr int kF32TileCount = sizeof(kF32Tiles) / sizeof(kF32Tiles[0]);

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// *dst = ok ? float(*src) : 0. f32: a 4-byte cp.async, zero-filled (no
// read) where !ok; bf16 (elements of 2 bytes, which cp.async does not take
// one by one): a load and a store
__device__ __forceinline__ void stage_elem(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void stage_elem(float* dst, const bf16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;
}
// four f32 at once (dst and src 16-byte aligned), zero-filled where !ok
__device__ __forceinline__ void stage_vec4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(ok ? 16 : 0) : "memory");
}

// grid (tiles x split, channel tiles), clusters of `split` CTAs along x.
// The n = (3 / kKy) ceil(Cin / 8) steps are (chunk of 8 input channels, kKy
// kernel rows) in that order; cluster rank r sums steps [r n / split,
// (r + 1) n / split) in order, each from a double-buffered copy of its halo
// and weights. vec_w: the weights go by 16-byte copies (f32, Cout % 4 == 0,
// w 16-byte aligned); `channels` is a power of two
template <typename Tin, typename Tout, int kCoT, int kKy>
__global__ void __launch_bounds__(kMaxThreads)
conv3x3_kernel(const Tin* __restrict__ x,    // (H, W, cin)
               const Tin* __restrict__ w,    // (3, 3, cin, cout)
               const Tin* __restrict__ b,    // (cout,)
               Tout* __restrict__ out,       // (H, W, cout)
               int H, int W, int cin, int cout, int relu, int rows, int channels, int split,
               int vec_w)
{
  extern __shared__ __align__(16) float smem[];
  const int ch_shift = __ffs(channels) - 1;
  const int strips = rows * (kTileW / kPix);
  const int halo_rows = rows + kKy - 1;
  const int halo_floats = halo_rows * kInW * kCi;
  const int stage_floats = halo_floats + kKy * 3 * kCi * channels;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tile = blockIdx.x / split, rank = blockIdx.x % split;
  const int y0 = (tile / tiles_w) * rows;
  const int x0 = (tile % tiles_w) * kTileW;
  const int co0 = blockIdx.y * channels;
  const int t = threadIdx.x, nt = blockDim.x;
  const int strip = t % strips, cg = t / strips;  // a warp's strips share their channels
  const int sy = strip / (kTileW / kPix);
  const int sx = (strip % (kTileW / kPix)) * kPix;
  constexpr int kRowSteps = 3 / kKy;  // steps of a chunk
  const int steps = kRowSteps * ((cin + kCi - 1) / kCi);
  const int s0 = rank * steps / split, s1 = (rank + 1) * steps / split;

  auto stage = [&](int s, float* buf) {
    const int ci0 = (s / kRowSteps) * kCi, ky0 = (s % kRowSteps) * kKy;
    for (int i = t; i < halo_floats; i += nt) {
      const int c = i % kCi, p = i / kCi;
      const int iy = p / kInW, ix = p % kInW;
      const int yy = y0 - 1 + ky0 + iy, xx = x0 - 1 + ix;
      const bool ok = ci0 + c < cin && yy >= 0 && yy < H && xx >= 0 && xx < W;
      stage_elem(&buf[(c * halo_rows + iy) * kInW + ix],
                 x + (ok ? (static_cast<size_t>(yy) * W + xx) * cin + ci0 + c : 0), ok);
    }
    // (kKy x 3 taps, 8 channels c, channels): row = tap * 8 + c, the tap
    // (ky0 + tap / 3, tap % 3) of w
    float* s_w = buf + halo_floats;
    if constexpr (sizeof(Tin) == 4) {
      if (vec_w) {
        for (int i = t; i < kKy * 3 * kCi * channels / 4; i += nt) {
          const int co = (i << 2) & (channels - 1), row = (i << 2) >> ch_shift;
          const int c = row & (kCi - 1), tap = ky0 * 3 + (row >> 3);
          const bool ok = ci0 + c < cin && co0 + co < cout;
          stage_vec4(&s_w[i << 2],
                     w + (ok ? (static_cast<size_t>(tap) * cin + ci0 + c) * cout + co0 + co : 0),
                     ok);
        }
        cp_async_commit();
        return;
      }
    }
    for (int i = t; i < kKy * 3 * kCi * channels; i += nt) {
      const int co = i & (channels - 1), row = i >> ch_shift;
      const int c = row & (kCi - 1), tap = ky0 * 3 + (row >> 3);
      const bool ok = ci0 + c < cin && co0 + co < cout;
      stage_elem(&s_w[i],
                 w + (ok ? (static_cast<size_t>(tap) * cin + ci0 + c) * cout + co0 + co : 0),
                 ok);
    }
    cp_async_commit();
  };

  float acc[kPix][kCoT];
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int o = 0; o < kCoT; ++o) acc[p][o] = 0.0f;

  if (s0 < s1) stage(s0, smem);
  for (int s = s0; s < s1; ++s) {
    const float* buf = smem + ((s - s0) & 1) * stage_floats;
    if (s + 1 < s1) {
      stage(s + 1, smem + ((s + 1 - s0) & 1) * stage_floats);
      cp_async_wait<1>();  // step s has landed; s + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_w = buf + halo_floats + cg * kCoT;
#pragma unroll 2
    for (int c = 0; c < kCi; ++c) {
#pragma unroll
      for (int ky = 0; ky < kKy; ++ky) {
        float in[kPix + 2];
#pragma unroll
        for (int j = 0; j < kPix + 2; ++j) in[j] = buf[(c * halo_rows + sy + ky) * kInW + sx + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[kCoT];
#pragma unroll
          for (int q = 0; q < kCoT / 4; ++q) {
            const float4 v4 = reinterpret_cast<const float4*>(
                &s_w[((ky * 3 + kx) * kCi + c) * channels])[q];
            wv[4 * q] = v4.x;
            wv[4 * q + 1] = v4.y;
            wv[4 * q + 2] = v4.z;
            wv[4 * q + 3] = v4.w;
          }
#pragma unroll
          for (int p = 0; p < kPix; ++p)
#pragma unroll
            for (int o = 0; o < kCoT; ++o) acc[p][o] = fmaf(in[p + kx], wv[o], acc[p][o]);
        }
      }
    }
    __syncthreads();  // the stage two steps on overwrites this buffer
  }

  if (split == 1) {
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
    return;
  }

  // Split K: each CTA's partial sums into its shared memory; rank q then
  // finishes the q-th slice of the tile, adding the partials of ranks 0, 1,
  // ... in that order through distributed shared memory
  namespace cg_ = cooperative_groups;
  cg_::cluster_group cluster = cg_::this_cluster();
  float* part = smem;  // (rows x 16 pixels, channels); every copy has landed
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int q = 0; q < kCoT / 4; ++q)
      reinterpret_cast<float4*>(&part[((sy * kTileW + sx + p) * channels) + cg * kCoT])[q] =
          make_float4(acc[p][4 * q], acc[p][4 * q + 1], acc[p][4 * q + 2], acc[p][4 * q + 3]);
  cluster.sync();
  const int n = rows * kTileW * channels;
  for (int e = rank * n / split + t; e < (rank + 1) * n / split; e += nt) {
    float p[kMaxSplit];  // every rank's partial in flight at once, then added in rank order
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      p[r] = r < split ? cluster.map_shared_rank(part, r)[e] : 0.f;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < split) v += p[r];
    const int pix = e >> ch_shift, co = co0 + (e & (channels - 1));
    const int yy = y0 + pix / kTileW, xx = x0 + pix % kTileW;
    if (co < cout && yy < H && xx < W) {
      float y = v + to_float(b[co]);
      if (relu) y = fmaxf(y, 0.0f);
      out[(static_cast<size_t>(yy) * W + xx) * cout + co] = from_float<Tout>(y);
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its partials
}

template <typename Tin, typename Tout, int kCoT, int kKy>
int launch_f32_tile(const F32Tile& tl, const void* x, const void* w, const void* b, void* out,
                    int H, int W, int cin, int cout, int relu, int split, cudaStream_t stream) {
  const int vec_w =
      sizeof(Tin) == 4 && cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = conv3x3_kernel<Tin, Tout, kCoT, kKy>;
  const int tiles = ((H + tl.rows - 1) / tl.rows) * ((W + kTileW - 1) / kTileW);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split, (cout + tl.channels - 1) / tl.channels);
  cfg.blockDim = dim3(tl.threads());
  cfg.dynamicSmemBytes = tl.smem_bytes(split, kKy);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const Tin*>(x), static_cast<const Tin*>(w),
                         static_cast<const Tin*>(b), static_cast<Tout*>(out), H, W, cin, cout,
                         relu, tl.rows, tl.channels, split, vec_w);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch(const void* x, const void* w, const void* b, void* out, int H, int W, int cin,
           int cout, int relu, int tile, int split, cudaStream_t stream) {
  if (tile < 0 || tile >= kF32TileCount || split < 1 || split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const F32Tile& tl = kF32Tiles[tile];
  const bool rows3 = F32Tile::ky_per_step(cin, split) == 3;
  const auto args = [&](auto kernel_launch) {
    return kernel_launch(tl, x, w, b, out, H, W, cin, cout, relu, split, stream);
  };
  if (tl.per_thread == 8)
    return rows3 ? args(launch_f32_tile<Tin, Tout, 8, 3>) : args(launch_f32_tile<Tin, Tout, 8, 1>);
  return rows3 ? args(launch_f32_tile<Tin, Tout, 4, 3>) : args(launch_f32_tile<Tin, Tout, 4, 1>);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcW = 16;              // output pixels of a tile row: one warp's 16 M rows
constexpr int kHaloW = kTcW + 2;
constexpr int kChunk = 64;            // input channels of a halo tile: 128 B a pixel
constexpr int kAtomBytes = 64 * 128;  // 64 rows of K x 64 columns of N (128 B) of bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// returns once the phase of parity `parity` of the barrier has completed;
// traps (a launch error, not a hang) if that takes more than 2^26 tries
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one TMA box of a 3-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// the canonical MN-major, 128-byte-swizzled B operand at `addr` (1024-aligned):
// a k row of 64 N values is 128 B, 8 rows make an atom, the next 8 rows of K
// are 1024 B on (SBO), the next 64 columns of N kAtomBytes on (LBO)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t kLbo = kAtomBytes >> 4, kSbo = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kLbo << 16) | (kSbo << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across wgmma's
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define MOSS_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32) += a (64 x 16, bf16, registers) * B (16 x N, bf16, shared, MN-major)
template <int N> __device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                                          const uint32_t (&a)[4], uint64_t desc);
template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MOSS_F8(0), MOSS_F8(8), MOSS_F8(16), MOSS_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MOSS_F8(0), MOSS_F8(8), MOSS_F8(16), MOSS_F8(24), MOSS_F8(32), MOSS_F8(40),
        MOSS_F8(48), MOSS_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#undef MOSS_F8

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// A CTA tile: kWG consumer warpgroups (4 output rows of 16 pixels each, one
// row per warp) x kBN output channels, and kStages weight slices in flight;
// plus one producer warp.
template <int WG, int BN, int Stages>
struct TcTile {
  static constexpr int kWG = WG, kBN = BN, kStages = Stages;
  static constexpr int kThreads = 128 * kWG + 32;
  static constexpr int kRows = 4 * kWG;
  static constexpr int kHaloBox = (kRows + 2) * kHaloW * 128;         // TMA bytes
  static constexpr int kHaloBytes = (kHaloBox + 1023) / 1024 * 1024;  // buffer stride
  static constexpr int kWBytes = (kBN / 64) * kAtomBytes;
  static constexpr int kSmem = kStages * kWBytes + 2 * kHaloBytes + 16 * kStages + 1024;
};

// Stages of the tensor-core kernel, each leaving out part of its work, so
// that their times say what holds the kernel back (moss_torch/tools/
// conv_proto.py). In every stage but kFull the accumulators stay zero (no
// products, or products of zeroed shared memory), so the output is
// relu(b) at every pixel.
enum Stage : int {
  kFull = 0,      // the production kernel
  kCopy = 1,      // the TMA ring alone: each step's data waited for, its slot freed
  kOperands = 2,  // kCopy and the A fragments' ldmatrix, no products
  kProducts = 3,  // ldmatrix and wgmma on zeroed shared memory, no copies
  kMma = 4,       // the wgmmas alone, on zero A registers and zeroed shared memory
};

// A persistent CTA walks tiles blockIdx.x, + gridDim.x, ...; the step ring
// runs on across them, so the next tile's copies overlap this tile's products
// and epilogue.
template <typename T, typename Tout, int S>
__global__ void __launch_bounds__(T::kThreads, 1)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap map_x,  // x (H, W, cin) as (cin, W, H)
                  const __grid_constant__ CUtensorMap map_w,  // w as (cout, cin, 9)
                  const bf16* __restrict__ b,                 // (cout,)
                  Tout* __restrict__ out,                     // (H, W, cout)
                  int H, int W, int cin, int cout, int relu)
{
  constexpr int kWG = T::kWG, kBN = T::kBN, kStages = T::kStages;
  constexpr bool kCopies = S == kFull || S == kCopy || S == kOperands;
  constexpr bool kLoadsA = S == kFull || S == kOperands || S == kProducts;
  constexpr bool kMath = S == kFull || S == kProducts || S == kMma;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t wsm = (smem_u32(smem_raw) + 1023u) & ~1023u;  // kStages weight slices
  const uint32_t hsm = wsm + kStages * T::kWBytes;              // 2 halo tiles
  const uint32_t full = hsm + 2 * T::kHaloBytes;                // kStages mbarriers: data in
  const uint32_t empty = full + 8 * kStages;                    // kStages mbarriers: slot free
  if constexpr (!kCopies) {  // zeros for the products, visible to wgmma's (async) reads
    uint4* z = reinterpret_cast<uint4*>(smem_raw + (wsm - smem_u32(smem_raw)));
    for (int i = threadIdx.x; i < static_cast<int>(full - wsm) / 16; i += T::kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // tiles in M-fastest order, so CTAs running together share a weight slice
  const int tiles_w = (W + kTcW - 1) / kTcW;
  const int tiles_m = tiles_w * ((H + T::kRows - 1) / T::kRows);
  const int tiles = tiles_m * ((cout + kBN - 1) / kBN);
  const int nchunks = (cin + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * kWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step q of the CTA (counted across its tiles) = tile, chunk c, tap: slot
  // q % kStages; the chunk's halo tile sits in buffer (the CTA's chunk count) & 1
  if (warp == 4 * kWG) {
    // the producer: brings w[tap][64 c ...][co0 ...] and, at tap 0, chunk
    // c's halo tile, once the consumers have released the slot's last use
    if (lane != 0 || !kCopies) return;
    int q = 0, cq = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, cq += nchunks) {
      const int tm = t % tiles_m, co0 = (t / tiles_m) * kBN;
      const int y0 = (tm / tiles_w) * T::kRows, x0 = (tm % tiles_w) * kTcW;
      for (int c = 0; c < nchunks; ++c)
        for (int tap = 0; tap < 9; ++tap, ++q) {
          const int slot = q % kStages, use = q / kStages;
          if (use > 0) mbar_wait(empty + 8 * slot, (use - 1) & 1);
          const uint32_t bar = full + 8 * slot;
          mbar_expect_tx(bar, T::kWBytes + (tap == 0 ? T::kHaloBox : 0));
#pragma unroll
          for (int a = 0; a < kBN / 64; ++a)
            tma_load_3d(wsm + slot * T::kWBytes + a * kAtomBytes, &map_w, co0 + 64 * a,
                        kChunk * c, tap, bar);
          if (tap == 0)
            tma_load_3d(hsm + ((cq + c) & 1) * T::kHaloBytes, &map_x, kChunk * c, x0 - 1,
                        y0 - 1, bar);
        }
    }
    return;
  }

  // the consumers: warp 4 g + i owns output row 4 g + i of the tile.
  // ldmatrix.x4 of a 16 x 16 A block: lane l gives the address of M row
  // l & 15 (pixel l & 15 of the warp's row) at K half l >> 4, so the four 8 x 8
  // matrices land as the m16k16 fragment (rows 0-7 | 8-15) x (k 0-7 | 8-15).
  // A step's wgmmas run while the next step's A fragments load: the step
  // waits only for the previous step's group (wait_group 1), then frees that
  // step's slot; A alternates between two register sets, so a fragment is
  // rewritten only once the wgmmas that read it are done. The chunk's last
  // step waits for all, so no group outlives the chunk's halo buffer.
  const int a_pix = warp * kHaloW + (lane & 15), a_half = lane >> 4;
  int q = 0, cq = 0;
  uint32_t a[2][4][4] = {};
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, cq += nchunks) {
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
    for (int c = 0; c < nchunks; ++c) {
      const uint32_t hb = hsm + ((cq + c) & 1) * T::kHaloBytes;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++q) {
        const int slot = q % kStages, dy = tap / 3, dx = tap - 3 * dy;
        const int p = a_pix + dy * kHaloW + dx;
        if constexpr (kCopies) mbar_wait(full + 8 * slot, (q / kStages) & 1);
        if constexpr (kLoadsA) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldmatrix_x4(a[tap & 1][kk], hb + p * 128 + (((2 * kk + a_half) ^ (p & 7)) << 4));
        }
        if constexpr (!kMath) {
          if (lane == 0) mbar_arrive(empty + 8 * slot);
          continue;
        }
        const uint32_t wb = wsm + slot * T::kWBytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<kBN>(acc, a[tap & 1][kk], b_desc(wb + kk * 2048));
        wgmma_commit();
        const int prev = (q + kStages - 1) % kStages;  // the previous step's slot
        if (tap < 8) {
          wgmma_wait1();
          fence_regs(acc);
          if (kCopies && tap > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        } else {
          wgmma_wait0();
          fence_regs(acc);
          if (kCopies && lane == 0) {
            mbar_arrive(empty + 8 * prev);
            mbar_arrive(empty + 8 * slot);
          }
        }
      }
    }

    // accumulator i of n8 block j = i / 4: M row (lane >> 2) + 8 ((i >> 1) & 1),
    // column 8 j + 2 (lane & 3) + (i & 1)
    const int tm = t % tiles_m, co0 = (t / tiles_m) * kBN;
    const int oy = (tm / tiles_w) * T::kRows + warp, x0 = (tm % tiles_w) * kTcW;
    if (oy >= H) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * (lane & 3);
      if (co >= cout) continue;  // cout % 8 == 0: co + 1 < cout too
      const float b0 = __bfloat162float(b[co]), b1 = __bfloat162float(b[co + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = x0 + (lane >> 2) + 8 * h;
        if (ox >= W) continue;
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        store2(out + (static_cast<size_t>(oy) * W + ox) * cout + co, v0, v1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a 3-D bf16 tensor map (dims and box innermost first, packed), 128-byte
// swizzle, zero fill out of bounds; 0 or a cudaError
int make_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int b0, int b1, int b2) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || !fn)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {2ull * d0, 2ull * d0 * d1};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// calls f(TcTile<...>{}) for tile code `tile`; -1 past the last tile
template <typename F>
int with_tile(int tile, F f) {
  switch (tile) {
    case 0: return f(TcTile<2, 128, 4>{});  // 8 x 16 pixels x 128 channels
    case 1: return f(TcTile<2, 64, 6>{});   // 8 x 16 x 64
    case 2: return f(TcTile<1, 64, 6>{});   // 4 x 16 x 64
    default: return -1;
  }
}

// stage S of the kernel on the grid of the production kernel (kFull), so
// that the stages' times compare
template <typename T, typename Tout, int S = kFull>
int launch_tc(const void* x, const void* w, const void* b, void* out, int H, int W, int cin,
              int cout, int relu, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  int err = make_map(&map_x, x, cin, W, H, kChunk, kHaloW, T::kRows + 2);
  if (!err) err = make_map(&map_w, w, cout, cin, 9, 64, kChunk, 1);
  if (err) return err;
  auto production = conv3x3_tc_kernel<T, Tout, kFull>;
  auto kernel = conv3x3_tc_kernel<T, Tout, S>;
  cudaError_t e = cudaFuncSetAttribute(production, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, production, T::kThreads,
                                                      T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long tiles = static_cast<long>((H + T::kRows - 1) / T::kRows) * ((W + kTcW - 1) / kTcW) *
                     ((cout + T::kBN - 1) / T::kBN);
  const int grid = static_cast<int>(tiles < static_cast<long>(sms) * per_sm ? tiles
                                                                            : sms * per_sm);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(map_x, map_w, static_cast<const bf16*>(b),
                                                   static_cast<Tout*>(out), H, W, cin, cout,
                                                   relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The CUDA-core kernel: x, w, b are f32 (in_bf16 = 0) or bf16 (1); out f32
// (out_bf16 = 0) or bf16; tile a code of kF32Tiles, split the CTAs of a
// cluster that share the K walk, 1-8 (cudaErrorInvalidValue otherwise).
extern "C" int moss_conv3x3(const void* x, const void* w, const void* b, void* out, int H,
                            int W, int cin, int cout, int relu, int in_bf16, int out_bf16,
                            int tile, int split, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || cin <= 0 || cout <= 0) return 0;
  if (in_bf16) {
    return out_bf16 ? launch<bf16, bf16>(x, w, b, out, H, W, cin, cout, relu, tile, split, s)
                    : launch<bf16, float>(x, w, b, out, H, W, cin, cout, relu, tile, split, s);
  }
  return out_bf16 ? launch<float, bf16>(x, w, b, out, H, W, cin, cout, relu, tile, split, s)
                  : launch<float, float>(x, w, b, out, H, W, cin, cout, relu, tile, split, s);
}

// the CUDA-core kernel's tile `tile`: info = output rows (of 16 pixels),
// output channels, channels a thread, threads, the most dynamic shared
// memory it takes at a split of 1 and above 1; -1 past the last tile
extern "C" int moss_conv3x3_f32_tile(int tile, int* info) {
  if (tile < 0 || tile >= kF32TileCount) return -1;
  const F32Tile& tl = kF32Tiles[tile];
  info[0] = tl.rows;
  info[1] = tl.channels;
  info[2] = tl.per_thread;
  info[3] = tl.threads();
  info[4] = tl.smem_bytes(1, 3);
  info[5] = tl.smem_bytes(2, 3);
  return 0;
}

// The tensor-core kernel: x, w, b bf16 with cin % 8 == 0, cout % 8 == 0 and
// x, w 16-byte aligned (cudaErrorInvalidValue otherwise); out f32 or bf16.
// tile: a code of with_tile; -1 for a code past the last tile.
extern "C" int moss_conv3x3_tc(const void* x, const void* w, const void* b, void* out, int H,
                               int W, int cin, int cout, int relu, int out_bf16, int tile,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || cin <= 0 || cout <= 0) return 0;
  if (cin % 8 || cout % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_tile(tile, [&](auto t) {
    using T = decltype(t);
    return out_bf16 ? launch_tc<T, bf16>(x, w, b, out, H, W, cin, cout, relu, s)
                    : launch_tc<T, float>(x, w, b, out, H, W, cin, cout, relu, s);
  });
}

// A stage of the tensor-core kernel (enum Stage) at tile code `tile`, bf16
// out, with moss_conv3x3_tc's conditions on the inputs; -1 for a code past
// the last tile or stage.
extern "C" int moss_conv3x3_tc_stage(int stage, const void* x, const void* w, const void* b,
                                     void* out, int H, int W, int cin, int cout, int relu,
                                     int tile, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || cin <= 0 || cout <= 0) return 0;
  if (cin % 8 || cout % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_tile(tile, [&](auto t) {
    using T = decltype(t);
    switch (stage) {
      case kFull: return launch_tc<T, bf16, kFull>(x, w, b, out, H, W, cin, cout, relu, s);
      case kCopy: return launch_tc<T, bf16, kCopy>(x, w, b, out, H, W, cin, cout, relu, s);
      case kOperands:
        return launch_tc<T, bf16, kOperands>(x, w, b, out, H, W, cin, cout, relu, s);
      case kProducts:
        return launch_tc<T, bf16, kProducts>(x, w, b, out, H, W, cin, cout, relu, s);
      case kMma: return launch_tc<T, bf16, kMma>(x, w, b, out, H, W, cin, cout, relu, s);
      default: return -1;
    }
  });
}

// the launch shape of tile code `tile`: info = output rows (of 16 pixels),
// output channels, threads, dynamic shared memory, CTAs an SM; -1 past the
// last tile
extern "C" int moss_conv3x3_tc_tile(int tile, int* info) {
  return with_tile(tile, [&](auto t) {
    using T = decltype(t);
    auto kernel = conv3x3_tc_kernel<T, bf16, kFull>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4], kernel, T::kThreads,
                                                        T::kSmem);
    info[0] = T::kRows;
    info[1] = T::kBN;
    info[2] = T::kThreads;
    info[3] = T::kSmem;
    return static_cast<int>(e);
  });
}
