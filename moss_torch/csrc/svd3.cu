// Proper singular value decomposition of a batch of 3x3 matrices.
//
// Replaces no TPU kernel: moss_tpu/ops/fisher.py:118-139 calls XLA's SVD
// (jnp.linalg.svd) for the matrix-Fisher NLL of the pose-correction MLPs'
// 23 rotations. On the H100 the library call, torch.linalg.svd, reads
// cuSOLVER's info flags back to the host after every call, a host sync
// inside the training step; so the step could not run without a sync, nor be
// captured in a CUDA graph. This kernel makes no host read.
//
// What bounds it on the H100: neither bytes (36 B in, 88 B out a matrix) nor
// operations (about 1,500 a matrix); for 23 matrices the launch is the time.
// What the design does: one thread a matrix. One-sided Jacobi (Hestenes) on
// the columns of A: kSweeps fixed sweeps of the three column pairs, each
// rotation zeroing the pair's dot product, accumulate V; the column norms
// are the singular values, sorted descending with V's columns. Then
// u1 = w1 / s1, u2 = w2 Gram-Schmidt against u1, u3 = u1 x u2, so U is a
// rotation, and s3's sign is that of w3 . u3. Outputs: U, V (rows of the
// matrix in row-major order), S >= 0 and sign = sign(det U det V) of the
// decomposition A = U diag(S) V^T whose U has u3 flipped where w3 . u3 < 0
// (ops/fisher.py's proper singular values: S with s3 times sign). A fixed
// sweep count and no atomics: the same bits on every run.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (moss_torch/ops/cuda_build.py)
#include <cuda_runtime.h>

namespace {

constexpr int kSweeps = 8;     // 3x3 one-sided Jacobi converges in 4-5; 8 is margin
constexpr int kThreads = 128;

__device__ __forceinline__ void rotate(float w[3][3], float v[3][3], int p, int q) {
  float alpha = 0.f, beta = 0.f, gamma = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    alpha += w[i][p] * w[i][p];
    beta += w[i][q] * w[i][q];
    gamma += w[i][p] * w[i][q];
  }
  if (gamma == 0.f || fabsf(gamma) <= 1e-30f) return;
  const float zeta = (beta - alpha) / (2.f * gamma);
  const float t = copysignf(1.f, zeta) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
  const float c = rsqrtf(1.f + t * t);
  const float s = c * t;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float wp = w[i][p], wq = w[i][q];
    w[i][p] = c * wp - s * wq;
    w[i][q] = s * wp + c * wq;
    const float vp = v[i][p], vq = v[i][q];
    v[i][p] = c * vp - s * vq;
    v[i][q] = s * vp + c * vq;
  }
}

__device__ __forceinline__ void swap_cols(float m[3][3], int p, int q) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t = m[i][p];
    m[i][p] = m[i][q];
    m[i][q] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
svd3_kernel(const float* __restrict__ a,  // (n, 3, 3)
            int n,
            float* __restrict__ u_out,    // (n, 3, 3)
            float* __restrict__ s_out,    // (n, 3)
            float* __restrict__ v_out,    // (n, 3, 3)
            float* __restrict__ sign_out) // (n,)
{
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n) return;
  float w[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[i][j] = a[b * 9 + i * 3 + j];
      v[i][j] = i == j ? 1.f : 0.f;
    }
  float det_v = 1.f;
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate(w, v, 0, 1);
    rotate(w, v, 0, 2);
    rotate(w, v, 1, 2);
  }
  float s[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) s[j] = sqrtf(w[0][j] * w[0][j] + w[1][j] * w[1][j] + w[2][j] * w[2][j]);
  // sort descending; each swap flips det V
#pragma unroll
  for (int pass = 0; pass < 2; ++pass)
#pragma unroll
    for (int j = 0; j < 2 - pass; ++j)
      if (s[j] < s[j + 1]) {
        const float t = s[j];
        s[j] = s[j + 1];
        s[j + 1] = t;
        swap_cols(w, j, j + 1);
        swap_cols(v, j, j + 1);
        det_v = -det_v;
      }
  float u[3][3];
  // u1: w1 / s1 (e1 for a zero matrix)
  const float inv1 = s[0] > 0.f ? 1.f / s[0] : 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i][0] = s[0] > 0.f ? w[i][0] * inv1 : (i == 0 ? 1.f : 0.f);
  // u2: w2 without its u1 part, normalised; an axis orthogonal to u1 where that vanishes
  float d = u[0][0] * w[0][1] + u[1][0] * w[1][1] + u[2][0] * w[2][1];
  float x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = w[i][1] - d * u[i][0];
  float nx = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  if (!(nx > 1e-30f)) {
    // the axis of least |u1| component, crossed with u1
    const int k = fabsf(u[0][0]) <= fabsf(u[1][0])
                      ? (fabsf(u[0][0]) <= fabsf(u[2][0]) ? 0 : 2)
                      : (fabsf(u[1][0]) <= fabsf(u[2][0]) ? 1 : 2);
    float e[3] = {0.f, 0.f, 0.f};
    e[k] = 1.f;
    x[0] = u[1][0] * e[2] - u[2][0] * e[1];
    x[1] = u[2][0] * e[0] - u[0][0] * e[2];
    x[2] = u[0][0] * e[1] - u[1][0] * e[0];
    nx = sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i][1] = x[i] / nx;
  // u3 = u1 x u2: U is a rotation
  u[0][2] = u[1][0] * u[2][1] - u[2][0] * u[1][1];
  u[1][2] = u[2][0] * u[0][1] - u[0][0] * u[2][1];
  u[2][2] = u[0][0] * u[1][1] - u[1][0] * u[0][1];
  const float s3 = u[0][2] * w[0][2] + u[1][2] * w[1][2] + u[2][2] * w[2][2];
  // A = U diag(s1, s2, s3) V^T with s3 signed; as S >= 0, u3 takes s3's sign
  const float flip = s3 < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      u_out[b * 9 + i * 3 + j] = j == 2 ? flip * u[i][j] : u[i][j];
      v_out[b * 9 + i * 3 + j] = v[i][j];
    }
  }
  s_out[b * 3 + 0] = s[0];
  s_out[b * 3 + 1] = s[1];
  s_out[b * 3 + 2] = fabsf(s3);
  sign_out[b] = flip * det_v;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int moss_svd3(const float* a, int n, float* u, float* s, float* v, float* sign,
                         void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  svd3_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, n, u, s, v, sign);
  return static_cast<int>(cudaGetLastError());
}
