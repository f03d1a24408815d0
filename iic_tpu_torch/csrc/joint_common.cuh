// Shared by seg_joint.cu (K1) and joint_exp.cu (X2, X1): the row tables of
// the stacked-shift GEMM P[(v,i),(u,j)] = A @ B^T, the store of a block's
// split-K partial and the ordered reduce of the partials.
//
// Row m of A (the column-shifted x1 stack) is (v, i), v-major, and reads
// x1[n, i, y, q + v - h]; row nn of B (the row-shifted x2 stack) is (u, j),
// u-major, and reads x2[n, j, y + h - u, q]; h = half_t, kT = k * (2h + 1).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Input channel of stack row m; 0 for a row past kT, which the caller masks
// (m < kT).
__device__ __forceinline__ int stack_chan(int m, int tk, int k) {
  return m < tk ? m % k : 0;
}

// Column shift of A row m, v - h (-h past kT).
__device__ __forceinline__ int a_shift_of(int m, int tk, int k, int half_t) {
  return (m < tk ? m / k : 0) - half_t;
}

// Row shift of B row nn, h - u (h past kT).
__device__ __forceinline__ int b_shift_of(int nn, int tk, int k, int half_t) {
  return half_t - (nn < tk ? nn / k : 0);
}

// Writes a thread's 4x4 accumulator, rows row0 + step*a and columns
// col0 + step*b of the (kT, kT) product, to part[blockIdx.z]; entries past
// kT are dropped.
__device__ __forceinline__ void store_partial(float* part, int tk, int row0,
                                              int col0, int step,
                                              const float (&acc)[4][4]) {
  float* p = part + static_cast<size_t>(blockIdx.z) * tk * tk;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = row0 + step * a;
    if (m >= tk) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int nn = col0 + step * b;
      if (nn < tk) p[static_cast<size_t>(m) * tk + nn] = acc[a][b];
    }
  }
}

// Index in the (k, k, T, T) output of entry e = (v,i)*kT + (u,j).
__device__ __forceinline__ size_t scatter_index(int e, int k, int t) {
  const int tk = k * t;
  const int m = e / tk, nn = e - (e / tk) * tk;
  const int v = m / k, i = m - v * k;
  const int u = nn / k, j = nn - u * k;
  return ((static_cast<size_t>(i) * k + j) * t + u) * t + v;
}

// Sums the split-K partials in chunk order (deterministic; no atomics). With
// `scatter` it writes P[(v,i),(u,j)] into the (k, k, T, T) layout, else the
// (kT, kT) matrix as it is.
__global__ void __launch_bounds__(kThreads)
joint_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int splits, int k, int t, int scatter) {
  const int tk = k * t;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= tk * tk) return;
  const size_t stride = static_cast<size_t>(tk) * tk;
  float s = 0.f;
  for (int c = 0; c < splits; ++c) s += part[c * stride + e];
  out[scatter ? scatter_index(e, k, t) : e] = s;
}

}  // namespace
