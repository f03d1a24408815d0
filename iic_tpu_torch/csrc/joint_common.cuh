// Shared by seg_joint.cu (K1) and joint_exp.cu (X2, X1, X7): the row tables
// of the stacked-shift GEMM P[(v,i),(u,j)] = A @ B^T, the store of a block's
// split-K partial, the ordered reduce of the partials, and K1's split-K
// partial kernel itself, templated on the input type (f32 for K1, bf16 for
// X7).
//
// Row m of A (the column-shifted x1 stack) is (v, i), v-major, and reads
// x1[n, i, y, q + v - h]; row nn of B (the row-shifted x2 stack) is (u, j),
// u-major, and reads x2[n, j, y + h - u, q]; h = half_t, kT = k * (2h + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// A refused runtime call also sets the thread's last error; clear it so
// that the next launch's cudaGetLastError() reports that launch alone.
inline int refused(cudaError_t err) {
  cudaGetLastError();
  return static_cast<int>(err);
}

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

// ------------------------------------------- K1's split-K partial kernel

// An input value as f32: K1 reads f32, X7 bf16 (widened once, on its way
// into the f32 shared tiles).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int PAD = 4;  // keeps float4 rows aligned; spreads store banks

// Block (bx, by, s) owns the 64x64 output tile (by, bx) and the s-th chunk
// of rows_per_chunk (n, y) rows; a plain shared-memory SGEMM, 16-wide
// k-steps along q, 256 threads, 4x4 register micro-tiles. The loader's
// expressions are K1's own: a form that costs a few more registers drops
// K1 to fewer resident blocks per SM (check ptxas -v).
template <typename T>
__global__ void __launch_bounds__(kThreads)
joint_partial_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                     float* __restrict__ part, int k, int h, int w,
                     int half_t, int rows_total, int rows_per_chunk) {
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * rows_per_chunk;
  const int r_end = min(r_begin + rows_per_chunk, rows_total);
  const size_t plane = static_cast<size_t>(h) * w;

  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  // Loader role: each thread fills 4 rows of each tile at one k-offset.
  // Sixteen neighbouring threads read sixteen neighbouring columns.
  const int kk = tid % BK;
  const int lr = tid / BK;  // 0..15
  size_t a_off[4], b_off[4];
  int a_shift[4], b_shift[4];
  bool a_ok[4], b_ok[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int m = m0 + lr + 16 * l;
    a_ok[l] = m < tk;
    a_off[l] = static_cast<size_t>(stack_chan(m, tk, k)) * plane;
    a_shift[l] = a_shift_of(m, tk, k, half_t);
    const int nn = n0 + lr + 16 * l;
    b_ok[l] = nn < tk;
    b_off[l] = static_cast<size_t>(stack_chan(nn, tk, k)) * plane;
    b_shift[l] = b_shift_of(nn, tk, k, half_t);
  }

  // Compute role: a 4x4 micro-tile, rows tr*4.., cols tc*4..
  const int tr = tid / 16;
  const int tc = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int r = r_begin; r < r_end; ++r) {
    const int img = r / h;
    const int y = r - img * h;
    const T* x1n = x1 + static_cast<size_t>(img) * k * plane
                   + static_cast<size_t>(y) * w;
    const T* x2n = x2 + static_cast<size_t>(img) * k * plane;
    for (int q0 = 0; q0 < w; q0 += BK) {
      const int q = q0 + kk;
      const bool q_ok = q < w;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int col = q + a_shift[l];
        float av = 0.f;
        if (a_ok[l] && q_ok && col >= 0 && col < w)
          av = widen(x1n[a_off[l] + col]);
        As[kk][lr + 16 * l] = av;
        const int row = y + b_shift[l];
        float bv = 0.f;
        if (b_ok[l] && q_ok && row >= 0 && row < h)
          bv = widen(x2n[b_off[l] + static_cast<size_t>(row) * w + q]);
        Bs[kk][lr + 16 * l] = bv;
      }
      __syncthreads();
#pragma unroll
      for (int kq = 0; kq < BK; ++kq) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kq][tr * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kq][tc * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

  store_partial(part, tk, m0 + tr * 4, n0 + tc * 4, 1, acc);
}

// The split-K partials, then their ordered reduce into (k, k, T, T).
template <typename T>
int launch_joint_fwd(const T* x1, const T* x2, float* part, float* out, int n,
                     int k, int h, int w, int half_t, int splits,
                     int rows_per_chunk, cudaStream_t stream) {
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  dim3 grid((tk + BN - 1) / BN, (tk + BM - 1) / BM, splits);
  joint_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      x1, x2, part, k, h, w, half_t, n * h, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = tk * tk;
  joint_reduce_kernel<<<(outs + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, out, splits, k, t, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
