// Fused clustering IID loss (K3), hand-written for Hopper (sm_90a).
//
// Replaces iic_tpu/ops/pallas/iid_loss_kernel.py: `_fwd_kernel`, launched by
// `_fwd` (public `iid_loss_fused`).
//
// For each sub-head s of z, zt (S, bn, k), softmax pairs:
//
//   J = z^T zt                       (k x k, f32 FMAs over the bn rows)
//   J = (J + J^T) / 2,  T = sum(J),  P = J / T
//   p_i = row sums of P, p_j = column sums of P     (of the UNCLAMPED P)
//   P, p_i, p_j clamped below at eps = 2^-52 (sys.float_info.epsilon)
//   loss    = -sum P (log P - lamb log p_j - lamb log p_i)
//   loss_nl = -sum P (log P - log p_j - log p_i)
//
// outputs loss[s], loss_nl[s], P[s] (k x k) and T[s]; the backward (torch
// ops in ops/kernels/iid_loss.py) reuses P and T.
//
// Bound: at the clustering path's shapes (S=5 sub-heads, bn=660, k=70 or
// 10) a sub-head is 2 * 660 * 70^2 ~ 6.5e6 FLOP on 370 KB of input: a few
// microseconds of the card's compute or bandwidth. What bounds it is launch
// and latency. The plain version is a batched matmul plus about fifteen
// elementwise and reduction launches, each writing its (S, k, k) result to
// device memory and reading it back; this kernel is ONE launch for all S
// sub-heads, and the joint, the marginals and the log terms never leave
// shared memory.
//
// Design. The TPU kernel walks the batch in 256-row tiles along a
// sequential grid and carries the joint in a VMEM accumulator; it pads k to
// 128 lanes and bn to the tile. Blocks here run in parallel, so one block
// owns one sub-head and loops over all its rows itself (no cross-block
// reduction, no atomics: the loss is deterministic, and a sub-head's numbers
// do not depend on how many sub-heads share the launch). Rows are staged 32
// at a time in shared memory, zero-masked past bn and past k (no padded copy
// reaches device memory); each of the 512 threads keeps MT 4x4 register
// micro-tiles of the joint. The epilogue runs in the same block on the k x k
// joint in shared memory (k <= 180: 130 KB at k=180, 79 KB at k=140, over the
// 48 KB static limit, so the launch opts into dynamic shared memory). Every
// sum is a fixed-order block reduction.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int RC = 32;  // rows staged per step
constexpr int kMaxTilesPerThread = 4;
constexpr float kEps = 2.220446049250313e-16f;  // 2^-52, exact in f32

__host__ __device__ int padded(int k) { return (k + 3) & ~3; }

size_t smem_bytes(int k) {
  const int kp = padded(k);
  return sizeof(float) * (2 * static_cast<size_t>(RC) * kp
                          + static_cast<size_t>(k) * (k + 1)
                          + 2 * kThreads + k);
}

// Fixed-order sum of (a, b) over the block; every thread gets the result.
__device__ float2 block_sum2(float a, float b, float* red) {
  const int tid = threadIdx.x;
  red[tid] = a;
  red[kThreads + tid] = b;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] += red[tid + s];
      red[kThreads + tid] += red[kThreads + tid + s];
    }
    __syncthreads();
  }
  const float2 out = make_float2(red[0], red[kThreads]);
  __syncthreads();
  return out;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
iid_loss_kernel(const float* __restrict__ z, const float* __restrict__ zt,
                float* __restrict__ loss, float* __restrict__ loss_nl,
                float* __restrict__ p_out, float* __restrict__ total_out,
                int bn, int k, float lamb) {
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int kp = padded(k);  // staged row stride, float4-aligned
  const int kq = kp / 4;     // micro-tiles along each edge
  const int tiles = kq * kq;
  const int ld = k + 1;      // joint row stride
  const float* zb = z + static_cast<size_t>(s) * bn * k;
  const float* ztb = zt + static_cast<size_t>(s) * bn * k;

  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                  // [RC][kp]
  float* zts = zs + RC * kp;         // [RC][kp]
  float* js = zts + RC * kp;         // [k][k + 1]
  float* red = js + k * ld;          // [2 * kThreads]
  float* logm = red + 2 * kThreads;  // [k]

  // ---- J = z^T zt
  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[m][a][b] = 0.f;

  for (int r0 = 0; r0 < bn; r0 += RC) {
    __syncthreads();  // previous rows consumed
    for (int e = tid; e < RC * kp; e += kThreads) {
      const int rr = e / kp;
      const int c = e - rr * kp;
      const int r = r0 + rr;
      const bool ok = r < bn && c < k;
      const size_t off = static_cast<size_t>(r) * k + c;
      zs[e] = ok ? zb[off] : 0.f;
      zts[e] = ok ? ztb[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int t = tid + m * kThreads;
      if (t >= tiles) continue;
      const int ti = t / kq;
      const int tj = t - ti * kq;
#pragma unroll 4
      for (int rr = 0; rr < RC; ++rr) {
        const float4 a4 = *reinterpret_cast<const float4*>(zs + rr * kp + 4 * ti);
        const float4 b4 =
            *reinterpret_cast<const float4*>(zts + rr * kp + 4 * tj);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[m][a][b] = fmaf(av[a], bv[b], acc[m][a][b]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int t = tid + m * kThreads;
    if (t >= tiles) continue;
    const int ti = t / kq;
    const int tj = t - ti * kq;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ti + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * tj + b;
        if (i < k && j < k) js[i * ld + j] = acc[m][a][b];
      }
    }
  }
  __syncthreads();

  // ---- symmetrise: each unordered pair {i, j} belongs to one thread
  const int kk = k * k;
  for (int e = tid; e < kk; e += kThreads) {
    const int i = e / k;
    const int j = e - i * k;
    if (i < j) {
      const float v = (js[i * ld + j] + js[j * ld + i]) / 2.0f;
      js[i * ld + j] = v;
      js[j * ld + i] = v;
    }
  }
  __syncthreads();

  // ---- T and P = J / T
  float part = 0.f;
  for (int e = tid; e < kk; e += kThreads) {
    const int i = e / k;
    part += js[i * ld + e - i * k];
  }
  const float total = block_sum2(part, 0.f, red).x;
  for (int e = tid; e < kk; e += kThreads) {
    const int i = e / k;
    js[i * ld + e - i * k] /= total;
  }
  __syncthreads();

  // ---- marginals of the unclamped P. P is exactly symmetric, so the row
  // sum i and the column sum i, added in the same order, are the same
  // number: one array serves as both p_i and p_j.
  for (int i = tid; i < k; i += kThreads) {
    float m = 0.f;
    for (int j = 0; j < k; ++j) m += js[i * ld + j];
    logm[i] = logf(fmaxf(m, kEps));
  }
  __syncthreads();

  // ---- the MI terms, and P out
  float* pb = p_out + static_cast<size_t>(s) * kk;
  float t_l = 0.f, t_nl = 0.f;
  for (int e = tid; e < kk; e += kThreads) {
    const int i = e / k;
    const int j = e - i * k;
    const float p = js[i * ld + j];
    pb[e] = p;
    const float pc = fmaxf(p, kEps);
    const float lp = logf(pc);
    t_l += -pc * (lp - lamb * logm[j] - lamb * logm[i]);
    t_nl += -pc * (lp - logm[j] - logm[i]);
  }
  const float2 sums = block_sum2(t_l, t_nl, red);
  if (tid == 0) {
    loss[s] = sums.x;
    loss_nl[s] = sums.y;
    total_out[s] = total;
  }
}

template <int MT>
int launch(const float* z, const float* zt, float* loss, float* loss_nl,
           float* p, float* total, int s, int bn, int k, float lamb,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        iid_loss_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  iid_loss_kernel<MT><<<s, kThreads, smem, stream>>>(
      z, zt, loss, loss_nl, p, total, bn, k, lamb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest k the kernel takes: 4x4 micro-tiles, at most kMaxTilesPerThread
// per thread.
int iid_loss_max_k() {
  int k = 4;
  while ((k / 4 + 1) * (k / 4 + 1) <= kMaxTilesPerThread * kThreads) k += 4;
  return k;
}

// z, zt (s, bn, k) f32 contiguous; loss, loss_nl, total (s,) f32;
// p (s, k, k) f32. Returns cudaErrorInvalidValue for a k over
// iid_loss_max_k() or an empty batch.
int iid_loss_fwd(const float* z, const float* zt, float* loss, float* loss_nl,
                 float* p, float* total, int s, int bn, int k, float lamb,
                 cudaStream_t stream) {
  if (s < 1 || bn < 1 || k < 1 || k > iid_loss_max_k())
    return static_cast<int>(cudaErrorInvalidValue);
  const int kq = padded(k) / 4;
  const int mt = (kq * kq + kThreads - 1) / kThreads;
  switch (mt) {
    case 1: return launch<1>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                             stream);
    case 2: return launch<2>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                             stream);
    case 3: return launch<3>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                             stream);
    default: return launch<4>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                              stream);
  }
}

}  // extern "C"
