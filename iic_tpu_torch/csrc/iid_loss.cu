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
// microseconds of the card's compute or bandwidth, under one launch. What
// bounds it is launch and latency. The plain version is a batched matmul
// plus about fifteen elementwise and reduction launches, each writing its
// (S, k, k) result to device memory and reading it back; this kernel is ONE
// launch for all S sub-heads, and the joint, the marginals and the log
// terms never leave shared memory.
//
// The joint runs on f32 FMAs, not on the tensor cores: the reference
// computes it at Precision.HIGHEST (iid_loss_kernel.py:43-47), and TF32's
// 10-bit mantissa would break the kernel's 1e-5 contract; at 6.5 MFLOP a
// sub-head the tensor cores would save nothing.
//
// The TPU kernel walks the batch in 256-row tiles along a sequential grid
// and carries the joint in a VMEM accumulator. Blocks here run in parallel
// and carry nothing between them, so the rows of a sub-head are split over
// the blocks of one thread-block cluster, whose partial joints meet in
// distributed shared memory.
//
// Two forms, one entry point (`cluster` blocks a sub-head: kCluster, or 0
// for the block form).
//
// The cluster form (the default). One thread-block cluster of C = kCluster
// = 16 blocks per sub-head (grid S C, launched with cudaLaunchKernelEx and
// a cluster dimension). 16 is a non-portable size; on the H100 it was
// faster than 8, the portable maximum, at every shape of the clustering
// path (PERF.md, K3). A card that cannot hold such a cluster fails the
// launch, and the entry point returns the error.
//   - Rows: rank r takes the r-th of C contiguous ranges of its sub-head's
//     rows (ceil(bn / C) rows each; a rank past the end adds a zero
//     partial) and keeps its partial k x k joint in registers, up to four
//     4x4 micro-tiles on each of 512 threads. The rows are one contiguous
//     span of memory; they are staged 32 at a time into shared-memory rows
//     of padded width (a multiple of 4, so a micro-tile's four values are
//     one 16-byte load) by cp.async copies as wide as the alignment allows
//     (16 bytes where k % 4 == 0, 8 where k is even, else 4), double-
//     buffered: the next stage's copies are in flight while the FMAs run.
//   - Reduce: each rank writes its partial into its shared memory (over
//     the stage buffers); after a cluster barrier rank r adds, for its rows
//     i = r + C m, the C partials of (i, j) in rank order 0 ... C-1 from
//     distributed shared memory (a warp a row, reading along the row; a
//     lane's C loads of several entries issued before any add): a[i][j].
//     After a second barrier it symmetrises its rows, (a[i][j] + a[j][i]) /
//     2, reading a[j][i] from the rank that owns row j: the sums of (i, j)
//     and of (j, i) over the ranks, each in rank order, as the reference's
//     (J + J^T) / 2 of the summed joint, with C loads an entry along rows
//     and one along a column.
//   - Epilogue, in the reference's order (symmetrise, T, P = J / T,
//     marginals of the unclamped P, then the clamped log terms), spread
//     over the ranks: T is the ranks' partial sums added in rank order
//     (each rank stores its partial into every rank's shared memory); each
//     rank divides its rows, sums each row (one warp a row) and stores the
//     row's log marginal into every rank; after a barrier each rank writes
//     its rows of P and sums their log terms, and rank 0 adds the ranks'
//     partial sums in rank order. Block sums are a __shfl_xor_sync tree a
//     warp, then the 16 warp sums in warp order; every loop runs over
//     (row, column) in two dimensions, with no division by k.
//   No atomics and no scratch in device memory: every sum has a fixed
//   order, so a launch gives the same bits every time, and a sub-head's
//   numbers do not depend on S.
//
// The block form (`cluster` = 0, the port's first kernel, kept for timing
// against the cluster form). One 512-thread block per sub-head walks all
// the sub-head's rows in stages of 32, staging each by a scalar loop, and
// sums the joint and the epilogue through fixed-order shared-memory trees
// on that block.
//
// Both forms take k <= 180 (iid_loss_max_k): at most four micro-tiles a
// thread. The cluster form's partial joint (130 KB at k=180) shares its
// shared memory with the stage buffers (92 KB at k=180), so both buffers
// fit at every k it takes. The entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() after its
// launch. A kernel's attributes (its dynamic shared memory limit, at the
// largest k it takes, and the non-portable cluster size) are set on its
// first launch on a device, not on every launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int RC = 32;  // rows staged per step
constexpr int kMaxTilesPerThread = 4;
constexpr int kCluster = 16;  // blocks of a sub-head's cluster
constexpr float kEps = 2.220446049250313e-16f;  // 2^-52, exact in f32

__host__ __device__ int padded(int k) { return (k + 3) & ~3; }

// ------------------------------------------------------------ block form

size_t block_smem_bytes(int k) {
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
iid_loss_block_kernel(const float* __restrict__ z,
                      const float* __restrict__ zt,
                      float* __restrict__ loss, float* __restrict__ loss_nl,
                      float* __restrict__ p_out,
                      float* __restrict__ total_out, int bn, int k,
                      float lamb) {
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

// ---------------------------------------------------------- cluster form

// Floats of the stage buffers (two, each z's and zt's RC rows of padded
// width) and of a rank's partial joint (k rows of k + 1), which reuses
// them once the rows are done.
__host__ __device__ int stage_floats(int k) { return 4 * RC * padded(k); }
__host__ __device__ int joint_floats(int k) { return k * (k + 1); }
__host__ __device__ int union_floats(int k) {
  return stage_floats(k) > joint_floats(k) ? stage_floats(k)
                                           : joint_floats(k);
}
// The rows of the symmetrised joint rank r owns: i = r + C m, m < ceil(k/C)
__host__ __device__ int owned_rows(int k) {
  return (k + kCluster - 1) / kCluster;
}

// The smem plan after the union: the owned rows [ceil(k/C)][k], logm [k],
// T's partials [C], the loss partials [2 C], the block sums [2 kWarps].
size_t cluster_smem_bytes(int k) {
  return sizeof(float)
         * (static_cast<size_t>(union_floats(k)) + owned_rows(k) * k + k
            + 3 * kCluster + 2 * kWarps);
}

// One copy of `vec` floats (4, 2 or 1: 16, 8 or 4 bytes) from global to
// shared memory, completing on the thread's cp.async group.
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int vec) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else if (vec == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies `rows` rows of z and zt (k floats each, contiguous from zr, ztr)
// into the stage buffer `buf` ([z rows][zt rows], RC rows of kp floats
// each): warp w takes rows w, w + 16, its lanes the row's copies of `vec`
// floats.
__device__ __forceinline__ void stage_rows(float* buf, const float* zr,
                                           const float* ztr, int rows, int k,
                                           int kp, int vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int copies = k / vec;
  for (int rr = warp; rr < rows; rr += kWarps)
    for (int c = lane; c < copies; c += 32) {
      const int e = c * vec;
      cp_async(buf + rr * kp + e, zr + static_cast<size_t>(rr) * k + e, vec);
      cp_async(buf + (RC + rr) * kp + e, ztr + static_cast<size_t>(rr) * k + e,
               vec);
    }
  cp_async_commit();
}

// Sum over the block of each thread's v[0..N-1]: a shuffle tree in each
// warp, then the warp sums added in warp order by every thread; `red`
// holds N * kWarps floats. Every thread gets the same sums.
template <int N>
__device__ __forceinline__ void warp_block_sum(float (&v)[N], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
    if (lane == 0) red[n * kWarps + warp] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    v[n] = red[n * kWarps];
    for (int w = 1; w < kWarps; ++w) v[n] += red[n * kWarps + w];
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One sub-head per cluster of C = kCluster blocks (see the header). MT:
// micro-tiles a thread.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
iid_loss_cluster_kernel(const float* __restrict__ z,
                        const float* __restrict__ zt,
                        float* __restrict__ loss,
                        float* __restrict__ loss_nl,
                        float* __restrict__ p_out,
                        float* __restrict__ total_out, int bn, int k,
                        float lamb, int vec) {
  constexpr int C = kCluster;
  // entries of a row the reduce loads at once: U a lane, C values each
  constexpr int U = 64 / C;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kp = padded(k);
  const int kq = kp / 4;
  const int tiles = kq * kq;
  const int ld = k + 1;
  // this rank's rows [r0, r0 + rows) of the sub-head
  const int per = (bn + C - 1) / C;
  const int r0 = min(bn, rank * per);
  const int rows = min(bn, r0 + per) - r0;
  const size_t first = (static_cast<size_t>(s) * bn + r0) * k;
  const float* zr = z + first;
  const float* ztr = zt + first;

  extern __shared__ __align__(16) float smem[];
  float* js = smem;  // [k][k + 1], over the stage buffers once rows are done
  float* jr = smem + union_floats(k);           // [ceil(k/C)][k]: a
  float* logm = jr + owned_rows(k) * k;         // [k]
  float* tpart = logm + k;                      // [C]
  float* lpart = tpart + C;                     // [2 C]
  float* red = lpart + 2 * C;                   // [2 kWarps]

  // ---- this rank's partial J = z^T zt over its rows
  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[m][a][b] = 0.f;
  int ti[MT], tj[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int t = tid + m * kThreads;
    ti[m] = t / kq;
    tj[m] = t - ti[m] * kq;
  }

  const int stages = (rows + RC - 1) / RC;
  if (stages > 0) {
    // the padding columns k..kp-1 of every staged row stay zero
    for (int rr = warp; rr < 4 * RC; rr += kWarps)
      for (int col = k + lane; col < kp; col += 32) smem[rr * kp + col] = 0.f;
    stage_rows(smem, zr, ztr, min(RC, rows), k, kp, vec);
  }
  for (int st = 0; st < stages; ++st) {
    // the next stage's copies go into the other buffer, which the
    // barrier ending the previous stage freed
    if (st + 1 < stages) {
      const int next = (st + 1) * RC;
      stage_rows(smem + ((st + 1) & 1) * 2 * RC * kp,
                 zr + static_cast<size_t>(next) * k,
                 ztr + static_cast<size_t>(next) * k, min(RC, rows - next),
                 k, kp, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* zs = smem + (st & 1) * 2 * RC * kp;
    const float* zts = zs + RC * kp;
    const int nr = min(RC, rows - st * RC);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (tid + m * kThreads >= tiles) continue;
      const float* za = zs + 4 * ti[m];
      const float* zb = zts + 4 * tj[m];
#pragma unroll 4
      for (int rr = 0; rr < nr; ++rr) {
        const float4 a4 = *reinterpret_cast<const float4*>(za + rr * kp);
        const float4 b4 = *reinterpret_cast<const float4*>(zb + rr * kp);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[m][a][b] = fmaf(av[a], bv[b], acc[m][a][b]);
      }
    }
    __syncthreads();  // this buffer consumed
  }
  // the partial into this rank's joint (a rank with no rows: zeros)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (tid + m * kThreads >= tiles) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ti[m] + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * tj[m] + b;
        if (i < k && j < k) js[i * ld + j] = acc[m][a][b];
      }
    }
  }
  const float* peer[C];
#pragma unroll
  for (int q = 0; q < C; ++q) peer[q] = cluster.map_shared_rank(js, q);
  cluster.sync();

  // ---- a = the sum of the ranks' J_q[i][j] in rank order, for the rows
  // i = rank + C m, into jr: a warp a row, each lane's U entries' C loads
  // issued before any add
  for (int m = warp; rank + C * m < k; m += kWarps) {
    const int i = rank + C * m;
    for (int j0 = 0; j0 < k; j0 += 32 * U) {
      float v[U][C];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = min(j0 + 32 * u + lane, k - 1);
#pragma unroll
        for (int q = 0; q < C; ++q) v[u][q] = peer[q][i * ld + j];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u + lane;
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < C; ++q) a += v[u][q];
        if (j < k) jr[m * k + j] = a;
      }
    }
  }
  cluster.sync();

  // ---- the symmetrised rows (a + b) / 2, b = a[j][i] from row j / C of
  // rank j % C, into the shared memory the partial joint held (no rank
  // reads a partial again), and this rank's sum of them
  float* jv = js;  // [ceil(k/C)][k]
  float t_part[1] = {0.f};
  for (int m = warp; rank + C * m < k; m += kWarps) {
    const int i = rank + C * m;
    for (int j = lane; j < k; j += 32) {
      const float b = cluster.map_shared_rank(jr, j % C)[(j / C) * k + i];
      const float v = (jr[m * k + j] + b) / 2.0f;
      jv[m * k + j] = v;
      t_part[0] += v;
    }
  }
  // ---- T: the ranks' partial sums, added in rank order by every rank
  warp_block_sum(t_part, red);
  if (tid < C) cluster.map_shared_rank(tpart, tid)[rank] = t_part[0];
  cluster.sync();
  float total = tpart[0];
#pragma unroll
  for (int q = 1; q < C; ++q) total += tpart[q];

  // ---- P = J / T on the owned rows, and their marginals of the
  // unclamped P, a warp a row. P is exactly symmetric, so the row sum i
  // and the column sum i, added in the same order, are the same number:
  // one array serves as both p_i and p_j, and each rank sends its rows'
  // logs to every rank.
  for (int m = warp; rank + C * m < k; m += kWarps) {
    float msum = 0.f;
    for (int j = lane; j < k; j += 32) {
      const float p = jv[m * k + j] / total;
      jv[m * k + j] = p;
      msum += p;
    }
    msum = warp_sum(msum);
    if (lane < C)
      cluster.map_shared_rank(logm, lane)[rank + C * m] =
          logf(fmaxf(msum, kEps));
  }
  cluster.sync();

  // ---- the MI terms of the owned rows, and P out; the ranks' partial
  // sums go to rank 0, which adds them in rank order
  float* pb = p_out + static_cast<size_t>(s) * k * k;
  float t[2] = {0.f, 0.f};
  for (int m = warp; rank + C * m < k; m += kWarps) {
    const int i = rank + C * m;
    const float li = logm[i];
    for (int j = lane; j < k; j += 32) {
      const float p = jv[m * k + j];
      pb[i * k + j] = p;
      const float pc = fmaxf(p, kEps);
      const float lp = logf(pc);
      t[0] += -pc * (lp - lamb * logm[j] - lamb * li);
      t[1] += -pc * (lp - logm[j] - li);
    }
  }
  warp_block_sum(t, red);
  if (tid < 2)
    cluster.map_shared_rank(lpart, 0)[2 * rank + tid] = tid ? t[1] : t[0];
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float l = lpart[0], l_nl = lpart[1];
#pragma unroll
    for (int q = 1; q < C; ++q) {
      l += lpart[2 * q];
      l_nl += lpart[2 * q + 1];
    }
    loss[s] = l;
    loss_nl[s] = l_nl;
    total_out[s] = total;
  }
}

__global__ void empty_kernel() {}

// cudaLaunchKernelEx with `cluster` blocks a cluster.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), int blocks,
                             int cluster, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

int device_bit() {
  int device = 0;
  cudaGetDevice(&device);
  return device < 64 ? device : 63;
}

// Sets `kernel`'s dynamic shared memory limit to `smem` and, where
// `clustered`, allows its non-portable cluster size, on the current device
// the first time it is called there for the kernel (`done`: one bit a
// device; a second call that races the first sets the same values again).
template <typename Kernel>
cudaError_t configure_once(Kernel kernel, size_t smem, bool clustered,
                           std::atomic<uint64_t>& done) {
  const uint64_t bit = uint64_t{1} << device_bit();
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && clustered)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Largest k the kernel takes: 4x4 micro-tiles, at most kMaxTilesPerThread
// per thread.
int max_k() {
  int k = 4;
  while ((k / 4 + 1) * (k / 4 + 1) <= kMaxTilesPerThread * kThreads) k += 4;
  return k;
}

template <int MT>
int launch_cluster(const float* z, const float* zt, float* loss,
                   float* loss_nl, float* p, float* total, int s, int bn,
                   int k, float lamb, cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  // the widest copy every row start allows: rows start k floats apart
  const uintptr_t base = reinterpret_cast<uintptr_t>(z)
                         | reinterpret_cast<uintptr_t>(zt);
  const int vec = (k % 4 == 0 && base % 16 == 0)  ? 4
                  : (k % 2 == 0 && base % 8 == 0) ? 2
                                                  : 1;
  cudaError_t err = configure_once(iid_loss_cluster_kernel<MT>,
                                   cluster_smem_bytes(max_k()), true, done);
  if (err == cudaSuccess)
    err = launch_clustered(iid_loss_cluster_kernel<MT>, s * kCluster,
                           kCluster, cluster_smem_bytes(k), stream, z, zt,
                           loss, loss_nl, p, total, bn, k, lamb, vec);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch(const float* z, const float* zt, float* loss, float* loss_nl,
           float* p, float* total, int s, int bn, int k, float lamb,
           int cluster, cudaStream_t stream) {
  if (cluster == kCluster)
    return launch_cluster<MT>(z, zt, loss, loss_nl, p, total, s, bn, k,
                              lamb, stream);
  static std::atomic<uint64_t> done{0};
  const cudaError_t err = configure_once(
      iid_loss_block_kernel<MT>, block_smem_bytes(max_k()), false, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  iid_loss_block_kernel<MT><<<s, kThreads, block_smem_bytes(k), stream>>>(
      z, zt, loss, loss_nl, p, total, bn, k, lamb);
  return static_cast<int>(cudaGetLastError());
}

bool valid_cluster(int cluster) {
  return cluster == 0 || cluster == kCluster;
}

int tiles_per_thread(int k) {
  const int kq = padded(k) / 4;
  return (kq * kq + kThreads - 1) / kThreads;
}

}  // namespace

extern "C" {

int iid_loss_max_k() { return max_k(); }

// Dynamic shared memory of a block at k: the cluster form's, or (cluster =
// 0) the block form's.
int iid_loss_smem(int k, int cluster) {
  return static_cast<int>(cluster ? cluster_smem_bytes(k)
                                  : block_smem_bytes(k));
}

// z, zt (s, bn, k) f32 contiguous; loss, loss_nl, total (s,) f32;
// p (s, k, k) f32; cluster: the blocks of a sub-head's cluster, kCluster
// (the wrapper's CLUSTER), or 0 for the block form. Returns
// cudaErrorInvalidValue for a k over iid_loss_max_k(), an empty batch or
// another cluster size.
int iid_loss_fwd(const float* z, const float* zt, float* loss, float* loss_nl,
                 float* p, float* total, int s, int bn, int k, float lamb,
                 int cluster, cudaStream_t stream) {
  if (s < 1 || bn < 1 || k < 1 || k > max_k()
      || !valid_cluster(cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tiles_per_thread(k)) {
    case 1: return launch<1>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                             cluster, stream);
    case 2: return launch<2>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                             cluster, stream);
    case 3: return launch<3>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                             cluster, stream);
    default: return launch<4>(z, zt, loss, loss_nl, p, total, s, bn, k, lamb,
                              cluster, stream);
  }
}

// The launch floor: an empty kernel on the grid and cluster of a launch
// of the same form (no shared memory), on the caller's stream.
int iid_loss_launch_floor(int s, int cluster, cudaStream_t stream) {
  if (s < 1 || !valid_cluster(cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 0) {
    empty_kernel<<<s, kThreads, 0, stream>>>();
    return static_cast<int>(cudaGetLastError());
  }
  static std::atomic<uint64_t> done{0};
  cudaError_t err = configure_once(empty_kernel, 0, true, done);
  if (err == cudaSuccess)
    err = launch_clustered(empty_kernel, s * cluster, cluster, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
