// X8's implicit GEMM for the input gradient of the displacement joint on
// bf16 operands, hand-written for Hopper (sm_90a) on the tensor cores
// (wgmma, hopper_mma.cuh). Shared by seg_joint.cu (K2, the training path's
// input gradient, at k > 4) and joint_exp_bwd.cu (X8, the experiment tool's
// `dgrad_v8`, and X9, which reuses the window's products and staging rules).
//
//   dx[n,i,y,x] = sum_{j,u,v} G[(v,i),(u,j)] * other[n,j,y-u+h,x-v+h]
//
// with h = half_t, T = 2h+1, u,v in [0,T), zero outside the frame, G the
// (kT x kT) reordered adjoint and `other` the row-shifted input, both bf16:
// the products of two bf16 values are exact in f32, the sums are f32.
//
// X8 design: an implicit GEMM with pixels as M. For one output row y and
// 64 pixels x0.. of it, dx (64 x N) = sum_{v, u} A(u, v) B(u, v), where
//   A(u, v)[p, j] = other[n, j, y - u + h, x0 + p - v + h]   (64 x 16)
//   B(u, v)[j, i] = G[(v, i), (u, j)]                        (16 x N)
// with j a chunk of 16 channels (one wgmma k16 step is one displacement
// (u, v) at k <= 16) and i a chunk of N = 8 (k <= 8) or 16 output channels,
// both zero past k. The wrapper lays `other` out once as channels-last bf16
// padded to 16 channels, so a pixel is 32 bytes, one row of an A fragment,
// and the adjoint as (i chunk, j chunk, v, u) tiles in the layout wgmma
// reads (a plain permute and pad, in the timed call, like the TPU tool's
// jnp.pad). Block (bx, by, z) owns `rb` rows x 64 pixels of one image and
// one i chunk, one warpgroup, and walks its rows in windows of 8. For a
// window it stages with cp.async the zero-masked patch of (8 + 2h) rows x
// (64 + 2h) pixels (src-size 0 fills the pixels outside the frame), then
// for each v the adjoint chunk B(., v) (T N 32 bytes, 10.75 KB at T=21,
// N=16), double-buffered over v. A(u, v) starts 32 bytes further per v,
// which a descriptor cannot express, so it is loaded into registers with
// ldmatrix and multiplied with wgmma RS (A from registers, B from shared
// memory). The loop over v is outermost because it makes A reusable: the
// fragment of patch row pr at v feeds every row r of the window with
// u = r - pr + 2h in [0, T), so the window's 8 accumulators (m64nN, N/2
// registers each) cut the ldmatrix traffic by 8 T / (T + 7), 6x at T=21,
// against one row at a time. Two fragments alternate, each reloaded only
// after wgmma_wait<1> has retired the products that read it. The products
// are tiny (m64n16k16), so what they cost beyond the tensor cores' work is
// issue: a full window runs its patch rows as a head, a body and a tail
// whose row sets are compile-time, with no test around a product. Every
// pixel's sum runs over (j chunk, v ascending, u descending) in that order
// in every tile and window, so rb changes no bit of dx. The epilogue passes
// the accumulators through shared memory (the patch's) so that each
// channel's 64 pixels leave as one coalesced f32 row of dx, in the
// unpadded frame.
// Shared memory does not grow with rb: 96,768 bytes at k=15, h=10 (two
// blocks an SM). It grows with h, and from h = 23 at N=16 (25 at N=8) the
// whole patch no longer fits a block's 227 KB; there the kernel's sliced
// form stages, for each v, only the 64 pixel columns A(., v) reads, in
// slabs of patch rows (the wrapper picks the rows), so every h the TPU
// tool admits (h <= 64) runs, with the same products in the same order.
//
// Bound: at the segmentation path's shapes (n=120, 128^2, T=21, k=15) one
// call needs 2 * n * k^2 * S_h * S_w ~ 3.6e11 FLOP of in-frame products,
// S = 2578 (see seg_joint.cu), on 59 MB of bf16 input and 118 MB of f32
// output: compute-bound, 0.36 ms at the H100 SXM's published 989 TFLOP/s
// bf16 tensor-core peak (700 W).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "joint_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int V8_PIX = 64;      // pixels of a tile row: the m64 of a product
constexpr int V8_WIN = 8;       // output rows a window keeps in registers
constexpr int V8_THREADS = 128;  // one warpgroup
constexpr int V8_CH = 16;       // channels of a chunk: one k16 step
constexpr int V8_PIXEL = 2 * V8_CH;  // bytes of a channels-last pixel
constexpr int V8_EPI_PITCH = V8_PIX + 4;  // f32; spreads the epilogue banks

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Bytes of the patch (the whole patch at slab 0, else one slab of `slab`
// rows x 64 pixels), of the epilogue tile (which reuses the patch's
// memory), of one adjoint chunk, and of a block's dynamic shared memory.
__host__ __device__ inline int v8_patch_bytes(int half_t, int slab) {
  if (slab > 0) return slab * V8_PIX * V8_PIXEL;
  return (V8_WIN + 2 * half_t) * (V8_PIX + 2 * half_t) * V8_PIXEL;
}
__host__ __device__ inline int v8_region_bytes(int n_cols, int half_t,
                                               int slab) {
  const int patch = v8_patch_bytes(half_t, slab);
  const int epi = V8_WIN * n_cols * V8_EPI_PITCH * 4;
  return round_up(patch > epi ? patch : epi, 128);
}
__host__ __device__ inline int v8_chunk_bytes(int n_cols, int t) {
  return t * n_cols * V8_PIXEL;
}
__host__ __device__ inline int v8_smem(int n_cols, int half_t, int slab) {
  return v8_region_bytes(n_cols, half_t, slab)
         + 2 * v8_chunk_bytes(n_cols, 2 * half_t + 1);
}

// One patch row's products: load A(pr, v) from the patch (once the
// products that last read `a` have retired), then acc[r] += A * B(u) with
// u = r + u0 (u0 = 2h - pr) for the rows r in [lo, hi], in r order.
// Unchecked, the caller passes bounds that are compile-time after
// unrolling and meet the patch row at displacements in [0, T), so the
// products are straight-line code; kChecked also tests each (r, u).
// kRestart with `restart` set: the product at u = 2h, which is each row's
// first of a v (u runs down from 2h), sets acc[r] = A * B(u) (scale-d 0),
// so no other instruction writes the accumulators between products.
template <int N, bool kChecked, bool kRestart = false>
__device__ __forceinline__ void v8_row(float (&acc)[V8_WIN][N / 2],
                                       uint32_t (&a)[4], uint32_t a_addr,
                                       uint64_t db, int u0, int lo, int hi,
                                       int t, bool restart = false) {
  wgmma_wait<1>();
  ldmatrix_x4(a, a_addr);
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < V8_WIN; ++r) {
    const int u = r + u0;
    if (r >= lo && r <= hi && (!kChecked || (u >= 0 && u < t)))
      wgmma_rs<N>(acc[r], a, desc_advance(db, u * N * V8_PIXEL),
                  kRestart && restart && u == t - 1 ? 0 : 1);
  }
  wgmma_commit();
}

// The products of one v for patch rows pr in [p0, p1), in order, two A
// fragments alternating, each (r, u) tested; a_base is the address of
// patch row p0.
template <int N, bool kRestart = false>
__device__ __forceinline__ void v8_rows_checked(float (&acc)[V8_WIN][N / 2],
                                                uint32_t a_base,
                                                int row_bytes, uint64_t db,
                                                int p0, int p1, int rows,
                                                int half_t,
                                                bool restart = false) {
  const int t = 2 * half_t + 1;
  const int d = 2 * half_t;
  uint32_t a0[4], a1[4];
  for (int pr = p0; pr < p1; pr += 2) {
    v8_row<N, true, kRestart>(acc, a0, a_base + (pr - p0) * row_bytes, db,
                              d - pr, 0, rows - 1, t, restart);
    if (pr + 1 < p1)
      v8_row<N, true, kRestart>(acc, a1, a_base + (pr + 1 - p0) * row_bytes,
                                db, d - pr - 1, 0, rows - 1, t, restart);
  }
  wgmma_wait<0>();
}

// All products of one v for the window: patch rows pr = 0 .. rows+2h-1 in
// order, two A fragments alternating. A full window (8 rows, 2h >= 7) runs
// as a head (pr < 7: rows 0..pr), a body (pr = 7..2h: every row) and a
// tail (pr > 2h: rows pr-2h..7) of unconditional products; any other
// window checks each (r, u). Either way each row sums its products in the
// same order (u descending).
template <int N, bool kRestart = false>
__device__ __forceinline__ void v8_products(float (&acc)[V8_WIN][N / 2],
                                            uint32_t a_base, int row_bytes,
                                            uint64_t db, int rows,
                                            int half_t,
                                            bool restart = false) {
  constexpr int kRamp = V8_WIN - 1;
  const int t = 2 * half_t + 1;
  const int d = 2 * half_t;
  uint32_t a0[4], a1[4];
  if (rows == V8_WIN && d >= kRamp) {
#pragma unroll
    for (int q = 0; q < kRamp; q += 2) {  // head: pr = q, rows 0..q
      v8_row<N, false, kRestart>(acc, a0, a_base + q * row_bytes, db, d - q,
                                 0, q, t, restart);
      if (q + 1 < kRamp)
        v8_row<N, false, kRestart>(acc, a1, a_base + (q + 1) * row_bytes, db,
                                   d - q - 1, 0, q + 1, t, restart);
    }
    wgmma_wait<0>();
    int pr = kRamp;
    for (; pr + 1 <= d; pr += 2) {  // body: every row
      v8_row<N, false, kRestart>(acc, a0, a_base + pr * row_bytes, db,
                                 d - pr, 0, V8_WIN - 1, t, restart);
      v8_row<N, false, kRestart>(acc, a1, a_base + (pr + 1) * row_bytes, db,
                                 d - pr - 1, 0, V8_WIN - 1, t, restart);
    }
    if (pr <= d)
      v8_row<N, false, kRestart>(acc, a0, a_base + pr * row_bytes, db,
                                 d - pr, 0, V8_WIN - 1, t, restart);
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < kRamp; q += 2) {  // tail: pr = 2h+1+q, rows q+1..7
      v8_row<N, false, kRestart>(acc, a0, a_base + (d + 1 + q) * row_bytes,
                                 db, -1 - q, q + 1, V8_WIN - 1, t, restart);
      if (q + 1 < kRamp)
        v8_row<N, false, kRestart>(acc, a1,
                                   a_base + (d + 2 + q) * row_bytes, db,
                                   -2 - q, q + 2, V8_WIN - 1, t, restart);
    }
    wgmma_wait<0>();
  } else {
    v8_rows_checked<N, kRestart>(acc, a_base, row_bytes, db, 0, rows + d,
                                 rows, half_t, restart);
  }
}

// Stages rows p0 .. p0+n_rows-1 of a window's patch (patch row q is image
// row wy - h + q), pixels x_lo .. x_lo+n_cols-1 of one channel chunk
// (src_c, its (h, w, 16) plane), at `dst` with cp.async, zero outside the
// frame; the two 16-byte halves of a pixel swap places when bit 2 of its
// column is set, so that the eight rows an ldmatrix phase reads fall in
// distinct banks.
__device__ __forceinline__ void v8_stage_rows(uint32_t dst,
                                              const bf16* __restrict__ src_c,
                                              int wy, int p0, int n_rows,
                                              int x_lo, int n_cols, int h,
                                              int w, int half_t) {
  for (int e = threadIdx.x; e < n_rows * n_cols * 2; e += V8_THREADS) {
    const int pr = e / (2 * n_cols);
    const int rem = e - pr * 2 * n_cols;
    const int pc = rem >> 1, c = rem & 1;
    const int yy = wy - half_t + p0 + pr, xx = x_lo + pc;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const bf16* src = in ? src_c + (static_cast<size_t>(yy) * w + xx) * V8_CH
                                   + 8 * c
                         : src_c;
    cp_async_16(dst + (pr * n_cols + pc) * V8_PIXEL
                    + 16 * (c ^ ((pc >> 2) & 1)),
                src, in ? 16 : 0);
  }
}

// Stages the adjoint chunk of (ic, jc, v), T core-matrix tiles B(u) of
// 16 x N, at `dst` with cp.async.
template <int N>
__device__ __forceinline__ void v8_stage_chunk(uint32_t dst,
                                               const bf16* __restrict__ gc,
                                               int ic, int jchunks, int jc,
                                               int v, int t) {
  const bf16* src = gc + (static_cast<size_t>(ic * jchunks + jc) * t + v)
                             * t * N * V8_CH;
  for (int e = threadIdx.x; e < v8_chunk_bytes(N, t) / 16; e += V8_THREADS)
    cp_async_16(dst + 16 * e, src + 8 * e, 16);
}

// The epilogue of a window: its accumulators through shared memory (`epi`,
// which reuses the patch), then each channel's row of 64 pixels leaves as
// one coalesced f32 row of dx (n, k, h, w), in the unpadded frame.
template <int N>
__device__ __forceinline__ void v8_store_window(
    float* __restrict__ dx, float* __restrict__ epi,
    const float (&acc)[V8_WIN][N / 2], int rows, int wy, int x0, int i0,
    int img, int k, int h, int w) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();
  const int prow = 16 * warp + lane / 4;
#pragma unroll
  for (int r = 0; r < V8_WIN; ++r) {
    if (r >= rows) continue;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int p = prow + 8 * ((e >> 1) & 1);
      const int i = 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
      epi[(r * N + i) * V8_EPI_PITCH + p] = acc[r][e];
    }
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(h) * w;
  const int n_valid = min(N, k - i0);
  for (int e = tid; e < rows * n_valid * V8_PIX; e += V8_THREADS) {
    const int p = e % V8_PIX;
    const int ri = e / V8_PIX;
    const int r = ri / n_valid, i = ri - r * n_valid;
    const int x = x0 + p;
    if (x < w)
      dx[(static_cast<size_t>(img) * k + i0 + i) * plane
         + static_cast<size_t>(wy + r) * w + x] =
          epi[(r * N + i) * V8_EPI_PITCH + p];
  }
}

template <int N, bool kSliced>
__global__ void __launch_bounds__(V8_THREADS)
dgrad_v8_kernel(const bf16* __restrict__ gc, const bf16* __restrict__ oc,
                float* __restrict__ dx, int k, int h, int w, int half_t,
                int rb, int slab) {
  const int t = 2 * half_t + 1;
  const int jchunks = (k + V8_CH - 1) / V8_CH;
  const int ichunks = (k + N - 1) / N;
  const int img = blockIdx.z / ichunks;
  const int ic = blockIdx.z - img * ichunks;
  const int i0 = ic * N;
  const int x0 = blockIdx.x * V8_PIX;
  const int y_begin = blockIdx.y * rb;
  const int y_end = min(y_begin + rb, h);
  const int pw = V8_PIX + 2 * half_t;
  const int chunk_bytes = v8_chunk_bytes(N, t);
  const size_t plane = static_cast<size_t>(h) * w;

  extern __shared__ __align__(16) unsigned char smem[];
  float* epi = reinterpret_cast<float*>(smem);  // reuses the patch
  unsigned char* bufs = smem + v8_region_bytes(N, half_t, slab);
  const uint32_t patch = smem_addr(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // this lane's ldmatrix row: pixel 16 warp + lane % 16, channels 8 (lane/16)
  const int lpix = 16 * warp + (lane & 15);
  const int lhalf = lane >> 4;

  auto stage_chunk = [&](int jc, int v, int buf) {
    v8_stage_chunk<N>(smem_addr(bufs + buf * chunk_bytes), gc, ic, jchunks,
                      jc, v, t);
  };

  for (int wy = y_begin; wy < y_end; wy += V8_WIN) {
    const int rows = min(V8_WIN, y_end - wy);
    const int ph = rows + 2 * half_t;
    float acc[V8_WIN][N / 2];
#pragma unroll
    for (int r = 0; r < V8_WIN; ++r)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[r][e] = 0.f;

    for (int jc = 0; jc < jchunks; ++jc) {
      __syncthreads();  // the previous patch or epilogue tile fully read
      const bf16* src_c = oc + static_cast<size_t>(img * jchunks + jc)
                                   * plane * V8_CH;
      if constexpr (!kSliced) {
        // The whole patch: rows wy-h .. wy+rows-1+h, pixels x0-h .. x0+63+h.
        v8_stage_rows(patch, src_c, wy, 0, ph, x0 - half_t, pw, h, w,
                      half_t);
        stage_chunk(jc, 0, 0);
        cp_async_commit();
        for (int v = 0; v < t; ++v) {
          cp_async_wait_all();
          fence_proxy_async();
          __syncthreads();  // chunk v (and the patch) visible to every thread
          if (v + 1 < t) {  // its buffer's products retired at the end of v-1
            stage_chunk(jc, v + 1, (v + 1) & 1);
            cp_async_commit();
          }
          const uint64_t db = smem_desc(bufs + (v & 1) * chunk_bytes,
                                        128 * (N / 8), 128);
          // A(pr, v): the 64 pixels at patch column p + 2h - v of row pr
          const int col = lpix + 2 * half_t - v;
          v8_products<N>(acc, patch + col * V8_PIXEL
                                  + 16 * (lhalf ^ ((col >> 2) & 1)),
                         pw * V8_PIXEL, db, rows, half_t);
        }
      } else {
        // A patch too large for shared memory: for each v only the 64
        // pixels x0+h-v .. x0+h-v+63 that A(., v) reads, in slabs of `slab`
        // patch rows: the same products in the same order as the whole
        // patch's, so both forms give the same bits.
        stage_chunk(jc, 0, 0);
        cp_async_commit();
        const uint32_t a_row = patch + lpix * V8_PIXEL
                               + 16 * (lhalf ^ ((lpix >> 2) & 1));
        for (int v = 0; v < t; ++v) {
          const uint64_t db = smem_desc(bufs + (v & 1) * chunk_bytes,
                                        128 * (N / 8), 128);
          for (int p0 = 0; p0 < ph; p0 += slab) {
            const int n_rows = min(slab, ph - p0);
            __syncthreads();  // the previous slab's fragments loaded
            v8_stage_rows(patch, src_c, wy, p0, n_rows, x0 + half_t - v,
                          V8_PIX, h, w, half_t);
            cp_async_commit();
            cp_async_wait_all();
            fence_proxy_async();
            __syncthreads();  // the slab and chunk v visible to every thread
            if (p0 == 0 && v + 1 < t) {  // buffer's products retired in v-1
              stage_chunk(jc, v + 1, (v + 1) & 1);
              cp_async_commit();
            }
            v8_rows_checked<N>(acc, a_row, V8_PIX * V8_PIXEL, db, p0,
                               p0 + n_rows, rows, half_t);
          }
        }
      }
    }

    v8_store_window<N>(dx, epi, acc, rows, wy, x0, i0, img, k, h, w);
  }
}

template <int N>
int launch_dgrad_v8(const bf16* gc, const bf16* oc, float* dx, int n, int k,
                    int h, int w, int half_t, int rb, int slab,
                    cudaStream_t stream) {
  if (rb < 1 || n < 1 || k < 1 || half_t < 0 || slab < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = v8_smem(N, half_t, slab);
  auto kernel = slab ? dgrad_v8_kernel<N, true> : dgrad_v8_kernel<N, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return refused(err);
  const int ichunks = (k + N - 1) / N;
  dim3 grid((w + V8_PIX - 1) / V8_PIX, (h + rb - 1) / rb, n * ichunks);
  kernel<<<grid, V8_THREADS, smem, stream>>>(gc, oc, dx, k, h, w, half_t, rb,
                                             slab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
