// Backward probes of the displacement-joint experiment tool, hand-written for
// Hopper (sm_90a): X8, the input gradient with bf16 operands on the tensor
// cores, and X9, both input gradients in one launch with each
// per-displacement partial rounded to bf16.
//
// Replaces tools/joint_kernel_exp.py: `_dgrad_kernel_v8` (launched by
// `dgrad_v8`, called twice by `bwd_v8`) and `_dgrad_kernel_v7` (launched by
// `dgrad_fused_v7`).
//
//   p_v[n,i,y,x] = sum_{u,j} G[(v,i),(u,j)] * other[n,j,y-u+h,x-v+h]
//   X8:  dx = sum_v p_v                                   (f32 throughout)
//   X9:  dx = sum_v bf16(p_v), the sum over v in f32, in v order
//
// with h = half_t, T = 2h+1, u,v in [0,T), zero outside the frame, G the
// (kT x kT) reordered adjoint (bf16) and `other` the row-shifted input
// (bf16): dx1 takes G[(v,i),(u,j)] = g[i,j,u,v] and other = x2, dx2 the
// swapped adjoint and other = x1 (the swap symmetry; the wrappers build
// both adjoints). K2's function (seg_joint.cu) on bf16 operands: the
// products of two bf16 values are exact in f32. X9 rounds each p_v to bf16
// before the sum over v, as the TPU kernel's bf16 `da` scratch does; that
// rounding is what X9 computes and sets it apart from X8.
//
// Bound: at the tool's shapes (n=120, 128^2, T=21, k=15) each X8 call needs
// 2 * n * k^2 * S_h * S_w ~ 3.6e11 FLOP of in-frame products, S = 2578 (see
// joint_exp.cu), on 59 MB of bf16 input and 118 MB of f32 output; X9 twice
// that. Compute-bound: 0.36 / 0.73 ms at the H100 SXM's published 989
// TFLOP/s bf16 tensor-core peak (700 W). Both run on the tensor cores
// (wgmma, hopper_mma.cuh).
//
// X8 is the implicit GEMM of dgrad_common.cuh, which K2 (seg_joint.cu)
// shares; its design note is there.
//
//
// X9 design: X8's implicit GEMM with the loop over v outermost. Rounding
// p_v needs it complete, and X8 runs the j chunk outermost, so at k > 16
// its order never holds a complete p_v. Here a window runs, for each v, the
// products of every j chunk (X8's head, body and tail over the patch rows,
// u descending) into the window's p_v accumulators; the wgmma_wait<0> that
// ends each v's products (in X8 too) leaves them final; each is rounded to
// bf16 (__float2bfloat16_rn) and added into f32 dx accumulators held in
// registers beside them (a second m64n16 tile per window row). The next
// v's first product of each row restarts its p_v with scale-d 0: zeroing
// the accumulators between products instead made ptxas serialise every
// product (a WARPGROUP.DEPBAR after each HGMMA, 4.9 ms against 2.9). Each
// pixel's sum is then, over v ascending, bf16 of its (j chunk, u
// descending) sum. Every v needs every j chunk's patch, so the whole
// patches of all j chunks stay resident for the window (96,768 bytes at
// k=15, h=10: two blocks an SM, as X8; up to k=32 at h=10); where they do
// not fit, the sliced form stages, for each (v, j chunk), the 64 columns
// that v reads, in slabs of rows, as X8's sliced form does, so every k and
// every h <= 64 runs. One launch: the grid's z covers (output, image, i
// chunk); dx1 reads x2 with the adjoint, dx2 x1 with the swapped adjoint,
// each pair in X8's layouts at N = 16 (V9_COLS).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dgrad_common.cuh"

namespace {

// ------------------------------------------------------------------- X9

// X9's output channels a block owns, at every k: at N = 8 (k <= 8) ptxas
// serialised every product of this kernel (a WARPGROUP.DEPBAR after each
// HGMMA: 4.6 ms at k=3 against 2.9 at k=15), which N = 16 does not.
constexpr int V9_COLS = 16;

// Bytes of X9's patch region (at slab 0 the whole patches of `patches` j
// chunks side by side, else one slab as in X8's sliced form; the epilogue
// tile reuses it) and of its dynamic shared memory (two adjoint chunks
// follow the region).
__host__ __device__ inline int v9_region_bytes(int n_cols, int half_t,
                                               int slab, int patches) {
  if (slab > 0) return v8_region_bytes(n_cols, half_t, slab);
  const int patch = patches * v8_patch_bytes(half_t, 0);
  const int epi = V8_WIN * n_cols * V8_EPI_PITCH * 4;
  return round_up(patch > epi ? patch : epi, 128);
}
__host__ __device__ inline int v9_smem(int n_cols, int half_t, int slab,
                                       int patches) {
  return v9_region_bytes(n_cols, half_t, slab, patches)
         + 2 * v8_chunk_bytes(n_cols, 2 * half_t + 1);
}

// out += bf16(acc), nearest even, for the window's finished p_v (the next
// v's first products restart acc with scale-d 0).
template <int N>
__device__ __forceinline__ void v9_round_into(float (&out)[V8_WIN][N / 2],
                                              float (&acc)[V8_WIN][N / 2]) {
#pragma unroll
  for (int r = 0; r < V8_WIN; ++r)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      wgmma_fence_operand(acc[r][e]);
      out[r][e] += __bfloat162float(__float2bfloat16_rn(acc[r][e]));
    }
}

template <int N, bool kSliced>
__global__ void __launch_bounds__(V8_THREADS)
dgrad_fused_v7_kernel(const bf16* __restrict__ g_1,
                      const bf16* __restrict__ o_1,
                      const bf16* __restrict__ g_2,
                      const bf16* __restrict__ o_2, float* __restrict__ dx_1,
                      float* __restrict__ dx_2, int n, int k, int h, int w,
                      int half_t, int rb, int slab) {
  const int t = 2 * half_t + 1;
  const int jchunks = (k + V8_CH - 1) / V8_CH;
  const int ichunks = (k + N - 1) / N;
  const int per_out = n * ichunks;
  const int which = blockIdx.z / per_out;  // 0: dx1, 1: dx2
  const int rest = blockIdx.z - which * per_out;
  const int img = rest / ichunks;
  const int ic = rest - img * ichunks;
  const int i0 = ic * N;
  const bf16* gc = which ? g_2 : g_1;
  float* dx = which ? dx_2 : dx_1;
  const int x0 = blockIdx.x * V8_PIX;
  const int y_begin = blockIdx.y * rb;
  const int y_end = min(y_begin + rb, h);
  const int pw = V8_PIX + 2 * half_t;
  const int chunk_bytes = v8_chunk_bytes(N, t);
  const int patch_bytes = v8_patch_bytes(half_t, 0);
  const int steps = t * jchunks;  // (v, j chunk), v outermost
  const size_t plane = static_cast<size_t>(h) * w;
  const bf16* src_img = (which ? o_2 : o_1)
                        + static_cast<size_t>(img) * jchunks * plane * V8_CH;

  extern __shared__ __align__(16) unsigned char smem[];
  float* epi = reinterpret_cast<float*>(smem);  // reuses the patches
  unsigned char* bufs = smem + v9_region_bytes(N, half_t, slab, jchunks);
  const uint32_t patch = smem_addr(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this lane's ldmatrix row: pixel 16 warp + lane % 16, channels 8 (lane/16)
  const int lpix = 16 * warp + (lane & 15);
  const int lhalf = lane >> 4;

  // The adjoint chunk of step s = (v, j chunk) into buffer `buf`.
  auto stage_chunk = [&](int s, int buf) {
    const int v = s / jchunks;
    v8_stage_chunk<N>(smem_addr(bufs + buf * chunk_bytes), gc, ic, jchunks,
                      s - v * jchunks, v, t);
  };

  for (int wy = y_begin; wy < y_end; wy += V8_WIN) {
    const int rows = min(V8_WIN, y_end - wy);
    const int ph = rows + 2 * half_t;
    float acc[V8_WIN][N / 2], out[V8_WIN][N / 2];
#pragma unroll
    for (int r = 0; r < V8_WIN; ++r)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[r][e] = out[r][e] = 0.f;

    __syncthreads();  // the previous window's epilogue tile fully read
    stage_chunk(0, 0);
    if constexpr (!kSliced) {
      // Every j chunk's whole patch: rows wy-h .. wy+rows-1+h, pixels
      // x0-h .. x0+63+h.
      for (int jc = 0; jc < jchunks; ++jc)
        v8_stage_rows(patch + jc * patch_bytes, src_img + jc * plane * V8_CH,
                      wy, 0, ph, x0 - half_t, pw, h, w, half_t);
      cp_async_commit();
      for (int s = 0; s < steps; ++s) {
        const int v = s / jchunks, jc = s - v * jchunks;
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();  // chunk s (and the patches) visible to every thread
        if (s + 1 < steps) {  // its buffer's products retired in step s-1
          stage_chunk(s + 1, (s + 1) & 1);
          cp_async_commit();
        }
        const uint64_t db = smem_desc(bufs + (s & 1) * chunk_bytes,
                                      128 * (N / 8), 128);
        // A(pr, v): the 64 pixels at patch column p + 2h - v of row pr
        const int col = lpix + 2 * half_t - v;
        v8_products<N, true>(acc, patch + jc * patch_bytes + col * V8_PIXEL
                                      + 16 * (lhalf ^ ((col >> 2) & 1)),
                             pw * V8_PIXEL, db, rows, half_t, jc == 0);
        if (jc == jchunks - 1) v9_round_into<N>(out, acc);  // p_v complete
      }
    } else {
      // For each (v, j chunk) only the 64 pixels x0+h-v .. x0+h-v+63 that
      // A(., v) reads, in slabs of `slab` patch rows: the whole patches'
      // products in the same order, so both forms give the same bits.
      cp_async_commit();
      const uint32_t a_row = patch + lpix * V8_PIXEL
                             + 16 * (lhalf ^ ((lpix >> 2) & 1));
      for (int s = 0; s < steps; ++s) {
        const int v = s / jchunks, jc = s - v * jchunks;
        const uint64_t db = smem_desc(bufs + (s & 1) * chunk_bytes,
                                      128 * (N / 8), 128);
        for (int p0 = 0; p0 < ph; p0 += slab) {
          const int n_rows = min(slab, ph - p0);
          __syncthreads();  // the previous slab's fragments loaded
          v8_stage_rows(patch, src_img + jc * plane * V8_CH, wy, p0, n_rows,
                        x0 + half_t - v, V8_PIX, h, w, half_t);
          cp_async_commit();
          cp_async_wait_all();
          fence_proxy_async();
          __syncthreads();  // the slab and chunk s visible to every thread
          if (p0 == 0 && s + 1 < steps) {  // buffer's products retired
            stage_chunk(s + 1, (s + 1) & 1);
            cp_async_commit();
          }
          v8_rows_checked<N, true>(acc, a_row, V8_PIX * V8_PIXEL, db, p0,
                                   p0 + n_rows, rows, half_t, jc == 0);
        }
        if (jc == jchunks - 1) v9_round_into<N>(out, acc);  // p_v complete
      }
    }

    v8_store_window<N>(dx, epi, out, rows, wy, x0, i0, img, k, h, w);
  }
}

template <int N>
int launch_fused_v7(const bf16* g_1, const bf16* o_1, const bf16* g_2,
                    const bf16* o_2, float* dx_1, float* dx_2, int n, int k,
                    int h, int w, int half_t, int rb, int slab,
                    cudaStream_t stream) {
  if (rb < 1 || n < 1 || k < 1 || half_t < 0 || slab < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = v9_smem(N, half_t, slab, (k + V8_CH - 1) / V8_CH);
  auto kernel = slab ? dgrad_fused_v7_kernel<N, true>
                     : dgrad_fused_v7_kernel<N, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return refused(err);
  const int ichunks = (k + N - 1) / N;
  dim3 grid((w + V8_PIX - 1) / V8_PIX, (h + rb - 1) / rb, 2 * n * ichunks);
  kernel<<<grid, V8_THREADS, smem, stream>>>(g_1, o_1, g_2, o_2, dx_1, dx_2,
                                             n, k, h, w, half_t, rb, slab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// X8: gc the adjoint in chunks, (ceil(k/N), ceil(k/16), T v, T u) tiles of
// 16 x N bf16 in the K-major layout without swizzle (core matrix (i/8, j/8)
// at ((j/8) * N/8 + i/8) * 128 bytes), N = 8 for k <= 8 and 16 above, with
// tile (ic, jc, v, u)[i, j] = g2d[(v, N ic + i), (u, 16 jc + j)], zero past
// k; oc the other input channels-last, (n, ceil(k/16), h, w, 16) bf16, zero
// past k; dx (n, k, h, w) f32; all contiguous. rb >= 1 tile rows; slab 0
// stages the whole patch, slab > 0 each v's 64 columns in slabs of that
// many rows.
int joint_exp_dgrad_v8(const void* gc, const void* oc, float* dx, int n,
                       int k, int h, int w, int half_t, int rb, int slab,
                       cudaStream_t stream) {
  const auto* g = static_cast<const bf16*>(gc);
  const auto* o = static_cast<const bf16*>(oc);
  if (k <= 8)
    return launch_dgrad_v8<8>(g, o, dx, n, k, h, w, half_t, rb, slab,
                              stream);
  return launch_dgrad_v8<16>(g, o, dx, n, k, h, w, half_t, rb, slab, stream);
}

// X9: (g_1, o_1) the operands of dx1 (the adjoint and x2) and (g_2, o_2)
// those of dx2 (the swapped adjoint and x1), each pair in X8's layouts
// (above) with N = 16 at every k; dx1, dx2 (n, k, h, w) f32; all
// contiguous. rb >= 1 tile rows;
// slab 0 keeps every j chunk's whole patch, slab > 0 stages each (v, j
// chunk)'s 64 columns in slabs of that many rows.
int joint_exp_dgrad_fused_v7(const void* g_1, const void* o_1,
                             const void* g_2, const void* o_2, float* dx1,
                             float* dx2, int n, int k, int h, int w,
                             int half_t, int rb, int slab,
                             cudaStream_t stream) {
  return launch_fused_v7<V9_COLS>(
      static_cast<const bf16*>(g_1), static_cast<const bf16*>(o_1),
      static_cast<const bf16*>(g_2), static_cast<const bf16*>(o_2), dx1, dx2,
      n, k, h, w, half_t, rb, slab, stream);
}

}  // extern "C"
