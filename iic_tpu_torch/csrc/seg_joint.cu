// Displacement joint of the uncollapsed segmentation IID loss, forward (K1)
// and input gradient (K2), hand-written for Hopper (sm_90a).
//
// Replaces iic_tpu/ops/pallas/seg_joint_kernel.py: `_joint_kernel` (launched
// by `_joint_pallas_raw`) and `_dgrad_kernel` (launched by `_dgrad_pallas`).
//
//   P[i,j,u,v] = sum_{n,y,q} x1[n,i,y,q+v-h] * x2[n,j,y+h-u,q]        (K1)
//   dx[n,i,y,x] = sum_{j,u,v} g[i,j,u,v] * other[n,j,y-u+h,x-v+h]      (K2)
//
// with h = half_t, T = 2h+1, u,v in [0,T) and zero outside each frame.
// K1 is the (kT x kT) GEMM  P[(v,i),(u,j)] = A @ B^T  whose contraction runs
// over (n, y, q) = n*H*W: A is the column-shifted x1 stack, B the row-shifted
// x2 stack. Only the H real x1 rows contribute, so there is no padded-row work.
//
// Bound: at the main path's shapes (n=120, 128^2, T=21, k=15) K1 needs
// 2 * n * k^2 * S_h * S_w ~ 3.6e11 FLOP, S = sum_{|d|<=h} (128 - |d|) = 2578
// the in-frame rows (columns) over the shifts, on 2 x 118 MB of f32 input
// (59 MB each once rounded to bf16), and each K2 call the same count of
// multiply-adds: far above the H100's ridge, so both are compute-bound.
// The TPU kernels round their operands to bf16 for the MXU and sum in f32,
// and so do K1 and K2 on the card; at the bf16 tensor-core peak (989
// TFLOP/s) each needs 0.36 ms. (K1's tensor-core form issues 5.1e11: k
// padded to 16 channels, 6 M tiles of 4 shifts for T = 21, and the zeros
// outside the frame.)
//
// K1 design. K1 computes what the TPU's `_joint_kernel` computes: x1 and
// x2 rounded to bf16 (nearest even; the wrapper's one layout pass), exact
// products, f32 sums. At k > 4 it is the stack product on the tensor cores
// of joint_fwd_common.cuh: both inputs laid out channels-last in chunks of
// 16 channels, A (the column-shifted x1 stack) from registers through
// ldmatrix.trans, so a shift is a pointer, and B (the row-shifted x2
// stack) read by a descriptor from a staged window of x2 rows with its
// columns ordered (T - 1 - u, j), so the row shift needs no build either;
// m64n168k16 wgmma in two warpgroups a block while a third stages the next
// slab with cp.async. The TPU kernel carries one
// (kT x kT) accumulator across its sequential grid. Blocks here run in
// parallel, so the contraction is split into chunks of whole passes of
// rows; each block writes its partial sum to part[s], and a second kernel
// adds the partials in a fixed order (deterministic; no atomics) and
// writes the (k, k, T, T) layout. The chunks are short (the wrapper's
// K1_CHUNK_ROWS) because the tensor cores' f32 sums truncate and a joint's
// terms are all positive. X7 (joint_exp.cu) launches the same kernel. At
// k <= 4 the 16-channel padding issues 5.3x the work (k = 3); there K1
// keeps its CUDA-core form, on the same bf16 operands: a plain
// shared-memory SGEMM (joint_common.cuh, X7's CUDA-core form), block
// (bx, by, s) a 64x64 output tile and the s-th chunk of (n, y) rows, both
// shifted stacks built in shared memory from the unpadded inputs, 16-wide
// k-steps along q, 256 threads, 4x4 register micro-tiles, the same split
// and ordered reduce.
//
// K2 design. K2 computes what the TPU's `_dgrad_kernel` computes: the
// adjoint and `other` rounded to bf16 (nearest even; the wrapper's one
// layout pass), exact products, f32 sums, dx f32 in the unpadded frame.
// At k > 4 it is X8's implicit GEMM on the tensor cores (dgrad_common.cuh:
// pixels as M, 16 channels of j as each k16 step, A from a channels-last
// patch through ldmatrix into wgmma RS), launched at 16 tile rows a block;
// the same kernel and operands as X8 (joint_exp_bwd.cu), so the two give
// the same bits. At k <= 4 that form pads j to 16 and issues 5.3x the
// work; there K2 keeps its CUDA-core form, here on the same bf16 operands:
// output-stationary, block (bx, by, z) owns a 32-row x (8*PX)-col tile of
// one image and KM output channels, so no reduction crosses blocks and
// each block writes its tile of the unpadded frame directly (the TPU's
// per-width-tile overlap-add disappears). It walks the other input's
// channels j; for each it stages the (32+2h) x (8*PX+2h) zero-masked patch
// of `other` and the adjoint chunk g[i0:i0+KM, j, :, :] in shared memory,
// widened to f32, and each thread keeps KM x PX accumulators in registers.
// dx2 runs through the same kernels via the swap symmetry
// P[i,j,u,v] = P_swap[j,i,2h-u,2h-v] (the wrapper swaps inputs, flips g).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include "dgrad_common.cuh"
#include "joint_common.cuh"
#include "joint_fwd_common.cuh"

namespace {

// ------------------------------------------------------------------- K2

constexpr int TY = 32;  // tile rows: 32 rows of 8 threads
constexpr int K2_RB = 16;  // tile rows of the tensor-core form (X8's best)

// The CUDA-core form (k <= 4), templated on the input type as K1's kernel
// is: bf16 operands here, widened to f32 as they are staged.
template <typename T, int KM, int PX>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const T* __restrict__ g2d, const T* __restrict__ oth,
             float* __restrict__ dx, int k, int h, int w, int half_t) {
  constexpr int TX = 8 * PX;
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  const int ichunks = (k + KM - 1) / KM;
  const int img = blockIdx.z / ichunks;
  const int i0 = (blockIdx.z - img * ichunks) * KM;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const int pw = TX + 2 * half_t;
  const int ph = TY + 2 * half_t;
  const size_t plane = static_cast<size_t>(h) * w;

  // named apart from X8's `smem` (dgrad_common.cuh): extern shared arrays
  // of one translation unit must agree in type
  extern __shared__ __align__(16) float k2_smem[];
  float* gs = k2_smem;                // [u][v][KM]
  float* patch = k2_smem + t * t * KM;  // [ph][pw]

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;  // pixel p of this thread sits at column tx + 8p

  float acc[KM][PX];
#pragma unroll
  for (int a = 0; a < KM; ++a)
#pragma unroll
    for (int p = 0; p < PX; ++p) acc[a][p] = 0.f;

  for (int j = 0; j < k; ++j) {
    __syncthreads();  // previous channel's tiles fully consumed
    for (int e = tid; e < t * t * KM; e += kThreads) {
      const int ii = e % KM;
      const int uv = e / KM;
      const int u = uv / t, v = uv - (uv / t) * t;
      const int i = i0 + ii;
      gs[e] = (i < k)
          ? widen(g2d[static_cast<size_t>(v * k + i) * tk + u * k + j]) : 0.f;
    }
    const T* o = oth + (static_cast<size_t>(img) * k + j) * plane;
    for (int e = tid; e < ph * pw; e += kThreads) {
      const int pr = e / pw, pc = e - (e / pw) * pw;
      const int yy = y0 - half_t + pr, xx = x0 - half_t + pc;
      patch[e] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
          ? widen(o[static_cast<size_t>(yy) * w + xx]) : 0.f;
    }
    __syncthreads();

    for (int u = 0; u < t; ++u) {
      const float* prow = patch + (ty - u + 2 * half_t) * pw + tx + 2 * half_t;
      const float* gu = gs + u * t * KM;
      for (int v = 0; v < t; ++v) {
        float gv[KM];
#pragma unroll
        for (int a = 0; a < KM; a += 4) {
          const float4 q = *reinterpret_cast<const float4*>(gu + v * KM + a);
          gv[a] = q.x; gv[a + 1] = q.y; gv[a + 2] = q.z; gv[a + 3] = q.w;
        }
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const float val = prow[8 * p - v];
#pragma unroll
          for (int a = 0; a < KM; ++a) acc[a][p] = fmaf(gv[a], val, acc[a][p]);
        }
      }
    }
  }

  const int y = y0 + ty;
  if (y >= h) return;
#pragma unroll
  for (int a = 0; a < KM; ++a) {
    const int i = i0 + a;
    if (i >= k) continue;
    float* row = dx + (static_cast<size_t>(img) * k + i) * plane
                 + static_cast<size_t>(y) * w;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int x = x0 + tx + 8 * p;
      if (x < w) row[x] = acc[a][p];
    }
  }
}

template <typename T, int KM, int PX>
int launch_dgrad(const T* g2d, const T* other, float* dx, int n, int k,
                 int h, int w, int half_t, cudaStream_t stream) {
  const int t = 2 * half_t + 1;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(t) * t * KM
       + static_cast<size_t>(TY + 2 * half_t) * (8 * PX + 2 * half_t));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dgrad_kernel<T, KM, PX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return refused(err);
  }
  const int ichunks = (k + KM - 1) / KM;
  dim3 grid((w + 8 * PX - 1) / (8 * PX), (h + TY - 1) / TY, n * ichunks);
  dgrad_kernel<T, KM, PX><<<grid, kThreads, smem, stream>>>(
      g2d, other, dx, k, h, w, half_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 at k > 4, on the tensor cores: x1, x2 (n, k, h, w) f32 contiguous;
// x1c, x2c (n, ceil(k/16), h, w, 16) bf16 scratch for the layout pass;
// part (splits, kT, kT) f32 scratch; out (k, k, T, T) f32. The (n, y) rows
// are cut into passes of rb rows of one image, and the passes into
// `splits` chunks of passes_per_chunk.
int seg_joint_fwd(const float* x1, const float* x2, void* x1c, void* x2c,
                  float* part, float* out, int n, int k, int h, int w,
                  int half_t, int rb, int passes_per_chunk, int splits,
                  cudaStream_t stream) {
  return launch_joint_fwd_mma<float>(x1, x2, static_cast<bf16*>(x1c),
                                     static_cast<bf16*>(x2c), part, out, n,
                                     k, h, w, half_t, rb, passes_per_chunk,
                                     splits, stream);
}

// K1's CUDA-core form (k <= 4): x1, x2 (n, k, h, w) bf16 contiguous; part
// (splits, kT, kT) f32 scratch; out (k, k, T, T) f32. The (n, y) rows are
// cut into `splits` chunks of `rows_per_chunk` rows.
int seg_joint_fwd_small(const void* x1, const void* x2, float* part,
                        float* out, int n, int k, int h, int w, int half_t,
                        int splits, int rows_per_chunk,
                        cudaStream_t stream) {
  return launch_joint_fwd<bf16>(static_cast<const bf16*>(x1),
                                static_cast<const bf16*>(x2), part, out, n,
                                k, h, w, half_t, splits, rows_per_chunk,
                                stream);
}

// K2 at k > 4, X8's tensor-core form: gc, oc the adjoint and the other
// input in X8's layouts (dgrad_common.cuh, joint_exp_bwd.cu's
// joint_exp_dgrad_v8), bf16; dx (n, k, h, w) f32; all contiguous. slab 0
// stages the whole patch, slab > 0 each v's 64 columns in slabs of that
// many rows (the wrapper's plan).
int seg_joint_dgrad(const void* gc, const void* oc, float* dx, int n, int k,
                    int h, int w, int half_t, int slab, cudaStream_t stream) {
  const auto* g = static_cast<const bf16*>(gc);
  const auto* o = static_cast<const bf16*>(oc);
  if (k <= 8)
    return launch_dgrad_v8<8>(g, o, dx, n, k, h, w, half_t, K2_RB, slab,
                              stream);
  return launch_dgrad_v8<16>(g, o, dx, n, k, h, w, half_t, K2_RB, slab,
                             stream);
}

// K2's CUDA-core form (k <= 4): g2d (kT, kT) bf16 with
// g2d[(v,i),(u,j)] = g[i,j,u,v]; other (n, k, h, w) bf16; dx (n, k, h, w)
// f32; all contiguous.
int seg_joint_dgrad_small(const void* g2d, const void* other, float* dx,
                          int n, int k, int h, int w, int half_t,
                          cudaStream_t stream) {
  return launch_dgrad<bf16, 4, 16>(static_cast<const bf16*>(g2d),
                                   static_cast<const bf16*>(other), dx, n, k,
                                   h, w, half_t, stream);
}

}  // extern "C"
