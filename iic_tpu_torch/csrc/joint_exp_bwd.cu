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
// TFLOP/s bf16 tensor-core peak (700 W). X8 runs on the tensor cores
// (wgmma, hopper_mma.cuh); X9 still runs f32 FMAs on the CUDA cores (67
// TFLOP/s peak).
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
// X9 design: the rounding of each p_v forces the loop over v outermost: a
// block must finish p_v for its tile before it can round it. Block
// (bx, by, z) owns a 16-row x (8*PX)-column tile (16 = the TPU tool's _RB),
// KM output channels of one image and one of the two outputs: the grid's z
// covers (output, image, channel chunk), so one launch writes dx1 and dx2.
// For each v it restages column v of the adjoint, G[(v, i0:i0+KM), (u, j)]
// for all (u, j), T*k*KM*2 bytes (10 KB at k=15, T=21, KM=16); runs the
// KM x PX f32 accumulators over all (j, u); rounds them with
// __float2bfloat16_rn and adds them into KM x PX f32 output accumulators in
// v order. Since every v needs every channel's patch, all k patches stay
// resident, staged once: k*(16+2h)*(8*PX+2h)*2 bytes. Shared memory at
// k=15, h=10, KM=16, PX=4 (tile 16 x 32): 15*36*52*2 = 56,160 patch bytes
// + 10,080 adjoint bytes = 66,240 bytes, so three 128-thread blocks fit an
// H100 SM's 228 KB; the 2*KM*PX accumulators (128 registers) are what bound
// the block to 128 threads. At k <= 4 (KM=4, PX=16: tile 16 x 128) 32 KB.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "joint_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int V7_ROWS = 16;                 // X9 tile rows (the TPU's _RB)
constexpr int V7_THREADS = 8 * V7_ROWS;     // 8 threads along a tile row

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16(0); }

// dst[a] = float(src[a]) for KM bf16 values, 8 bytes per load; src 8-byte
// aligned. bf16 is the top half of an f32, so widening is a shift or a mask.
template <int KM>
__device__ __forceinline__ void load_widen(const bf16* __restrict__ src,
                                           float (&dst)[KM]) {
  static_assert(KM % 4 == 0, "KM must be a multiple of 4");
#pragma unroll
  for (int a = 0; a < KM; a += 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(src + a);
    dst[a] = __uint_as_float(q.x << 16);
    dst[a + 1] = __uint_as_float(q.x & 0xFFFF0000u);
    dst[a + 2] = __uint_as_float(q.y << 16);
    dst[a + 3] = __uint_as_float(q.y & 0xFFFF0000u);
  }
}

// acc[a][p] += sum_{u < t} g[u*gstride + a] * prow[cols*p - u*pw]: the
// displacement rows u of one (j, v) pair. prow points at the patch entry of
// this thread's first pixel for u = 0; its pixel p sits cols*p to the right.
template <int KM, int PX>
__device__ __forceinline__ void accumulate(float (&acc)[KM][PX],
                                           const bf16* __restrict__ g,
                                           int gstride,
                                           const bf16* __restrict__ prow,
                                           int t, int pw, int cols) {
  for (int u = 0; u < t; ++u) {
    float gv[KM];
    load_widen<KM>(g + u * gstride, gv);
    const bf16* pr = prow - u * pw;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const float val = __bfloat162float(pr[cols * p]);
#pragma unroll
      for (int a = 0; a < KM; ++a) acc[a][p] = fmaf(gv[a], val, acc[a][p]);
    }
  }
}

// Zero-masked patch rows y0-h .. y0+rows+h-1, columns x0-h .. x0+cols'+h-1
// of one (h, w) plane into patch[ph][pw].
__device__ __forceinline__ void stage_patch(bf16* __restrict__ patch,
                                            const bf16* __restrict__ plane,
                                            int y0, int x0, int ph, int pw,
                                            int h, int w, int half_t,
                                            int tid, int nthreads) {
  for (int e = tid; e < ph * pw; e += nthreads) {
    const int pr = e / pw, pc = e - (e / pw) * pw;
    const int yy = y0 - half_t + pr, xx = x0 - half_t + pc;
    patch[e] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
        ? plane[static_cast<size_t>(yy) * w + xx] : bf16_zero();
  }
}

// ------------------------------------------------------------------- X8

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
template <int N, bool kChecked>
__device__ __forceinline__ void v8_row(float (&acc)[V8_WIN][N / 2],
                                       uint32_t (&a)[4], uint32_t a_addr,
                                       uint64_t db, int u0, int lo, int hi,
                                       int t) {
  wgmma_wait<1>();
  ldmatrix_x4(a, a_addr);
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < V8_WIN; ++r) {
    const int u = r + u0;
    if (r >= lo && r <= hi && (!kChecked || (u >= 0 && u < t)))
      wgmma_rs<N>(acc[r], a, desc_advance(db, u * N * V8_PIXEL));
  }
  wgmma_commit();
}

// The products of one v for patch rows pr in [p0, p1), in order, two A
// fragments alternating, each (r, u) tested; a_base is the address of
// patch row p0.
template <int N>
__device__ __forceinline__ void v8_rows_checked(float (&acc)[V8_WIN][N / 2],
                                                uint32_t a_base,
                                                int row_bytes, uint64_t db,
                                                int p0, int p1, int rows,
                                                int half_t) {
  const int t = 2 * half_t + 1;
  const int d = 2 * half_t;
  uint32_t a0[4], a1[4];
  for (int pr = p0; pr < p1; pr += 2) {
    v8_row<N, true>(acc, a0, a_base + (pr - p0) * row_bytes, db, d - pr, 0,
                    rows - 1, t);
    if (pr + 1 < p1)
      v8_row<N, true>(acc, a1, a_base + (pr + 1 - p0) * row_bytes, db,
                      d - pr - 1, 0, rows - 1, t);
  }
  wgmma_wait<0>();
}

// All products of one v for the window: patch rows pr = 0 .. rows+2h-1 in
// order, two A fragments alternating. A full window (8 rows, 2h >= 7) runs
// as a head (pr < 7: rows 0..pr), a body (pr = 7..2h: every row) and a
// tail (pr > 2h: rows pr-2h..7) of unconditional products; any other
// window checks each (r, u). Either way each row sums its products in the
// same order (u descending).
template <int N>
__device__ __forceinline__ void v8_products(float (&acc)[V8_WIN][N / 2],
                                            uint32_t a_base, int row_bytes,
                                            uint64_t db, int rows,
                                            int half_t) {
  constexpr int kRamp = V8_WIN - 1;
  const int t = 2 * half_t + 1;
  const int d = 2 * half_t;
  uint32_t a0[4], a1[4];
  if (rows == V8_WIN && d >= kRamp) {
#pragma unroll
    for (int q = 0; q < kRamp; q += 2) {  // head: pr = q, rows 0..q
      v8_row<N, false>(acc, a0, a_base + q * row_bytes, db, d - q, 0, q, t);
      if (q + 1 < kRamp)
        v8_row<N, false>(acc, a1, a_base + (q + 1) * row_bytes, db,
                         d - q - 1, 0, q + 1, t);
    }
    wgmma_wait<0>();
    int pr = kRamp;
    for (; pr + 1 <= d; pr += 2) {  // body: every row
      v8_row<N, false>(acc, a0, a_base + pr * row_bytes, db, d - pr, 0,
                       V8_WIN - 1, t);
      v8_row<N, false>(acc, a1, a_base + (pr + 1) * row_bytes, db,
                       d - pr - 1, 0, V8_WIN - 1, t);
    }
    if (pr <= d)
      v8_row<N, false>(acc, a0, a_base + pr * row_bytes, db, d - pr, 0,
                       V8_WIN - 1, t);
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < kRamp; q += 2) {  // tail: pr = 2h+1+q, rows q+1..7
      v8_row<N, false>(acc, a0, a_base + (d + 1 + q) * row_bytes, db,
                       -1 - q, q + 1, V8_WIN - 1, t);
      if (q + 1 < kRamp)
        v8_row<N, false>(acc, a1, a_base + (d + 2 + q) * row_bytes, db,
                         -2 - q, q + 2, V8_WIN - 1, t);
    }
    wgmma_wait<0>();
  } else {
    v8_rows_checked<N>(acc, a_base, row_bytes, db, 0, rows + d, rows,
                       half_t);
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

  // The adjoint chunk of (jc, v): T core-matrix tiles B(u), 16 x N each.
  auto stage_chunk = [&](int jc, int v, int buf) {
    const bf16* src = gc + (static_cast<size_t>(ic * jchunks + jc) * t + v)
                               * t * N * V8_CH;
    const uint32_t dst = smem_addr(bufs + buf * chunk_bytes);
    for (int e = tid; e < chunk_bytes / 16; e += V8_THREADS)
      cp_async_16(dst + 16 * e, src + 8 * e, 16);
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
      // Stages patch rows p0 .. p0+n_rows-1 (patch row q is image row
      // wy - h + q), pixels x_lo .. x_lo+n_cols-1 of channel chunk jc at
      // `dst`, zero outside the frame; the two 16-byte halves of a pixel
      // swap places when bit 2 of its column is set, so that the eight rows
      // an ldmatrix phase reads fall in distinct banks.
      auto stage_patch_rows = [&](uint32_t dst, int p0, int n_rows,
                                  int x_lo, int n_cols) {
        for (int e = tid; e < n_rows * n_cols * 2; e += V8_THREADS) {
          const int pr = e / (2 * n_cols);
          const int rem = e - pr * 2 * n_cols;
          const int pc = rem >> 1, c = rem & 1;
          const int yy = wy - half_t + p0 + pr, xx = x_lo + pc;
          const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
          const bf16* src = in ? src_c + (static_cast<size_t>(yy) * w + xx)
                                             * V8_CH + 8 * c
                               : src_c;
          cp_async_16(dst + (pr * n_cols + pc) * V8_PIXEL
                          + 16 * (c ^ ((pc >> 2) & 1)),
                      src, in ? 16 : 0);
        }
      };

      if constexpr (!kSliced) {
        // The whole patch: rows wy-h .. wy+rows-1+h, pixels x0-h .. x0+63+h.
        stage_patch_rows(patch, 0, ph, x0 - half_t, pw);
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
            stage_patch_rows(patch, p0, n_rows, x0 + half_t - v, V8_PIX);
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

    // Epilogue: acc through shared memory, then each channel's row of 64
    // pixels leaves as one coalesced f32 row of dx.
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

// ------------------------------------------------------------------- X9

template <int KM, int PX>
__global__ void __launch_bounds__(V7_THREADS, 3)
dgrad_fused_v7_kernel(const bf16* __restrict__ g2d_1,
                      const bf16* __restrict__ g2d_2,
                      const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                      float* __restrict__ dx1, float* __restrict__ dx2, int n,
                      int k, int h, int w, int half_t) {
  constexpr int TX = 8 * PX;
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  const int ichunks = (k + KM - 1) / KM;
  const int per_out = n * ichunks;
  const int which = blockIdx.z / per_out;  // 0: dx1, 1: dx2
  const int rest = blockIdx.z - which * per_out;
  const int img = rest / ichunks;
  const int i0 = (rest - img * ichunks) * KM;
  const bf16* g2d = which ? g2d_2 : g2d_1;
  const bf16* oth = which ? x1 : x2;
  float* dx = which ? dx2 : dx1;
  const int y0 = blockIdx.y * V7_ROWS;
  const int x0 = blockIdx.x * TX;
  const int pw = TX + 2 * half_t;
  const int ph = V7_ROWS + 2 * half_t;
  const int pplane = ph * pw;
  const size_t plane = static_cast<size_t>(h) * w;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* gcol = reinterpret_cast<bf16*>(smem);  // [j][u][KM], column v
  bf16* patches = gcol + k * t * KM;            // [j][ph][pw]

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;  // pixel p of this thread sits at column tx + 8p

  for (int j = 0; j < k; ++j)
    stage_patch(patches + j * pplane,
                oth + (static_cast<size_t>(img) * k + j) * plane, y0, x0, ph,
                pw, h, w, half_t, tid, V7_THREADS);

  float out[KM][PX];
#pragma unroll
  for (int a = 0; a < KM; ++a)
#pragma unroll
    for (int p = 0; p < PX; ++p) out[a][p] = 0.f;

  const bf16* prow0 = patches + (ty + 2 * half_t) * pw + tx + 2 * half_t;
  for (int v = 0; v < t; ++v) {
    __syncthreads();  // the previous column fully consumed
    // G[(v, i0+a), c] for c = (u, j): each adjoint row is contiguous in c
    for (int e = tid; e < KM * tk; e += V7_THREADS) {
      const int a = e / tk, c = e - (e / tk) * tk;
      const int u = c / k, j = c - (c / k) * k;
      const int i = i0 + a;
      gcol[(j * t + u) * KM + a] =
          (i < k) ? g2d[static_cast<size_t>(v * k + i) * tk + c]
                  : bf16_zero();
    }
    __syncthreads();

    float acc[KM][PX];
#pragma unroll
    for (int a = 0; a < KM; ++a)
#pragma unroll
      for (int p = 0; p < PX; ++p) acc[a][p] = 0.f;
    for (int j = 0; j < k; ++j)
      accumulate<KM, PX>(acc, gcol + j * t * KM, KM, prow0 + j * pplane - v,
                         t, pw, 8);
#pragma unroll
    for (int a = 0; a < KM; ++a)
#pragma unroll
      for (int p = 0; p < PX; ++p)
        out[a][p] += __bfloat162float(__float2bfloat16_rn(acc[a][p]));
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
      if (x < w) row[x] = out[a][p];
    }
  }
}

template <int KM, int PX>
int launch_fused_v7(const bf16* g2d_1, const bf16* g2d_2, const bf16* x1,
                    const bf16* x2, float* dx1, float* dx2, int n, int k,
                    int h, int w, int half_t, cudaStream_t stream) {
  const int t = 2 * half_t + 1;
  const size_t smem = sizeof(bf16) * static_cast<size_t>(k) *
      (static_cast<size_t>(t) * KM
       + static_cast<size_t>(V7_ROWS + 2 * half_t) * (8 * PX + 2 * half_t));
  cudaError_t err = cudaFuncSetAttribute(
      dgrad_fused_v7_kernel<KM, PX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return refused(err);
  const int ichunks = (k + KM - 1) / KM;
  dim3 grid((w + 8 * PX - 1) / (8 * PX), (h + V7_ROWS - 1) / V7_ROWS,
            2 * n * ichunks);
  dgrad_fused_v7_kernel<KM, PX><<<grid, V7_THREADS, smem, stream>>>(
      g2d_1, g2d_2, x1, x2, dx1, dx2, n, k, h, w, half_t);
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

// X9: g2d_1, g2d_2 (kT, kT) bf16, the adjoints of dx1 and dx2; x1, x2
// (n, k, h, w) bf16; dx1, dx2 (n, k, h, w) f32; all contiguous.
int joint_exp_dgrad_fused_v7(const void* g2d_1, const void* g2d_2,
                             const void* x1, const void* x2, float* dx1,
                             float* dx2, int n, int k, int h, int w,
                             int half_t, cudaStream_t stream) {
  const auto* g1 = static_cast<const bf16*>(g2d_1);
  const auto* g2 = static_cast<const bf16*>(g2d_2);
  const auto* a = static_cast<const bf16*>(x1);
  const auto* b = static_cast<const bf16*>(x2);
  if (k <= 4)
    return launch_fused_v7<4, 16>(g1, g2, a, b, dx1, dx2, n, k, h, w, half_t,
                                  stream);
  return launch_fused_v7<16, 4>(g1, g2, a, b, dx1, dx2, n, k, h, w, half_t,
                                stream);
}

}  // extern "C"
