// Backward probes of the displacement-joint experiment tool, hand-written for
// Hopper (sm_90a): X8, the input gradient with bf16 operands, and X9, both
// input gradients in one launch with each per-displacement partial rounded
// to bf16.
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
// TFLOP/s bf16 tensor-core peak (700 W). This first version runs f32 FMAs
// on the CUDA cores (67 TFLOP/s peak); tensor cores are the later speed-up.
//
// X8 design: K2's output-stationary block. Block (bx, by, z) owns an
// rb-row x (256/rb * PX)-column tile of one image and KM output channels,
// walks the other input's channels j, and for each stages the zero-masked
// (rb+2h) x (tile columns + 2h) patch of `other` and the adjoint chunk
// G[(v, i0:i0+KM), (u, j)] for all (u, v) in shared memory, both bf16: the
// chunk is T*T*KM*2 bytes, 14 KB at T=21, KM=16, half K2's f32 28 KB. Each
// thread keeps KM x PX f32 accumulators in registers and widens each bf16
// operand once per use. `rb`, the tile rows, is K2's TY=32 made a parameter:
// the 256 threads stand in 256/rb columns of rb rows, so a tile is always
// 256*PX pixels, and rb must divide 256. Each block writes its tile of the
// unpadded frame directly: the TPU's width-tile overlap-add (a 128-lane
// artefact) is not carried over.
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

template <int KM, int PX>
__global__ void __launch_bounds__(kThreads)
dgrad_v8_kernel(const bf16* __restrict__ g2d, const bf16* __restrict__ oth,
                float* __restrict__ dx, int k, int h, int w, int half_t,
                int rb) {
  const int cols = kThreads / rb;  // threads along a tile row
  const int tw = cols * PX;        // tile columns
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  const int ichunks = (k + KM - 1) / KM;
  const int img = blockIdx.z / ichunks;
  const int i0 = (blockIdx.z - img * ichunks) * KM;
  const int y0 = blockIdx.y * rb;
  const int x0 = blockIdx.x * tw;
  const int pw = tw + 2 * half_t;
  const int ph = rb + 2 * half_t;
  const size_t plane = static_cast<size_t>(h) * w;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem);  // [u][v][KM]
  bf16* patch = gs + t * t * KM;             // [ph][pw]

  const int tid = threadIdx.x;
  const int ty = tid / cols;
  const int tx = tid - ty * cols;  // pixel p of this thread: column tx+cols*p

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
      gs[e] = (i < k) ? g2d[static_cast<size_t>(v * k + i) * tk + u * k + j]
                      : bf16_zero();
    }
    stage_patch(patch, oth + (static_cast<size_t>(img) * k + j) * plane, y0,
                x0, ph, pw, h, w, half_t, tid, kThreads);
    __syncthreads();

    const bf16* prow = patch + (ty + 2 * half_t) * pw + tx + 2 * half_t;
    for (int v = 0; v < t; ++v)
      accumulate<KM, PX>(acc, gs + v * KM, t * KM, prow - v, t, pw, cols);
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
      const int x = x0 + tx + cols * p;
      if (x < w) row[x] = acc[a][p];
    }
  }
}

template <int KM, int PX>
int launch_dgrad_v8(const bf16* g2d, const bf16* oth, float* dx, int n, int k,
                    int h, int w, int half_t, int rb, cudaStream_t stream) {
  if (rb < 1 || kThreads % rb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = 2 * half_t + 1;
  const int tw = kThreads / rb * PX;
  const size_t smem = sizeof(bf16) *
      (static_cast<size_t>(t) * t * KM
       + static_cast<size_t>(rb + 2 * half_t) * (tw + 2 * half_t));
  cudaError_t err = cudaFuncSetAttribute(
      dgrad_v8_kernel<KM, PX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return refused(err);
  const int ichunks = (k + KM - 1) / KM;
  dim3 grid((w + tw - 1) / tw, (h + rb - 1) / rb, n * ichunks);
  dgrad_v8_kernel<KM, PX><<<grid, kThreads, smem, stream>>>(
      g2d, oth, dx, k, h, w, half_t, rb);
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

// X8: g2d (kT, kT) bf16 with g2d[(v,i),(u,j)] = g[i,j,u,v]; other (n, k, h,
// w) bf16 and dx (n, k, h, w) f32, contiguous; rb tile rows, dividing 256.
int joint_exp_dgrad_v8(const void* g2d, const void* other, float* dx, int n,
                       int k, int h, int w, int half_t, int rb,
                       cudaStream_t stream) {
  const auto* g = static_cast<const bf16*>(g2d);
  const auto* o = static_cast<const bf16*>(other);
  if (k <= 4)
    return launch_dgrad_v8<4, 8>(g, o, dx, n, k, h, w, half_t, rb, stream);
  return launch_dgrad_v8<16, 4>(g, o, dx, n, k, h, w, half_t, rb, stream);
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
