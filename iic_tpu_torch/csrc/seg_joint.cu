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
// Bound: at the main path's shapes (n=120, 128^2, T=21, k=15) K1 is
// 2 * 120*128*128 * 315^2 ~ 3.9e11 FLOP on 2 x 118 MB of input, and each K2
// call is the same count of multiply-adds: far above the H100's ridge, so
// both are compute-bound. This first version runs f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), keeps the operands f32 (the TPU kernel rounds
// them to bf16 for its MXU; without tensor cores bf16 buys nothing here and
// f32 keeps the kernel within f32 rounding of the conv oracle), and builds
// both shifted stacks in shared memory straight from the unpadded inputs,
// masking the frame edges itself: no padded copy reaches device memory.
// Tensor cores (wgmma on bf16 or TF32 tiles fed by TMA) are the later
// speed-up.
//
// K1 design. The TPU kernel carries one (kT x kT) accumulator across its
// sequential grid. Blocks here run in parallel, so the contraction is split:
// block (bx, by, s) owns a 64x64 output tile and the s-th chunk of
// (n, y) rows, and writes its partial sum to part[s]. A second kernel adds
// the partials in a fixed order (deterministic; no atomics) and writes the
// (k, k, T, T) layout. Inside a block it is a plain shared-memory SGEMM:
// 16-wide k-steps along q, 256 threads, 4x4 register micro-tiles.
//
// K2 design. Output-stationary: block (bx, by, z) owns a 32-row x (8*PX)-col
// tile of one image and KM output channels, so no reduction crosses blocks
// and each block writes its tile of the unpadded frame directly (the TPU's
// per-width-tile overlap-add disappears). It walks the other input's
// channels j; for each it stages the (32+2h) x (8*PX+2h) zero-masked patch
// of `other` and the adjoint chunk g[i0:i0+KM, j, :, :] (T*T*KM floats,
// 28 KB at T=21, KM=16 -- the whole adjoint, 397 KB for head A, does not fit
// a block's 227 KB) in shared memory. Each thread keeps KM x PX accumulators
// in registers. dx2 runs through the same kernel via the swap symmetry
// P[i,j,u,v] = P_swap[j,i,2h-u,2h-v] (the wrapper swaps inputs, flips g).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ------------------------------------------------------------------- K1

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int PAD = 4;  // keeps float4 rows aligned; spreads store banks

__global__ void __launch_bounds__(kThreads)
joint_partial_kernel(const float* __restrict__ x1,
                     const float* __restrict__ x2,
                     float* __restrict__ part,
                     int k, int h, int w, int half_t,
                     int rows_total, int rows_per_chunk) {
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
    const int m = m0 + lr + 16 * l;   // (v, i), v-major
    a_ok[l] = m < tk;
    a_off[l] = static_cast<size_t>(a_ok[l] ? m % k : 0) * plane;
    a_shift[l] = (a_ok[l] ? m / k : 0) - half_t;
    const int nn = n0 + lr + 16 * l;  // (u, j), u-major
    b_ok[l] = nn < tk;
    b_off[l] = static_cast<size_t>(b_ok[l] ? nn % k : 0) * plane;
    b_shift[l] = half_t - (b_ok[l] ? nn / k : 0);
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
    const float* x1n = x1 + static_cast<size_t>(img) * k * plane
                       + static_cast<size_t>(y) * w;
    const float* x2n = x2 + static_cast<size_t>(img) * k * plane;
    for (int q0 = 0; q0 < w; q0 += BK) {
      const int q = q0 + kk;
      const bool q_ok = q < w;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int col = q + a_shift[l];
        float av = 0.f;
        if (a_ok[l] && q_ok && col >= 0 && col < w) av = x1n[a_off[l] + col];
        As[kk][lr + 16 * l] = av;
        const int row = y + b_shift[l];
        float bv = 0.f;
        if (b_ok[l] && q_ok && row >= 0 && row < h)
          bv = x2n[b_off[l] + static_cast<size_t>(row) * w + q];
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

  float* p = part + static_cast<size_t>(blockIdx.z) * tk * tk;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + tr * 4 + a;
    if (m >= tk) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int nn = n0 + tc * 4 + b;
      if (nn < tk) p[static_cast<size_t>(m) * tk + nn] = acc[a][b];
    }
  }
}

// Sums the split-K partials in chunk order and scatters P[(v,i),(u,j)] into
// the (k, k, T, T) output.
__global__ void __launch_bounds__(kThreads)
joint_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int splits, int k, int t) {
  const int tk = k * t;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= tk * tk) return;
  const size_t stride = static_cast<size_t>(tk) * tk;
  float s = 0.f;
  for (int c = 0; c < splits; ++c) s += part[c * stride + e];
  const int m = e / tk, nn = e - (e / tk) * tk;
  const int v = m / k, i = m - v * k;
  const int u = nn / k, j = nn - u * k;
  out[((static_cast<size_t>(i) * k + j) * t + u) * t + v] = s;
}

// ------------------------------------------------------------------- K2

constexpr int TY = 32;  // tile rows: 32 rows of 8 threads

template <int KM, int PX>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const float* __restrict__ g2d, const float* __restrict__ oth,
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

  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                // [u][v][KM]
  float* patch = smem + t * t * KM;  // [ph][pw]

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
          ? g2d[static_cast<size_t>(v * k + i) * tk + u * k + j] : 0.f;
    }
    const float* o = oth + (static_cast<size_t>(img) * k + j) * plane;
    for (int e = tid; e < ph * pw; e += kThreads) {
      const int pr = e / pw, pc = e - (e / pw) * pw;
      const int yy = y0 - half_t + pr, xx = x0 - half_t + pc;
      patch[e] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
          ? o[static_cast<size_t>(yy) * w + xx] : 0.f;
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

template <int KM, int PX>
int launch_dgrad(const float* g2d, const float* other, float* dx, int n, int k,
                 int h, int w, int half_t, cudaStream_t stream) {
  const int t = 2 * half_t + 1;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(t) * t * KM
       + static_cast<size_t>(TY + 2 * half_t) * (8 * PX + 2 * half_t));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dgrad_kernel<KM, PX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ichunks = (k + KM - 1) / KM;
  dim3 grid((w + 8 * PX - 1) / (8 * PX), (h + TY - 1) / TY, n * ichunks);
  dgrad_kernel<KM, PX><<<grid, kThreads, smem, stream>>>(
      g2d, other, dx, k, h, w, half_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: x1, x2 (n, k, h, w) f32 contiguous; part (splits, kT, kT) f32 scratch;
// out (k, k, T, T) f32. The (n, y) rows are cut into `splits` chunks of
// `rows_per_chunk` rows.
int seg_joint_fwd(const float* x1, const float* x2, float* part, float* out,
                  int n, int k, int h, int w, int half_t, int splits,
                  int rows_per_chunk, cudaStream_t stream) {
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  dim3 grid((tk + BN - 1) / BN, (tk + BM - 1) / BM, splits);
  joint_partial_kernel<<<grid, kThreads, 0, stream>>>(
      x1, x2, part, k, h, w, half_t, n * h, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = tk * tk;
  joint_reduce_kernel<<<(outs + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, out, splits, k, t);
  return static_cast<int>(cudaGetLastError());
}

// K2: g2d (kT, kT) f32 with g2d[(v,i),(u,j)] = g[i,j,u,v]; other and dx
// (n, k, h, w) f32 contiguous.
int seg_joint_dgrad(const float* g2d, const float* other, float* dx, int n,
                    int k, int h, int w, int half_t, cudaStream_t stream) {
  if (k <= 4)
    return launch_dgrad<4, 16>(g2d, other, dx, n, k, h, w, half_t, stream);
  return launch_dgrad<16, 4>(g2d, other, dx, n, k, h, w, half_t, stream);
}

}  // extern "C"
