// Forward probes of the displacement-joint experiment tool, hand-written for
// Hopper (sm_90a): X2, the joint forward with bf16 operands and its
// ablations, X1, the stack-product probe on the tensor cores, and X7, the
// joint forward with bf16 operands on K1's kernels.
//
// Replaces tools/joint_kernel_exp.py: `_joint_kernel_v2` (launched by
// `joint_fwd_v2`), `_mm_probe_kernel` (launched by `mm_probe`) and
// `_joint_kernel_v8` (launched by `joint_fwd_v8`).
//
//   P[i,j,u,v] = sum_{n,y,q} x1[n,i,y,q+v-h] * x2[n,j,y+h-u,q]         (X2)
//
// with h = half_t, T = 2h+1, zero outside each frame: K1's joint
// (seg_joint.cu), here with both inputs rounded to bf16 (the wrapper rounds
// f32 inputs, as the TPU tool's astype does) and f32 accumulation. As in K1
// it is the (kT x kT) GEMM P[(v,i),(u,j)] = A @ B^T over the (n, y, q)
// contraction, A the column-shifted x1 stack, B the row-shifted x2 stack.
//
// Bound: at the tool's shapes (n=120, 128^2, T=21, k=15) X2 needs
// 2 * n * k^2 * S_h * S_w ~ 3.6e11 FLOP, S = sum_{|d|<=h} (128 - |d|) = 2578
// the in-frame rows (columns) over the shifts, on 2 x 59 MB of bf16 input:
// far above the H100's ridge, so compute-bound (0.36 ms at the 989 TFLOP/s
// bf16 tensor-core peak). Like K1 it also multiplies the zeros outside the
// frame, 2 * n*h*w * (kT)^2 ~ 3.9e11 FLOP issued. X2 and X7 run the product
// as f32 FMAs on the CUDA cores (67 TFLOP/s peak): each bf16 pair is widened
// in registers, so the tiles in shared memory hold half the bytes of K1's.
// X1 issues the TPU probe's count of products, 2 * (kT)^2 * n*(t_hi -
// t_lo)*rb*128 ~ 4.4e11 FLOP at rb=16, over no input at all, so only the
// tensor cores' issue rate bounds it (0.44 ms); it runs on them (wgmma,
// hopper_mma.cuh).
//
// X2 design. K1's structure: block (bx, by, s) owns a 64x64 tile of the
// (kT x kT) output and the s-th chunk of the (n, y) rows, and writes its
// partial sum to part[s]; a second kernel adds the partials in chunk order
// (deterministic, no atomics) and scatters them into (k, k, T, T). A pass
// stages, for the tile's 64 A rows and 64 B rows, `rb` image rows x 8
// columns of the contraction (depth 8*rb) as bf16 in shared memory, built
// straight from the unpadded inputs with the frame edges masked: so `rb` is
// the image rows one block stages per shared-memory pass, and a pass needs
// 2 * 64 * (8*rb + 2) * 2 bytes (33 KB at rb=16, 132 KB at rb=64; rb=128
// does not fit and is refused). Both tiles are contraction-contiguous
// ((M, K) and (N, K), the TPU tool's "mk-nk"), rows padded by two bf16 so
// that the 16 rows of B a warp reads at one k-step fall in 16 distinct
// banks. Each thread keeps a 4x4 micro-tile (rows tr + 16a, columns
// tc + 16b) and widens two bf16 of each operand per load.
//
// The TPU kernel cuts its B window into three 16-row BlockSpec blocks and
// builds the stacks with static slices because Mosaic cannot lower a
// dynamic sublane slice of a bf16 block; nothing here needs that, so the
// windows are gone and every shift is a plain masked index.
//
// Modes are instantiations of the one kernel body and differ only in what
// they skip:
//   full            loads, builds and product ("rank3" is the same launch:
//                   here the contraction over (rb, 128) and over rb*128 is
//                   one loop);
//   mm-only         no global loads and no builds: the product runs over
//                   tiles filled with bf16 1.0 once at block start, so each
//                   entry of P is the count of contraction terms issued,
//                   ceil(n*h / rb) * ceil(w / 8) * 8*rb (the wrapper cuts
//                   the rows into chunks of whole passes), exact in f32
//                   while it stays under 2^24;
//   copies-only     loads and builds, no product. Each thread reads back
//                   what it staged and adds the bf16 bit patterns as
//                   unsigned 32-bit integers; per stack row, the sums go
//                   through shared then global atomics (blocks of the first
//                   tile column publish A rows, of the first tile row B
//                   rows). Integer addition modulo 2^32 is exact and
//                   commutative, so the checksum depends neither on the
//                   split count nor on the block order:
//                     S_A[(v,i)] = sum_{n,y,q} bits(x1[n,i,y,q+v-h])
//                     S_B[(u,j)] = sum_{n,y,q} bits(x2[n,j,y+h-u,q])
//                     P[i,j,u,v] = float((S_A[(v,i)] + S_B[(u,j)]) mod 2^32)
//                   with bits() the 16-bit pattern and 0 outside the frame;
//   aligned-copies  the full kernel with every shift at zero: P[:, :, u, v]
//                   is the zero-displacement joint for every (u, v), exactly
//                   the same value in each.
//
// X1 is the stack product alone on Hopper's tensor cores. Block (bx, by, s)
// owns a 64 x 160 tile of the (kT, kT) output (kT = 315 at the tool's
// default: 5 x 2 tiles) and the s-th chunk of the passes, one warpgroup
// with its m64n160 f32 accumulator in registers (80 a thread). The A
// (64 x 8*rb) and B tiles are filled with bf16 ones once, at block start,
// in the layout wgmma reads; B is K-major for "mk-nk" and MN-major for
// "mk-kn" (the transpose bit: the card's counterpart of the TPU tool's two
// forms). A pass is then rb/2 wgmma k16 steps along the tiles, one commit
// group a pass with one more group in flight, and no barrier in the loop.
// Every entry of its (kT, kT) output is the count of terms issued,
// n * (t_hi - t_lo) * rb*128 (2,211,840 at the tool's default), so a pass
// skipped or a descriptor that strays into the zeroed guards shows. The
// partials go through the ordered reduce (no atomics). rb must be even (a
// pass is whole k16 steps) and its two tiles must fit a block: rb <= 64.
//
// The row tables, the partial store and the ordered reduce are K1's
// (joint_common.cuh).
//
// X7. The TPU tool's v8 is its production K1 with the row tile `rb` as a
// parameter: bf16 stacks, f32 accumulation. Here it is K1's own kernels on
// bf16 inputs. Its tensor-core form is K1's stack product
// (joint_fwd_common.cuh) over the same channels-last operands: `rb` is
// what it is on the TPU, the (n, y) rows a block stages per pass, each
// pass cut into the kernel's slabs of 16 rows x 64 pixels (a whole pass of
// 32 or 64 rows does not fit a block beside its window), and a split-K
// chunk is whole passes, so rb changes the order of the f32 sums only at a
// ragged frame, never the work. Its CUDA-core form is K1's SGEMM
// (joint_common.cuh) instantiated on bf16 inputs: each bf16 value is
// widened once, when the loader stores it into the f32 shared tiles, and
// `rb` is the (n, y) row quantum of a split-K chunk (the wrapper cuts the
// n*h rows into chunks of a multiple of rb rows, as X2's does); no shared
// memory depends on it (two 16 x 68 f32 tiles, 8.7 KB). X3 and X5 add
// their stages in that form's order and equal it bit for bit.
// Bound: as X2, 0.36 ms at the H100 SXM's published bf16 tensor-core peak
// (2 * n * k^2 * S_h * S_w in-frame products), on 2 x 59 MB of bf16 input.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "joint_common.cuh"
#include "joint_fwd_common.cuh"

namespace {

constexpr int TILE = 64;  // output tile edge
constexpr int BQ = 8;     // image columns per pass

enum Mode { kFull = 0, kMmOnly = 1, kCopiesOnly = 2, kAligned = 3 };

__host__ __device__ inline int pitch(int rb) { return BQ * rb + 2; }

// X2's dynamic shared memory: the A and B tiles, (64, 8*rb + 2) bf16 each.
__host__ __device__ inline size_t stage_bytes(int rb) {
  return 2 * sizeof(__nv_bfloat16) * TILE * pitch(rb);
}

// acc[a][b] += sum_{kq < depth} A[tr + 16a][kq] * B[tc + 16b][kq]; A and B
// are (M, K) and (N, K) with pitch lda.
__device__ __forceinline__ void product(const __nv_bfloat16* __restrict__ As,
                                        const __nv_bfloat16* __restrict__ Bs,
                                        int depth, int lda, int tr, int tc,
                                        float (&acc)[4][4]) {
#pragma unroll 2
  for (int kq = 0; kq < depth; kq += 2) {
    float2 a[4], b[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a[s] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          As + (tr + 16 * s) * lda + kq));
      b[s] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          Bs + (tc + 16 * s) * lda + kq));
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[p][q] = fmaf(a[p].x, b[q].x, acc[p][q]);
        acc[p][q] = fmaf(a[p].y, b[q].y, acc[p][q]);
      }
  }
}

// Fills the staged tiles with bf16 1.0 (0x3F80): a product over them adds
// one per contraction term.
__device__ __forceinline__ void fill_ones(__nv_bfloat16* s, size_t bytes) {
  unsigned* w = reinterpret_cast<unsigned*>(s);
  for (size_t e = threadIdx.x; e < bytes / 4; e += kThreads)
    w[e] = 0x3F803F80u;
}

// ------------------------------------------------------------------- X2

template <int MODE>
__global__ void __launch_bounds__(kThreads)
joint_v2_partial_kernel(const __nv_bfloat16* __restrict__ x1,
                        const __nv_bfloat16* __restrict__ x2,
                        float* __restrict__ part, unsigned* __restrict__ chk,
                        int k, int h, int w, int half_t, int rb,
                        int rows_total, int rows_per_chunk) {
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  const int depth = BQ * rb;
  const int lda = pitch(rb);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const int r_begin = blockIdx.z * rows_per_chunk;
  const int r_end = min(r_begin + rows_per_chunk, rows_total);
  const size_t plane = static_cast<size_t>(h) * w;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + TILE * lda;
  // Per stack row of this tile: input channel (-1 past kT) and shift.
  __shared__ int a_chan[TILE], a_shift[TILE], b_chan[TILE], b_shift[TILE];
  __shared__ unsigned row_sum[2][TILE];  // copies-only

  if (tid < TILE) {
    const int m = m0 + tid;
    const int nn = n0 + tid;
    a_chan[tid] = m < tk ? stack_chan(m, tk, k) : -1;
    b_chan[tid] = nn < tk ? stack_chan(nn, tk, k) : -1;
    a_shift[tid] = MODE == kAligned ? 0 : a_shift_of(m, tk, k, half_t);
    b_shift[tid] = MODE == kAligned ? 0 : b_shift_of(nn, tk, k, half_t);
    row_sum[0][tid] = row_sum[1][tid] = 0u;
  }
  if (MODE == kMmOnly) fill_ones(As, stage_bytes(rb));
  __syncthreads();

  // Loader role: 64 threads sweep the pass's depth, four rows at a time.
  const int kk = tid & 63;
  const int mrow = tid >> 6;
  // Compute role: rows tr + 16a, columns tc + 16b.
  const int tr = tid / 16;
  const int tc = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  unsigned sum_a[16], sum_b[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) sum_a[s] = sum_b[s] = 0u;

  for (int r0 = r_begin; r0 < r_end; r0 += rb) {
    for (int q0 = 0; q0 < w; q0 += BQ) {
      if (MODE != kMmOnly) {
        for (int kidx = kk; kidx < depth; kidx += 64) {
          const int r = r0 + kidx / BQ;
          const int q = q0 + kidx % BQ;
          const bool ok = r < r_end && q < w;
          const int img = ok ? r / h : 0;
          const int y = ok ? r - img * h : 0;
          const __nv_bfloat16* x1r = x1 + static_cast<size_t>(img) * k * plane
                                     + static_cast<size_t>(y) * w;
          const __nv_bfloat16* x2n = x2 + static_cast<size_t>(img) * k * plane;
#pragma unroll 4
          for (int s = 0; s < 16; ++s) {
            const int mm = mrow + 4 * s;
            __nv_bfloat16 av = __float2bfloat16(0.f);
            const int ca = a_chan[mm];
            const int col = q + a_shift[mm];
            if (ok && ca >= 0 && col >= 0 && col < w)
              av = x1r[static_cast<size_t>(ca) * plane + col];
            As[mm * lda + kidx] = av;
            __nv_bfloat16 bv = __float2bfloat16(0.f);
            const int cb = b_chan[mm];
            const int row = y + b_shift[mm];
            if (ok && cb >= 0 && row >= 0 && row < h)
              bv = x2n[static_cast<size_t>(cb) * plane
                       + static_cast<size_t>(row) * w + q];
            Bs[mm * lda + kidx] = bv;
          }
        }
      }
      __syncthreads();
      if (MODE == kCopiesOnly) {
        for (int kidx = kk; kidx < depth; kidx += 64) {
#pragma unroll
          for (int s = 0; s < 16; ++s) {
            const int mm = mrow + 4 * s;
            sum_a[s] += __bfloat16_as_ushort(As[mm * lda + kidx]);
            sum_b[s] += __bfloat16_as_ushort(Bs[mm * lda + kidx]);
          }
        }
      } else {
        product(As, Bs, depth, lda, tr, tc, acc);
      }
      __syncthreads();
    }
  }

  if (MODE == kCopiesOnly) {
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      atomicAdd(&row_sum[0][mrow + 4 * s], sum_a[s]);
      atomicAdd(&row_sum[1][mrow + 4 * s], sum_b[s]);
    }
    __syncthreads();
    if (tid < TILE) {
      if (blockIdx.x == 0 && m0 + tid < tk)
        atomicAdd(&chk[m0 + tid], row_sum[0][tid]);
      if (blockIdx.y == 0 && n0 + tid < tk)
        atomicAdd(&chk[tk + n0 + tid], row_sum[1][tid]);
    }
    return;
  }
  store_partial(part, tk, m0 + tr, n0 + tc, 16, acc);
}

// copies-only: P[i,j,u,v] = float((S_A[(v,i)] + S_B[(u,j)]) mod 2^32).
__global__ void __launch_bounds__(kThreads)
checksum_kernel(const unsigned* __restrict__ chk, float* __restrict__ out,
                int k, int t) {
  const int tk = k * t;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= tk * tk) return;
  out[scatter_index(e, k, t)] =
      __uint2float_rn(chk[e / tk] + chk[tk + e % tk]);
}

template <int MODE>
int launch_v2(const __nv_bfloat16* x1, const __nv_bfloat16* x2, float* part,
              unsigned* chk, int n, int k, int h, int w, int half_t, int rb,
              int splits, int rows_per_chunk, cudaStream_t stream) {
  const int tk = k * (2 * half_t + 1);
  const size_t smem = stage_bytes(rb);
  cudaError_t err = cudaFuncSetAttribute(
      joint_v2_partial_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return refused(err);
  dim3 grid((tk + TILE - 1) / TILE, (tk + TILE - 1) / TILE, splits);
  joint_v2_partial_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      x1, x2, part, chk, k, h, w, half_t, rb, n * h, rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- X1

constexpr int PROBE_M = 64;          // output tile rows: one m64 product
constexpr int PROBE_N = 160;         // output tile columns (kT = 315: 5 x 2)
constexpr int PROBE_THREADS = 128;   // one warpgroup
constexpr int PROBE_GUARD = 1024;    // zeroed bytes after each tile

// Bytes of a (rows x 8*rb) bf16 tile.
__host__ __device__ inline size_t probe_tile_bytes(int rows, int rb) {
  return sizeof(__nv_bfloat16) * rows * BQ * rb;
}

// Dynamic shared memory of one X1 block: the A and B tiles, each followed
// by a zeroed guard.
__host__ __device__ inline size_t probe_smem(int rb) {
  return probe_tile_bytes(PROBE_M, rb) + probe_tile_bytes(PROBE_N, rb)
         + 2 * PROBE_GUARD;
}

// Block (bx, by, s) owns the 64 x 160 output tile (by, bx) and the s-th
// chunk of passes. Both tiles are filled with bf16 ones once and the
// guards with zeros, so a descriptor that strays outside a tile reads zeros
// and the count falls short. Layout, no swizzle: core matrix (r/8, k/8) of
// a tile of R rows at byte ((k/8) * R/8 + r/8) * 128. A is K-major; B is
// K-major ("mk-nk") or, with kTransB, MN-major ("mk-kn", the transpose bit
// of the instruction), and in both the core matrices sit 128 bytes apart
// along the rows and 128 R/8 bytes apart along K.
template <int kTransB>
__global__ void __launch_bounds__(PROBE_THREADS)
mm_probe_partial_kernel(float* __restrict__ part, int tk, int rb,
                        int passes_total, int passes_per_chunk) {
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * PROBE_M;
  const int n0 = blockIdx.x * PROBE_N;
  const int p_begin = blockIdx.z * passes_per_chunk;
  const int p_end = min(p_begin + passes_per_chunk, passes_total);
  const uint32_t a_bytes = probe_tile_bytes(PROBE_M, rb);
  const uint32_t b_off = a_bytes + PROBE_GUARD;
  const uint32_t b_end = b_off + probe_tile_bytes(PROBE_N, rb);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  for (uint32_t e = tid; e < (b_end + PROBE_GUARD) / 4; e += PROBE_THREADS) {
    const uint32_t byte = 4 * e;
    words[e] = (byte < a_bytes || (byte >= b_off && byte < b_end))
                   ? 0x3F803F80u : 0u;
  }
  fence_proxy_async();
  __syncthreads();

  const uint64_t da = smem_desc(smem, 128 * (PROBE_M / 8), 128);
  const uint64_t db = smem_desc(smem + b_off, 128 * (PROBE_N / 8), 128);
  const uint32_t a_step = 2 * 128 * (PROBE_M / 8);  // one k16 step
  const uint32_t b_step = 2 * 128 * (PROBE_N / 8);
  const int steps = BQ * rb / 16;  // wgmmas per pass of depth 8*rb

  float acc[80];
#pragma unroll
  for (int e = 0; e < 80; ++e) acc[e] = 0.f;
  wgmma_fence();
  for (int p = p_begin; p < p_end; ++p) {
    for (int s = 0; s < steps; ++s)
      wgmma_m64n160k16_ss<kTransB>(acc, desc_advance(da, s * a_step),
                                   desc_advance(db, s * b_step));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();

  float* out = part + static_cast<size_t>(blockIdx.z) * tk * tk;
  const int row = m0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int col = n0 + 2 * (tid % 4);
#pragma unroll
  for (int e = 0; e < 80; ++e) {
    const int m = row + 8 * ((e >> 1) & 1);
    const int nn = col + 8 * (e >> 2) + (e & 1);
    if (m < tk && nn < tk) out[static_cast<size_t>(m) * tk + nn] = acc[e];
  }
}

template <int kTransB>
int launch_probe(float* part, int tk, int rb, int passes_total,
                 int passes_per_chunk, int splits, cudaStream_t stream) {
  if (rb < 2 || rb % 2 != 0 || passes_per_chunk < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = probe_smem(rb);
  cudaError_t err = cudaFuncSetAttribute(
      mm_probe_partial_kernel<kTransB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return refused(err);
  dim3 grid((tk + PROBE_N - 1) / PROBE_N, (tk + PROBE_M - 1) / PROBE_M,
            splits);
  mm_probe_partial_kernel<kTransB><<<grid, PROBE_THREADS, smem, stream>>>(
      part, tk, rb, passes_total, passes_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// X2: x1, x2 (n, k, h, w) bf16 contiguous; part (splits, kT, kT) f32
// scratch; chk (2 kT) u32 scratch (copies-only); out (k, k, T, T) f32.
// mode: 0 full, 1 mm-only, 2 copies-only, 3 aligned-copies. The (n, y) rows
// are cut into `splits` chunks of `rows_per_chunk` rows, a multiple of rb.
int joint_exp_fwd_v2(const void* x1, const void* x2, float* part,
                     unsigned* chk, float* out, int n, int k, int h, int w,
                     int half_t, int rb, int mode, int splits,
                     int rows_per_chunk, cudaStream_t stream) {
  const auto* a = static_cast<const __nv_bfloat16*>(x1);
  const auto* b = static_cast<const __nv_bfloat16*>(x2);
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  int err;
  switch (mode) {
    case kFull:
      err = launch_v2<kFull>(a, b, part, chk, n, k, h, w, half_t, rb, splits,
                             rows_per_chunk, stream);
      break;
    case kMmOnly:
      err = launch_v2<kMmOnly>(a, b, part, chk, n, k, h, w, half_t, rb,
                               splits, rows_per_chunk, stream);
      break;
    case kCopiesOnly: {
      cudaError_t e = cudaMemsetAsync(chk, 0, sizeof(unsigned) * 2 * tk,
                                      stream);
      if (e != cudaSuccess) return refused(e);
      err = launch_v2<kCopiesOnly>(a, b, part, chk, n, k, h, w, half_t, rb,
                                   splits, rows_per_chunk, stream);
      break;
    }
    case kAligned:
      err = launch_v2<kAligned>(a, b, part, chk, n, k, h, w, half_t, rb,
                                splits, rows_per_chunk, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int blocks = (tk * tk + kThreads - 1) / kThreads;
  if (mode == kCopiesOnly)
    checksum_kernel<<<blocks, kThreads, 0, stream>>>(chk, out, k, t);
  else
    joint_reduce_kernel<<<blocks, kThreads, 0, stream>>>(part, out, splits, k,
                                                         t, 1);
  return static_cast<int>(cudaGetLastError());
}

// X7's CUDA-core form: x1, x2 (n, k, h, w) bf16 contiguous; part (splits,
// kT, kT) f32 scratch; out (k, k, T, T) f32. The (n, y) rows are cut into
// `splits` chunks of `rows_per_chunk` rows, a multiple of rb.
int joint_exp_fwd_v8(const void* x1, const void* x2, float* part, float* out,
                     int n, int k, int h, int w, int half_t, int splits,
                     int rows_per_chunk, cudaStream_t stream) {
  return launch_joint_fwd<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x1),
      static_cast<const __nv_bfloat16*>(x2), part, out, n, k, h, w, half_t,
      splits, rows_per_chunk, stream);
}

// X7's tensor-core form, K1's stack product: x1, x2 (n, k, h, w) bf16
// contiguous; x1c, x2c (n, ceil(k/16), h, w, 16) bf16 scratch for the
// layout pass; part (splits, kT, kT) f32 scratch; out (k, k, T, T) f32.
// The (n, y) rows are cut into passes of rb rows of one image, the passes
// into `splits` chunks of passes_per_chunk.
int joint_exp_fwd_v8_mma(const void* x1, const void* x2, void* x1c,
                         void* x2c, float* part, float* out, int n, int k,
                         int h, int w, int half_t, int rb,
                         int passes_per_chunk, int splits,
                         cudaStream_t stream) {
  return launch_joint_fwd_mma<bf16>(
      static_cast<const bf16*>(x1), static_cast<const bf16*>(x2),
      static_cast<bf16*>(x1c), static_cast<bf16*>(x2c), part, out, n, k, h,
      w, half_t, rb, passes_per_chunk, splits, stream);
}

// X1: part (splits, tk, tk) f32 scratch; out (tk, tk) f32. passes_total
// passes of depth 8*rb, cut into `splits` chunks of passes_per_chunk.
int joint_exp_mm_probe(float* part, float* out, int tk, int rb, int kn,
                       int passes_total, int passes_per_chunk, int splits,
                       cudaStream_t stream) {
  const int err = kn ? launch_probe<1>(part, tk, rb, passes_total,
                                       passes_per_chunk, splits, stream)
                     : launch_probe<0>(part, tk, rb, passes_total,
                                       passes_per_chunk, splits, stream);
  if (err != 0) return err;
  joint_reduce_kernel<<<(tk * tk + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, out, splits, tk, 1, 0);
  return static_cast<int>(cudaGetLastError());
}

// X1's blocks the current device holds at once at rb: its SMs times the
// blocks an SM admits (registers, shared memory); minus a CUDA error code
// when rb's tiles do not fit.
int joint_exp_mm_probe_slots(int rb, int kn) {
  const auto kernel = kn ? mm_probe_partial_kernel<1>
                         : mm_probe_partial_kernel<0>;
  const int smem = static_cast<int>(probe_smem(rb));
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, PROBE_THREADS, smem);
  if (err != cudaSuccess) return -refused(err);
  return sms * per_sm;
}

}  // extern "C"
