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
// frame, 2 * n*h*w * (kT)^2 ~ 3.9e11 FLOP issued. X2 and X7 run it on the
// tensor cores as K1 does (X7's CUDA-core form: f32 FMAs, 67 TFLOP/s peak).
// X1 issues the TPU probe's count of products, 2 * (kT)^2 * n*(t_hi -
// t_lo)*rb*128 ~ 4.4e11 FLOP at rb=16, over no input at all, so only the
// tensor cores' issue rate bounds it (0.44 ms); it runs on them (wgmma,
// hopper_mma.cuh).
//
// X2 is K1's stack product (joint_fwd_common.cuh) on the tensor cores, on
// bf16 operands, with `rb` the rows of a pass as in X7's. Its modes:
//   full            X7's launch at the same rb, so it equals X7 bit for bit
//                   ("rank3" is the same launch: here the contraction over
//                   (rb, 128) and over rb*128 is one loop);
//   mm-only         the kernel's kJfMmOnly instantiation: no layout pass and
//                   no staging, the products over buffers of bf16 1.0, so
//                   each entry of P is the count of contraction terms
//                   issued, rows x 16-pixel k16 steps x 16 summed over the
//                   slabs, n * h * ceil(w/16) * 16 whatever rb (1,966,080
//                   at the tool's shapes, exact in f32 under 2^24);
//   copies-only     the layout pass and K1's staging (jf_stage, jf_next)
//                   and no product: copies_only_kernel below, whose product
//                   warpgroups read back what was staged and add the bf16
//                   bit patterns as unsigned 32-bit integers; integer
//                   addition modulo 2^32 is exact and commutative, so the
//                   checksum depends neither on the chunks nor on the block
//                   order:
//                     S_A[(v,i)] = sum_{n,y,q} bits(x1[n,i,y,q+v-h])
//                     S_B[(u,j)] = sum_{n,y,q} bits(x2[n,j,y+h-u,q])
//                     P[i,j,u,v] = float((S_A[(v,i)] + S_B[(u,j)]) mod 2^32)
//                   with bits() the 16-bit pattern and 0 outside the frame;
//   aligned-copies  the kernel's kJfAligned instantiation, every shift at
//                   zero: P[:, :, u, v] is the zero-displacement joint for
//                   every (u, v), exactly the same value in each.
//
// The TPU kernel cuts its B window into three 16-row BlockSpec blocks and
// builds the stacks with static slices because Mosaic cannot lower a
// dynamic sublane slice of a bf16 block; nothing here needs that: a shift
// is an address in the staged slab.
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
// n*h rows into chunks of a multiple of rb rows); no shared
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

constexpr int BQ = 8;  // image columns per X1 pass (the TPU tool's)

// ------------------------------------------------------------------- X2

// copies-only's shared words after the two slab buffers: the window's row
// sums (JF_WIN_ROWS x 16 channels), then the block's S_A (4 shifts x 16)
// and S_B (JF_U shifts x 16) totals.
constexpr int CK_SUMS = JF_WIN_ROWS * JF_CH;
constexpr int CK_TOTALS = JF_V * JF_CH + JF_U * JF_CH;
constexpr int CK_SMEM = 2 * JF_SMEM + 4 * (CK_SUMS + CK_TOTALS);

// The bf16 bit patterns of the 8 channels in `v` added to words[0 .. 8)
// (channel c at bits 16 (c & 1) of word c / 2).
__device__ __forceinline__ void add_bits(unsigned (&words)[8],
                                         const uint4& v) {
  const unsigned in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    words[2 * c] += in[c] & 0xFFFFu;
    words[2 * c + 1] += in[c] >> 16;
  }
}

// The 256 threads that read back (named barrier 1).
__device__ __forceinline__ void bar_readers() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// A reading thread's checksum words over its chunk. a[e]: S_A of shift
// v0 + pt / 64, channel 8 ((pt / 32) & 1) + e; b[0], b[1]: S_B of the
// (u', j) pairs pt and pt + 256 of the N tile's JF_U x 16.
struct Checksum {
  unsigned a[8];
  unsigned b[2];
};

// Adds the staged slab `s` in `buf` to thread pt's words: S_A from the x1
// pixels q + v - v0 of the rows (do_a), S_B from the row sums of the
// window's rows + 20 staged rows in `rs` (do_b); pixels q of the slab at
// or past w count nothing. Output rows y0 .. y0+15 read window rows
// u' .. u'+15 at shift u', so one sum a staged row and a range sum a shift.
__device__ __forceinline__ void checksum_slab(Checksum& c,
                                              const unsigned char* buf,
                                              unsigned* rs, const JfSlab& s,
                                              int pt, int w, bool do_a,
                                              bool do_b) {
  const int qmax = min(JF_PIX, w - s.q0);
  if (do_a) {
    const int shift = pt >> 6, half = (pt >> 5) & 1;
    for (int r = 0; r < s.rows; ++r)
      for (int q = pt & 31; q < qmax; q += 32)
        add_bits(c.a, *reinterpret_cast<const uint4*>(
                          buf + JF_A_OFF + r * JF_A_ROW + half * JF_A_HALF
                          + (q + shift) * 16));
  }
  if (!do_b) return;
  for (int e = pt; e < CK_SUMS; e += 256) rs[e] = 0u;
  bar_readers();
  // row sums: (row, half, quarter of the pixels) a thread at a time
  for (int e = pt; e < (s.rows + JF_U - 1) * 8; e += 256) {
    const int row = e >> 3, half = (e >> 2) & 1, q0 = 16 * (e & 3);
    unsigned sum[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    for (int q = q0; q < min(q0 + 16, qmax); ++q)
      add_bits(sum, *reinterpret_cast<const uint4*>(
                        buf + row * JF_ROW + half * JF_HALF + q * 16));
#pragma unroll
    for (int ch = 0; ch < 8; ++ch)
      atomicAdd(&rs[row * JF_CH + 8 * half + ch], sum[ch]);
  }
  bar_readers();
  // shift u' (pair p = 16 u' + j) reads window rows u' .. u' + rows - 1
  for (int r = 0; r < s.rows; ++r) {
    c.b[0] += rs[(r + (pt >> 4)) * JF_CH + (pt & 15)];
    if (pt + 256 < JF_U * JF_CH)
      c.b[1] += rs[(r + ((pt + 256) >> 4)) * JF_CH + (pt & 15)];
  }
}

// X2 copies-only: joint_fwd_mma_kernel's grid, slab walk and staging, its
// product warpgroups reading back each staged slab instead of multiplying
// it. Blocks of the first N tile publish S_A, of the first M tile S_B,
// through shared, then global, atomics into `part` read as the (2 kT) u32
// checksum, which the caller zeroes.
__global__ void __launch_bounds__(JF_THREADS, 1)
copies_only_kernel(const bf16* __restrict__ x1c,
                   const bf16* __restrict__ x2c, float* __restrict__ part,
                   int k, int h, int w, int half_t, int rb, int passes_total,
                   int passes_per_chunk) {
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  const int chunks = (k + JF_CH - 1) / JF_CH;
  const int m_tiles = (t + JF_V - 1) / JF_V;
  const int n_tiles = (t + JF_U - 1) / JF_U;
  const int ic = blockIdx.y / m_tiles;
  const int v0 = (blockIdx.y - ic * m_tiles) * JF_V;
  const int jc = blockIdx.x / n_tiles;
  const int up0 = (blockIdx.x - jc * n_tiles) * JF_U;
  const int p_begin = blockIdx.z * passes_per_chunk;
  const int p_end = min(p_begin + passes_per_chunk, passes_total);
  const int passes_per_image = (h + rb - 1) / rb;

  // two slab buffers, then the row sums and the block's totals
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  unsigned* rs = reinterpret_cast<unsigned*>(smem + 2 * JF_SMEM);
  unsigned* tot = rs + CK_SUMS;
  const int tid = threadIdx.x;
  const bool stager = tid >= JF_WGS * 128;
  for (int e = tid; e < CK_TOTALS; e += JF_THREADS) tot[e] = 0u;
  Checksum sums = {};

  // the chunk's first slab: its pass's first row, column 0
  JfSlab s{p_begin, p_begin / passes_per_image, 0, 0, 0, 0};
  s.wy = (p_begin - s.img * passes_per_image) * rb;
  s.rows = p_begin < p_end ? min(JF_ROWS, min(s.wy + rb, h) - s.wy) : 0;
  s.steps = (min(JF_PIX, w) + 15) / 16;
  if (stager && s.rows) {
    jf_stage(base, x1c, x2c, s, tid - JF_WGS * 128, ic, jc, chunks, v0, up0,
             h, w, half_t);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  int cur = 0;
  while (s.rows) {
    // the staging warpgroup fills the other buffer with the next slab
    // while the others read this one back; the barrier ends both
    const JfSlab nx = jf_next(s, p_end, rb, passes_per_image, h, w);
    if (stager) {
      if (nx.rows) {
        jf_stage(base + (cur ^ 1) * JF_SMEM, x1c, x2c, nx,
                 tid - JF_WGS * 128, ic, jc, chunks, v0, up0, h, w, half_t);
        cp_async_commit();
        cp_async_wait_all();
      }
    } else {
      checksum_slab(sums, smem + cur * JF_SMEM, rs, s, tid, w,
                    blockIdx.x == 0, blockIdx.y == 0);
    }
    __syncthreads();
    s = nx;
    cur ^= 1;
  }
  if (stager) return;

  // the block's totals, then the (2 kT) checksum words: S_A[(v, i)] at
  // v k + i, S_B[(u, j)] at kT + u k + j
  if (blockIdx.x == 0)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      atomicAdd(&tot[(tid >> 6) * JF_CH + 8 * ((tid >> 5) & 1) + e],
                sums.a[e]);
  if (blockIdx.y == 0) {
    atomicAdd(&tot[JF_V * JF_CH + tid], sums.b[0]);
    if (tid + 256 < JF_U * JF_CH)
      atomicAdd(&tot[JF_V * JF_CH + tid + 256], sums.b[1]);
  }
  bar_readers();
  unsigned* chk = reinterpret_cast<unsigned*>(part);
  for (int e = tid; e < CK_TOTALS; e += 256) {
    if (e < JF_V * JF_CH) {
      const int v = v0 + e / JF_CH, i = ic * JF_CH + e % JF_CH;
      if (blockIdx.x == 0 && v < t && i < k)
        atomicAdd(&chk[v * k + i], tot[e]);
    } else {
      const int p = e - JF_V * JF_CH;
      const int u = t - 1 - (up0 + p / JF_CH), j = jc * JF_CH + p % JF_CH;
      if (blockIdx.y == 0 && u >= 0 && j < k)
        atomicAdd(&chk[tk + u * k + j], tot[e]);
    }
  }
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

// X2, K1's stack product in `mode` (0 full, 1 mm-only, 2 copies-only, 3
// aligned-copies): x1, x2 (n, k, h, w) bf16 contiguous; x1c, x2c (n,
// ceil(k/16), h, w, 16) bf16 scratch for the layout pass; part (splits,
// kT, kT) f32 scratch; chk (2 kT) u32 scratch (copies-only); out (k, k, T,
// T) f32. The passes of rb rows are cut into `splits` chunks of
// passes_per_chunk, as X7's.
int joint_exp_fwd_v2(const void* x1, const void* x2, void* x1c, void* x2c,
                     float* part, unsigned* chk, float* out, int n, int k,
                     int h, int w, int half_t, int rb, int mode,
                     int passes_per_chunk, int splits, cudaStream_t stream) {
  const auto* a = static_cast<const bf16*>(x1);
  const auto* b = static_cast<const bf16*>(x2);
  auto* ac = static_cast<bf16*>(x1c);
  auto* bc = static_cast<bf16*>(x2c);
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  int err;
  switch (mode) {
    case 0:
      return launch_joint_fwd_mma<bf16>(a, b, ac, bc, part, out, n, k, h, w,
                                        half_t, rb, passes_per_chunk, splits,
                                        stream);
    case 1:
      err = launch_jf_partials<bf16, kJfMmOnly>(a, b, ac, bc, part, n, k, h,
                                                w, half_t, rb,
                                                passes_per_chunk, splits,
                                                stream);
      break;
    case 2: {
      cudaError_t e = cudaMemsetAsync(chk, 0, sizeof(unsigned) * 2 * tk,
                                      stream);
      if (e != cudaSuccess) return refused(e);
      err = launch_jf_grid<bf16>(copies_only_kernel, CK_SMEM, true, a, b, ac,
                                 bc, reinterpret_cast<float*>(chk), n, k, h,
                                 w, half_t, rb, passes_per_chunk, splits,
                                 stream);
      break;
    }
    case 3:
      err = launch_jf_partials<bf16, kJfAligned>(a, b, ac, bc, part, n, k, h,
                                                 w, half_t, rb,
                                                 passes_per_chunk, splits,
                                                 stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int blocks = (tk * tk + kThreads - 1) / kThreads;
  if (mode == 2)
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
