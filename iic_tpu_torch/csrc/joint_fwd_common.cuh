// K1's stack product on Hopper's tensor cores (wgmma, hopper_mma.cuh), for
// the displacement joint of bf16 operands. Shared by seg_joint.cu (K1, the
// training path's joint forward, at k > 4), joint_exp.cu (X7, the
// experiment tool's `joint_fwd_v8`, which is K1 with the pass rows `rb` as
// a parameter, and X2, whose modes are instantiations of the one kernel
// but for copies-only, which walks and stages its slabs) and
// joint_exp_tma.cu (X3's tensor-core form, the same GEMM fed by TMA).
//
//   P[(v,i),(u,j)] = sum_{n,y,q} x1[n,i,y,q+v-h] * x2[n,j,y+h-u,q]
//
// with h = half_t, T = 2h+1, u,v in [0,T), zero outside each frame, both
// inputs rounded to bf16 (the TPU kernel's contract): the products of two
// bf16 values are exact in f32, the sums are f32.
//
// Operands. A layout pass (jf_layout_kernel, in the same call) writes each
// input once as channels-last bf16 in chunks of 16 channels, zero past k,
// (n, ceil(k/16), h, w, 16): K2's and X8's `oc` layout
// (seg_joint.channels_last_chunks). Nothing is padded in device memory;
// the frame edges are zero-filled as the block stages.
//
// The GEMM. M is (v, i): an M tile is 4 shifts v x 16 channels i, one warp
// per shift. N is (u', j) with u' = T - 1 - u: an N tile is 21 shifts x 16
// channels j, two warpgroups of m64n168 (84 f32 accumulators a thread), so
// the 336 columns at T = 21 are one tile. The contraction is (n, y, q),
// 16 pixels q of one image row a k16 step.
//   A (64 x 16) comes from registers (the RS form): warp w's 16 rows are
// the 16 channels of x1 at the pixels q + v - h of row y, read from the
// staged x1 row with ldmatrix.trans (a pixel's 8 channels of one half are
// one stored row), so the column shift v is only a pointer.
//   B (16 x 168) is read by a descriptor straight from a staged window of
// x2 rows, stored [row][channel half][pixel][8 channels], MN-major: a core
// matrix is 8 pixels x 8 channels of one half, 128 contiguous bytes. With
// N ordered (u', j), the core matrices adjacent along N are (u', half 0),
// (u', half 1), (u'+1, half 0): each one channel half further, 1,024
// bytes at 64 pixels, a uniform stride, because the row of u' + 1 is the
// next window row (y + h - u = y - h + u'). So the row shift u needs no
// build, and each output row y moves the descriptor's start one window row.
//
// Blocks. Block (bx, by, s) owns an N tile (j chunk, u' range), an M tile
// (i chunk, v range) and the s-th chunk of passes; a pass is `rb` rows of
// one image (the TPU's row tile), cut into slabs of 16 rows x 64 pixels.
// A slab's staging is the 16 x1 rows (67 pixels: the slab's columns
// shifted by the M tile's v - h) and the window of 16 + 20 x2 rows (the N
// tile's rows for all 16 output rows), zero outside the frame: 108,544
// bytes whatever k, h or w, two buffers, one block an SM. The block's
// warps are specialised: a third warpgroup stages the next slab with
// cp.async into the other buffer while the two product warpgroups run, for
// each row and k16 step, one ldmatrix.trans and one m64n168k16 product
// each, one A fragment a step so that three product groups stay in
// flight; a barrier ends each slab. (Copies issued by the product warps
// themselves, between products, starved the warpgroup-wide products,
// which wait for their slowest warp.) The accumulators are never written
// between products, and
// the kernel has registers to spare (one block an SM), which ptxas needs
// to keep the products in flight: capped at 128 (two blocks an SM) it
// serialised them. The block's partial goes to part[s] in the (kT, kT)
// layout and K1's ordered reduce (joint_common.cuh) adds the partials in
// chunk order: the result is deterministic and depends on the chunks, not
// on the launch.
//
// Depth. The tensor cores' f32 sums truncate toward zero, and every term
// of a joint of softmax maps is positive, so the truncation does not
// cancel: a partial's relative error grows with its k16 steps. The wrapper
// bounds a chunk's rows (seg_joint.K1_CHUNK_ROWS); the ordered reduce adds
// the partials in rounded f32.
//
// Work: at T = 21 and k = 15 (16 with the padding) the block tiles issue
// 6 M tiles x 336 columns x 16 x 2 FLOP per pixel, 5.1e11 FLOP at the
// main path's shapes (n = 120, 128^2): 0.51 ms at the H100 SXM's 989
// TFLOP/s bf16 peak, against the in-frame work's 0.363 ms (seg_joint.cu).
//
// Modes (X2's ablations, joint_exp.cu), compile-time instantiations of the
// one kernel; K1 and X7 are kJfFull, the default (X2's copies-only, which
// issues no product, is a kernel of joint_exp.cu over jf_stage/jf_next):
//   kJfMmOnly   no staging and no layout pass: both buffers are filled with
//               bf16 1.0 once, at block start, and the product warpgroups
//               issue every product of the chunk over them, so each entry
//               of a partial is the count of terms issued, rows x k16
//               steps x 16 summed over the block's slabs;
//   kJfAligned  kJfFull with every shift at the zero displacement: x1 is
//               staged from the slab's own columns and read at no warp
//               offset, the window from the slab's own rows, and warpgroup
//               g reads channel half g with an N stride (SBO) of 0, so every
//               one of its 21 core matrices along N is the same one: each
//               (u, v) entry sums the same terms in the same order.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "joint_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int JF_CH = 16;       // channels of a chunk: one k16 step's rows
constexpr int JF_PIX = 64;      // pixels of a column slab: 4 k16 steps
constexpr int JF_STEPS = JF_PIX / 16;
constexpr int JF_ROWS = 16;     // image rows of a row slab
constexpr int JF_V = 4;         // shifts v of an M tile: one a warp
constexpr int JF_CM = 21;       // core matrices along N of a warpgroup
constexpr int JF_WGS = 2;       // product warpgroups of a block
constexpr int JF_THREADS = 128 * (JF_WGS + 1);  // and one that stages
constexpr int JF_U = JF_WGS * JF_CM / 2;           // shifts u' of an N tile
constexpr int JF_WIN_ROWS = JF_ROWS + JF_U - 1;    // x2 rows of a window
constexpr int JF_A_PIX = JF_PIX + JF_V;            // x1 pixels (67 read)
constexpr int JF_HALF = JF_PIX * 16;    // bytes of one channel half of a
                                        // window row: the N stride (SBO)
constexpr int JF_ROW = 2 * JF_HALF;     // bytes of a window row
constexpr int JF_A_HALF = JF_A_PIX * 16;
constexpr int JF_A_ROW = 2 * JF_A_HALF;  // bytes of a staged x1 row
constexpr int JF_A_OFF = JF_WIN_ROWS * JF_ROW;
constexpr int JF_SMEM = JF_A_OFF + JF_ROWS * JF_A_ROW;  // 108,544 bytes
                                                        // a buffer
constexpr int JF_ACC = JF_CM * 4;       // accumulators a thread

static_assert(JF_WGS * JF_CM % 2 == 0, "an N tile holds whole shifts");

enum JfMode { kJfFull = 0, kJfMmOnly = 1, kJfAligned = 2 };

// One k16 step of a warpgroup: load A into `a` once at most kWait product
// groups are in flight (so the one that last read `a` has retired), then
// acc += A * B.
template <int kWait>
__device__ __forceinline__ void jf_step(float (&acc)[JF_ACC],
                                       uint32_t (&a)[4], uint32_t a_addr,
                                       uint64_t db) {
  wgmma_wait<kWait>();
  ldmatrix_x4_trans(a, a_addr);
  wgmma_fence();
  wgmma_m64n168k16_rs_tn(acc, a, db);
  wgmma_commit();
}

// A slab of a block's chunk: `rows` output rows of image `img` from wy,
// 64 pixels from q0 (`steps` k16 steps, 4 unless the frame's last).
struct JfSlab {
  int p, img, wy, rows, q0, steps;
};

// The slab after `s` in the chunk's order (passes, then row slabs of a
// pass, then column slabs); p == p_end when there is none.
__device__ __forceinline__ JfSlab jf_next(JfSlab s, int p_end, int rb,
                                         int passes_per_image, int h,
                                         int w) {
  const int y_end = min((s.p - s.img * passes_per_image) * rb + rb, h);
  s.q0 += JF_PIX;
  if (s.q0 >= w) {
    s.q0 = 0;
    s.wy += JF_ROWS;
    if (s.wy >= y_end) {
      ++s.p;
      s.img = s.p / passes_per_image;
      s.wy = (s.p - s.img * passes_per_image) * rb;
    }
  }
  const int y_stop = min((s.p - s.img * passes_per_image) * rb + rb, h);
  s.rows = min(JF_ROWS, y_stop - s.wy);
  s.steps = (min(JF_PIX, w - s.q0) + 15) / 16;
  if (s.p >= p_end) s.rows = 0;
  return s;
}

// Stages slab `s` into the buffer at `buf` with cp.async, zero outside
// the frame, by the staging warpgroup (thread `pt` of 128): the x2 window
// (rows wy - h + up0 .. + rows + 19, the N tile's shifts u' from up0 on;
// thread pt copies pixel pt / 2, half pt % 2 of each row) and the x1 rows
// (pixels q0 + v0 - h .. + 66; 134 copies a row, pt and 128 + pt).
__device__ __forceinline__ void jf_stage(uint32_t buf,
                                         const bf16* __restrict__ x1c,
                                         const bf16* __restrict__ x2c,
                                         const JfSlab& s, int pt, int ic,
                                         int jc, int chunks, int v0, int up0,
                                         int h, int w, int half_t) {
  const size_t chunk_elems = static_cast<size_t>(h) * w * JF_CH;
  const size_t row_elems = static_cast<size_t>(w) * JF_CH;
  const bf16* src1 = x1c + (static_cast<size_t>(s.img) * chunks + ic)
                               * chunk_elems;
  const bf16* src2 = x2c + (static_cast<size_t>(s.img) * chunks + jc)
                               * chunk_elems;
  {
    const int px = pt >> 1, c = pt & 1;
    const int xx = s.q0 + px;
    const bool col_in = xx < w;
    const int y0 = s.wy - half_t + up0;
    const bf16* src = src2 + static_cast<size_t>(col_in ? xx : 0) * JF_CH
                      + 8 * c;
    uint32_t dst = buf + c * JF_HALF + px * 16;
    for (int r = 0; r < s.rows + JF_U - 1; ++r, dst += JF_ROW) {
      const int yy = y0 + r;
      const bool in = col_in && yy >= 0 && yy < h;
      cp_async_16(dst, in ? src + yy * row_elems : src2, in ? 16 : 0);
    }
  }
  for (int e = pt; e < 2 * (JF_A_PIX - 1); e += 128) {
    const int px = e >> 1, c = e & 1;
    const int xx = s.q0 + v0 - half_t + px;
    const bool in = xx >= 0 && xx < w;
    const bf16* src = in ? src1 + static_cast<size_t>(s.wy) * row_elems
                               + static_cast<size_t>(xx) * JF_CH + 8 * c
                         : src1;
    uint32_t dst = buf + JF_A_OFF + c * JF_A_HALF + px * 16;
    for (int r = 0; r < s.rows; ++r, dst += JF_A_ROW)
      cp_async_16(dst, in ? src + r * row_elems : src1, in ? 16 : 0);
  }
}

// The products of the staged slab `s`: for each row, `steps` k16 steps,
// one A fragment a step, so three product groups stay in flight
// (kChecked, for a ragged last column slab, tests each step against
// `steps` and waits for every group before reloading a fragment). kSbo is
// the N stride of B's core matrices (0 in aligned-copies).
template <bool kChecked, uint32_t kSbo = JF_HALF>
__device__ __forceinline__ void jf_products(float (&acc)[JF_ACC],
                                            uint32_t a_lane,
                                            const unsigned char* b_base,
                                            const JfSlab& s) {
  uint32_t a[JF_STEPS][4];
  for (int r = 0; r < s.rows; ++r) {
    const uint32_t a_row = a_lane + r * JF_A_ROW;
    // B: LBO 128 (the next 8 pixels), SBO one channel half (the next
    // core matrix along N)
    const uint64_t db = smem_desc(b_base + r * JF_ROW, 128, kSbo);
#pragma unroll
    for (int st = 0; st < JF_STEPS; ++st) {
      if (!kChecked)
        jf_step<JF_STEPS - 1>(acc, a[st], a_row + 256 * st,
                              desc_advance(db, 256 * st));
      else if (st < s.steps)
        jf_step<0>(acc, a[st], a_row + 256 * st,
                   desc_advance(db, 256 * st));
    }
  }
  wgmma_wait<0>();
}

template <int kMode = kJfFull>
__global__ void __launch_bounds__(JF_THREADS, 1)
joint_fwd_mma_kernel(const bf16* __restrict__ x1c,
                     const bf16* __restrict__ x2c, float* __restrict__ part,
                     int k, int h, int w, int half_t, int rb,
                     int passes_total, int passes_per_chunk) {
  constexpr bool kAligned = kMode == kJfAligned;
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
  // the shifts the slabs are staged at: aligned-copies stages x1 from the
  // slab's own columns (v0 - h = 0) and the window from its own rows
  const int v0_staged = kAligned ? half_t : v0;
  const int up0_staged = kAligned ? half_t : up0;

  // two slab buffers, each the x2 window then the x1 rows
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_addr(smem);

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0, 1: products; JF_WGS: staging
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const bool stager = wg == JF_WGS;
  // this lane's ldmatrix.trans row: pixel (lane & 7) + 8 (lane >> 4) of a
  // step, shifted by the warp's v - v0, channel half (lane >> 3) & 1
  const uint32_t a_lane = JF_A_OFF + ((lane >> 3) & 1) * JF_A_HALF
                          + ((kAligned ? 0 : warp) + (lane & 7)
                             + 8 * (lane >> 4)) * 16;
  // this warpgroup's first core matrix along N (aligned-copies: its
  // channel half of the row)
  const int b_lane = kAligned ? wg * JF_HALF : wg * JF_CM * JF_HALF;

  if constexpr (kMode == kJfMmOnly) {
    unsigned* words = reinterpret_cast<unsigned*>(smem);
    for (int e = tid; e < 2 * JF_SMEM / 4; e += JF_THREADS)
      words[e] = 0x3F803F80u;  // bf16 1.0, 1.0
    fence_proxy_async();
  }

  float acc[JF_ACC];
#pragma unroll
  for (int e = 0; e < JF_ACC; ++e) acc[e] = 0.f;
  if (!stager) wgmma_fence();

  // the chunk's first slab: its pass's first row, column 0
  JfSlab s{p_begin, p_begin / passes_per_image, 0, 0, 0, 0};
  s.wy = (p_begin - s.img * passes_per_image) * rb;
  s.rows = p_begin < p_end ? min(JF_ROWS, min(s.wy + rb, h) - s.wy) : 0;
  s.steps = (min(JF_PIX, w) + 15) / 16;
  if (kMode != kJfMmOnly && stager && s.rows) {
    jf_stage(base, x1c, x2c, s, tid - JF_WGS * 128, ic, jc, chunks,
             v0_staged, up0_staged, h, w, half_t);
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
  }
  __syncthreads();
  int cur = 0;
  while (s.rows) {
    // the staging warpgroup fills the other buffer with the next slab
    // while the others multiply this one; the barrier ends both
    const JfSlab nx = jf_next(s, p_end, rb, passes_per_image, h, w);
    if (stager) {
      if (kMode != kJfMmOnly && nx.rows) {
        jf_stage(base + (cur ^ 1) * JF_SMEM, x1c, x2c, nx,
                 tid - JF_WGS * 128, ic, jc, chunks, v0_staged, up0_staged,
                 h, w, half_t);
        cp_async_commit();
        cp_async_wait_all();
        fence_proxy_async();
      }
    } else {
      const unsigned char* b_base = smem + cur * JF_SMEM + b_lane;
      const uint32_t a_base = base + cur * JF_SMEM + a_lane;
      constexpr uint32_t kSbo = kAligned ? 0 : JF_HALF;
      if (s.steps == JF_STEPS)
        jf_products<false, kSbo>(acc, a_base, b_base, s);
      else
        jf_products<true, kSbo>(acc, a_base, b_base, s);
    }
    __syncthreads();
    s = nx;
    cur ^= 1;
  }
  if (stager) return;

  // acc[4c + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column
  // 8 c + 2 (lane % 4) + (e & 1) of this warpgroup's 168
  float* out = part + static_cast<size_t>(blockIdx.z) * tk * tk;
  const int v = v0 + warp;
  const int i_lo = ic * JF_CH + lane / 4;
#pragma unroll
  for (int c = 0; c < JF_CM; ++c) {
    const int ct = wg * JF_CM + c;  // core matrix of the N tile
    // aligned-copies: warpgroup wg's core matrix c is shift u' = c of
    // channel half wg
    const int u = t - 1 - (up0 + (kAligned ? c : ct / 2));
    const int j0 = jc * JF_CH + 8 * (kAligned ? wg : ct & 1)
                   + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i_lo + 8 * (e >> 1);
      const int j = j0 + (e & 1);
      if (v < t && u >= 0 && i < k && j < k)
        out[static_cast<size_t>(v * k + i) * tk + u * k + j] = acc[4 * c + e];
    }
  }
}

// The layout pass: x (n, k, h, w), f32 or bf16, to xc (n, ceil(k/16), h, w,
// 16) bf16 rounded to nearest even, zero past k (seg_joint's
// channels_last_chunks). Thread e writes one pixel's 16 channels of one
// chunk, 32 bytes; consecutive threads take consecutive pixels, so each
// channel's reads and the writes are coalesced.
template <typename T>
__global__ void __launch_bounds__(kThreads)
jf_layout_kernel(const T* __restrict__ x, bf16* __restrict__ xc, int n,
                 int k, int h, int w) {
  const int chunks = (k + JF_CH - 1) / JF_CH;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t total = static_cast<size_t>(n) * chunks * plane;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t px = e % plane;
    const size_t ic = e / plane;  // img * chunks + chunk
    const int img = static_cast<int>(ic / chunks);
    const int c0 = static_cast<int>(ic % chunks) * JF_CH;
    const T* src = x + static_cast<size_t>(img) * k * plane + px;
    __align__(16) bf16 v[JF_CH];
#pragma unroll
    for (int c = 0; c < JF_CH; ++c)
      v[c] = c0 + c < k ? __float2bfloat16_rn(widen(src[(c0 + c) * plane]))
                        : __float2bfloat16_rn(0.f);
    uint4* dst = reinterpret_cast<uint4*>(xc + e * JF_CH);
    dst[0] = reinterpret_cast<const uint4*>(v)[0];
    dst[1] = reinterpret_cast<const uint4*>(v)[1];
  }
}

template <typename T>
int launch_jf_layout(const T* x, bf16* xc, int n, int k, int h, int w,
                     cudaStream_t stream) {
  const size_t total = static_cast<size_t>(n) * ((k + JF_CH - 1) / JF_CH)
                       * h * w;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  jf_layout_kernel<T><<<static_cast<unsigned>(blocks < 65535 * 32
                                                  ? blocks : 65535 * 32),
                        kThreads, 0, stream>>>(x, xc, n, k, h, w);
  return static_cast<int>(cudaGetLastError());
}

// A kernel over the stack product's grid and slab walk: joint_fwd_mma_kernel
// and X2's copies-only (joint_exp.cu).
using JfKernel = void (*)(const bf16*, const bf16*, float*, int, int, int,
                          int, int, int, int);

// Launches `kernel` with `smem` bytes of dynamic shared memory over the
// stack product's grid on x1, x2 (n, k, h, w), f32 (K1) or bf16 (X7, X2):
// the layout pass into x1c, x2c ((n, ceil(k/16), h, w, 16) bf16 scratch;
// skipped unless `layout`), then a block for each N tile, M tile and chunk
// of `passes_per_chunk` passes of rb rows (the passes of an image first),
// writing into part ((splits, kT, kT) f32 scratch for the partials).
template <typename T>
int launch_jf_grid(JfKernel kernel, int smem, bool layout, const T* x1,
                   const T* x2, bf16* x1c, bf16* x2c, float* part, int n,
                   int k, int h, int w, int half_t, int rb,
                   int passes_per_chunk, int splits, cudaStream_t stream) {
  if (n < 1 || k < 1 || h < 1 || w < 1 || half_t < 0 || rb < 1
      || passes_per_chunk < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int passes = n * ((h + rb - 1) / rb);
  if (static_cast<long long>(splits) * passes_per_chunk < passes
      || static_cast<long long>(splits - 1) * passes_per_chunk >= passes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return refused(err);
  if (layout) {
    int e = launch_jf_layout<T>(x1, x1c, n, k, h, w, stream);
    if (e == 0) e = launch_jf_layout<T>(x2, x2c, n, k, h, w, stream);
    if (e != 0) return e;
  }
  const int t = 2 * half_t + 1;
  const int chunks = (k + JF_CH - 1) / JF_CH;
  dim3 grid(chunks * ((t + JF_U - 1) / JF_U),
            chunks * ((t + JF_V - 1) / JF_V), splits);
  kernel<<<grid, JF_THREADS, smem, stream>>>(x1c, x2c, part, k, h, w, half_t,
                                             rb, passes, passes_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

// The partials of the stack product in mode kMode (launch_jf_grid; no
// layout pass in mm-only).
template <typename T, int kMode = kJfFull>
int launch_jf_partials(const T* x1, const T* x2, bf16* x1c, bf16* x2c,
                       float* part, int n, int k, int h, int w, int half_t,
                       int rb, int passes_per_chunk, int splits,
                       cudaStream_t stream) {
  return launch_jf_grid<T>(joint_fwd_mma_kernel<kMode>, 2 * JF_SMEM,
                           kMode != kJfMmOnly, x1, x2, x1c, x2c, part, n, k,
                           h, w, half_t, rb, passes_per_chunk, splits,
                           stream);
}

// K1's tensor-core form on x1, x2 (n, k, h, w), f32 (K1) or bf16 (X7): the
// partials (launch_jf_partials, kJfFull), then their ordered reduce into
// out (k, k, T, T).
template <typename T>
int launch_joint_fwd_mma(const T* x1, const T* x2, bf16* x1c, bf16* x2c,
                         float* part, float* out, int n, int k, int h, int w,
                         int half_t, int rb, int passes_per_chunk,
                         int splits, cudaStream_t stream) {
  const int e = launch_jf_partials<T>(x1, x2, x1c, x2c, part, n, k, h, w,
                                      half_t, rb, passes_per_chunk, splits,
                                      stream);
  if (e != 0) return e;
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  joint_reduce_kernel<<<(tk * tk + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, out, splits, k, t, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
