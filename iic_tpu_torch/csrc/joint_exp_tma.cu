// X3's tensor-core form, hand-written for Hopper (sm_90a): the experiment
// tool's pipelined joint forward as K1's stack product (joint_fwd_common.cuh)
// fed by the Tensor Memory Accelerator through a double buffer whose slot
// and phase are the slab's parity.
//
// Replaces tools/joint_kernel_exp.py: `_joint_kernel_v3` (launched by
// `joint_fwd_v3`), with joint_exp_pipe.cu's CUDA-core kernel as
// `form="cuda-core"`.
//
//   P[(v,i),(u,j)] = sum_{n,y,q} x1[n,i,y,q+v-h] * x2[n,j,y+h-u,q]
//
// with h = half_t, T = 2h+1, zero outside each frame, both inputs rounded
// to bf16 (nearest even) and f32 sums: K1's function on bf16 operands.
//
// What the TPU kernel measures. One core issues the MXU product of the
// stage before and then builds the next stage into the other slot of a
// double buffer indexed by the step's parity, p = s % 2. Its counterpart
// here: one thread asks the TMA for the next slab (one instruction a box:
// no registers and no copy instructions in the product warps), the copy
// completes on the slot's `full` mbarrier, and the products wait on that
// barrier's phase, the slab's parity.
//
// The GEMM is K1's, unchanged: M tiles of 4 shifts v x 16 channels i (A
// from registers by ldmatrix.trans), the N tile of 21 shifts u' = T-1-u x
// 16 channels j on two m64n168k16 warpgroups, the same slab walk (jf_next)
// and chunks of whole passes, the same partials and ordered reduce. So X3
// issues the same products, each output entry in the same thread's
// accumulator over the same k16 steps in the same order, and equals K1's
// tensor-core form (X7's "wgmma") bit for bit.
//
// What changes is how a slab gets into shared memory:
//   - No staging warpgroup: 256 threads, the two product warpgroups.
//     Thread 0 issues the next slab's four TMA loads once the first row's
//     products of the current slab are committed, into the other slot.
//   - Each slot has a `full` mbarrier (one arrival, armed with the slab's
//     108,544 bytes) and an `empty` one (256 arrivals: every product thread
//     after its last product of the slab has retired). A slab s waits on
//     full[s % 2] for parity (s / 2) % 2; before loading slab s + 1 into
//     slot (s + 1) % 2, thread 0 waits on that slot's empty barrier for
//     slab s - 1. No __syncthreads() ends a slab.
//   - The operands stay in K1's channels-last chunks, (n, ceil(k/16), h, w,
//     16) bf16 from jf_layout_kernel, seen by two 4-D tiled tensor maps,
//     dims (16 channels, w, h, n ceil(k/16)), strides (32, 32 w, 32 w h)
//     bytes, no swizzle. A box of (8, pixels, rows, 1) at channel 0 or 8
//     lands one channel half as [row][pixel][8]: the x2 window (64 pixels x
//     36 rows at (q0, y - h + up0)) and the x1 rows (68 pixels x 16 rows at
//     (q0 + v0 - h, y)). Coordinates before or past the frame are zero-
//     filled by the TMA (jf_stage's masks); the image is its own dimension,
//     so no row spills into the next. A ragged slab loads whole boxes and
//     reads only its rows.
//   - The window is stored [half][row][pixel][8] and N is ordered (channel
//     half, u'): warpgroup g takes half g, and its 21 core matrices along N
//     are one window row (1,024 bytes) apart, the descriptor's uniform
//     stride; the epilogue maps column 8 c + jj of warpgroup g back to u' =
//     up0 + c, j = 16 jc + 8 g + jj. The x1 rows are stored
//     [half][row][68 pixels][8], and the ldmatrix.trans addresses follow.
//
// Bound: as K1, 2 * n * k^2 * S_h * S_w ~ 3.6e11 in-frame FLOP at the
// tool's shapes (n=120, 128^2, T=21, k=15): 0.363 ms at the H100 SXM's 989
// TFLOP/s bf16 peak, compute-bound; it issues K1's 5.1e11.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launches; a tensor map that
// cuTensorMapEncodeTiled refuses returns minus its CUresult, and nothing
// is launched.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "joint_common.cuh"
#include "joint_fwd_common.cuh"

namespace {

constexpr int XT_THREADS = 128 * JF_WGS;           // the product warpgroups
constexpr int XT_WIN = JF_WIN_ROWS * JF_HALF;      // a half's window: 36,864
constexpr int XT_A_ROW = JF_A_PIX * 16;            // a half's x1 row: 1,088
constexpr int XT_A_HALF = JF_ROWS * XT_A_ROW;      // 17,408
constexpr int XT_A_OFF = JF_WGS * XT_WIN;          // x1 after both windows
constexpr int XT_BUF = XT_A_OFF + 2 * XT_A_HALF;   // 108,544 bytes a slot
constexpr int XT_SMEM = 2 * XT_BUF + 4 * 8;        // and four mbarriers

static_assert(XT_BUF == JF_SMEM, "a slot holds what K1's buffer holds");
static_assert(XT_WIN % 128 == 0 && XT_A_HALF % 128 == 0,
              "TMA destinations stay 128-byte aligned");

// The four boxes of slab `s` into the slot at `buf`, completing on `bar`:
// each channel half of the x2 window and of the x1 rows.
__device__ __forceinline__ void xt_load(uint32_t buf, uint64_t* bar,
                                        const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        const JfSlab& s, int ic, int jc,
                                        int chunks, int v0, int up0,
                                        int half_t) {
  mbar_arrive_expect_tx(bar, XT_BUF);
  const int za = s.img * chunks + ic, zb = s.img * chunks + jc;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    tma_load_4d(buf + c * XT_WIN, map_b, bar, 8 * c, s.q0,
                s.wy - half_t + up0, zb);
    tma_load_4d(buf + XT_A_OFF + c * XT_A_HALF, map_a, bar, 8 * c,
                s.q0 + v0 - half_t, s.wy, za);
  }
}

// K1's products of slab `s` (jf_products) over this layout: A rows 1,088
// bytes apart, B's window rows one half-row (1,024 bytes) apart, which is
// also the N stride; `after_first_row` runs once the first row's products
// are committed.
template <bool kChecked, typename F>
__device__ __forceinline__ void xt_products(float (&acc)[JF_ACC],
                                            uint32_t a_lane,
                                            const unsigned char* b_base,
                                            const JfSlab& s,
                                            F&& after_first_row) {
  uint32_t a[JF_STEPS][4];
  for (int r = 0; r < s.rows; ++r) {
    const uint32_t a_row = a_lane + r * XT_A_ROW;
    const uint64_t db = smem_desc(b_base + r * JF_HALF, 128, JF_HALF);
#pragma unroll
    for (int st = 0; st < JF_STEPS; ++st) {
      if (!kChecked)
        jf_step<JF_STEPS - 1>(acc, a[st], a_row + 256 * st,
                              desc_advance(db, 256 * st));
      else if (st < s.steps)
        jf_step<0>(acc, a[st], a_row + 256 * st,
                   desc_advance(db, 256 * st));
    }
    if (r == 0) after_first_row();
  }
  wgmma_wait<0>();
}

__global__ void __launch_bounds__(XT_THREADS, 1)
joint_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     float* __restrict__ part, int k, int h, int w,
                     int half_t, int rb, int passes_total,
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

  // two slots, each the two halves' x2 windows then x1 rows; then the
  // mbarriers full[2], empty[2]. The TMA destinations are 128-byte aligned
  // (the base is declared so, and a block whose base is not traps; the
  // offsets keep it). Its own name: K1's kernel, in the same translation
  // unit, declares its dynamic shared memory with 16.
  extern __shared__ __align__(128) unsigned char xt_smem[];
  unsigned char* smem = xt_smem;
  const uint32_t base = smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * XT_BUF);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x;
  if (tid == 0 && (base & 127u) != 0) __trap();
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  // this lane's ldmatrix.trans row: pixel (lane & 7) + 8 (lane >> 4) of a
  // step, shifted by the warp's v - v0, in channel half (lane >> 3) & 1
  const uint32_t a_lane = XT_A_OFF + ((lane >> 3) & 1) * XT_A_HALF
                          + (warp + (lane & 7) + 8 * (lane >> 4)) * 16;
  // this warpgroup's channel half of the window, core matrix u' = 0
  const int b_lane = wg * XT_WIN;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], XT_THREADS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  float acc[JF_ACC];
#pragma unroll
  for (int e = 0; e < JF_ACC; ++e) acc[e] = 0.f;
  wgmma_fence();

  // the chunk's first slab: its pass's first row, column 0
  JfSlab s{p_begin, p_begin / passes_per_image, 0, 0, 0, 0};
  s.wy = (p_begin - s.img * passes_per_image) * rb;
  s.rows = p_begin < p_end ? min(JF_ROWS, min(s.wy + rb, h) - s.wy) : 0;
  s.steps = (min(JF_PIX, w) + 15) / 16;
  if (tid == 0 && s.rows)
    xt_load(base, &full[0], &map_a, &map_b, s, ic, jc, chunks, v0, up0,
            half_t);
  for (int idx = 0; s.rows; ++idx) {
    const int slot = idx & 1;
    const JfSlab nx = jf_next(s, p_end, rb, passes_per_image, h, w);
    // the TPU's "issue the dot, then fetch the next stage": once this
    // slab's first products are in flight, thread 0 refills the other slot
    // as soon as slab idx - 1 has left it
    const auto fetch_next = [&]() {
      if (tid == 0 && nx.rows) {
        if (idx > 0) mbar_wait(&empty[slot ^ 1], ((idx - 1) >> 1) & 1);
        xt_load(base + (slot ^ 1) * XT_BUF, &full[slot ^ 1], &map_a, &map_b,
                nx, ic, jc, chunks, v0, up0, half_t);
      }
    };
    mbar_wait(&full[slot], (idx >> 1) & 1);
    const unsigned char* b_base = smem + slot * XT_BUF + b_lane;
    const uint32_t a_base = base + slot * XT_BUF + a_lane;
    if (s.steps == JF_STEPS)
      xt_products<false>(acc, a_base, b_base, s, fetch_next);
    else
      xt_products<true>(acc, a_base, b_base, s, fetch_next);
    mbar_arrive(&empty[slot]);
    s = nx;
  }

  // acc[4c + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column
  // 8 c + 2 (lane % 4) + (e & 1) of warpgroup wg's 168: u' = up0 + c,
  // channel half wg
  float* out = part + static_cast<size_t>(blockIdx.z) * tk * tk;
  const int v = v0 + warp;
  const int i_lo = ic * JF_CH + lane / 4;
#pragma unroll
  for (int c = 0; c < JF_CM; ++c) {
    const int u = t - 1 - (up0 + c);
    const int j0 = jc * JF_CH + 8 * wg + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i_lo + 8 * (e >> 1);
      const int j = j0 + (e & 1);
      if (v < t && u >= 0 && i < k && j < k)
        out[static_cast<size_t>(v * k + i) * tk + u * k + j] = acc[4 * c + e];
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
}

// A 4-D tiled map over xc (n, chunks, h, w, 16) bf16: dims (16, w, h,
// n chunks), boxes of (8, pixels, rows, 1), zero fill outside.
CUresult encode(PFN_cuTensorMapEncodeTiled_v12000 fn, CUtensorMap* map,
                const bf16* xc, int n, int chunks, int h, int w, int pixels,
                int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(JF_CH),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n) * chunks};
  const cuuint64_t strides[3] = {
      2 * JF_CH, static_cast<cuuint64_t>(2 * JF_CH) * w,
      static_cast<cuuint64_t>(2 * JF_CH) * w * h};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(pixels),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<bf16*>(xc), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

extern "C" {

// X3's tensor-core form: x1, x2 (n, k, h, w) bf16 contiguous; x1c, x2c
// (n, ceil(k/16), h, w, 16) bf16 scratch for the layout pass; part
// (splits, kT, kT) f32 scratch; out (k, k, T, T) f32. The (n, y) rows are
// cut into passes of rb rows of one image, the passes into `splits` chunks
// of passes_per_chunk (X7's plan). Returns 0, a CUDA error, or minus the
// CUresult of a refused tensor map.
int joint_exp_fwd_v3_tma(const void* x1, const void* x2, void* x1c,
                         void* x2c, float* part, float* out, int n, int k,
                         int h, int w, int half_t, int rb,
                         int passes_per_chunk, int splits,
                         cudaStream_t stream) {
  if (n < 1 || k < 1 || h < 1 || w < 1 || half_t < 0 || rb < 1
      || passes_per_chunk < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int passes = n * ((h + rb - 1) / rb);
  if (static_cast<long long>(splits) * passes_per_chunk < passes
      || static_cast<long long>(splits - 1) * passes_per_chunk >= passes)
    return static_cast<int>(cudaErrorInvalidValue);
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const int chunks = (k + JF_CH - 1) / JF_CH;
  auto* ac = static_cast<bf16*>(x1c);
  auto* bc = static_cast<bf16*>(x2c);
  CUtensorMap map_a, map_b;
  CUresult res = encode(fn, &map_a, ac, n, chunks, h, w, JF_A_PIX, JF_ROWS);
  if (res == CUDA_SUCCESS)
    res = encode(fn, &map_b, bc, n, chunks, h, w, JF_PIX, JF_WIN_ROWS);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  cudaError_t err = cudaFuncSetAttribute(
      joint_fwd_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      XT_SMEM);
  if (err != cudaSuccess) return refused(err);
  int e = launch_jf_layout<bf16>(static_cast<const bf16*>(x1), ac, n, k, h,
                                 w, stream);
  if (e == 0)
    e = launch_jf_layout<bf16>(static_cast<const bf16*>(x2), bc, n, k, h, w,
                               stream);
  if (e != 0) return e;
  const int t = 2 * half_t + 1;
  dim3 grid(chunks * ((t + JF_U - 1) / JF_U),
            chunks * ((t + JF_V - 1) / JF_V), splits);
  joint_fwd_tma_kernel<<<grid, XT_THREADS, XT_SMEM, stream>>>(
      map_a, map_b, part, k, h, w, half_t, rb, passes, passes_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tk = k * t;
  joint_reduce_kernel<<<(tk * tk + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, out, splits, k, t, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
