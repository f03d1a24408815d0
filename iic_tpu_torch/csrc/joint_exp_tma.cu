// The tensor-core forms of X3, X4, X5 and X6, hand-written for Hopper
// (sm_90a): the experiment tool's pipelined joint forwards as K1's stack
// product (joint_fwd_common.cuh) fed by the Tensor Memory Accelerator
// through a double buffer of two slots, each with a `full` and an `empty`
// mbarrier.
//
// Replaces tools/joint_kernel_exp.py: `_joint_kernel_v3` (launched by
// `joint_fwd_v3`), `_joint_kernel_v4` (`joint_fwd_v4`), `_joint_kernel_v5`
// (`joint_fwd_v5`, also in the tool's `kpad` run) and `_joint_kernel_v6`
// (`joint_fwd_v6`), with joint_exp_pipe.cu's CUDA-core kernels as
// `form="cuda-core"`.
//
//   P[(v,i),(u,j)] = sum_{n,y,q} x1[n,i,y,q+v-h] * x2[n,j,y+h-u,q]
//
// with h = half_t, T = 2h+1, zero outside each frame, both inputs rounded
// to bf16 (nearest even) and f32 sums: K1's function on bf16 operands.
//
// What the TPU kernels measure. X3: one core issues the MXU product of the
// stage before and then builds the next stage into the other slot of a
// double buffer indexed by the step's parity, p = s % 2. Its counterpart
// here: one thread asks the TMA for the next slab (one instruction a box:
// no registers and no copy instructions in the product warps), the copy
// completes on the slot's `full` mbarrier, and the products wait on that
// barrier's phase, the slab's parity. X5: two row tiles a grid step in
// straight-line code, each stage with its own scratch names and no
// parity, the tile count padded to even. X4: X3 with the two slots
// declared as separate scratch arrays, one picked by a branch on the
// step's parity, and each stage's product staged in a second accumulator
// before it is added. X6: X5's pipeline on f32 inputs
// rounded to bf16 in the kernel, with an optional `roll_build` that
// builds each column-shifted A row from the row before by a lane roll.
//
// The GEMM is K1's, unchanged: M tiles of 4 shifts v x 16 channels i (A
// from registers by ldmatrix.trans), the N tile of 21 shifts u' = T-1-u x
// 16 channels j on two m64n168k16 warpgroups, the same slab walk (jf_next)
// and chunks of whole passes, the same partials and ordered reduce. So the
// four kernels issue the same products, each output entry in the same
// thread's accumulator over the same k16 steps in the same order, and
// equal K1's tensor-core form (X7's "wgmma") bit for bit.
//
// What changes is how a slab gets into shared memory:
//   - No staging warpgroup: 256 threads, the two product warpgroups.
//     Thread 0 issues a slab's four TMA loads once the first row's products
//     of the slab before are committed, into the other slot.
//   - Each slot has a `full` mbarrier (one arrival, armed with the slab's
//     108,544 bytes) and an `empty` one (256 arrivals: every product thread
//     after its last product of the slab has retired). Before loading a
//     slot, thread 0 waits on its empty barrier for the slab that used it
//     last. No __syncthreads() ends a slab.
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
// The loops, one kernel each:
//   X3 (joint_fwd_tma_kernel) walks the slabs one at a time: slab s waits
//     on full[s % 2] for parity (s / 2) % 2, and the refill of slot
//     (s + 1) % 2 waits on its empty barrier for slab s - 1: slot and
//     phase are runtime values of the slab's index.
//   X4 (joint_fwd_tma_branch_kernel) walks the slabs as X3 does, with X3's
//     prologue and phases, but picks the slot by a block-uniform branch on
//     the slab's parity: two call sites of the products, in each of which
//     the slot's address, the other slot's and both barriers are constants
//     (the TPU's `@pl.when(p == 0) build(a0, b0)` / `@pl.when(p == 1)
//     build(a1, b1)`). The TPU's `mmout` staging exists because its product
//     of step s reads the stacks built in step s - 1 and is added after the
//     build; here the TMA fills a slot before its products read it, so, as
//     for X5's `mm`, no second accumulator is kept (it would cost 84
//     registers a thread, past the ceiling where ptxas serialises the
//     products) and the products add into the accumulators directly, in
//     X3's order: X4 equals X3 and X7's tensor-core form bit for bit.
//   X5 (joint_fwd_tma_pair_kernel) unrolls the slab loop over the two
//     slots: iteration m takes the even slab 2m from slot 0 and the odd
//     slab 2m + 1 from slot 1 in straight-line code, so the slots' addresses
//     and barriers are constants of the body; both wait on phase m & 1.
//     The prologue loads slabs 0 and 1. Slab 2m's first row triggers the
//     load of slab 2m + 1 into slot 1 (past the first iteration: empty[1],
//     phase of slab 2m - 1), slab 2m + 1's first row that of slab 2m + 2
//     into slot 0 (empty[0], phase of slab 2m). An odd slab count per chunk
//     (the TPU pads its row tiles to even, `nt += nt % 2`) ends on an
//     iteration whose odd slab is absent: a block-uniform branch skips its
//     wait, products and arrival, where the TPU multiplies an all-padding
//     tile that adds zeros. The TPU's priming product on a zeroed odd slot
//     and its `mm` staging scratch exist because its product of step s
//     reads the stacks built in step s - 1; here the TMA fills both slots
//     before the first product, so neither is kept, and the products add
//     into the accumulators directly, in X3's order.
//   X6 is X5's kernel after K1's layout pass on f32 input (jf_layout_kernel
//     <float>: rounded to bf16, nearest even, as astype), so it equals X5
//     on inputs the wrapper rounds. Its roll_build is the other
//     instantiation (kRoll): every warp loads, with one ldmatrix.trans at
//     the same addresses, the A fragment of the M tile's first shift v0,
//     and warp w rolls it by w pixels along K in registers: each register
//     holds two pixels of one channel, the 16 pixels of a k16 step lie over
//     the four lanes of a quad and two registers, so the roll is a
//     __shfl_sync within the quad from lane (q + w / 2 + d) % 4 (d = 0, 1)
//     of this step's two registers and the next step's first (the tail
//     patch: the next k16 step's fragment, and past the slab's last step
//     pixels 64-67 by an ldmatrix.x2; each lane sends the register its
//     reader needs), d = 1 and a byte permute (prmt) that takes the high
//     pixel of one pair and the low of the next for an odd w only. The
//     values are the bits ldmatrix reads at shift w, so the result
//     equals roll_build = false bit for bit. The rolled registers are the
//     product's A: each is written only after wgmma_wait has retired the
//     product that last read it (the raw fragments are read by shuffles
//     alone).
//
// Bound: as K1, 2 * n * k^2 * S_h * S_w ~ 3.6e11 in-frame FLOP at the
// tool's shapes (n=120, 128^2, T=21, k=15): 0.363 ms at the H100 SXM's 989
// TFLOP/s bf16 peak, compute-bound (X6's 2 x 118 MB of f32 input take
// 0.07 ms at 3.35 TB/s); it issues K1's 5.1e11.
//
// Every entry point launches on the caller's stream, allocates nothing and
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

// The A fragment of warp `w`'s shift from the M tile's v0 fragment `f`
// of this k16 step and `g0`, `g1` (pixels 16-19: registers 0 and 1, lanes
// 0 and 1 of a quad, of the next step's fragment, or of the tail): lane
// q of a quad holds pixels 2q, 2q + 1 in f[c] and 8 + 2q, 9 + 2q in
// f[c + 2], channel lane / 4 + 8 c. Lane q's pixels 2q + w, 2q + w + 1 are
// in pixel pair q + w / 2 (and the next, for an odd w), which lane (q +
// w / 2 + d) % 4 holds (d = 0, 1), in the register after its own where
// the pair index passes 3 (f[c] -> f[c + 2] -> g[c]). Within a quad the
// readers of d's shuffle are a rotation, so each lane sends the register
// its one reader needs: the next one if its q < w / 2 + d. An even w takes
// pair d = 0 as it is; an odd w shuffles pair d = 1 too, and prmt keeps
// the high pixel of the first and the low of the second. The branch on
// w is warp-uniform.
__device__ __forceinline__ void xt_roll(uint32_t (&a)[4],
                                        const uint32_t (&f)[4], uint32_t g0,
                                        uint32_t g1, int lane, int w) {
  const uint32_t g[2] = {g0, g1};
  const int q = lane & 3, s = w >> 1;
  const auto pair = [&](int d, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
    const int src = (lane & ~3) | ((q + s + d) & 3);
    const bool next = q < s + d;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      lo[c] = __shfl_sync(0xffffffffu, next ? f[c + 2] : f[c], src);
      hi[c] = __shfl_sync(0xffffffffu, next ? g[c] : f[c + 2], src);
    }
  };
  uint32_t lo[2], hi[2];
  pair(0, lo, hi);
  if (w & 1) {
    uint32_t lo1[2], hi1[2];
    pair(1, lo1, hi1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a[c] = __byte_perm(lo[c], lo1[c], 0x5432u);
      a[c + 2] = __byte_perm(hi[c], hi1[c], 0x5432u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a[c] = lo[c];
      a[c + 2] = hi[c];
    }
  }
}

// K1's products of slab `s` (jf_products) over this layout: A rows 1,088
// bytes apart, B's window rows one half-row (1,024 bytes) apart, which is
// also the N stride; `after_first_row` runs once the first row's products
// are committed. With kRoll, `a_lane` points at the v0 fragment (no warp
// offset) and `tail_lane` at pixels 64-67, and warp `w` rolls its A
// (xt_roll); the products are the same.
template <bool kChecked, bool kRoll, typename F>
__device__ __forceinline__ void xt_products(float (&acc)[JF_ACC],
                                            uint32_t a_lane,
                                            uint32_t tail_lane,
                                            const unsigned char* b_base,
                                            const JfSlab& s, int lane, int w,
                                            F&& after_first_row) {
  uint32_t a[JF_STEPS][4];
  for (int r = 0; r < s.rows; ++r) {
    const uint32_t a_row = a_lane + r * XT_A_ROW;
    const uint64_t db = smem_desc(b_base + r * JF_HALF, 128, JF_HALF);
    if constexpr (!kRoll) {
#pragma unroll
      for (int st = 0; st < JF_STEPS; ++st) {
        if (!kChecked)
          jf_step<JF_STEPS - 1>(acc, a[st], a_row + 256 * st,
                                desc_advance(db, 256 * st));
        else if (st < s.steps)
          jf_step<0>(acc, a[st], a_row + 256 * st,
                     desc_advance(db, 256 * st));
      }
    } else {
      uint32_t f[JF_STEPS + 1][4];  // v0's fragments; f[JF_STEPS]: the tail
      ldmatrix_x4_trans(f[0], a_row);
#pragma unroll
      for (int st = 0; st < JF_STEPS; ++st) {
        if (kChecked && st >= s.steps) break;
        if (st + 1 < JF_STEPS) {
          ldmatrix_x4_trans(f[st + 1], a_row + 256 * (st + 1));
        } else {
          uint32_t t2[2];
          ldmatrix_x2_trans(t2, tail_lane + r * XT_A_ROW);
          f[st + 1][0] = t2[0];
          f[st + 1][1] = t2[1];
        }
        // a[st] is read by the product four steps back (every product
        // before, in the checked form): the roll writes it once that has
        // retired. Its inputs are pinned after the wait, so that no shuffle
        // writing a[st] moves above it (computed before the wait into other
        // registers, the roll ran no faster)
        wgmma_wait<kChecked ? 0 : JF_STEPS - 1>();
#pragma unroll
        for (int e = 0; e < 4; ++e) wgmma_fence_operand(f[st][e]);
        wgmma_fence_operand(f[st + 1][0]);
        wgmma_fence_operand(f[st + 1][1]);
        xt_roll(a[st], f[st], f[st + 1][0], f[st + 1][1], lane, w);
        wgmma_fence();
        wgmma_m64n168k16_rs_tn(acc, a[st], desc_advance(db, 256 * st));
        wgmma_commit();
      }
    }
    if (r == 0) after_first_row();
  }
  wgmma_wait<0>();
}

// The products of slab `s` in the slot at `slot` (shared-memory address
// `slot_addr`): the unchecked form for a full column slab, else the
// checked one.
template <bool kRoll, typename F>
__device__ __forceinline__ void xt_slab(float (&acc)[JF_ACC],
                                        uint32_t slot_addr,
                                        const unsigned char* slot,
                                        uint32_t a_lane, uint32_t tail_lane,
                                        int b_lane, const JfSlab& s,
                                        int lane, int w,
                                        F&& after_first_row) {
  if (s.steps == JF_STEPS)
    xt_products<false, kRoll>(acc, slot_addr + a_lane, slot_addr + tail_lane,
                              slot + b_lane, s, lane, w, after_first_row);
  else
    xt_products<true, kRoll>(acc, slot_addr + a_lane, slot_addr + tail_lane,
                             slot + b_lane, s, lane, w, after_first_row);
}

// The block's place in the grid and its chunk's first slab, shared by the
// kernels below.
struct XtBlock {
  int t, tk, chunks, ic, v0, jc, up0, p_end, passes_per_image;
  JfSlab first;
};

__device__ __forceinline__ XtBlock xt_block(int k, int h, int w, int half_t,
                                            int rb, int passes_total,
                                            int passes_per_chunk) {
  XtBlock b;
  b.t = 2 * half_t + 1;
  b.tk = k * b.t;
  b.chunks = (k + JF_CH - 1) / JF_CH;
  const int m_tiles = (b.t + JF_V - 1) / JF_V;
  const int n_tiles = (b.t + JF_U - 1) / JF_U;
  b.ic = blockIdx.y / m_tiles;
  b.v0 = (blockIdx.y - b.ic * m_tiles) * JF_V;
  b.jc = blockIdx.x / n_tiles;
  b.up0 = (blockIdx.x - b.jc * n_tiles) * JF_U;
  const int p_begin = blockIdx.z * passes_per_chunk;
  b.p_end = min(p_begin + passes_per_chunk, passes_total);
  b.passes_per_image = (h + rb - 1) / rb;
  // the chunk's first slab: its pass's first row, column 0
  JfSlab& s = b.first;
  s = JfSlab{p_begin, p_begin / b.passes_per_image, 0, 0, 0, 0};
  s.wy = (p_begin - s.img * b.passes_per_image) * rb;
  s.rows = p_begin < b.p_end ? min(JF_ROWS, min(s.wy + rb, h) - s.wy) : 0;
  s.steps = (min(JF_PIX, w) + 15) / 16;
  return b;
}

// Checks the base, initialises the mbarriers and publishes them.
__device__ __forceinline__ void xt_init(uint64_t* full, uint64_t* empty,
                                        uint32_t base) {
  if (threadIdx.x == 0) {
    if ((base & 127u) != 0) __trap();
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], XT_THREADS);
    }
    fence_mbarrier_init();
  }
  __syncthreads();
}

// acc[4c + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column
// 8 c + 2 (lane % 4) + (e & 1) of warpgroup wg's 168: u' = up0 + c,
// channel half wg
__device__ __forceinline__ void xt_store(const float (&acc)[JF_ACC],
                                         float* __restrict__ part,
                                         const XtBlock& b, int k, int wg,
                                         int warp, int lane) {
  float* out = part + static_cast<size_t>(blockIdx.z) * b.tk * b.tk;
  const int v = b.v0 + warp;
  const int i_lo = b.ic * JF_CH + lane / 4;
#pragma unroll
  for (int c = 0; c < JF_CM; ++c) {
    const int u = b.t - 1 - (b.up0 + c);
    const int j0 = b.jc * JF_CH + 8 * wg + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i_lo + 8 * (e >> 1);
      const int j = j0 + (e & 1);
      if (v < b.t && u >= 0 && i < k && j < k)
        out[static_cast<size_t>(v * k + i) * b.tk + u * k + j] =
            acc[4 * c + e];
    }
  }
}

// this lane's ldmatrix.trans row: pixel (lane & 7) + 8 (lane >> 4) of a
// step, shifted by `shift` (the warp's v - v0, or 0 for the roll), in
// channel half (lane >> 3) & 1
__device__ __forceinline__ uint32_t xt_a_lane(int lane, int shift) {
  return XT_A_OFF + ((lane >> 3) & 1) * XT_A_HALF
         + (shift + (lane & 7) + 8 * (lane >> 4)) * 16;
}

// the roll's tail: pixel 64 + (lane & 3) of channel half (lane >> 3) & 1
// (lanes 0-15 address ldmatrix.x2's two matrices; rows 4-7 repeat 0-3)
__device__ __forceinline__ uint32_t xt_tail_lane(int lane) {
  return XT_A_OFF + ((lane >> 3) & 1) * XT_A_HALF + (JF_PIX + (lane & 3)) * 16;
}

__global__ void __launch_bounds__(XT_THREADS, 1)
joint_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     float* __restrict__ part, int k, int h, int w,
                     int half_t, int rb, int passes_total,
                     int passes_per_chunk) {
  const XtBlock bl = xt_block(k, h, w, half_t, rb, passes_total,
                              passes_per_chunk);
  // two slots, each the two halves' x2 windows then x1 rows; then the
  // mbarriers full[2], empty[2]. The TMA destinations are 128-byte aligned
  // (the base is declared so, and a block whose base is not traps; the
  // offsets keep it). Its own name: K1's kernel template, in the same
  // translation unit, declares its dynamic shared memory with 16.
  extern __shared__ __align__(128) unsigned char xt_smem[];
  unsigned char* smem = xt_smem;
  const uint32_t base = smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * XT_BUF);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const uint32_t a_lane = xt_a_lane(lane, warp);
  // this warpgroup's channel half of the window, core matrix u' = 0
  const int b_lane = wg * XT_WIN;
  xt_init(full, empty, base);

  float acc[JF_ACC];
#pragma unroll
  for (int e = 0; e < JF_ACC; ++e) acc[e] = 0.f;
  wgmma_fence();

  JfSlab s = bl.first;
  if (tid == 0 && s.rows)
    xt_load(base, &full[0], &map_a, &map_b, s, bl.ic, bl.jc, bl.chunks,
            bl.v0, bl.up0, half_t);
  for (int idx = 0; s.rows; ++idx) {
    const int slot = idx & 1;
    const JfSlab nx = jf_next(s, bl.p_end, rb, bl.passes_per_image, h, w);
    // the TPU's "issue the dot, then fetch the next stage": once this
    // slab's first products are in flight, thread 0 refills the other slot
    // as soon as slab idx - 1 has left it
    const auto fetch_next = [&]() {
      if (tid == 0 && nx.rows) {
        if (idx > 0) mbar_wait(&empty[slot ^ 1], ((idx - 1) >> 1) & 1);
        xt_load(base + (slot ^ 1) * XT_BUF, &full[slot ^ 1], &map_a,
                &map_b, nx, bl.ic, bl.jc, bl.chunks, bl.v0, bl.up0, half_t);
      }
    };
    mbar_wait(&full[slot], (idx >> 1) & 1);
    xt_slab<false>(acc, base + slot * XT_BUF, smem + slot * XT_BUF, a_lane,
                   0, b_lane, s, lane, warp, fetch_next);
    mbar_arrive(&empty[slot]);
    s = nx;
  }
  xt_store(acc, part, bl, k, wg, warp, lane);
}

// X4's loop: X3's walk, one slab an iteration, with the slot picked by a
// block-uniform branch on the slab's parity, so each branch's slot
// addresses and barriers are constants of its body.
__global__ void __launch_bounds__(XT_THREADS, 1)
joint_fwd_tma_branch_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap map_b,
                            float* __restrict__ part, int k, int h, int w,
                            int half_t, int rb, int passes_total,
                            int passes_per_chunk) {
  const XtBlock bl = xt_block(k, h, w, half_t, rb, passes_total,
                              passes_per_chunk);
  // two slots and four mbarriers, as in X3's kernel
  extern __shared__ __align__(128) unsigned char xt_smem[];
  unsigned char* smem = xt_smem;
  const uint32_t base = smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * XT_BUF);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const uint32_t a_lane = xt_a_lane(lane, warp);
  const int b_lane = wg * XT_WIN;
  xt_init(full, empty, base);

  float acc[JF_ACC];
#pragma unroll
  for (int e = 0; e < JF_ACC; ++e) acc[e] = 0.f;
  wgmma_fence();

  const auto load = [&](int slot, const JfSlab& s) {
    xt_load(base + slot * XT_BUF, &full[slot], &map_a, &map_b, s, bl.ic,
            bl.jc, bl.chunks, bl.v0, bl.up0, half_t);
  };
  JfSlab s = bl.first;
  if (tid == 0 && s.rows) load(0, s);
  for (uint32_t idx = 0; s.rows; ++idx) {
    // slab idx waits at parity (idx / 2) % 2; slab idx - 1, which the
    // refill of the other slot waits out, left it at parity par ^ 1 for an
    // even idx and par for an odd one
    const uint32_t par = (idx >> 1) & 1;
    const JfSlab nx = jf_next(s, bl.p_end, rb, bl.passes_per_image, h, w);
    if ((idx & 1) == 0) {
      mbar_wait(&full[0], par);
      xt_slab<false>(acc, base, smem, a_lane, 0, b_lane, s, lane, warp,
                     [&]() {
                       if (tid == 0 && nx.rows) {
                         if (idx > 0) mbar_wait(&empty[1], par ^ 1);
                         load(1, nx);
                       }
                     });
      mbar_arrive(&empty[0]);
    } else {
      mbar_wait(&full[1], par);
      xt_slab<false>(acc, base + XT_BUF, smem + XT_BUF, a_lane, 0, b_lane, s,
                     lane, warp, [&]() {
                       if (tid == 0 && nx.rows) {
                         mbar_wait(&empty[0], par);
                         load(0, nx);
                       }
                     });
      mbar_arrive(&empty[1]);
    }
    s = nx;
  }
  xt_store(acc, part, bl, k, wg, warp, lane);
}

// X5's loop (X6's with f32 input; kRoll: roll_build): two slabs an
// iteration from the two slots, whose addresses and barriers are
// constants of the body.
template <bool kRoll>
__global__ void __launch_bounds__(XT_THREADS, 1)
joint_fwd_tma_pair_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          float* __restrict__ part, int k, int h, int w,
                          int half_t, int rb, int passes_total,
                          int passes_per_chunk) {
  const XtBlock bl = xt_block(k, h, w, half_t, rb, passes_total,
                              passes_per_chunk);
  // two slots, each the two halves' x2 windows then x1 rows; then the
  // mbarriers full[2], empty[2]. The TMA destinations are 128-byte aligned
  // (the base is declared so, and a block whose base is not traps; the
  // offsets keep it). Its own name: K1's kernel template, in the same
  // translation unit, declares its dynamic shared memory with 16.
  extern __shared__ __align__(128) unsigned char xt_smem[];
  unsigned char* smem = xt_smem;
  const uint32_t base = smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * XT_BUF);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const uint32_t a_lane = xt_a_lane(lane, kRoll ? 0 : warp);
  const uint32_t tail_lane = xt_tail_lane(lane);
  const int b_lane = wg * XT_WIN;
  xt_init(full, empty, base);

  float acc[JF_ACC];
#pragma unroll
  for (int e = 0; e < JF_ACC; ++e) acc[e] = 0.f;
  wgmma_fence();

  const auto load = [&](int slot, const JfSlab& s) {
    xt_load(base + slot * XT_BUF, &full[slot], &map_a, &map_b, s, bl.ic,
            bl.jc, bl.chunks, bl.v0, bl.up0, half_t);
  };
  JfSlab s0 = bl.first;
  JfSlab s1 = jf_next(s0, bl.p_end, rb, bl.passes_per_image, h, w);
  if (tid == 0) {
    if (s0.rows) load(0, s0);
    if (s1.rows) load(1, s1);
  }
  for (uint32_t m = 0; s0.rows; ++m) {
    const uint32_t par = m & 1;
    const JfSlab n0 = jf_next(s1, bl.p_end, rb, bl.passes_per_image, h, w);
    const JfSlab n1 = jf_next(n0, bl.p_end, rb, bl.passes_per_image, h, w);
    // the even slab, slot 0; then slot 1 takes slab 2m + 1 once slab
    // 2m - 1 has left it (the prologue loaded slab 1)
    mbar_wait(&full[0], par);
    xt_slab<kRoll>(acc, base, smem, a_lane, tail_lane, b_lane, s0, lane,
                   warp, [&]() {
                     if (tid == 0 && m > 0 && s1.rows) {
                       mbar_wait(&empty[1], par ^ 1);
                       load(1, s1);
                     }
                   });
    mbar_arrive(&empty[0]);
    // the odd slab, slot 1, absent at the end of an odd count; then slot
    // 0 takes slab 2m + 2 once slab 2m has left it
    if (s1.rows) {
      mbar_wait(&full[1], par);
      xt_slab<kRoll>(acc, base + XT_BUF, smem + XT_BUF, a_lane, tail_lane,
                     b_lane, s1, lane, warp, [&]() {
                       if (tid == 0 && n0.rows) {
                         mbar_wait(&empty[0], par);
                         load(0, n0);
                       }
                     });
      mbar_arrive(&empty[1]);
    }
    s0 = n0;
    s1 = n1;
  }
  xt_store(acc, part, bl, k, wg, warp, lane);
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

using XtKernel = void (*)(CUtensorMap, CUtensorMap, float*, int, int, int,
                          int, int, int, int);

// Runs `kernel` on x1, x2 (n, k, h, w) of type T (f32 or bf16): the layout
// pass into x1c, x2c ((n, ceil(k/16), h, w, 16) bf16 scratch), the tensor
// maps over them, the GEMM kernel's partials into part ((splits, kT, kT)
// f32 scratch) and their ordered reduce into out (k, k, T, T) f32. The
// (n, y) rows are cut into passes of rb rows of one image, the passes into
// `splits` chunks of passes_per_chunk (X7's plan).
template <typename T>
int launch_tma(XtKernel kernel, const void* x1, const void* x2, void* x1c,
               void* x2c, float* part, float* out, int n, int k, int h,
               int w, int half_t, int rb, int passes_per_chunk, int splits,
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
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, XT_SMEM);
  if (err != cudaSuccess) return refused(err);
  int e = launch_jf_layout<T>(static_cast<const T*>(x1), ac, n, k, h, w,
                              stream);
  if (e == 0)
    e = launch_jf_layout<T>(static_cast<const T*>(x2), bc, n, k, h, w,
                            stream);
  if (e != 0) return e;
  const int t = 2 * half_t + 1;
  dim3 grid(chunks * ((t + JF_U - 1) / JF_U),
            chunks * ((t + JF_V - 1) / JF_V), splits);
  kernel<<<grid, XT_THREADS, XT_SMEM, stream>>>(
      map_a, map_b, part, k, h, w, half_t, rb, passes, passes_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tk = k * t;
  joint_reduce_kernel<<<(tk * tk + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, out, splits, k, t, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tensor-core forms (launch_tma): x1, x2 (n, k, h, w) contiguous, bf16
// for X3, X4 and X5, f32 for X6; x1c, x2c (n, ceil(k/16), h, w, 16) bf16
// scratch; part (splits, kT, kT) f32 scratch; out (k, k, T, T) f32.
// Return 0, a CUDA error, or minus the CUresult of a refused tensor map.
int joint_exp_fwd_v3_tma(const void* x1, const void* x2, void* x1c,
                         void* x2c, float* part, float* out, int n, int k,
                         int h, int w, int half_t, int rb,
                         int passes_per_chunk, int splits,
                         cudaStream_t stream) {
  return launch_tma<bf16>(joint_fwd_tma_kernel, x1, x2, x1c, x2c, part, out,
                          n, k, h, w, half_t, rb, passes_per_chunk, splits,
                          stream);
}

int joint_exp_fwd_v4_tma(const void* x1, const void* x2, void* x1c,
                         void* x2c, float* part, float* out, int n, int k,
                         int h, int w, int half_t, int rb,
                         int passes_per_chunk, int splits,
                         cudaStream_t stream) {
  return launch_tma<bf16>(joint_fwd_tma_branch_kernel, x1, x2, x1c, x2c,
                          part, out, n, k, h, w, half_t, rb,
                          passes_per_chunk, splits, stream);
}

int joint_exp_fwd_v5_tma(const void* x1, const void* x2, void* x1c,
                         void* x2c, float* part, float* out, int n, int k,
                         int h, int w, int half_t, int rb,
                         int passes_per_chunk, int splits,
                         cudaStream_t stream) {
  return launch_tma<bf16>(joint_fwd_tma_pair_kernel<false>, x1, x2, x1c, x2c,
                          part, out, n, k, h, w, half_t, rb,
                          passes_per_chunk, splits, stream);
}

// X6: f32 x1, x2, rounded to bf16 by the layout pass; roll_build != 0
// launches the instantiation that rolls each warp's A from v0's.
int joint_exp_fwd_v6_tma(const void* x1, const void* x2, void* x1c,
                         void* x2c, float* part, float* out, int n, int k,
                         int h, int w, int half_t, int rb,
                         int passes_per_chunk, int splits, int roll_build,
                         cudaStream_t stream) {
  return launch_tma<float>(roll_build ? joint_fwd_tma_pair_kernel<true>
                                      : joint_fwd_tma_pair_kernel<false>,
                           x1, x2, x1c, x2c, part, out, n, k, h, w, half_t,
                           rb, passes_per_chunk, splits, stream);
}

}  // extern "C"
