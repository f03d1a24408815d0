// Pipelined forward probes of the displacement-joint experiment tool,
// hand-written for Hopper (sm_90a): X3, X4, X5 and X6, the joint forward
// with bf16 operands whose next stage is fetched while the FMAs run on the
// current one, on the CUDA cores: X4's only form, and the `form="cuda-core"`
// of X3, X5 and X6 (their default at k <= 4; their tensor-core forms are
// joint_exp_tma.cu).
//
// Replaces tools/joint_kernel_exp.py: `_joint_kernel_v3` (launched by
// `joint_fwd_v3`), `_joint_kernel_v4` (`joint_fwd_v4`), `_joint_kernel_v5`
// (`joint_fwd_v5`, also in the tool's `kpad` run) and `_joint_kernel_v6`
// (`joint_fwd_v6`).
//
//   P[i,j,u,v] = sum_{n,y,q} bf16(x1[n,i,y,q+v-h]) * bf16(x2[n,j,y+h-u,q])
//
// with h = half_t, T = 2h+1, zero outside each frame: X2's joint
// (joint_exp.cu), both inputs rounded to bf16 (nearest even, as the TPU
// tool's astype), f32 accumulation. A product of two bf16 values is exact in
// f32, so the four kernels differ from each other and from X2 only in the
// order of the f32 sums. As in K1 it is the (kT x kT) GEMM
// P[(v,i),(u,j)] = A @ B^T over the (n, y, q) contraction, A the
// column-shifted x1 stack, B the row-shifted x2 stack.
//
// Bound: as X2, 2 * n * k^2 * S_h * S_w ~ 3.6e11 in-frame FLOP at the tool's
// shapes (n=120, 128^2, T=21, k=15; S = 2578): 0.363 ms at the 989 TFLOP/s
// bf16 tensor-core peak, on 2 x 59 MB of bf16 input (X6: 2 x 118 MB of
// f32), so compute-bound. This first version runs the product as f32 FMAs on
// the CUDA cores (67 TFLOP/s peak), as K1 and X7 do.
//
// What the TPU kernels measure. A TPU grid step builds the shifted stacks of
// one rb x 128 row tile on the VPU and multiplies them on the MXU; v3-v6
// overlap the MXU product of one tile with the VPU build of the next: the
// product on the stacks built in the step before issues first, this step's
// stacks are built into the other slot meanwhile, then the product is
// accumulated. The matching question on this card is whether fetching the
// next stage while the FMAs run on the current one moves a CUDA-core joint.
//
// Design, common to the four: one split-K partial kernel, templated on the
// pipeline and the input type and instantiated once per TPU kernel (X6 twice,
// for roll_build). It is X7, K1's split-K kernel (joint_common.cuh) on bf16
// inputs, with its loads moved ahead of the FMAs of the stage before. Block
// (bx, by, s) owns the 64x64 tile (by, bx) of the (kT x kT) product and the
// s-th chunk of the (n, y) rows (a multiple of rb rows: rb is X7's row
// quantum, it moves chunk edges and so the order of the sums, never the
// work); its partial goes to part[s], and K1's ordered reduce adds the
// partials and scatters them into (k, k, T, T). A stage is K1's pass: 16
// columns of one (n, y) row, depth 16 of the contraction, for the tile's 64
// A rows and 64 B rows. (The TPU's stage, a whole rb x 128 row tile, would
// need 64 x 2048 f32 per stack and slot, far above a block's shared
// memory.) Each thread issues its 8 loads of stage c+1 into registers, runs
// K1's 16 x 4 x 4 FMAs on stage c's slot, then stores the fetched values,
// widened to f32, into the other slot: one __syncthreads() per stage
// instead of K1's two. A value is converted only at that store: a
// conversion next to its load would make the warp wait on the load before
// the FMAs. On a GPU the other resident blocks already hide a
// block's load latency, which the TPU's single in-order core could not do;
// what is left to win is K1's second barrier and the latency inside one
// block.
//
// Why registers and not cp.async. The A stack reads x1[.., q + v - h] at
// every column shift: for bf16 input a 2-byte element at any alignment,
// below cp.async's smallest copy (4 bytes). X6's f32 input could be copied
// with 4-byte cp.async and zero-fill at any shift, but it would land
// unrounded: the rounding to bf16 would then need a second pass over the
// tile or move into the FMA loop. So all four stage through registers,
// which keeps X7's "widen once, at the store" and K1's FMA loop unchanged.
// The cost is 8 values live across the FMA loop: `ptxas -v` prints each
// instantiation's registers (at 80 or fewer, K1's count, 3 blocks of 256
// threads fit an SM; from 81 to 128, 2).
//
// The TPU constructs, and what each maps to:
//   X3 (v3)  The stack double buffer a2/b2 (2, tk, ...) indexed by the step
//            parity p: __shared__ As[2][BK][BM+PAD], Bs[2][BK][BN+PAD]
//            indexed by a runtime p ^= 1. The TPU's drain dot at the last
//            step is the last stage's FMA pass. `flat` picks the TPU stack
//            layout, (2, tk, rb*128) or (2, tk, rb, 128): the same bytes in
//            row-major order, and here a stage is 16 deep whatever the
//            layout, so both select the same launch (as X2's rank3).
//   X4 (v4)  Two separately declared slot scratches a0/b0 and a1/b1:
//            As0/Bs0 and As1/Bs1, chosen by a block-uniform branch on the
//            parity. The product is staged through `mmout`: a second 4x4
//            accumulator per thread, cleared each stage, takes the stage's
//            FMAs and is then added into the running sum (16 registers and
//            16 adds a stage more).
//   X5 (v5)  Two tiles per grid step in straight-line code with static slot
//            names: the loop body runs two stages, the even one through
//            slot 0 and the odd one through slot 1, with no parity. A block
//            with an odd stage count gets one all-zero stage (the tool's
//            `nt += nt % 2`), and slot 1 is zeroed before the first
//            iteration, so the priming product (the TPU's dot on the odd
//            stacks of the step before) adds nothing; the drain is a last
//            product on slot 1. The TPU's `mm` scratch is not kept: the FMAs
//            add into the sum directly, so X5 sums in X3's and X7's order.
//   X6 (v6)  X5's body on f32 inputs: each value is rounded to bf16 with
//            __float2bfloat16_rn (nearest even, as astype) and widened back
//            as it is stored into the tile. rb is fixed at 16. With
//            `roll_build` the TPU builds the A stack of shift v from shift
//            v-1's by a one-lane roll of each 128-lane row, the last lane
//            patched from the window. Here each thread's four A rows are
//            taken in (channel, shift) order, so that consecutive rows of a
//            thread are mostly (v-1, i) and (v, i); row (v, i) at column q
//            is row (v-1, i) at column q+1, which the next lane of the
//            thread's 16-lane group holds: __shfl_down_sync(.., 1, 16) is
//            the roll, and lane 15 loads the last column fresh, as does the
//            first row of each chain. The fresh loads are issued before the
//            product and the roll runs after it, on the unrounded values, so
//            the loads still overlap the FMAs. The values are the same bits
//            as a fresh load, and the tiles in shared memory the same, so
//            the result equals roll_build = false bit for bit; about half
//            of the A loads are shuffles instead.
//
// X3, X5 and X6 sum in X7's order (X5's priming and padding products add
// zeros), so at the same rb they give X7's result bit for bit; X6 equals
// X5 on inputs rounded by the wrapper.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "joint_common.cuh"

namespace {

// The pipelines, named by the TPU kernel; X6 is kPair on f32 input.
enum Pipe { kParity = 3, kSlots = 4, kPair = 5 };

typedef float Row[BM + PAD];  // one contraction index of a stage tile
static_assert(BM == BN, "Row serves the A and the B tile");

// A value as staged into the f32 tiles: bf16 input widened; f32 input (X6)
// rounded to bf16, nearest even, and widened back.
__device__ __forceinline__ float staged(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float staged(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A thread's part of a stage: column q0 + kk, four A rows (a_row) and four
// B rows (lr + 16 l) of the 64x64 tile. Offsets are within one image.
struct Loader {
  int kk, lr;
  int a_row[4];
  int a_off[4], b_off[4];
  int a_shift[4], b_shift[4];
  bool a_ok[4], b_ok[4];
  bool chain[4];  // roll_build: A row l is A row l-1 one shift on
};

// The stage at (n, y) row r, first column q0; `img` is image n's offset.
struct Cursor {
  int r, y, q0;
  size_t img;
};

__device__ __forceinline__ Cursor first_stage(int r, int h,
                                              size_t img_stride) {
  const int n = r / h;
  Cursor c;
  c.r = r;
  c.y = r - n * h;
  c.q0 = 0;
  c.img = static_cast<size_t>(n) * img_stride;
  return c;
}

__device__ __forceinline__ void advance(Cursor& c, int h, int w,
                                        size_t img_stride) {
  c.q0 += BK;
  if (c.q0 < w) return;
  c.q0 = 0;
  ++c.r;
  if (++c.y == h) {
    c.y = 0;
    c.img += img_stride;
  }
}

// roll_build's row order (thread 0): the tile's rows below kT by channel,
// then by shift, then the rows past kT. rows[p] is a row of the tile.
__device__ void rows_by_channel(int* rows, int m0, int tk, int k) {
  const int m_hi = min(m0 + BM, tk);
  int p = 0;
  for (int c = 0; c < k; ++c)
    for (int m = m0 + ((c - m0 % k) % k + k) % k; m < m_hi; m += k)
      rows[p++] = m - m0;
  for (int m = m_hi; m < m0 + BM; ++m) rows[p++] = m - m0;
}

// K1's loader tables for this thread; with kRoll its A rows come from
// `rows` (rows_by_channel), four consecutive entries per thread.
template <bool kRoll>
__device__ __forceinline__ Loader make_loader(int m0, int n0, int tk, int k,
                                              int half_t, int plane,
                                              const int* rows) {
  Loader L;
  L.kk = threadIdx.x % BK;
  L.lr = threadIdx.x / BK;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    L.a_row[l] = kRoll ? rows[4 * L.lr + l] : L.lr + 16 * l;
    const int m = m0 + L.a_row[l];
    L.a_ok[l] = m < tk;
    L.a_off[l] = stack_chan(m, tk, k) * plane;
    L.a_shift[l] = a_shift_of(m, tk, k, half_t);
    L.chain[l] = kRoll && l > 0 && L.a_ok[l]
                 && L.a_row[l] - L.a_row[l - 1] == k;
    const int nn = n0 + L.lr + 16 * l;
    L.b_ok[l] = nn < tk;
    L.b_off[l] = stack_chan(nn, tk, k) * plane;
    L.b_shift[l] = b_shift_of(nn, tk, k, half_t);
  }
  return L;
}

// The raw input values of one stage that a thread holds across the
// product: four A rows and four B rows, zero where masked. They are rounded
// and widened only at the put, after the product, so that no conversion
// waits on a load before the FMAs.
template <typename T>
struct Stage {
  T a[4], b[4];
};

// This thread's values of stage `c` (all zero unless `live`); returns
// whether its column is in the stage. With kRoll, a holds only the A values
// loaded fresh (`roll` makes the rest after the product), unmasked by the
// column: the next lane's roll reads them.
template <typename T, bool kRoll>
__device__ __forceinline__ bool fetch(const T* __restrict__ x1,
                                      const T* __restrict__ x2,
                                      const Cursor& c, bool live,
                                      const Loader& L, int h, int w,
                                      Stage<T>& st) {
  const int q = c.q0 + L.kk;
  const bool q_ok = live && q < w;
  const T* x1r = x1 + c.img + static_cast<size_t>(c.y) * w;
  const T* x2n = x2 + c.img;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int col = q + L.a_shift[l];
    const bool fresh = !kRoll || !L.chain[l] || L.kk == BK - 1;
    st.a[l] = (fresh && L.a_ok[l] && (kRoll ? live : q_ok) && col >= 0
               && col < w) ? x1r[L.a_off[l] + col] : T(0.f);
    const int row = c.y + L.b_shift[l];
    st.b[l] = (L.b_ok[l] && q_ok && row >= 0 && row < h)
                  ? x2n[L.b_off[l] + static_cast<size_t>(row) * w + q]
                  : T(0.f);
  }
  return q_ok;
}

// roll_build, after the product: A row l of a chain at column q is row
// l-1 at column q+1, which the next lane of the 16-lane group holds; lane
// 15 and the first row of each chain keep their fresh value. Every lane of
// a warp calls it together.
__device__ __forceinline__ void roll(const Loader& L, bool q_ok,
                                     float (&a)[4]) {
  float prev = 0.f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    float v = __shfl_down_sync(0xffffffffu, prev, 1, BK);
    if (!L.chain[l] || L.kk == BK - 1) v = a[l];
    prev = v;
    a[l] = q_ok ? v : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void put(Row* As, Row* Bs, const Loader& L,
                                    const Stage<T>& st) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    As[L.kk][L.a_row[l]] = staged(st.a[l]);
    Bs[L.kk][L.lr + 16 * l] = staged(st.b[l]);
  }
}

// K1's FMA loop over one stage: acc[a][b] += A[tr*4 + a] . B[tc*4 + b].
__device__ __forceinline__ void product(const Row* As, const Row* Bs, int tr,
                                        int tc, float (&acc)[4][4]) {
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
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// The split-K partial of block (bx, by, s) through pipeline kPipe.
template <int kPipe, typename T, bool kRoll>
__global__ void __launch_bounds__(kThreads)
joint_pipe_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                  float* __restrict__ part, int k, int h, int w, int half_t,
                  int rows_total, int rows_per_chunk) {
  static_assert(!kRoll || kPipe == kPair, "roll_build is X6's (kPair)");
  const int tk = k * (2 * half_t + 1);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * rows_per_chunk;
  const int r_end = min(r_begin + rows_per_chunk, rows_total);
  const size_t img_stride = static_cast<size_t>(k) * h * w;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  Cursor cur = first_stage(r_begin, h, img_stride);
  float acc[4][4];
  Stage<T> st;
  zero(acc);

  if constexpr (kPipe == kParity) {
    __shared__ __align__(16) float As[2][BK][BM + PAD];
    __shared__ __align__(16) float Bs[2][BK][BN + PAD];
    const Loader L = make_loader<false>(m0, n0, tk, k, half_t, h * w,
                                        nullptr);
    fetch<T, false>(x1, x2, cur, true, L, h, w, st);
    put(As[0], Bs[0], L, st);
    __syncthreads();
    int p = 0;
    while (cur.r < r_end) {
      Cursor next = cur;
      advance(next, h, w, img_stride);
      fetch<T, false>(x1, x2, next, next.r < r_end, L, h, w, st);
      product(As[p], Bs[p], tr, tc, acc);
      put(As[p ^ 1], Bs[p ^ 1], L, st);
      __syncthreads();
      p ^= 1;
      cur = next;
    }
  } else if constexpr (kPipe == kSlots) {
    __shared__ __align__(16) float As0[BK][BM + PAD], Bs0[BK][BN + PAD];
    __shared__ __align__(16) float As1[BK][BM + PAD], Bs1[BK][BN + PAD];
    const Loader L = make_loader<false>(m0, n0, tk, k, half_t, h * w,
                                        nullptr);
    float mmout[4][4];
    fetch<T, false>(x1, x2, cur, true, L, h, w, st);
    put(As0, Bs0, L, st);
    __syncthreads();
    int p = 0;
    while (cur.r < r_end) {
      Cursor next = cur;
      advance(next, h, w, img_stride);
      fetch<T, false>(x1, x2, next, next.r < r_end, L, h, w, st);
      zero(mmout);
      if (p == 0) {
        product(As0, Bs0, tr, tc, mmout);
        put(As1, Bs1, L, st);
      } else {
        product(As1, Bs1, tr, tc, mmout);
        put(As0, Bs0, L, st);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += mmout[a][b];
      __syncthreads();
      p ^= 1;
      cur = next;
    }
  } else {
    __shared__ __align__(16) float As0[BK][BM + PAD], Bs0[BK][BN + PAD];
    __shared__ __align__(16) float As1[BK][BM + PAD], Bs1[BK][BN + PAD];
    __shared__ int rows[kRoll ? BM : 1];  // the A rows, (channel, shift)
    // slot 1 starts at zero: the priming product adds nothing
    float* a1 = &As1[0][0];
    float* b1 = &Bs1[0][0];
    for (int e = threadIdx.x; e < BK * (BM + PAD); e += kThreads)
      a1[e] = b1[e] = 0.f;
    if (kRoll && threadIdx.x == 0) rows_by_channel(rows, m0, tk, k);
    __syncthreads();
    const Loader L = make_loader<kRoll>(m0, n0, tk, k, half_t, h * w, rows);
    // an even count of stages: an odd count ends on one all-zero stage
    const int pairs = ((r_end - r_begin) * ((w + BK - 1) / BK) + 1) / 2;
    for (int s = 0; s < pairs; ++s) {
      bool q_ok = fetch<T, kRoll>(x1, x2, cur, cur.r < r_end, L, h, w, st);
      product(As1, Bs1, tr, tc, acc);  // the odd stage before (zero at first)
      if constexpr (kRoll) roll(L, q_ok, st.a);
      put(As0, Bs0, L, st);
      __syncthreads();
      advance(cur, h, w, img_stride);
      q_ok = fetch<T, kRoll>(x1, x2, cur, cur.r < r_end, L, h, w, st);
      product(As0, Bs0, tr, tc, acc);
      if constexpr (kRoll) roll(L, q_ok, st.a);
      put(As1, Bs1, L, st);
      __syncthreads();
      advance(cur, h, w, img_stride);
    }
    product(As1, Bs1, tr, tc, acc);  // drain
  }
  store_partial(part, tk, m0 + tr * 4, n0 + tc * 4, 1, acc);
}

// The split-K partials of pipeline kPipe, then K1's ordered reduce into
// (k, k, T, T).
template <int kPipe, typename T, bool kRoll = false>
int launch(const void* x1, const void* x2, float* part, float* out, int n,
           int k, int h, int w, int half_t, int splits, int rows_per_chunk,
           cudaStream_t stream) {
  const int t = 2 * half_t + 1;
  const int tk = k * t;
  dim3 grid((tk + BN - 1) / BN, (tk + BM - 1) / BM, splits);
  joint_pipe_kernel<kPipe, T, kRoll><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), part, k, h, w,
      half_t, n * h, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  joint_reduce_kernel<<<(tk * tk + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(part, out, splits, k, t, 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// X3, X4, X5: x1, x2 (n, k, h, w) bf16 contiguous; part (splits, kT, kT)
// f32 scratch; out (k, k, T, T) f32. The (n, y) rows are cut into `splits`
// chunks of `rows_per_chunk` rows, a multiple of rb.
int joint_exp_fwd_v3(const void* x1, const void* x2, float* part, float* out,
                     int n, int k, int h, int w, int half_t, int splits,
                     int rows_per_chunk, cudaStream_t stream) {
  return launch<kParity, __nv_bfloat16>(x1, x2, part, out, n, k, h, w, half_t,
                                        splits, rows_per_chunk, stream);
}

int joint_exp_fwd_v4(const void* x1, const void* x2, float* part, float* out,
                     int n, int k, int h, int w, int half_t, int splits,
                     int rows_per_chunk, cudaStream_t stream) {
  return launch<kSlots, __nv_bfloat16>(x1, x2, part, out, n, k, h, w, half_t,
                                       splits, rows_per_chunk, stream);
}

int joint_exp_fwd_v5(const void* x1, const void* x2, float* part, float* out,
                     int n, int k, int h, int w, int half_t, int splits,
                     int rows_per_chunk, cudaStream_t stream) {
  return launch<kPair, __nv_bfloat16>(x1, x2, part, out, n, k, h, w, half_t,
                                      splits, rows_per_chunk, stream);
}

// X6: as X5, on f32 x1, x2 rounded to bf16 in the kernel; roll_build != 0
// builds each column-shifted A row from the one before.
int joint_exp_fwd_v6(const void* x1, const void* x2, float* part, float* out,
                     int n, int k, int h, int w, int half_t, int roll_build,
                     int splits, int rows_per_chunk, cudaStream_t stream) {
  return roll_build
             ? launch<kPair, float, true>(x1, x2, part, out, n, k, h, w,
                                          half_t, splits, rows_per_chunk,
                                          stream)
             : launch<kPair, float>(x1, x2, part, out, n, k, h, w, half_t,
                                    splits, rows_per_chunk, stream);
}

}  // extern "C"
