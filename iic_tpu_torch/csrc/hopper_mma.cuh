// Inline-PTX wrappers for Hopper's (sm_90a) warpgroup tensor-core product,
// shared by the kernels that run their products on the tensor cores
// (joint_exp.cu X1; dgrad_common.cuh, the implicit GEMM of X8 and K2;
// joint_exp_bwd.cu X9; joint_fwd_common.cuh, the stack product of K1 and
// X7; joint_exp_tma.cu, that product fed by TMA for X3, X5 and X6).
//
// A warpgroup is four consecutive warps (128 threads). `wgmma.mma_async`
// multiplies a 64-row A tile (from shared memory, or from registers) by an
// N-column B tile (always from shared memory) over a depth of 16 bf16 and
// adds the product into f32 accumulators held in registers, asynchronously:
// the issuing threads go on, and `commit_group` / `wait_group<N>` bound how
// many committed groups are still in flight.
//
// Shared-memory operands are named by a 64-bit matrix descriptor. Every
// operand here uses the layout without swizzle: the tile is cut into "core
// matrices" of 8 rows x 16 bytes (8 bf16), each stored as 128 contiguous
// bytes, row r at byte 16 r. For a K-major operand (rows along M or N, the
// 8 bf16 of a core-matrix row consecutive along K) the descriptor gives
//   LBO: the byte stride between core matrices adjacent along K,
//   SBO: the byte stride between core matrices adjacent along M or N;
// for an MN-major operand (the 8 bf16 of a core-matrix row consecutive
// along M or N, its 8 rows along K), LBO is the stride along K and SBO the
// stride along M or N too. One k16 step reads two core matrices along K.
//
// Accumulator layout of an m64nN tile, per thread t of the warpgroup
// (warp w = t / 32, lane l = t % 32): for each n8 chunk c of the N columns,
//   d[4c + 0], d[4c + 1]: row 16 w + l / 4,     columns 8 c + 2 (l % 4) + {0, 1}
//   d[4c + 2], d[4c + 3]: row 16 w + l / 4 + 8, the same columns.
// A register fragment (the RS form) has the same rows: a[0] holds row
// 16 w + l / 4, k 2 (l % 4) + {0, 1}; a[1] row + 8; a[2] k + 8; a[3] both.
// `ldmatrix_x4` with lane l pointing at row l % 16, k 8 (l / 16) of the
// warp's 16 rows fills exactly that fragment. From memory that holds the
// fragment's columns as rows (8 bf16 of 8 consecutive rows each, the k
// index outer), `ldmatrix_x4_trans` fills it with lane l pointing at
// column (l & 7) + 8 (l >> 4), rows 8 ((l >> 3) & 1) .. + 7.
//
// Ordering rules the callers keep: `wgmma_fence()` before the first
// product and whenever the accumulator or A registers were written by other
// instructions; `fence_proxy_async()` by the threads that wrote an operand
// into shared memory, before the barrier after which a product reads it;
// no register of a product in flight is written until a `wgmma_wait` has
// retired it.
//
// The Tensor Memory Accelerator (TMA) and its barriers (X3, X5, X6,
// joint_exp_tma.cu): one thread asks for a box of a tensor described by a
// `CUtensorMap` (a `const __grid_constant__` kernel parameter) to be copied
// into shared memory; the copy completes on an `mbarrier` in shared memory,
// which the thread first arms with the box's bytes (`arrive.expect_tx`).
// An mbarrier counts its phases: a wait names the parity of the phase it
// waits for, so a ring of two buffers waits on (use >> 1) & 1. Boxes that
// reach outside the tensor (negative coordinates, or past its end) are
// filled with zeros by the hardware.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

// Shared-memory matrix descriptor, no swizzle: start address >> 4 (bits
// 0-13), LBO >> 4 (bits 16-29), SBO >> 4 (bits 32-45), base offset 0,
// layout type 0 (bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// A descriptor moved by `bytes` (a multiple of 16) along its operand.
__device__ __forceinline__ uint64_t desc_advance(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator register in place: the compiler may not move a read
// of it above an earlier wgmma_wait, which it cannot see writes the
// register (the asm's "+f" makes the read depend on this point).
__device__ __forceinline__ void wgmma_fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// The same for a 32-bit register: whatever is computed from it (an A
// fragment built in registers) is computed after this point.
__device__ __forceinline__ void wgmma_fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Makes this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses (16-byte aligned) of matrix i, which lands in a[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// ldmatrix_x4 with the transpose: each 8x8 matrix lands transposed, so
// lane t holds the elements (2 (t % 4) + {0, 1}, t / 4) of the stored rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// Two 8x8 matrices with the transpose (lanes 0-15 give the row addresses,
// 8i..8i+7 those of matrix i, which lands in a[i]).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&a)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(a[0]), "=r"(a[1])
      : "r"(addr)
      : "memory");
}

// 16 bytes from global to shared memory; src_bytes = 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// An mbarrier in shared memory that completes a phase after `count`
// arrivals (and, once armed, the transaction bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the other threads and to the
// async proxy (TMA), before the barrier that publishes them.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also arms the barrier's phase with `bytes` of
// transactions (the TMA copies that complete on it).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of the 4-D tensor `map` at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory at `dst` (16-byte aligned); the copy
// completes its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// d (m64n160, f32) += A (64 x 16, shared, K-major) * B (16 x 160, shared;
// K-major, or MN-major when kTransB).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n160k16_ss(float (&d)[80],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, %83;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

// d (m64n16, f32) = A (64 x 16, registers) * B (16 x 16, shared, K-major)
// + d, or + 0 at scale_d = 0.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db,
                                                   int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
      "p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (m64n8, f32) = A (64 x 16, registers) * B (16 x 8, shared, K-major)
// + d, or + 0 at scale_d = 0.
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (m64n168, f32) = A (64 x 16, registers) * B (16 x 168, shared,
// MN-major: the transpose bit set) + d, or + 0 at scale_d = 0.
__device__ __forceinline__ void wgmma_m64n168k16_rs_tn(
    float (&d)[84], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %89, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83}, "
      "{%84, %85, %86, %87}, %88, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The RS product for an N of 8 or 16.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d = 1) {
  static_assert(N == 8 || N == 16, "N must be 8 or 16");
  if constexpr (N == 16)
    wgmma_m64n16k16_rs(d, a, db, scale_d);
  else
    wgmma_m64n8k16_rs(d, a, db, scale_d);
}

}  // namespace
