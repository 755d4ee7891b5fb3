// Helpers shared by the Hopper (sm_90a) attention kernels,
// flash_attention.cu and flash_attention_bwd.cu: shared-memory addresses,
// mbarriers, setmaxnreg, TMA copies, warpgroup MMAs (wgmma) with their
// shared-memory descriptors and the swizzled head_dim panels they read,
// global acquire/release, and the host-side TMA descriptors.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// an arrival on `bar` where `on` is true, as a predicated instruction: no
// branch, so no divergence around the warpgroup MMAs in flight
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(on))
      : "memory");
}
template <int REGS>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
// the issuing thread's arrival, and the bytes the copies will deliver
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box (cols, 128 rows) at (col, row, head, batch) of `map` to `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

// Where `on`: box (cols, 64 rows) of `src` to (col, row, head, batch) of
// `map` (rows past the tensor's end are not written).  Predicated, like the
// other helpers for one issuing thread: no branch near the MMAs.
__device__ __forceinline__ void tma_store_if(const CUtensorMap* map,
                                             uint32_t src, int col, int row,
                                             int head, int batch, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(head), "r"(batch), "r"(src),
      "r"(static_cast<int>(on))
      : "memory");
}
// where `on`: close this thread's group of bulk stores
__device__ __forceinline__ void bulk_commit_if(bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"r"(static_cast<int>(on))
      : "memory");
}
// where `on`: until this thread's bulk stores have read their sources
// (READ) or are complete
template <bool READ>
__device__ __forceinline__ void bulk_wait_if(bool on) {
  if constexpr (READ)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
        "@p cp.async.bulk.wait_group.read 0;\n}\n" ::"r"(
            static_cast<int>(on))
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
        "@p cp.async.bulk.wait_group 0;\n}\n" ::"r"(static_cast<int>(on))
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N committed groups of this warpgroup still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins registers that an in-flight wgmma reads or writes: code after the
// wait cannot read them early, nor reuse them before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1: 128-byte, 2: 64-byte, 3:
// 32-byte).  Swizzled K-major operands ignore the leading offset; the stride
// offset is the distance between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

// The shared layout of a 128 x HD bf16 tile, as the TMA writes it: head_dim
// cut into panels, as many 64-column panels as fit (128-byte rows, 128-byte
// swizzle) and one panel of the 16 or 32 columns left (32- or 64-byte rows
// and swizzle).  A panel stores its 128 rows one after another, the 16-byte
// chunks of a row permuted by the swizzle, which the tensor core undoes
// from the address bits; every panel starts on a 1024-byte boundary.
template <int HD>
struct Panels {
  static constexpr int FULL = HD / 64;          // 64-column panels
  static constexpr int REST = HD % 64;          // columns of the last panel
  static constexpr int COUNT = FULL + (REST ? 1 : 0);
  __host__ __device__ static constexpr int cols(int p) {
    return p < FULL ? 64 : REST;
  }
  __host__ __device__ static constexpr int chunks(int p) {  // 16 B a row
    return cols(p) / 8;
  }
  __host__ __device__ static constexpr uint32_t mode(int p) {
    return chunks(p) == 8 ? 1u : chunks(p) == 4 ? 2u : 3u;
  }
  template <int ROWS>
  __host__ __device__ static constexpr int offset(int p) {  // panel start
    return p * ROWS * 128;
  }
};

// Warpgroup MMAs, bf16 in, f32 accumulators laid out per thread as N / 8
// chunks of 4, the m16n8 accumulator of its warp's 16 rows.
// wgmma_ss<N>: D (64 x N) = A B + D (scale_d 1) or A B (scale_d 0), A
// (64 x 16) and B (N x 16) from shared memory, both K-major.
// wgmma_rsN<C0>: chunks [C0, C0 + N / 8) of D += A B, A (64 x 16) from
// registers (the m16n8k16 A fragment of each warp's 16 rows), B (16 x N)
// from shared memory, MN-major (transposed).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma_ss_t<N>: D (64 x N) = A B + D (scale_d 1) or A B (scale_d 0), A
// (64 x 16) and B (16 x N) from shared memory, both MN-major (transposed).
template <int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 8][4], uint64_t da,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_t<64>(float (&d)[8][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_t<32>(float (&d)[4][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_t<16>(float (&d)[2][4],
                                              uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma_ss_mnN<C0>: chunks [C0, C0 + N / 8) of D += A B, A (64 x 16) from
// shared memory, K-major, B (16 x N) from shared memory, MN-major.
template <int C0, int NC>
__device__ __forceinline__ void wgmma_ss_mn16(float (&d)[NC][4], uint64_t da,
                                              uint64_t db) {
  static_assert(C0 + 2 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3])
      : "l"(da), "l"(db), "r"(1));
}

template <int C0, int NC>
__device__ __forceinline__ void wgmma_ss_mn32(float (&d)[NC][4], uint64_t da,
                                              uint64_t db) {
  static_assert(C0 + 4 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3]),
        "+f"(d[C0 + 2][0]), "+f"(d[C0 + 2][1]),
        "+f"(d[C0 + 2][2]), "+f"(d[C0 + 2][3]),
        "+f"(d[C0 + 3][0]), "+f"(d[C0 + 3][1]),
        "+f"(d[C0 + 3][2]), "+f"(d[C0 + 3][3])
      : "l"(da), "l"(db), "r"(1));
}

template <int C0, int NC>
__device__ __forceinline__ void wgmma_ss_mn64(float (&d)[NC][4], uint64_t da,
                                              uint64_t db) {
  static_assert(C0 + 8 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3]),
        "+f"(d[C0 + 2][0]), "+f"(d[C0 + 2][1]),
        "+f"(d[C0 + 2][2]), "+f"(d[C0 + 2][3]),
        "+f"(d[C0 + 3][0]), "+f"(d[C0 + 3][1]),
        "+f"(d[C0 + 3][2]), "+f"(d[C0 + 3][3]),
        "+f"(d[C0 + 4][0]), "+f"(d[C0 + 4][1]),
        "+f"(d[C0 + 4][2]), "+f"(d[C0 + 4][3]),
        "+f"(d[C0 + 5][0]), "+f"(d[C0 + 5][1]),
        "+f"(d[C0 + 5][2]), "+f"(d[C0 + 5][3]),
        "+f"(d[C0 + 6][0]), "+f"(d[C0 + 6][1]),
        "+f"(d[C0 + 6][2]), "+f"(d[C0 + 6][3]),
        "+f"(d[C0 + 7][0]), "+f"(d[C0 + 7][1]),
        "+f"(d[C0 + 7][2]), "+f"(d[C0 + 7][3])
      : "l"(da), "l"(db), "r"(1));
}

template <int C0, int NC>
__device__ __forceinline__ void wgmma_ss_mn128(float (&d)[NC][4], uint64_t da,
                                               uint64_t db) {
  static_assert(C0 + 16 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3]),
        "+f"(d[C0 + 2][0]), "+f"(d[C0 + 2][1]),
        "+f"(d[C0 + 2][2]), "+f"(d[C0 + 2][3]),
        "+f"(d[C0 + 3][0]), "+f"(d[C0 + 3][1]),
        "+f"(d[C0 + 3][2]), "+f"(d[C0 + 3][3]),
        "+f"(d[C0 + 4][0]), "+f"(d[C0 + 4][1]),
        "+f"(d[C0 + 4][2]), "+f"(d[C0 + 4][3]),
        "+f"(d[C0 + 5][0]), "+f"(d[C0 + 5][1]),
        "+f"(d[C0 + 5][2]), "+f"(d[C0 + 5][3]),
        "+f"(d[C0 + 6][0]), "+f"(d[C0 + 6][1]),
        "+f"(d[C0 + 6][2]), "+f"(d[C0 + 6][3]),
        "+f"(d[C0 + 7][0]), "+f"(d[C0 + 7][1]),
        "+f"(d[C0 + 7][2]), "+f"(d[C0 + 7][3]),
        "+f"(d[C0 + 8][0]), "+f"(d[C0 + 8][1]),
        "+f"(d[C0 + 8][2]), "+f"(d[C0 + 8][3]),
        "+f"(d[C0 + 9][0]), "+f"(d[C0 + 9][1]),
        "+f"(d[C0 + 9][2]), "+f"(d[C0 + 9][3]),
        "+f"(d[C0 + 10][0]), "+f"(d[C0 + 10][1]),
        "+f"(d[C0 + 10][2]), "+f"(d[C0 + 10][3]),
        "+f"(d[C0 + 11][0]), "+f"(d[C0 + 11][1]),
        "+f"(d[C0 + 11][2]), "+f"(d[C0 + 11][3]),
        "+f"(d[C0 + 12][0]), "+f"(d[C0 + 12][1]),
        "+f"(d[C0 + 12][2]), "+f"(d[C0 + 12][3]),
        "+f"(d[C0 + 13][0]), "+f"(d[C0 + 13][1]),
        "+f"(d[C0 + 13][2]), "+f"(d[C0 + 13][3]),
        "+f"(d[C0 + 14][0]), "+f"(d[C0 + 14][1]),
        "+f"(d[C0 + 14][2]), "+f"(d[C0 + 14][3]),
        "+f"(d[C0 + 15][0]), "+f"(d[C0 + 15][1]),
        "+f"(d[C0 + 15][2]), "+f"(d[C0 + 15][3])
      : "l"(da), "l"(db), "r"(1));
}

template <int C0, int NC>
__device__ __forceinline__ void wgmma_rs16(float (&d)[NC][4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  static_assert(C0 + 2 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int C0, int NC>
__device__ __forceinline__ void wgmma_rs32(float (&d)[NC][4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  static_assert(C0 + 4 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3]),
        "+f"(d[C0 + 2][0]), "+f"(d[C0 + 2][1]),
        "+f"(d[C0 + 2][2]), "+f"(d[C0 + 2][3]),
        "+f"(d[C0 + 3][0]), "+f"(d[C0 + 3][1]),
        "+f"(d[C0 + 3][2]), "+f"(d[C0 + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int C0, int NC>
__device__ __forceinline__ void wgmma_rs64(float (&d)[NC][4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  static_assert(C0 + 8 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3]),
        "+f"(d[C0 + 2][0]), "+f"(d[C0 + 2][1]),
        "+f"(d[C0 + 2][2]), "+f"(d[C0 + 2][3]),
        "+f"(d[C0 + 3][0]), "+f"(d[C0 + 3][1]),
        "+f"(d[C0 + 3][2]), "+f"(d[C0 + 3][3]),
        "+f"(d[C0 + 4][0]), "+f"(d[C0 + 4][1]),
        "+f"(d[C0 + 4][2]), "+f"(d[C0 + 4][3]),
        "+f"(d[C0 + 5][0]), "+f"(d[C0 + 5][1]),
        "+f"(d[C0 + 5][2]), "+f"(d[C0 + 5][3]),
        "+f"(d[C0 + 6][0]), "+f"(d[C0 + 6][1]),
        "+f"(d[C0 + 6][2]), "+f"(d[C0 + 6][3]),
        "+f"(d[C0 + 7][0]), "+f"(d[C0 + 7][1]),
        "+f"(d[C0 + 7][2]), "+f"(d[C0 + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int C0, int NC>
__device__ __forceinline__ void wgmma_rs128(float (&d)[NC][4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  static_assert(C0 + 16 <= NC, "accumulator chunks out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[C0 + 0][0]), "+f"(d[C0 + 0][1]),
        "+f"(d[C0 + 0][2]), "+f"(d[C0 + 0][3]),
        "+f"(d[C0 + 1][0]), "+f"(d[C0 + 1][1]),
        "+f"(d[C0 + 1][2]), "+f"(d[C0 + 1][3]),
        "+f"(d[C0 + 2][0]), "+f"(d[C0 + 2][1]),
        "+f"(d[C0 + 2][2]), "+f"(d[C0 + 2][3]),
        "+f"(d[C0 + 3][0]), "+f"(d[C0 + 3][1]),
        "+f"(d[C0 + 3][2]), "+f"(d[C0 + 3][3]),
        "+f"(d[C0 + 4][0]), "+f"(d[C0 + 4][1]),
        "+f"(d[C0 + 4][2]), "+f"(d[C0 + 4][3]),
        "+f"(d[C0 + 5][0]), "+f"(d[C0 + 5][1]),
        "+f"(d[C0 + 5][2]), "+f"(d[C0 + 5][3]),
        "+f"(d[C0 + 6][0]), "+f"(d[C0 + 6][1]),
        "+f"(d[C0 + 6][2]), "+f"(d[C0 + 6][3]),
        "+f"(d[C0 + 7][0]), "+f"(d[C0 + 7][1]),
        "+f"(d[C0 + 7][2]), "+f"(d[C0 + 7][3]),
        "+f"(d[C0 + 8][0]), "+f"(d[C0 + 8][1]),
        "+f"(d[C0 + 8][2]), "+f"(d[C0 + 8][3]),
        "+f"(d[C0 + 9][0]), "+f"(d[C0 + 9][1]),
        "+f"(d[C0 + 9][2]), "+f"(d[C0 + 9][3]),
        "+f"(d[C0 + 10][0]), "+f"(d[C0 + 10][1]),
        "+f"(d[C0 + 10][2]), "+f"(d[C0 + 10][3]),
        "+f"(d[C0 + 11][0]), "+f"(d[C0 + 11][1]),
        "+f"(d[C0 + 11][2]), "+f"(d[C0 + 11][3]),
        "+f"(d[C0 + 12][0]), "+f"(d[C0 + 12][1]),
        "+f"(d[C0 + 12][2]), "+f"(d[C0 + 12][3]),
        "+f"(d[C0 + 13][0]), "+f"(d[C0 + 13][1]),
        "+f"(d[C0 + 13][2]), "+f"(d[C0 + 13][3]),
        "+f"(d[C0 + 14][0]), "+f"(d[C0 + 14][1]),
        "+f"(d[C0 + 14][2]), "+f"(d[C0 + 14][3]),
        "+f"(d[C0 + 15][0]), "+f"(d[C0 + 15][1]),
        "+f"(d[C0 + 15][2]), "+f"(d[C0 + 15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// 2^x on the special-function unit (2^-1e30 and below flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Descriptor of the 16 head_dim columns of k16 step kk, rows [row0,
// row0 + M or N) of a ROWS-row tile at `tile`, K-major: one panel, 16
// columns (32 bytes) into its swizzled rows.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  using P = Panels<HD>;
  const int p = kk * 16 / 64 < P::FULL ? kk * 16 / 64 : P::FULL;
  const int w = P::chunks(p);
  return smem_desc(tile + P::template offset<ROWS>(p) + row0 * w * 16 +
                       (kk * 16 - 64 * p) * 2,
                   16, 8 * w * 16, P::mode(p));
}

// O += P V for rows [16 kk, 16 kk + 16) of the ROWS-row tile at `vt`
// (MN-major: head_dim contiguous), N = head_dim: hd 128 as one product over
// both 64-column panels (the leading offset steps from one to the other),
// hd 80 as the 64-column panel and the 16-column panel into their own
// columns.  The forward's V tile, and the backward's dO and q tiles.
template <int HD, int ROWS = 128>
__device__ __forceinline__ void pv_product(float (&acc)[HD / 8][4],
                                           const uint32_t (&pa)[4],
                                           uint32_t vt, int kk) {
  using P = Panels<HD>;
  const int keys = kk * 16;
  if constexpr (HD == 128) {
    wgmma_rs128<0>(acc, pa,
                   smem_desc(vt + keys * 128, P::template offset<ROWS>(1),
                             1024, 1));
  } else if constexpr (HD == 80) {
    wgmma_rs64<0>(acc, pa, smem_desc(vt + keys * 128, 16, 1024, 1));
    wgmma_rs16<8>(acc, pa,
                  smem_desc(vt + P::template offset<ROWS>(1) + keys * 32,
                            16, 256, 3));
  } else if constexpr (HD == 64) {
    wgmma_rs64<0>(acc, pa, smem_desc(vt + keys * 128, 16, 1024, 1));
  } else {
    static_assert(HD == 32, "head dims 32, 64, 80 and 128");
    wgmma_rs32<0>(acc, pa, smem_desc(vt + keys * 64, 16, 512, 2));
  }
}

// Copies one ROWS-row tile (every panel) at row `row` of (head, batch)
// into `dst`, landing on `bar`, whose expected bytes the caller has set.
// Issued by one thread.
template <int HD, int ROWS>
__device__ __forceinline__ void load_panels(uint32_t dst,
                                            const CUtensorMap* m, int row,
                                            int head, int batch,
                                            uint32_t bar) {
  using P = Panels<HD>;
#pragma unroll
  for (int p = 0; p < P::FULL; ++p)
    tma_load(dst + P::template offset<ROWS>(p), m, 64 * p, row, head, batch,
             bar);
  if constexpr (P::REST != 0)
    tma_load(dst + P::template offset<ROWS>(P::FULL), m + (P::FULL ? 1 : 0),
             64 * P::FULL, row, head, batch, bar);
}

// Loads one ROWS-row tile of q, k or v (every panel) at row `row` of
// (head, batch) into `dst`, landing on `bar`.  Issued by one thread.
template <int HD, int ROWS = 128>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          int row, int head, int batch,
                                          uint32_t bar) {
  mbar_expect(bar, ROWS * HD * 2);
  load_panels<HD, ROWS>(dst, m, row, head, batch, bar);
}

// ---- global-memory synchronisation and bulk copies --------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// `*p += v` with release semantics at GPU scope
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// orders this thread's generic-proxy accesses to global memory against its
// async-proxy ones (bulk and tensor copies)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// the same for shared memory: generic stores before a wgmma or a bulk copy
// reads them
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// `src` to shared `dst`, landing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// box (cols, rows) of shared `src` to (col, row, head, batch) of `map`:
// stored where `add` is false, added to what is there (element by element,
// in the map's type) where it is true.  Rows past the tensor's end are not
// written.
__device__ __forceinline__ void tma_store_or_add(const CUtensorMap* map,
                                                 uint32_t src, int col,
                                                 int row, int head,
                                                 int batch, bool add) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
        " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(m),
        "r"(col), "r"(row), "r"(head), "r"(batch), "r"(src)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(m),
        "r"(col), "r"(row), "r"(head), "r"(batch), "r"(src)
        : "memory");
}

// ---- host: TMA descriptors -------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found once through the runtime
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// a (B, S, heads, hd) tensor (bf16 unless `type` says otherwise, of
// `esize` bytes) with element strides (sb, ss, sh, 1), moved in boxes of
// `cols` head_dim columns by `rows` rows with `swizzle`
inline bool make_map(
    CUtensorMap* map, const void* base, int B, int S, int heads, int hd,
    long long sb, long long ss, long long sh, int cols, int rows,
    CUtensorMapSwizzle swizzle,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    int esize = 2) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * esize,
                                 static_cast<cuuint64_t>(sh) * esize,
                                 static_cast<cuuint64_t>(sb) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_fn()(map, type, 4,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of one tensor: its panels, as Panels<hd> lays them out, in
// boxes of `rows` rows
inline bool make_maps(CUtensorMap (&maps)[2], const void* base, int B, int S,
               int heads, int hd, long long sb, long long ss, long long sh,
               int rows) {
  if (hd == 32)
    return make_map(&maps[0], base, B, S, heads, hd, sb, ss, sh, 32, rows,
                    CU_TENSOR_MAP_SWIZZLE_64B);
  if (!make_map(&maps[0], base, B, S, heads, hd, sb, ss, sh, 64, rows,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  return hd != 80 || make_map(&maps[1], base, B, S, heads, hd, sb, ss, sh,
                              16, rows, CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace hopper
