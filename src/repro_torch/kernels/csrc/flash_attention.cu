// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces: src/repro/kernels/flash_attention.py :: _fa_kernel (the Pallas
// TPU kernel behind flash_attention_fwd <- ops._flash <- ops.attention).
// Computes the same function: softmax(q k^T * scale) v with an f32 online
// softmax over key tiles, causal masking with q pos >= k pos (both counted
// from 0) and NEG_INF = -1e30, and l clamped at 1e-30.  Unlike the TPU
// kernel it also writes the log-sum-exp m + log(l), which the reference
// recomputes with a second pass (ops.py:128-130) and the backward needs.
//
// What bounds it on an H100: at the serving prefill shape (B 4, S 1024,
// H 32, KV 8, hd 128, causal) the work is ~34 GFLOP against ~84 MB of
// q/k/v/o/lse traffic, ~400 FLOP per byte, above the card's ~295 FLOP/byte
// bf16 ridge: tensor-core operations bound it, and only wgmma reaches the
// card's full tensor-core rate.
//
// What the design does about that (the FlashAttention-3 structure):
// - Work items of 128 query rows of one (batch, head), heaviest causal
//   items first, go round-robin to a persistent grid of one block per SM.
//   A block is two consumer warpgroups of 64 query rows each, so each K/V
//   tile serves 128 rows, and one producer warpgroup, which hands most of
//   its registers to the consumers (setmaxnreg).
// - Both products are warpgroup MMAs (wgmma.mma_async, bf16, f32 sums):
//   S = Q K^T as m64n128k16 with Q and K read from shared memory through
//   descriptors (K-major), and O += P V with P from registers -- the S
//   accumulator re-packed to bf16 in place, since each warp's accumulator
//   layout is the A-fragment layout -- and V from shared memory, MN-major
//   (transposed).  No head dim is padded in the math.
// - One producer thread moves every tile by TMA.  Each copy lands on a
//   "full" mbarrier, and rows past the end of q, k or v are zero-filled by
//   the hardware.  Q is double-buffered, K tiles of 128 keys ring through
//   two stages and V tiles through three; the consumer warps release a
//   stage on an "empty" mbarrier, and the producer refills it at once,
//   running ahead into the next work item.
// - S_j = Q K_j^T is issued together with O += P_{j-1} V_{j-1}, so the
//   softmax of tile j runs while the tensor cores finish the product of
//   tile j - 1, and the two warpgroups take turns to issue (named
//   barriers), so one's softmax also overlaps the other's products.
// - o leaves through shared memory (the item's Q tile) and a TMA store, so
//   its write is asynchronous and whole lines; lse is written directly.
// - Shared tiles use the canonical swizzled wgmma layouts, which the TMA
//   writes directly: head_dim in 64-column panels of 128-byte rows with
//   the 128-byte swizzle, and a last panel of 16 or 32 columns (hd 80,
//   hd 32) with the 32- or 64-byte swizzle.  The 128-byte atom alone fits
//   neither hd 80 nor hd 32; panels of both kinds tile all four head dims.
// - The softmax runs in the log2 domain: one FFMA by scale * log2(e), then
//   ex2.approx; m is kept in log2 units and lse written as m ln 2 + log(l).
//   The causal and ragged-key masks run only on a tile that crosses the
//   warpgroup's diagonal or the end of the keys, and the first
//   warpgroup's P V skips the half of its diagonal tile past all its rows.
// - GQA indexes the KV head as h / (H / KV) instead of broadcasting it.
// Registers (the S, O and P fragments of 64 rows: 232 a consumer thread)
// admit one block per SM; it takes 224 KB of shared memory at hd 128.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 128;    // query rows per work item, 64 per warpgroup
constexpr int BLOCK_N = 128;    // keys per K/V tile
constexpr int Q_STAGES = 2;     // Q tiles: the next item's is prefetched
constexpr int K_STAGES = 2;     // K tiles in the ring
constexpr int V_STAGES = 3;     // V tiles: P V of tile j - 1 runs beside
                                // S of tile j while tile j + 1 loads
constexpr int CONSUMERS = 256;  // two warpgroups of 64 query rows
constexpr int NUM_THREADS = CONSUMERS + 128;  // and a producer warpgroup
// registers a thread after the producer hands its share to the consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int N_BARS = 2 * (Q_STAGES + K_STAGES + V_STAGES);  // full, empty
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int tile_bytes(int hd) { return 128 * hd * 2; }
__host__ __device__ constexpr int smem_bytes(int hd) {
  return (Q_STAGES + K_STAGES + V_STAGES) * tile_bytes(hd) + 8 * N_BARS;
}

// TMA descriptors of q, k, v (boxes of 128 rows) and o (64 rows, one
// warpgroup's): per tensor the panel of head_dim columns [0, 64) (or
// [0, 32) at hd 32), and at hd 80 the panel [64, 80)
struct alignas(64) Maps {
  CUtensorMap q[2], k[2], v[2], o[2];
};

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
// named barriers 1 and 2 (0 is __syncthreads) over the 256 consumer
// threads: warpgroup w waits on barrier 1 + w before it issues its
// products, and then lets the other warpgroup issue
__device__ __forceinline__ void wg_turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wg_turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
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

// One step of the online softmax over a tile of NT 8-column accumulator
// chunks (rows e >> 1: 0 -> g, 1 -> g + 8 of the warp's 16).  s holds raw
// q.k products on entry and p = exp2(s c - m) on exit; m_i is in log2
// units; alpha returns the factor for the running sums.  MASK applies the
// causal and ragged-key masks (and the scale before the max, for c <= 0).
template <int NT, bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float m_i[2], float l_i[2],
                                               float alpha[2], float c,
                                               int k0, int t,
                                               const int qrow[2], int Sk,
                                               int causal) {
  float mx[2] = {NEG_INF, NEG_INF};
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < Sk && (!causal || qrow[e >> 1] >= col);
        s[j][e] = ok ? s[j][e] * c : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = mx[r];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float m_new = fmaxf(m_i[r], MASK ? v : v * c);
    alpha[r] = exp2_approx(m_i[r] - m_new);
    m_i[r] = m_new;
    neg_m[r] = -m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(MASK ? s[j][e] + neg_m[e >> 1]
                                       : fmaf(s[j][e], c, neg_m[e >> 1]));
      s[j][e] = p;
      rs[e >> 1] += p;
    }
  l_i[0] = alpha[0] * l_i[0] + rs[0];
  l_i[1] = alpha[1] * l_i[1] + rs[1];
}

// Descriptor of the 16 head_dim columns of k16 step kk, rows [row0,
// row0 + 64 or + BLOCK_N) of a ROWS-row tile at `tile`, K-major: one panel,
// 16 columns (32 bytes) into its swizzled rows.
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

// O += P V for keys [16 kk, 16 kk + 16) of the V tile at `vt` (MN-major:
// head_dim contiguous), N = head_dim: hd 128 as one product over both
// 64-column panels (the leading offset steps from one to the other), hd 80
// as the 64-column panel and the 16-column panel into their own columns
template <int HD>
__device__ __forceinline__ void pv_product(float (&acc)[HD / 8][4],
                                           const uint32_t (&pa)[4],
                                           uint32_t vt, int kk) {
  using P = Panels<HD>;
  const int keys = kk * 16;
  if constexpr (HD == 128) {
    wgmma_rs128<0>(acc, pa,
                   smem_desc(vt + keys * 128, P::template offset<BLOCK_N>(1),
                             1024, 1));
  } else if constexpr (HD == 80) {
    wgmma_rs64<0>(acc, pa, smem_desc(vt + keys * 128, 16, 1024, 1));
    wgmma_rs16<8>(acc, pa,
                  smem_desc(vt + P::template offset<BLOCK_N>(1) + keys * 32,
                            16, 256, 3));
  } else if constexpr (HD == 64) {
    wgmma_rs64<0>(acc, pa, smem_desc(vt + keys * 128, 16, 1024, 1));
  } else {
    static_assert(HD == 32, "head dims 32, 64, 80 and 128");
    wgmma_rs32<0>(acc, pa, smem_desc(vt + keys * 64, 16, 512, 2));
  }
}

// Loads one 128-row tile of q, k or v (every panel) at row `row` of
// (head, batch) into `dst`, landing on `bar`.  Issued by one thread.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          int row, int head, int batch,
                                          uint32_t bar) {
  using P = Panels<HD>;
  mbar_expect(bar, tile_bytes(HD));
#pragma unroll
  for (int p = 0; p < P::FULL; ++p)
    tma_load(dst + P::template offset<128>(p), m, 64 * p, row, head, batch,
             bar);
  if constexpr (P::REST != 0)
    tma_load(dst + P::template offset<128>(P::FULL), m + (P::FULL ? 1 : 0),
             64 * P::FULL, row, head, batch, bar);
}

// work item -> its first query row, batch and head, heaviest causal first
__device__ __forceinline__ void decode_item(int item, int BH, int nq, int H,
                                            int& q0, int& b, int& h) {
  q0 = (nq - 1 - item / BH) * BLOCK_M;
  b = (item % BH) / H;
  h = (item % BH) % H;
}

template <int HD>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int B, int H, int KV, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int KSTEPS = HD / 16;       // k16 steps of Q K^T over head_dim
  constexpr int NT_O = HD / 8;          // 8-column chunks of O
  constexpr int NT_S = BLOCK_N / 8;     // 8-column chunks of S
  constexpr int PSTEPS = BLOCK_N / 16;  // k16 steps of P V over the key tile
  constexpr int TILE = tile_bytes(HD);

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  const uint32_t sK = sQ + Q_STAGES * TILE;
  const uint32_t sV = sK + K_STAGES * TILE;
  // mbarriers, 8 bytes each: for every stage a "full" one (the producer's
  // copies landed) and an "empty" one (all 8 consumer warps are done)
  const uint32_t qfull = sV + V_STAGES * TILE;
  const uint32_t kfull = qfull + 8 * Q_STAGES, vfull = kfull + 8 * K_STAGES;
  const uint32_t qempty = vfull + 8 * V_STAGES;
  const uint32_t kempty = qempty + 8 * Q_STAGES;
  const uint32_t vempty = kempty + 8 * K_STAGES;

  const int tid = threadIdx.x;
  const int warp_id = tid >> 5, lane = tid & 31;
  const int BH = B * H, nq = (Sq + BLOCK_M - 1) / BLOCK_M;
  const int n_items = nq * BH;
  const int group = H / KV;
  auto n_tiles_of = [&](int q0) {
    const int kv_end = causal ? min(Sk, q0 + BLOCK_M) : Sk;
    return (kv_end + BLOCK_N - 1) / BLOCK_N;
  };

  if (static_cast<int>(blockIdx.x) >= n_items) return;
  if (tid == 0) {
    for (int i = 0; i < N_BARS / 2; ++i) {
      mbar_init(qfull + 8 * i, 1);             // the producer's arrival
      mbar_init(qempty + 8 * i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer warpgroup gives up its registers; one thread walks this
  // block's work items in the consumers' order and loads every tile as
  // soon as its stage is empty (the first use of a stage waits on the
  // phase before the first, which counts as complete).
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform
  if (role == CONSUMERS / 128) {
    regs_down<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int g = 0;
      for (int item = blockIdx.x, it = 0; item < n_items;
           item += gridDim.x, ++it) {
        int q0, b, h;
        decode_item(item, BH, nq, H, q0, b, h);
        const int qs = it % Q_STAGES;
        mbar_wait(qempty + 8 * qs, ((it / Q_STAGES) & 1) ^ 1);
        load_tile<HD>(sQ + qs * TILE, maps.q, q0, h, b, qfull + 8 * qs);
        const int n_tiles = n_tiles_of(q0);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int ks = g % K_STAGES, vs = g % V_STAGES;
          mbar_wait(kempty + 8 * ks, ((g / K_STAGES) & 1) ^ 1);
          load_tile<HD>(sK + ks * TILE, maps.k, j * BLOCK_N, h / group, b,
                        kfull + 8 * ks);
          mbar_wait(vempty + 8 * vs, ((g / V_STAGES) & 1) ^ 1);
          load_tile<HD>(sV + vs * TILE, maps.v, j * BLOCK_N, h / group, b,
                        vfull + 8 * vs);
        }
      }
    }
    return;
  }

  // The consumers: two warpgroups of 64 query rows.  Each warp's lane 0
  // releases a stage once the warp's products that read it have finished.
  regs_up<CONSUMER_REGS>();
  const int wg = role;                          // warpgroup
  const int warp = __shfl_sync(0xffffffffu, warp_id & 3, 0);  // in the wg
  const int t = lane & 3;                       // column pair
  const float c = scale * LOG2E;                // scores in log2 units
  auto release = [&](uint32_t bar, bool on) {
    mbar_arrive_if(bar, on && lane == 0);
  };

  if (wg == 1) wg_turn_pass(wg);  // the first warpgroup issues first
  int g = 0;  // this block's K/V tiles so far: stage g % STAGES, phase
  int prev_qs = 0;
  for (int item = blockIdx.x, it = 0; item < n_items;
       item += gridDim.x, ++it) {
    int q0, b, h;
    decode_item(item, BH, nq, H, q0, b, h);
    const int n_tiles = n_tiles_of(q0);
    const int qs = it % Q_STAGES;
    const uint32_t qt = sQ + qs * TILE;
    const int qg = q0 + wg * 64;        // the warpgroup's first query row
    const int qrow[2] = {qg + warp * 16 + (lane >> 2),
                         qg + warp * 16 + (lane >> 2) + 8};
    float acc[NT_O][4];
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF};
    float l_i[2] = {0.f, 0.f};  // per-thread partial sums over its columns
    float s[NT_S][4];           // S of the current tile, then its P in f32
    uint32_t pa[PSTEPS][4];     // P of the previous tile, bf16 A fragments
    mbar_wait(qfull + 8 * qs, (it / Q_STAGES) & 1);
    // the issuing warp releases the previous item's Q slot once the store
    // of its o has read it
    bulk_wait_if<true>(it > 0 && warp == 0 && lane == 0);
    __syncwarp();
    release(qempty + 8 * prev_qs, it > 0 && warp == 0);

    // tile j: S_j = Q K_j^T is issued together with O += P_{j-1} V_{j-1},
    // so the softmax of S_j runs while the tensor cores finish
    // P_{j-1} V_{j-1}; tile 0 has no predecessor and the last P V follows
    // the loop
    for (int j = 0; j < n_tiles; ++j, ++g) {
      const int k0 = j * BLOCK_N;
      const int ks = g % K_STAGES;
      const int vp = (g + V_STAGES - 1) % V_STAGES;  // V of tile g - 1
      mbar_wait(kfull + 8 * ks, (g / K_STAGES) & 1);
      if (j > 0) mbar_wait(vfull + 8 * vp, ((g - 1) / V_STAGES) & 1);
      const uint32_t kt = sK + ks * TILE, vt = sV + vp * TILE;
      wg_turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss<BLOCK_N>(s, kmajor_desc<HD, BLOCK_M>(qt, wg * 64, kk),
                          kmajor_desc<HD, BLOCK_N>(kt, 0, kk), kk > 0);
      wgmma_commit();
      if (j > 0) {
#pragma unroll
        for (int kk = 0; kk < PSTEPS; ++kk)
          pv_product<HD>(acc, pa[kk], vt, kk);
      }
      wgmma_commit();
      wg_turn_pass(wg);
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      release(kempty + 8 * ks, true);

      float alpha[2];
      if (c <= 0.f || k0 + BLOCK_N > Sk ||
          (causal && k0 + BLOCK_N - 1 > qg))
        online_softmax<NT_S, true>(s, m_i, l_i, alpha, c, k0, t, qrow, Sk,
                                   causal);
      else
        online_softmax<NT_S, false>(s, m_i, l_i, alpha, c, k0, t, qrow, Sk,
                                    causal);

      wgmma_wait<0>();  // P_{j-1} V_{j-1} is done: O, P and V_{j-1} free
      fence_regs(acc);
      fence_regs(pa);
      release(vempty + 8 * vp, j > 0);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < PSTEPS; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    }
    // O += P V of the last tile.  Causal: where its keys from 64 on lie
    // past every row of this warpgroup (the first warpgroup's diagonal
    // tile), their P is 0 and only the first 64 keys are multiplied.
    if (n_tiles > 0) {
      const int vp = (g + V_STAGES - 1) % V_STAGES;
      mbar_wait(vfull + 8 * vp, ((g - 1) / V_STAGES) & 1);
      const uint32_t vt = sV + vp * TILE;
      wgmma_fence();
      if (causal && (n_tiles - 1) * BLOCK_N >= qg) {
#pragma unroll
        for (int kk = 0; kk < PSTEPS / 2; ++kk)
          pv_product<HD>(acc, pa[kk], vt, kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < PSTEPS; ++kk)
          pv_product<HD>(acc, pa[kk], vt, kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(vempty + 8 * vp, true);
    }

    // epilogue: full row sums, clamp, normalise; o goes through this
    // item's Q tile (each warpgroup rewrites its own 64 rows, which only it
    // read) and one TMA store per panel, lse straight to memory
    float l_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[r] = fmaxf(l, 1e-30f);
    }
    using P = Panels<HD>;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / l_row[r];
      const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * r;  // in tile
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const int p = n / 8 < P::FULL ? n / 8 : P::FULL;
        const int w = P::chunks(p), cc = n - 8 * p;
        const uint32_t at = qt + P::template offset<BLOCK_M>(p) +
                            row * w * 16 +
                            ((cc ^ (((row * w) >> 3) & (w - 1))) << 4) + 4 * t;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(pack_bf16(acc[n][2 * r] * inv,
                                   acc[n][2 * r + 1] * inv))
                     : "memory");
      }
      // m stays NEG_INF (not NEG_INF ln 2) for a row that saw no key
      if (t == 0 && qrow[r] < Sq)
        lse[(static_cast<long long>(b) * H + h) * Sq + qrow[r]] =
            (m_i[r] == NEG_INF ? NEG_INF : m_i[r] * LN2) + logf(l_row[r]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
    const bool issuer = warp == 0 && lane == 0;
#pragma unroll
    for (int p = 0; p < P::COUNT; ++p)
      tma_store_if(maps.o + (p < P::FULL ? 0 : (P::FULL ? 1 : 0)),
                   qt + P::template offset<BLOCK_M>(p) +
                       wg * 64 * P::chunks(p) * 16,
                   64 * p, qg, h, b, issuer);
    bulk_commit_if(issuer);
    // the Q slot is free once the store has read it: the issuing warp
    // releases it after that, at the next item's start; the others now
    release(qempty + 8 * qs, warp != 0);
    prev_qs = qs;
  }
  bulk_wait_if<false>(warp == 0 && lane == 0);
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
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

// a (B, S, heads, hd) bf16 tensor with element strides (sb, ss, sh, 1),
// moved in boxes of `cols` head_dim columns by `rows` rows with `swizzle`
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
              int hd, long long sb, long long ss, long long sh, int cols,
              int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the maps of one tensor: its panels, as Panels<hd> lays them out, in
// boxes of `rows` rows
bool make_maps(CUtensorMap (&maps)[2], const void* base, int B, int S,
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

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int KV, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes(HD);
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  if (encode_fn() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Maps maps;
  const long long o_ss = static_cast<long long>(H) * HD;  // o: contiguous
  if (!make_maps(maps.q, q, B, Sq, H, HD, q_sb, q_ss, q_sh, BLOCK_M) ||
      !make_maps(maps.k, k, B, Sk, KV, HD, k_sb, k_ss, k_sh, BLOCK_N) ||
      !make_maps(maps.v, v, B, Sk, KV, HD, v_sb, v_ss, v_sh, BLOCK_N) ||
      !make_maps(maps.o, o, B, Sq, H, HD, o_ss * Sq, o_ss, HD, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int items = ((Sq + BLOCK_M - 1) / BLOCK_M) * B * H;
  const int grid = items < sms ? items : sms;
  flash_fwd_kernel<HD><<<grid, NUM_THREADS, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, H,
      KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd): bf16, strides in elements, the
// head_dim stride 1.  o (B, Sq, H, hd) bf16 and lse (B, H, Sq) f32 are
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int mist_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb, q_ss, q_sh,
                        k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb, q_ss, q_sh,
                        k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, s);
    case 80:
      return launch<80>(q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb, q_ss, q_sh,
                        k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb, q_ss, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
