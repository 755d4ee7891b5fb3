// Mamba2 SSD chunk scan, backward, for Hopper (sm_90a), written by hand.
//
// Replaces: no TPU kernel.  The reference differentiates only its jnp
// ssd_chunked (src/repro/models/ssm.py:57-116); its Pallas _ssd_kernel
// (src/repro/kernels/ssd_scan.py:20) has no VJP.  The port trains through
// the forward kernel of csrc/ssd_scan.cu, and this is that forward's
// gradient.  Its plain version is ssd_bwd_plain (kernels/ssd_scan.py).
//
// Per (batch, head) and chunk of Q steps, with cum the in-chunk cumsum of
// dt a, L_ts = exp(cum_t - cum_s) for s <= t (masked BEFORE the exp: above
// the diagonal cum_t - cum_s > 0 grows with |dt a| and would overflow),
// G = C B^T, dS = dy x^T, H_in (N x P) the state entering the chunk, saved
// by the forward, and dH the gradient of the state leaving it:
//   dx_s  = sum_t G L dt_s dy_t + e_s dt_s B_s dH,   e_s = exp(cum_Q - cum_s)
//   dB_s  = sum_t dS L dt_s C_t + e_s dt_s dH x_s
//   dC_t  = sum_s dS L dt_s B_s + exp(cum_t) H_in dy_t
//   ddt_s = sum_t dS G L + e_s B_s.(dH x_s) + a dda_s
//   dH_in = exp(cum_Q) dH + sum_t exp(cum_t) C_t dy_t^T
// where dda is the reverse cumsum over the chunk of the gradient of cum
// (dcum_t = sum_{s<t} M_ts - sum_{s>t} M_st + dy_t.y_inter_t - u_t, M = dS
// x the score, u_s = e_s dt_s B_s.(dH x_s), and at the chunk's last row
// also sum_s u_s + exp(cum_Q) <H_in, dH>; M_tt would add to both sums and
// cancel, so it is left out of both, and a large M_tt leaves no rounding
// in dcum), and da sums dt dda over every (batch, position).
//
// What bounds it on an H100: at zamba2's training shape (B 1, S 4096,
// H 80, P = N = 64, G 1, chunk 256, bf16) the function reads x, dy, B, C,
// dt and the forward's f32 states and writes dx, dB, dC and ddt: 150.2 MB,
// 44.8 us at 3.35 TB/s.  Its products (the causal half of G, dS, dx, dB and
// dC over each chunk, and four Q x N x P state products) are 37.0 GFLOP:
// 37.4 us at the bf16 tensor-core rate, so bytes bound the function -- if
// the products run on the tensor cores.  The port's first backward ran
// them on the CUDA cores in f32, G and dS formed twice, one block of 8
// warps an SM, and sent every head's f32 dB and dC through device memory
// to a second kernel (335.5 MB of traffic, 2.2x the function's bytes):
// 4.02 ms.  That kernel stays as the f32 route (ssd_bwd_f32_kernel, below):
// f32 inputs are not on the model's path.
//
// The bf16 route (ssd_bwd_tc_kernel), and what it does about each of those:
// - Tensor cores: every product is mma.sync m16n8k16 on bf16 operands from
//   ldmatrix (or from the accumulators of the product before), summed in
//   f32.  mma.sync, not wgmma: bytes bound the function, and one warp owns
//   one 16-row block of the chunk in both passes below, which a 64-row
//   warpgroup tile could not give without reductions across warps.
//   Rounding, rehearsed on the CPU (tests/test_torch_kernels.py,
//   _ssd_bwd_kernel_rounding):
//     G = C B^T, dS = dy x^T   exact products of bf16 operands.
//     scores G L dt  (dx)      rounded once to bf16: dx is a bf16 output
//                              held to 1e-2 of its largest value, and the
//                              rehearsal keeps it inside (a hi + lo split
//                              would cost 8 more MMAs a tile pair).
//     W = dS L dt  (dC)        split into bf16 hi + lo: rounded once it
//                              takes dC to ~0.7 of its tolerance at 80 heads.
//     W  (dB)                  rounded once: dB stays within ~0.6 of its
//                              tolerance, and both passes then issue 32
//                              MMAs a tile pair.
//     dH  (dH x_s^T)           split: it feeds u and so ddt (2e-4); for
//                              B_s dH (dx only) dH is rounded once.
//     H_in  (dy H_in^T)        split: it feeds y_inter, so ddt.
//     C exp(cum)  (dH_in)      split: dH_in is carried in f32 to every
//                              earlier chunk.
//   The elementwise work runs in f32 on the accumulator fragments in one
//   order: L = 2^((cum_t - cum_s) log2(e)), G L, the score, W, ddt's direct
//   part, M and its row or column sums; then dcum, dda, ddt and da in one
//   warp.  The causal mask is applied BEFORE the exp, and L is never
//   exp(cum_t) exp(-cum_s): cum falls to about -180 over a chunk of 256,
//   and exp(180) overflows f32.  The difference is taken before the
//   scaling, as the plain version takes it, and cum itself in the plain
//   version's order: at large |dt a| cum reaches -1e5, and a rounding of
//   each cum alone moves L by percents.
// - G and dS are formed twice, both times on the tensor cores (13.4 GFLOP
//   a formation at the training shape): dC_t sums over the keys s <= t and
//   dx_s, dB_s over the queries t >= s, so a pass over one of the two
//   leaves the other's outputs spread over every other warp.  With one
//   warp owning one 16-row block in both passes, every output row, every
//   row sum (M's over s, ddt's and M's over t) and every accumulator stays
//   in one warp's registers and needs no exchange: pass B walks a warp's
//   block as keys s (query blocks t >= s: dx_s, dB_s, ddt's direct part,
//   M's column sums), pass A as queries t (key blocks s <= t: dC_t, M's
//   row sums).  At chunk 256 warp w has 16 - w tile pairs in pass B and
//   w + 1 in pass A, 32 MMAs each: the 16 warps have the same work.
// - Warps in flight: one block of 16 warps an SM (128 registers a thread),
//   every warp issuing MMAs, in place of 8 warps on the CUDA cores.  The
//   chunk's x, dy, B and C stay in shared memory as bf16 (rows padded by 8
//   elements so ldmatrix reads are free of bank conflicts), loaded by
//   cp.async in three groups: dt and H_in, then C and dy (all the own part
//   of dH_in needs), then x and B.  The own part is split over pairs of
//   warps, each warp half of the chunk's rows.
// - dB and dC without the per-head round trip: the blocks of a thread-block
//   cluster are CL heads of one group at one (batch, chunk) (CL = 8, or the
//   largest power of 2 dividing H / G).  After both passes each block
//   stages its f32 dB and dC in its own shared memory; after a cluster
//   barrier block rank r sums rows [r Qp / CL, (r + 1) Qp / CL) of the CL
//   blocks' tiles through distributed shared memory in rank order and
//   writes one f32 part per cluster, (2, B, S, H / CL, N); the second
//   kernel sums a group's H / (G CL) parts in order and rounds once.  At
//   the training shape the parts cross device memory as 21.0 MB out and
//   21.0 MB in, 1/8 of the per-head 335.5 MB.  A cluster, not several
//   heads a block: a block holds one head's x and dy (73.7 KB) beside B
//   and C, and the heads' dB and dC sums would not fit beside them.
//   No float atomics: two calls give the same bits.
// - The chain: one ticket a cluster, in REVERSE chunk-major order (every
//   last-chunk cluster first), from an atomic counter; dH goes from chunk
//   to chunk backwards through an f32 scratch (nc - 1, B, H, N, P) and a
//   flag per (chunk, batch, head).  An item forms its own part of dH_in
//   (sum_t exp(cum_t) C_t dy_t^T) first, waits for dH of the chunk after
//   it (ld.acquire.gpu), publishes dH_in at once (st.release.gpu) and only
//   then runs its two passes, so the chain's critical path is one
//   elementwise pass over N x P per chunk.  An item waits only on a
//   cluster with a smaller ticket, resident or finished, so the chain
//   cannot deadlock; the wrapper zeroes the ticket and the flags for every
//   call.
// Shared memory at chunk 256, P = N = 64: x, dy, B and C (147,456 bytes,
// reused for the f32 dB / dC staging), dH and H_in as bf16 hi + lo
// (36,864), nine f32 vectors over the rows and the block's scratch:
// 193,616 bytes, one block an SM; 15 clusters of 8 fit an H100 at once
// (120 of its 132 SMs).  Chunks up to 256 rows (16 warps of 16 rows), P
// and N in 16, 32, 48, 64.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): 0.475
// ms cold at the training shape against the first kernel's 3.99 in the
// same call, 9.4% of the bound.  A block lives ~40 us (chip_smoke.py
// --ssd-bwd-phases): ~22 us in the two passes, ~18 us loading, chaining,
// forming the own part of dH_in and summing the cluster's dB and dC,
// which no other item on the SM hides.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_SMEM = 232448;  // 227 KB, a block's dynamic limit
constexpr int MAX_DIM = 64;       // the largest P and N
constexpr unsigned FULL = 0xffffffffu;

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const void* dy;         // (B, S, H, P) contiguous, x's dtype
  const float* states;    // the forward's (nc - 1, B, H, N, P) f32
  void* dx;               // (B, S, H, P) contiguous, x's dtype
  float* ddt;             // (B, S, H)
  float* da;              // (H,)
  void* db;               // (B, S, G, N) contiguous, b's dtype
  void* dc;
  float* parts;           // (2, B, S, H / CL, N): dB and dC per cluster
  float* da_parts;        // (B, H, nc)
  float* dstates;         // (nc - 1, B, H, N, P): the chain of dH
  int* sync;              // ticket counter, then (nc - 1) x B x H flags
  int B, S, H, G, P, N, Q, CL;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// the sum over a warp, lane 0's in one fixed order, given to every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return __shfl_sync(FULL, v, 0);
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores, one warp a 16-row block, clusters of heads
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 512;
constexpr int TC_WARPS = 16;
constexpr int ROW_BLOCK = 16;  // rows of one m16n8k16 tile; Q is padded to it
constexpr int MAX_ROWS = TC_WARPS * ROW_BLOCK;  // the longest chunk
constexpr int SMEM_PAD = 8;    // bf16 elements after every shared row
constexpr int STAGE_PAD = 4;   // f32 after every staged dB / dC row
constexpr int MAX_CLUSTER = 8;  // heads a cluster (portable cluster size)
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int padded_rows(int Q) {
  return (Q + ROW_BLOCK - 1) / ROW_BLOCK * ROW_BLOCK;
}

// bytes of the region that holds x, dy (Qp x P+8) and B, C (Qp x N+8) as
// bf16, and after both passes the f32 dB and dC staging (2 x Qp x N+4)
__host__ __device__ inline int tc_region_bytes(int Qp, int P, int N) {
  const int operands = 2 * Qp * (2 * (P + SMEM_PAD) + 2 * (N + SMEM_PAD));
  const int staging = 4 * 2 * Qp * (N + STAGE_PAD);
  return operands > staging ? operands : staging;
}

// bytes of shared memory (bwd_smem_bytes in the wrapper): the region, dH
// and H_in as bf16 hi and lo (4 x N x P+8), nine f32 vectors of Qp, the
// warps' sums, two scalars and the ticket
__host__ __device__ inline int tc_smem_bytes(int Q, int P, int N) {
  const int Qp = padded_rows(Q);
  return tc_region_bytes(Qp, P, N) + 2 * 4 * N * (P + SMEM_PAD) +
         4 * (9 * Qp + TC_WARPS + 4);
}

// the cluster: the most heads of one group up to MAX_CLUSTER, a power of 2
__host__ __device__ inline int tc_cluster(int H, int G) {
  int cl = MAX_CLUSTER;
  while ((H / G) % cl) cl /= 2;
  return cl;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ldmatrix on a shared-window address: x4 loads four 8 x 8 bf16 matrices,
// the rows of matrix i addressed by lanes 8i..8i+7
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (v0, v1) -> one bf16 pair (v0 in the low half)
__device__ __forceinline__ uint32_t pack2(float v0, float v1) {
  return bits(__floats2bfloat162_rn(v0, v1));
}

// (v0, v1) -> bf16 pairs hi and lo with hi + lo ~ v (v0 in the low half)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - f.x, v1 - f.y));
}

// the sum over the four lanes of a quad (the lanes that share an
// accumulator row), the same value in each
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Fragment layouts (m16n8k16, g = lane / 4, t4 = lane % 4): an A tile's
// registers hold (row g, cols 2t4, 2t4+1), (g+8, 2t4..), (g, 8+2t4..),
// (g+8, 8+2t4..); a B tile's (k 2t4.., col g), (k 8+2t4.., col g); an
// accumulator's (g, 2t4..), (g+8, 2t4..).  Two neighbouring n8
// accumulators are the A fragment of the next product over their columns.
// ldmatrix addressing: "rows" has lanes walk rows 0-7, 0-7, 8-15, 8-15 at
// columns 0, 8, 0, 8 -- B fragments of two n8 tiles from an [n][k] array,
// or (transposed) the A fragment of a [k][m] array; "cols" walks rows 0-7,
// 8-15, 0-7, 8-15 at columns 0, 0, 8, 8 -- the A fragment of an [m][k]
// array, or (transposed) B fragments of two n8 tiles from a [k][n] array.
template <int P, int N>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_bwd_tc_kernel(const BwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = args.S, H = args.H, Q = args.Q, CL = args.CL;
  const int Qp = padded_rows(Q), nrb = Qp / ROW_BLOCK;
  constexpr int LX = P + SMEM_PAD, LB = N + SMEM_PAD, LS = N + STAGE_PAD;
  constexpr int pk = P / 16, nk = N / 16, pt8 = P / 8, nt8 = N / 8;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDY = sX + Qp * LX;
  __nv_bfloat16* sB = sDY + Qp * LX;
  __nv_bfloat16* sC = sB + Qp * LB;
  float* sStage = reinterpret_cast<float*>(smem_raw);  // after both passes
  __nv_bfloat16* sDHhi =  // dH, [n][p]
      reinterpret_cast<__nv_bfloat16*>(smem_raw + tc_region_bytes(Qp, P, N));
  __nv_bfloat16* sDHlo = sDHhi + N * LX;
  __nv_bfloat16* sHhi = sDHlo + N * LX;  // H_in, [n][p]
  __nv_bfloat16* sHlo = sHhi + N * LX;
  float* sCum = reinterpret_cast<float*>(sHlo + N * LX);
  float* sDt = sCum + Qp;
  float* sEout = sDt + Qp;    // exp(cum_Q - cum_s)
  float* sEin = sEout + Qp;   // exp(cum_t)
  float* sRowM = sEin + Qp;   // sum_{s<t} M_ts
  float* sColM = sRowM + Qp;  // sum_{t>s} M_ts
  float* sDdt = sColM + Qp;   // ddt's direct part and e_s v_s
  float* sInter = sDdt + Qp;  // dy_t . y_inter_t
  float* sU = sInter + Qp;
  float* sRed = sU + Qp;      // TC_WARPS
  float* sScal = sRed + TC_WARPS;  // 2
  int* sTicket = reinterpret_cast<int*>(sScal + 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = S / Q, BH = args.B * H, HC = H / CL, BHC = args.B * HC;

  // the work item: one ticket a cluster, in reverse chunk-major order, so
  // the chunk after an item's always holds a smaller ticket
  if (rank == 0 && tid == 0) *sTicket = atomicAdd(args.sync, 1);
  cluster.sync();
  const int ticket = *cluster.map_shared_rank(sTicket, 0);
  const int c = nc - 1 - ticket / BHC, rem = ticket % BHC;
  const int b = rem / HC, hc = rem % HC, h = hc * CL + rank;
  const int bh = b * H + h;
  const int grp = h / (H / args.G);
  const int c0 = c * Q;
  const float a = args.a[h];
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(args.x) +
                            b * args.x_sb + h * args.x_sh + c0 * args.x_ss;
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(args.b) +
                            b * args.b_sb + grp * args.b_sg + c0 * args.b_ss;
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(args.c) +
                            b * args.c_sb + grp * args.c_sg + c0 * args.c_ss;
  const float* dtb = args.dt + b * args.dt_sb + h * args.dt_sh +
                     c0 * args.dt_ss;
  const long long row_hp = static_cast<long long>(H) * P;  // dy / dx rows
  const long long off_hp = (static_cast<long long>(b) * S + c0) * row_hp +
                           static_cast<long long>(h) * P;
  const __nv_bfloat16* dyb =
      static_cast<const __nv_bfloat16*>(args.dy) + off_hp;
  __nv_bfloat16* dxb = static_cast<__nv_bfloat16*>(args.dx) + off_hp;

  // the own part's split of N x P over the warps (step 3), and so the
  // (n, p) pairs whose H_in, dH and dH_in this thread moves: a pair of
  // warps (2 w, 2 w + 1) takes one 16-row block of n and up to four n8
  // tiles of p, each warp half of the chunk's rows; the even warp moves
  // the pairs
  constexpr int wpr = TC_WARPS / 2 / nk;           // warp pairs a 16 rows of n
  constexpr int l_cnt = (pt8 + wpr - 1) / wpr;     // p tiles a pair, <= 4
  const int pair = warp >> 1, khalf = warp & 1;
  const int l_rn = pair / wpr;                     // >= nk: no work
  const int l_pc0 = (pair % wpr) * l_cnt;
  const int l_tiles = l_rn < nk ? max(0, min(l_cnt, pt8 - l_pc0)) : 0;
  const int l_moves = khalf == 0 ? l_tiles : 0;
  constexpr long long NP = static_cast<long long>(N) * P;
  const float* h_src =
      c > 0 ? args.states + ((c - 1) * static_cast<long long>(BH) + bh) * NP
            : nullptr;
  // 1. by cp.async in three groups: dt (4 bytes a row) and H_in, the
  // forward's f32 state entering the chunk (into the dH region, N x P,
  // until it is split below); C and dy; x and B (16 bytes a thread); rows
  // past Q are zeros, dt = 0
  float* sHf = reinterpret_cast<float*>(sDHhi);
  for (int i = tid; i < Qp; i += TC_THREADS) {
    if (i < Q)
      cp_async4(sDt + i, dtb + i * args.dt_ss);
    else
      sDt[i] = 0.f;
  }
  if (h_src)
    for (int i = 4 * tid; i < N * P; i += 4 * TC_THREADS)
      cp_async16(sHf + i, h_src + i);
  cp_async_commit();
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                       long long stride, int L, int vecs) {
    for (int i = tid; i < Qp * vecs; i += TC_THREADS) {
      const int s = i / vecs, v = i - s * vecs;
      if (s < Q)
        cp_async16(dst + s * L + 8 * v, src + s * stride + 8 * v);
      else
        *reinterpret_cast<uint4*>(dst + s * L + 8 * v) = make_uint4(0, 0, 0, 0);
    }
  };
  load_rows(sC, cb, args.c_ss, LB, N / 8);
  load_rows(sDY, dyb, row_hp, LX, P / 8);
  cp_async_commit();
  load_rows(sX, xb, args.x_ss, LX, P / 8);
  load_rows(sB, bb, args.b_ss, LB, N / 8);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();  // dt and H_in are in

  // 2. cum = inclusive cumsum of dt a, in the order of the f32 route's
  // single-warp scan and of torch.cumsum on the card, so that a large
  // |dt a| leaves the differences cum_t - cum_s as the plain version rounds
  // them: each 32-row block scanned over its lanes by its own warp, the
  // blocks' carries added up in order by one thread (carry_k+1 = last_k +
  // carry_k), then added to each block; then the exps.  Meanwhile H_in
  // goes to shared memory as bf16 hi + lo, [n][p]
  const int nb32 = (Qp + 31) / 32;
  float cv = 0.f;
  if (warp < nb32) {
    const int i = 32 * warp + lane;
    cv = i < Qp ? sDt[i] * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, cv, off);
      if (lane >= off) cv += u;
    }
    if (lane == 31) sRed[warp] = cv;
  }
  for (int i = 2 * tid; i < N * P; i += 2 * TC_THREADS) {
    const int n = i / P, p = i - n * P;
    const float2 v = h_src ? *reinterpret_cast<const float2*>(sHf + i)
                           : make_float2(0.f, 0.f);
    uint32_t hi, lo;
    split2(v.x, v.y, hi, lo);
    *reinterpret_cast<uint32_t*>(sHhi + n * LX + p) = hi;
    *reinterpret_cast<uint32_t*>(sHlo + n * LX + p) = lo;
  }
  __syncthreads();
  if (tid == 0) {
    float carry = 0.f;
    for (int k = 0; k < nb32; ++k) {
      const float last = sRed[k];
      sRed[k] = carry;
      carry = last + carry;
    }
  }
  __syncthreads();
  if (warp < nb32 && 32 * warp + lane < Qp)
    sCum[32 * warp + lane] = cv + sRed[warp];
  __syncthreads();
  const float cum_last = sCum[Qp - 1];  // padded rows add dt = 0
  for (int i = tid; i < Qp; i += TC_THREADS) {
    sEout[i] = expf(cum_last - sCum[i]);
    sEin[i] = expf(sCum[i]);
  }
  cp_async_wait<1>();
  __syncthreads();  // C, dy and the vectors are in

  // lane offsets of the two ldmatrix walks, in bytes, for rows of LX and LB
  const int rows_r = (lane & 7) + (lane >> 4) * 8, rows_c = lane & 8;
  const int cols_r = (lane & 7) + (lane & 8), cols_c = (lane >> 4) * 8;
  const uint32_t rowsX = (rows_r * LX + rows_c) * 2,
                 colsX = (cols_r * LX + cols_c) * 2;
  const uint32_t rowsB = (rows_r * LB + rows_c) * 2,
                 colsB = (cols_r * LB + cols_c) * 2;
  const uint32_t uX = smem_addr(sX), uDY = smem_addr(sDY),
                 uB = smem_addr(sB), uC = smem_addr(sC),
                 uDH = smem_addr(sDHhi), uH = smem_addr(sHhi);
  constexpr uint32_t X16 = 16 * LX * 2, B16 = 16 * LB * 2;  // 16 rows
  constexpr uint32_t LO = N * LX * 2;  // hi -> lo of a state

  // 3. this chunk's part of dH_in: (C exp(cum))^T dy over the chunk, N x P
  // in m16n8 tiles of (n, p), the A fragment of C exp(cum) split into hi +
  // lo (each with its own accumulators); the odd warp of a pair sums the
  // second half of the rows and hands its f32 part to the even one through
  // the dH region (free until the publish), which adds it in order: own =
  // (hi + lo over the first half) + (hi + lo over the second)
  float own[l_cnt][4];
  {
    float lhi[l_cnt][4], llo[l_cnt][4];
#pragma unroll
    for (int j = 0; j < l_cnt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) lhi[j][e] = llo[j][e] = 0.f;
    const int k_mid = (nrb + 1) / 2;
    const int k_lo = khalf ? k_mid : 0, k_hi = khalf ? nrb : k_mid;
    if (l_tiles > 0) {
      const uint32_t dy_x2 = uDY + cols_r * LX * 2;  // lanes 0-15 used
#pragma unroll 2
      for (int ks = k_lo; ks < k_hi; ++ks) {
        const float2 e0 =
            *reinterpret_cast<const float2*>(sEin + 16 * ks + 2 * t4);
        const float2 e1 =
            *reinterpret_cast<const float2*>(sEin + 16 * ks + 8 + 2 * t4);
        uint32_t af[4], ahi[4], alo[4], yf[l_cnt][2];
        ldsm_x4_t(af, uC + rowsB + ks * B16 + 32 * l_rn);  // C^T as A
#pragma unroll
        for (int j = 0; j < l_cnt; ++j)
          if (j < l_tiles)
            ldsm_x2_t(yf[j][0], yf[j][1],
                      dy_x2 + ks * X16 + 16 * (l_pc0 + j));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = unpack(af[e]);
          const float2 w = e < 2 ? e0 : e1;
          split2(v.x * w.x, v.y * w.y, ahi[e], alo[e]);
        }
#pragma unroll
        for (int j = 0; j < l_cnt; ++j)
          if (j < l_tiles) {
            mma(lhi[j], ahi, yf[j][0], yf[j][1]);
            mma(llo[j], alo, yf[j][0], yf[j][1]);
          }
      }
    }
    float* part = reinterpret_cast<float*>(sDHhi);  // N x P f32
#pragma unroll
    for (int j = 0; j < l_cnt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) own[j][e] = lhi[j][e] + llo[j][e];
    if (khalf == 1) {
#pragma unroll
      for (int j = 0; j < l_cnt; ++j) {
        if (j >= l_tiles) continue;
        const int p = 8 * (l_pc0 + j) + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(part + (16 * l_rn + g + 8 * r) * P +
                                     p) =
              make_float2(own[j][2 * r], own[j][2 * r + 1]);
      }
    }
    __syncthreads();
    if (khalf == 0) {
#pragma unroll
      for (int j = 0; j < l_cnt; ++j) {
        if (j >= l_tiles) continue;
        const int p = 8 * (l_pc0 + j) + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 o = *reinterpret_cast<const float2*>(
              part + (16 * l_rn + g + 8 * r) * P + p);
          own[j][2 * r] += o.x;
          own[j][2 * r + 1] += o.y;
        }
      }
    }
    __syncthreads();  // the dH region is free again
  }

  // the chain: wait for dH leaving this chunk (published by chunk c + 1),
  // then publish dH_in = exp(cum_Q) dH + the part above at once; dH goes
  // to shared memory as bf16 hi + lo, [n][p]
  if (c < nc - 1) {
    if (tid == 0) {
      const int* flag = args.sync + 1 + c * BH + bh;
      while (ld_acquire(flag) == 0) __nanosleep(64);
    }
    __syncthreads();
  }
  const float dec = expf(cum_last);
  const float* dh_src =
      c < nc - 1 ? args.dstates + (c * static_cast<long long>(BH) + bh) * NP
                 : nullptr;
  float* dh_dst =
      c > 0 ? args.dstates + ((c - 1) * static_cast<long long>(BH) + bh) * NP
            : nullptr;
  float hdot = 0.f;
#pragma unroll
  for (int j = 0; j < l_cnt; ++j) {
    if (j >= l_moves) continue;
    const int p = 8 * (l_pc0 + j) + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = 16 * l_rn + g + 8 * r;
      const float2 dh =
          dh_src ? __ldcg(reinterpret_cast<const float2*>(dh_src + n * P + p))
                 : make_float2(0.f, 0.f);
      const float2 hin =  // again, from L2: for <H_in, dH> in f32
          h_src ? __ldcg(reinterpret_cast<const float2*>(h_src + n * P + p))
                : make_float2(0.f, 0.f);
      hdot = fmaf(hin.x, dh.x, hdot);
      hdot = fmaf(hin.y, dh.y, hdot);
      uint32_t hi, lo;
      split2(dh.x, dh.y, hi, lo);
      *reinterpret_cast<uint32_t*>(sDHhi + n * LX + p) = hi;
      *reinterpret_cast<uint32_t*>(sDHlo + n * LX + p) = lo;
      if (dh_dst)
        __stcg(reinterpret_cast<float2*>(dh_dst + n * P + p),
               make_float2(dh.x * dec + own[j][2 * r],
                           dh.y * dec + own[j][2 * r + 1]));
    }
  }
  {
    const float v = warp_sum(hdot);
    if (lane == 0) sRed[warp] = v;
  }
  cp_async_wait<0>();
  __syncthreads();  // dH_in is out; x, B, dH and sRed are in
  // the flag and <H_in, dH>, by the last warp (its fence delays no other
  // warp; it is idle in the passes below at chunks under 256)
  if (warp == TC_WARPS - 1 && lane == 0) {
    if (c > 0) {
      __threadfence();  // cumulative: the block's stores, then the flag
      st_release(args.sync + 1 + (c - 1) * BH + bh, 1);
    }
    float t = 0.f;
    for (int w = 0; w < TC_WARPS; ++w) t += sRed[w];
    sScal[0] = t;  // <H_in, dH>
  }

  // warp w owns rows [16 w, 16 w + 16): lo and hi are its rows g and g + 8
  const bool owner = warp < nrb;
  const int r0 = ROW_BLOCK * warp, r_lo = r0 + g, r_hi = r_lo + 8;
  float dB[nt8][4];  // this block's dB rows, held to the staging

  // 4. pass B: the block as keys s, query blocks t >= s: dx_s, dB_s, ddt's
  // direct part and M's column sums
  if (owner) {
    const int s0 = r0;
    const float cs_lo = sCum[r_lo], cs_hi = sCum[r_hi];
    const float dt_lo = sDt[r_lo], dt_hi = sDt[r_hi];
    float dX[pt8][4];
#pragma unroll
    for (int j = 0; j < pt8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dX[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < nt8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dB[j][e] = 0.f;
    // the leaving state's terms: dB_s = dH x_s (dH split), dx_s = B_s dH
    // (dH rounded once), both then scaled by e_s dt_s; v_s = B_s.(dH x_s)
    float v_lo = 0.f, v_hi = 0.f;
    if (c < nc - 1) {
#pragma unroll
      for (int kp = 0; kp < pk; ++kp) {
        uint32_t af[4];
        ldsm_x4(af, uX + colsX + s0 / 16 * X16 + 32 * kp);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          uint32_t hf[nk][4];
#pragma unroll
          for (int q = 0; q < nk; ++q)
            ldsm_x4(hf[q], uDH + part * LO + rowsX + q * X16 + 32 * kp);
#pragma unroll
          for (int q = 0; q < nk; ++q) {
            mma(dB[2 * q], af, hf[q][0], hf[q][1]);
            mma(dB[2 * q + 1], af, hf[q][2], hf[q][3]);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4], hf[pk][4];
        ldsm_x4(af, uB + colsB + s0 / 16 * B16 + 32 * kk);
#pragma unroll
        for (int q = 0; q < pk; ++q)
          ldsm_x4_t(hf[q], uDH + colsX + kk * X16 + 32 * q);
#pragma unroll
        for (int q = 0; q < pk; ++q) {
          mma(dX[2 * q], af, hf[q][0], hf[q][1]);
          mma(dX[2 * q + 1], af, hf[q][2], hf[q][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < nt8; ++j) {
        const int n = 8 * j + 2 * t4;
        const float2 bl =
            unpack(*reinterpret_cast<const uint32_t*>(sB + r_lo * LB + n));
        const float2 bh2 =
            unpack(*reinterpret_cast<const uint32_t*>(sB + r_hi * LB + n));
        v_lo = fmaf(bl.x, dB[j][0], v_lo);
        v_lo = fmaf(bl.y, dB[j][1], v_lo);
        v_hi = fmaf(bh2.x, dB[j][2], v_hi);
        v_hi = fmaf(bh2.y, dB[j][3], v_hi);
      }
      v_lo = quad_sum(v_lo);
      v_hi = quad_sum(v_hi);
      const float ed_lo = sEout[r_lo] * dt_lo, ed_hi = sEout[r_hi] * dt_hi;
#pragma unroll
      for (int j = 0; j < nt8; ++j) {
        dB[j][0] *= ed_lo;
        dB[j][1] *= ed_lo;
        dB[j][2] *= ed_hi;
        dB[j][3] *= ed_hi;
      }
#pragma unroll
      for (int j = 0; j < pt8; ++j) {
        dX[j][0] *= ed_lo;
        dX[j][1] *= ed_lo;
        dX[j][2] *= ed_hi;
        dX[j][3] *= ed_hi;
      }
    }
    float cm_lo = 0.f, cm_hi = 0.f, dd_lo = 0.f, dd_hi = 0.f;
    for (int T = warp; T < nrb; ++T) {
      // G^T = B_s C_t^T and dS^T = x_s dy_t^T: rows s, columns t
      float gt[2][4], st[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gt[j][e] = st[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, uB + colsB + warp * B16 + 32 * kk);
        ldsm_x4(bf, uC + rowsB + T * B16 + 32 * kk);
        mma(gt[0], af, bf[0], bf[1]);
        mma(gt[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int kp = 0; kp < pk; ++kp) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, uX + colsX + warp * X16 + 32 * kp);
        ldsm_x4(bf, uDY + rowsX + T * X16 + 32 * kp);
        mma(st[0], af, bf[0], bf[1]);
        mma(st[1], af, bf[2], bf[3]);
      }
      // L, the scores and W (each rounded once) as A fragments over t; the
      // mask (t >= s) before the exp, only on the diagonal block
      const bool diag = T == warp;
      uint32_t sa[4], wa[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int tc = 8 * jj + 2 * t4;  // column in the block
        const float2 ct =
            *reinterpret_cast<const float2*>(sCum + ROW_BLOCK * T + tc);
        float sc[4], w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = tc + (e & 1), row = g + (e >> 1) * 8;
          const float cs = e < 2 ? cs_lo : cs_hi;
          const float dts = e < 2 ? dt_lo : dt_hi;
          const bool keep = !diag || col >= row;
          const float l =
              ex2((keep ? (e & 1 ? ct.y : ct.x) - cs : -INFINITY) * LOG2E);
          const float gl = gt[jj][e] * l;
          sc[e] = gl * dts;
          w[e] = st[jj][e] * l * dts;
          const float dd = st[jj][e] * gl;
          const float m = (!diag || col > row) ? st[jj][e] * sc[e] : 0.f;
          if (e < 2) {
            dd_lo += dd;
            cm_lo += m;
          } else {
            dd_hi += dd;
            cm_hi += m;
          }
        }
        sa[2 * jj] = pack2(sc[0], sc[1]);
        sa[2 * jj + 1] = pack2(sc[2], sc[3]);
        wa[2 * jj] = pack2(w[0], w[1]);
        wa[2 * jj + 1] = pack2(w[2], w[3]);
      }
      // dx_s += scores^T dy_t
      {
        uint32_t yf[pk][4];
#pragma unroll
        for (int q = 0; q < pk; ++q)
          ldsm_x4_t(yf[q], uDY + colsX + T * X16 + 32 * q);
#pragma unroll
        for (int q = 0; q < pk; ++q) {
          mma(dX[2 * q], sa, yf[q][0], yf[q][1]);
          mma(dX[2 * q + 1], sa, yf[q][2], yf[q][3]);
        }
      }
      // dB_s += W^T C_t
      {
        uint32_t cf[nk][4];
#pragma unroll
        for (int q = 0; q < nk; ++q)
          ldsm_x4_t(cf[q], uC + colsB + T * B16 + 32 * q);
#pragma unroll
        for (int q = 0; q < nk; ++q) {
          mma(dB[2 * q], wa, cf[q][0], cf[q][1]);
          mma(dB[2 * q + 1], wa, cf[q][2], cf[q][3]);
        }
      }
    }
    cm_lo = quad_sum(cm_lo);
    cm_hi = quad_sum(cm_hi);
    dd_lo = quad_sum(dd_lo);
    dd_hi = quad_sum(dd_hi);
    if (t4 == 0) {
      sColM[r_lo] = cm_lo;
      sColM[r_hi] = cm_hi;
      sDdt[r_lo] = sEout[r_lo] * v_lo + dd_lo;
      sDdt[r_hi] = sEout[r_hi] * v_hi + dd_hi;
      sU[r_lo] = sEout[r_lo] * dt_lo * v_lo;
      sU[r_hi] = sEout[r_hi] * dt_hi * v_hi;
    }
    // dx rounded to bf16 once
#pragma unroll
    for (int j = 0; j < pt8; ++j) {
      const int p = 8 * j + 2 * t4;
      if (r_lo < Q)
        *reinterpret_cast<__nv_bfloat162*>(dxb + r_lo * row_hp + p) =
            __floats2bfloat162_rn(dX[j][0], dX[j][1]);
      if (r_hi < Q)
        *reinterpret_cast<__nv_bfloat162*>(dxb + r_hi * row_hp + p) =
            __floats2bfloat162_rn(dX[j][2], dX[j][3]);
    }
  }

  // 5. pass A: the block as queries t, key blocks s <= t: dC_t, y_inter's
  // term of dcum and M's row sums
  float dC[nt8][4];
  if (owner) {
    const int t0 = r0;
    const float ct_lo = sCum[r_lo], ct_hi = sCum[r_hi];
#pragma unroll
    for (int j = 0; j < nt8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dC[j][e] = 0.f;
    // the entering state's term: exp(cum_t) dy_t H_in^T (H_in split), and
    // dy_t . y_inter_t = C_t . that
    float in_lo = 0.f, in_hi = 0.f;
    if (c > 0) {
#pragma unroll
      for (int kp = 0; kp < pk; ++kp) {
        uint32_t af[4];
        ldsm_x4(af, uDY + colsX + t0 / 16 * X16 + 32 * kp);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          uint32_t hf[nk][4];
#pragma unroll
          for (int q = 0; q < nk; ++q)
            ldsm_x4(hf[q], uH + part * LO + rowsX + q * X16 + 32 * kp);
#pragma unroll
          for (int q = 0; q < nk; ++q) {
            mma(dC[2 * q], af, hf[q][0], hf[q][1]);
            mma(dC[2 * q + 1], af, hf[q][2], hf[q][3]);
          }
        }
      }
      const float ei_lo = sEin[r_lo], ei_hi = sEin[r_hi];
#pragma unroll
      for (int j = 0; j < nt8; ++j) {
        const int n = 8 * j + 2 * t4;
        dC[j][0] *= ei_lo;
        dC[j][1] *= ei_lo;
        dC[j][2] *= ei_hi;
        dC[j][3] *= ei_hi;
        const float2 cl =
            unpack(*reinterpret_cast<const uint32_t*>(sC + r_lo * LB + n));
        const float2 ch =
            unpack(*reinterpret_cast<const uint32_t*>(sC + r_hi * LB + n));
        in_lo = fmaf(cl.x, dC[j][0], in_lo);
        in_lo = fmaf(cl.y, dC[j][1], in_lo);
        in_hi = fmaf(ch.x, dC[j][2], in_hi);
        in_hi = fmaf(ch.y, dC[j][3], in_hi);
      }
      in_lo = quad_sum(in_lo);
      in_hi = quad_sum(in_hi);
    }
    float rm_lo = 0.f, rm_hi = 0.f;
    for (int Sb = 0; Sb <= warp; ++Sb) {
      // G = C_t B_s^T and dS = dy_t x_s^T: rows t, columns s
      float gg[2][4], ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gg[j][e] = ds[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, uC + colsB + warp * B16 + 32 * kk);
        ldsm_x4(bf, uB + rowsB + Sb * B16 + 32 * kk);
        mma(gg[0], af, bf[0], bf[1]);
        mma(gg[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int kp = 0; kp < pk; ++kp) {
        uint32_t af[4], xf[4];
        ldsm_x4(af, uDY + colsX + warp * X16 + 32 * kp);
        ldsm_x4(xf, uX + rowsX + Sb * X16 + 32 * kp);
        mma(ds[0], af, xf[0], xf[1]);
        mma(ds[1], af, xf[2], xf[3]);
      }
      // L and W (hi + lo) as A fragments over s; the mask (s <= t) before
      // the exp, only on the diagonal block
      const bool diag = Sb == warp;
      uint32_t wh[4], wl[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int sc0 = 8 * jj + 2 * t4;  // column in the block
        const float2 cs =
            *reinterpret_cast<const float2*>(sCum + ROW_BLOCK * Sb + sc0);
        const float2 dts =
            *reinterpret_cast<const float2*>(sDt + ROW_BLOCK * Sb + sc0);
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sc0 + (e & 1), row = g + (e >> 1) * 8;
          const float ct = e < 2 ? ct_lo : ct_hi;
          const float dt = e & 1 ? dts.y : dts.x;
          const bool keep = !diag || col <= row;
          const float l =
              ex2((keep ? ct - (e & 1 ? cs.y : cs.x) : -INFINITY) * LOG2E);
          const float sc = gg[jj][e] * l * dt;
          w[e] = ds[jj][e] * l * dt;
          const float m = (!diag || col < row) ? ds[jj][e] * sc : 0.f;
          if (e < 2)
            rm_lo += m;
          else
            rm_hi += m;
        }
        split2(w[0], w[1], wh[2 * jj], wl[2 * jj]);
        split2(w[2], w[3], wh[2 * jj + 1], wl[2 * jj + 1]);
      }
      // dC_t += W B_s, hi then lo
      uint32_t bf[nk][4];
#pragma unroll
      for (int q = 0; q < nk; ++q)
        ldsm_x4_t(bf[q], uB + colsB + Sb * B16 + 32 * q);
#pragma unroll
      for (int q = 0; q < nk; ++q) {
        mma(dC[2 * q], wh, bf[q][0], bf[q][1]);
        mma(dC[2 * q + 1], wh, bf[q][2], bf[q][3]);
      }
#pragma unroll
      for (int q = 0; q < nk; ++q) {
        mma(dC[2 * q], wl, bf[q][0], bf[q][1]);
        mma(dC[2 * q + 1], wl, bf[q][2], bf[q][3]);
      }
    }
    rm_lo = quad_sum(rm_lo);
    rm_hi = quad_sum(rm_hi);
    if (t4 == 0) {
      sRowM[r_lo] = rm_lo;
      sRowM[r_hi] = rm_hi;
      sInter[r_lo] = in_lo;
      sInter[r_hi] = in_hi;
    }
  }
  __syncthreads();  // both passes are done: the operands are free

  // 6. this head's f32 dB and dC to the staging, [2][Qp][N+4]
  if (owner) {
#pragma unroll
    for (int j = 0; j < nt8; ++j) {
      const int n = 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(sStage + r_lo * LS + n) =
          make_float2(dB[j][0], dB[j][1]);
      *reinterpret_cast<float2*>(sStage + r_hi * LS + n) =
          make_float2(dB[j][2], dB[j][3]);
      *reinterpret_cast<float2*>(sStage + (Qp + r_lo) * LS + n) =
          make_float2(dC[j][0], dC[j][1]);
      *reinterpret_cast<float2*>(sStage + (Qp + r_hi) * LS + n) =
          make_float2(dC[j][2], dC[j][3]);
    }
  }

  cluster.sync();  // every block's staging is written
  // 7. dcum, its reverse cumsum dda, ddt and this item's part of da: one
  // warp, 32 rows at a time from the chunk's end, while the others sum the
  // cluster's dB and dC
  if (warp == 0) {
    float us = 0.f;
    for (int i = lane; i < Q; i += 32) us += sU[i];
    const float extra = warp_sum(us) + dec * sScal[0];
    float carry = 0.f, da_acc = 0.f;
    for (int base = Qp - 32; base > -32; base -= 32) {
      const int r = base + lane;  // Qp may be 16 rows short of 32
      float v = r >= 0 ? sRowM[r] - sColM[r] + sInter[r] - sU[r] +
                             (r == Q - 1 ? extra : 0.f)
                       : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(FULL, v, off);
        if (lane + off < 32) v += u;
      }
      v += carry;  // dda_r
      carry = __shfl_sync(FULL, v, 0);
      if (r >= 0 && r < Q) {
        args.ddt[(static_cast<long long>(b) * S + c0 + r) * H + h] =
            sDdt[r] + a * v;
        da_acc = fmaf(sDt[r], v, da_acc);
      }
    }
    da_acc = warp_sum(da_acc);
    if (lane == 0)
      args.da_parts[static_cast<long long>(bh) * nc + c] = da_acc;
  } else {
    // 8. the cluster's heads summed in rank order, by the other warps: rank
    // r takes rows [r Qp / CL, (r + 1) Qp / CL) of dB and dC from every
    // block's staging
    const int R = Qp / CL, rq0 = rank * R;
    constexpr int V = N / 4;  // float4s a row
    const long long part_row = static_cast<long long>(HC) * N;
    for (int i = tid - 32; i < 2 * R * V; i += TC_THREADS - 32) {
      const int which = i / (R * V), k = i - which * R * V;
      const int row = rq0 + k / V, v = k % V;
      const int off = (which * Qp + row) * LS + 4 * v;
      float4 t[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < CL)
          t[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(sStage, q) + off);
      float4 sum = t[0];
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q)
        if (q < CL) {
          sum.x += t[q].x;
          sum.y += t[q].y;
          sum.z += t[q].z;
          sum.w += t[q].w;
        }
      if (row < Q)
        *reinterpret_cast<float4*>(
            args.parts +
            ((static_cast<long long>(which) * args.B + b) * S + c0 + row) *
                part_row +
            static_cast<long long>(hc) * N + 4 * v) = sum;
    }
  }
  cluster.sync();  // no block leaves while another reads its staging
}

// ---------------------------------------------------------------------------
// f32 route: the port's first backward kernel, on the CUDA cores
// ---------------------------------------------------------------------------
//
// One block of 16 x 16 threads per work item (batch, head, chunk), taken
// from the same reverse chunk-major ticket; the chunk's x, dy, B and C in
// shared memory as f32 (rows padded to whole 64-row tiles with zeros and
// dt = 0); every product a 64 x 64 tile, each thread a 4 x 4 register
// tile, summed in f32 in a fixed order.  Pass A walks the row tiles t and,
// for every column tile s <= t, forms G and dS, W = dS L dt_s (through a
// shared 64 x 65 tile) and dC_t; pass B walks the column tiles s and, for
// every t >= s, forms them again and dx_s and dB_s.  Each head's f32 dB and
// dC go to the parts scratch (a cluster of one head), summed by the second
// kernel.  f32 inputs fit chunks up to 128 at P = N = 64.

constexpr int THREADS = 256;  // 16 x 16
constexpr int TILE = 64;      // rows of a square tile
constexpr int WARPS = THREADS / 32;

__host__ __device__ inline int tile_rows(int Q) {
  return (Q + TILE - 1) / TILE * TILE;
}

// bytes of shared memory (bwd_smem_bytes in the wrapper): x, dy, B and C
// (Qp rows each, one f32 of padding a row), nine f32 vectors of Qp, two
// 64 x 65 f32 tiles, the 2 x 16 x 64 column partials, H_in and dH
// (N x P+1 each), and 16 words of block scratch
__host__ __device__ inline long long f32_smem_bytes(int Q, int P, int N) {
  const long long Qp = tile_rows(Q);
  return 4LL * (2 * Qp * (P + 1 + N + 1) + 9 * Qp + 2 * TILE * (TILE + 1) +
                2 * 16 * TILE + 2LL * N * (P + 1) + 16);
}

// the sum over the 16 lanes of a half-warp (lanes tx = 0..15 of one ty)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_f32_kernel(const BwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = args.S, H = args.H, P = args.P, N = args.N, Q = args.Q;
  const int Qp = tile_rows(Q);
  const int LP = P + 1, LN = N + 1, LH = P + 1, LT = TILE + 1;
  float* sX = reinterpret_cast<float*>(smem_raw);
  float* sDY = sX + Qp * LP;
  float* sB = sDY + Qp * LP;
  float* sC = sB + Qp * LN;
  float* sCum = reinterpret_cast<float*>(sC + Qp * LN);
  float* sDt = sCum + Qp;
  float* sEout = sDt + Qp;   // exp(cum_Q - cum_s)
  float* sEin = sEout + Qp;  // exp(cum_t)
  float* sRowM = sEin + Qp;  // sum_s M_ts
  float* sColM = sRowM + Qp;  // sum_t M_ts
  float* sDdt = sColM + Qp;  // ddt's direct part
  float* sInter = sDdt + Qp;  // dy_t . y_inter_t
  float* sU = sInter + Qp;
  float* sT1 = sU + Qp;  // 64 x 65 tiles
  float* sT2 = sT1 + TILE * LT;
  float* sPart = sT2 + TILE * LT;  // 2 x 16 x 64 column partials
  float* sH = sPart + 2 * 16 * TILE;  // H_in, N x P+1
  float* sDH = sH + N * LH;           // dH, N x P+1
  float* sRed = sDH + N * LH;         // WARPS
  float* sScal = sRed + WARPS;        // 4
  int* sTicket = reinterpret_cast<int*>(sScal + 4);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int nc = S / Q, BH = args.B * H;

  // the work item: tickets run in reverse chunk-major order, so the chunk
  // after an item's always holds a smaller ticket
  if (tid == 0) *sTicket = atomicAdd(args.sync, 1);
  __syncthreads();
  const int ticket = *sTicket;
  const int c = nc - 1 - ticket / BH, bh = ticket % BH;
  const int b = bh / H, h = bh % H;
  const int grp = h / (H / args.G);
  const int c0 = c * Q;
  const float a = args.a[h];
  const float* xb = static_cast<const float*>(args.x) + b * args.x_sb +
                h * args.x_sh + c0 * args.x_ss;
  const float* bb = static_cast<const float*>(args.b) + b * args.b_sb +
                grp * args.b_sg + c0 * args.b_ss;
  const float* cb = static_cast<const float*>(args.c) + b * args.c_sb +
                grp * args.c_sg + c0 * args.c_ss;
  const float* dtb = args.dt + b * args.dt_sb + h * args.dt_sh +
                     c0 * args.dt_ss;
  const long long row_hp = static_cast<long long>(H) * P;  // dy / dx rows
  const long long off_hp =
      (static_cast<long long>(b) * S + c0) * row_hp + static_cast<long long>(h) * P;
  const float* dyb = static_cast<const float*>(args.dy) + off_hp;
  float* dxb = static_cast<float*>(args.dx) + off_hp;
  const long long row_hn = static_cast<long long>(H) * N;  // parts rows
  const long long off_hn =
      (static_cast<long long>(b) * S + c0) * row_hn + static_cast<long long>(h) * N;
  float* part_b = args.parts + off_hn;
  float* part_c =
      args.parts + static_cast<long long>(args.B) * S * row_hn + off_hn;

  // this thread's columns over P and over N, clamped for the reads (the
  // writes check the bounds)
  int pp[4], nn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pp[j] = min(tx + 16 * j, P - 1);
    nn[j] = min(tx + 16 * j, N - 1);
  }

  // 1. the chunk's rows; rows past Q are zeros with dt = 0
  const float zero = 0.f;
  for (int i = tid; i < Qp * P; i += THREADS) {
    const int s = i / P, p = i - s * P;
    const bool in = s < Q;
    sX[s * LP + p] = in ? xb[s * args.x_ss + p] : zero;
    sDY[s * LP + p] = in ? dyb[s * row_hp + p] : zero;
  }
  for (int i = tid; i < Qp * N; i += THREADS) {
    const int s = i / N, n = i - s * N;
    const bool in = s < Q;
    sB[s * LN + n] = in ? bb[s * args.b_ss + n] : zero;
    sC[s * LN + n] = in ? cb[s * args.c_ss + n] : zero;
  }
  for (int i = tid; i < Qp; i += THREADS) {
    sDt[i] = i < Q ? dtb[i * args.dt_ss] : 0.f;
    sColM[i] = 0.f;
  }
  __syncthreads();

  // 2. cum = inclusive cumsum of dt a (one warp, 32 rows at a time), then
  // the exps
  if (warp == 0) {
    float carry = 0.f;
    for (int base = 0; base < Qp; base += 32) {
      const int i = base + lane;
      float v = sDt[i] * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      sCum[i] = v;
      carry = __shfl_sync(FULL, v, 31);
    }
  }
  __syncthreads();
  const float cum_last = sCum[Q - 1];  // rows past Q add dt = 0
  for (int i = tid; i < Qp; i += THREADS) {
    sEout[i] = expf(cum_last - sCum[i]);
    sEin[i] = expf(sCum[i]);
  }
  __syncthreads();

  // 3. this chunk's part of dH_in: sum_t exp(cum_t) C_t dy_t^T; this
  // thread's (n, p) = (ty + 16 i, tx + 16 j)
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < Q; ++t) {
    const float e = sEin[t];
    float cv[4], yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = (sC[t * LN + min(ty + 16 * i, N - 1)]) * e;
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = (sDY[t * LP + pp[j]]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], yv[j], acc[i][j]);
  }

  // the chain: wait for dH leaving this chunk (published by chunk c + 1),
  // then publish dH_in = exp(cum_Q) dH + the part above at once
  if (c < nc - 1) {
    if (tid == 0) {
      const int* flag = args.sync + 1 + c * BH + bh;
      while (ld_acquire(flag) == 0) __nanosleep(64);
    }
    __syncthreads();
  }
  const long long NP = static_cast<long long>(N) * P;
  const float dec = expf(cum_last);
  const float* dh_src =
      c < nc - 1 ? args.dstates + (c * static_cast<long long>(BH) + bh) * NP
                 : nullptr;
  float* dh_dst =
      c > 0 ? args.dstates + ((c - 1) * static_cast<long long>(BH) + bh) * NP
            : nullptr;
  const float* h_src =
      c > 0 ? args.states + ((c - 1) * static_cast<long long>(BH) + bh) * NP
            : nullptr;
  float hdot = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (n < N && p < P) {
        const float dh = dh_src ? __ldcg(dh_src + n * P + p) : 0.f;
        const float hin = h_src ? __ldcg(h_src + n * P + p) : 0.f;
        sDH[n * LH + p] = dh;
        sH[n * LH + p] = hin;
        hdot = fmaf(hin, dh, hdot);
        if (dh_dst) __stcg(dh_dst + n * P + p, dh * dec + acc[i][j]);
      }
    }
  }
  {
    const float v = warp_sum(hdot);
    if (lane == 0) sRed[warp] = v;
  }
  __syncthreads();  // dH_in is out; sH, sDH and sRed are written
  if (tid == 0) {
    if (c > 0) {
      __threadfence();  // cumulative: the block's stores, then the flag
      st_release(args.sync + 1 + (c - 1) * BH + bh, 1);
    }
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += sRed[w];
    sScal[0] = t;  // <H_in, dH>
  }

  // G = C B^T and dS = dy x^T on the tile (t0 + ty + 16 i, s0 + tx + 16 j)
  auto products = [&](const int t0, const int s0, float (&gv)[4][4],
                      float (&dv)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[i][j] = dv[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = (sC[(t0 + ty + 16 * i) * LN + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = (sB[(s0 + tx + 16 * j) * LN + n]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[i][j] = fmaf(cv[i], bv[j], gv[i][j]);
    }
    for (int p = 0; p < P; ++p) {
      float yv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        yv[i] = (sDY[(t0 + ty + 16 * i) * LP + p]);
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = (sX[(s0 + tx + 16 * j) * LP + p]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[i][j] = fmaf(yv[i], xv[j], dv[i][j]);
    }
  };

  const int ntile = Qp / TILE;

  // 4. pass A, one tile of rows t at a time: dC_t (this thread's (t, n) =
  // (t0 + ty + 16 i, tx + 16 j)), dy_t . y_inter_t and the row sums of M
  for (int T0 = 0; T0 < ntile; ++T0) {
    const int t0 = T0 * TILE;
    float accC[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accC[i][j] = 0.f;
    // the carried state's term: exp(cum_t) H_in dy_t
    for (int p = 0; p < P; ++p) {
      float yv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        yv[i] = (sDY[(t0 + ty + 16 * i) * LP + p]);
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = sH[nn[j] * LH + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) accC[i][j] = fmaf(yv[i], hv[j], accC[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      const float e = sEin[t];
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        accC[i][j] *= e;
        if (tx + 16 * j < N) d = fmaf((sC[t * LN + tx + 16 * j]), accC[i][j], d);
      }
      d = half_sum(d);
      if (tx == 0) sInter[t] = d;
    }
    float rowm[4] = {0.f, 0.f, 0.f, 0.f};
    for (int S0 = 0; S0 <= T0; ++S0) {
      const int s0 = S0 * TILE;
      float gv[4][4], dv[4][4];
      products(t0, s0, gv, dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tx + 16 * j;
          float w = 0.f;
          if (s <= t) {  // the mask, before the exp
            w = dv[i][j] * expf(sCum[t] - sCum[s]) * sDt[s];
            if (s < t) rowm[i] = fmaf(w, gv[i][j], rowm[i]);
          }
          sT1[(ty + 16 * i) * LT + tx + 16 * j] = w;
        }
      }
      __syncthreads();
      // dC_t += sum_s W_ts B_s
      for (int k = 0; k < TILE; ++k) {
        float wv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = sT1[(ty + 16 * i) * LT + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = (sB[(s0 + k) * LN + nn[j]]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) accC[i][j] = fmaf(wv[i], bv[j], accC[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      const float r = half_sum(rowm[i]);
      if (tx == 0) sRowM[t] = r;
      if (t < Q) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tx + 16 * j < N) part_c[t * row_hn + tx + 16 * j] = accC[i][j];
      }
    }
  }

  // 5. pass B, one tile of rows s at a time: dx_s and dB_s (this thread's
  // (s, p or n) = (s0 + ty + 16 i, tx + 16 j)), the column sums of M and
  // ddt's direct part
  for (int S0 = 0; S0 < ntile; ++S0) {
    const int s0 = S0 * TILE;
    float accX[4][4], accB[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) accX[i][j] = accB[i][j] = 0.f;
    // the leaving state's terms: B_s dH and dH x_s
    for (int n = 0; n < N; ++n) {
      float bv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = (sB[(s0 + ty + 16 * i) * LN + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = sDH[n * LH + pp[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) accX[i][j] = fmaf(bv[i], hv[j], accX[i][j]);
    }
    for (int p = 0; p < P; ++p) {
      float xv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = (sX[(s0 + ty + 16 * i) * LP + p]);
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = sDH[nn[j] * LH + p];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) accB[i][j] = fmaf(xv[i], hv[j], accB[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + ty + 16 * i;
      float v = 0.f;  // B_s . (dH x_s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < N) v = fmaf((sB[s * LN + tx + 16 * j]), accB[i][j], v);
      v = half_sum(v);
      const float ed = sEout[s] * sDt[s];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        accX[i][j] *= ed;
        accB[i][j] *= ed;
      }
      if (tx == 0) {
        sDdt[s] = sEout[s] * v;
        sU[s] = ed * v;
      }
    }
    for (int T0 = S0; T0 < ntile; ++T0) {
      const int t0 = T0 * TILE;
      float gv[4][4], dv[4][4];
      products(t0, s0, gv, dv);
      float cm[4] = {0.f, 0.f, 0.f, 0.f}, ck[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tx + 16 * j;
          float sc = 0.f, w = 0.f;
          if (s <= t) {  // the mask, before the exp
            const float l = expf(sCum[t] - sCum[s]);
            const float gl = gv[i][j] * l;
            sc = gl * sDt[s];  // the score
            w = dv[i][j] * l * sDt[s];
            if (s < t) cm[j] = fmaf(dv[i][j], sc, cm[j]);
            ck[j] = fmaf(dv[i][j], gl, ck[j]);
          }
          sT1[(ty + 16 * i) * LT + tx + 16 * j] = sc;
          sT2[(ty + 16 * i) * LT + tx + 16 * j] = w;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sPart[ty * TILE + tx + 16 * j] = cm[j];
        sPart[16 * TILE + ty * TILE + tx + 16 * j] = ck[j];
      }
      __syncthreads();
      // dx_s += sum_t score_ts dy_t, dB_s += sum_t W_ts C_t
      for (int k = 0; k < TILE; ++k) {
        float sv[4], wv[4], yv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sv[i] = sT1[k * LT + ty + 16 * i];
          wv[i] = sT2[k * LT + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          yv[j] = (sDY[(t0 + k) * LP + pp[j]]);
          cv[j] = (sC[(t0 + k) * LN + nn[j]]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            accX[i][j] = fmaf(sv[i], yv[j], accX[i][j]);
            accB[i][j] = fmaf(wv[i], cv[j], accB[i][j]);
          }
      }
      // the column sums, over the 16 row groups in order
      if (tid < TILE) {
        float sum = 0.f;
        for (int r = 0; r < 16; ++r) sum += sPart[r * TILE + tid];
        sColM[s0 + tid] += sum;
      } else if (tid < 2 * TILE) {
        const int col = tid - TILE;
        float sum = 0.f;
        for (int r = 0; r < 16; ++r) sum += sPart[16 * TILE + r * TILE + col];
        sDdt[s0 + col] += sum;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + ty + 16 * i;
      if (s >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tx + 16 * j < P) dxb[s * row_hp + tx + 16 * j] = (accX[i][j]);
        if (tx + 16 * j < N) part_b[s * row_hn + tx + 16 * j] = accB[i][j];
      }
    }
  }
  __syncthreads();

  // 6. dcum, its reverse cumsum dda, ddt and this item's part of da: one
  // warp, 32 rows at a time from the chunk's end
  if (warp == 0) {
    float us = 0.f;
    for (int i = lane; i < Q; i += 32) us += sU[i];
    const float extra = warp_sum(us) + dec * sScal[0];
    float carry = 0.f, da_acc = 0.f;
    for (int base = Qp - 32; base >= 0; base -= 32) {
      const int r = base + lane;
      float v = sRowM[r] - sColM[r] + sInter[r] - sU[r] +
                (r == Q - 1 ? extra : 0.f);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(FULL, v, off);
        if (lane + off < 32) v += u;
      }
      v += carry;  // dda_r
      carry = __shfl_sync(FULL, v, 0);
      if (r < Q) {
        args.ddt[(static_cast<long long>(b) * S + c0 + r) * H + h] =
            sDdt[r] + a * v;
        da_acc = fmaf(sDt[r], v, da_acc);
      }
    }
    da_acc = warp_sum(da_acc);
    if (lane == 0)
      args.da_parts[static_cast<long long>(bh) * nc + c] = da_acc;
  }
}


// dB and dC: each (b, s, g, n) the sum of its group's cluster parts in
// order (the tensor-core route's clusters of CL heads, or the f32 route's
// single heads), rounded once; then da: each head the sum of its (b,
// chunk) parts in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const BwdArgs args) {
  const long long bsgn =
      static_cast<long long>(args.B) * args.S * args.G * args.N;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int HC = args.H / args.CL, rep = HC / args.G;
  if (i < 2 * bsgn) {
    const int which = i >= bsgn;  // 0: dB, 1: dC
    const long long j = i - which * bsgn;
    const int n = static_cast<int>(j % args.N);
    const long long rest = j / args.N;
    const int g = static_cast<int>(rest % args.G);
    const long long bs = rest / args.G;
    const float* src =
        args.parts + which * (bsgn / args.G * HC) +
        (bs * HC + static_cast<long long>(g) * rep) * args.N + n;
    float sum = 0.f;
    for (int r = 0; r < rep; ++r) sum += src[static_cast<long long>(r) * args.N];
    T* out = static_cast<T*>(which ? args.dc : args.db);
    if constexpr (sizeof(T) == 2)
      out[j] = __float2bfloat16_rn(sum);
    else
      out[j] = sum;
  } else if (i < 2 * bsgn + args.H) {
    const int h = static_cast<int>(i - 2 * bsgn);
    const int nc = args.S / args.Q;
    float sum = 0.f;
    for (int b = 0; b < args.B; ++b)
      for (int c = 0; c < nc; ++c)
        sum += args.da_parts[(static_cast<long long>(b) * args.H + h) * nc + c];
    args.da[h] = sum;
  }
}

template <typename T>
int launch_reduce(const BwdArgs& args, cudaStream_t stream) {
  const long long work =
      2LL * args.B * args.S * args.G * args.N + args.H;
  ssd_bwd_reduce_kernel<T><<<static_cast<unsigned>((work + THREADS - 1) /
                                                   THREADS),
                             THREADS, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const BwdArgs& args, cudaStream_t stream) {
  const long long smem = f32_smem_bytes(args.Q, args.P, args.N);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // the attribute holds for the process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long items =
      static_cast<long long>(args.B) * args.H * (args.S / args.Q);
  ssd_bwd_f32_kernel<<<static_cast<unsigned>(items), THREADS,
                       static_cast<int>(smem), stream>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<float>(args, stream);
}

// the launch of one (P, N) instance: one block of TC_THREADS an item,
// clusters of args.CL blocks
template <int P, int N>
cudaLaunchConfig_t tc_config(const BwdArgs& args, cudaLaunchAttribute* attr,
                             cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      static_cast<long long>(args.B) * args.H * (args.S / args.Q)));
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = tc_smem_bytes(args.Q, P, N);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int P, int N>
cudaError_t configure_tc() {
  static bool configured = false;  // the attribute holds for the process
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_tc_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err == cudaSuccess) configured = true;
  return err;
}

// what the tensor-core route does with one (P, N) instance: launch it, or
// (clusters != nullptr) report how many of its clusters fit on the card
template <int P, int N>
int run_tc_pn(const BwdArgs& args, cudaStream_t stream, int* clusters) {
  cudaError_t err = configure_tc<P, N>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = tc_config<P, N>(args, attr, stream);
  if (clusters)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        clusters, ssd_bwd_tc_kernel<P, N>, &cfg));
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_tc_kernel<P, N>, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<__nv_bfloat16>(args, stream);
}

template <int P>
int run_tc_p(const BwdArgs& args, cudaStream_t stream, int* clusters) {
  switch (args.N) {
    case 16:
      return run_tc_pn<P, 16>(args, stream, clusters);
    case 32:
      return run_tc_pn<P, 32>(args, stream, clusters);
    case 48:
      return run_tc_pn<P, 48>(args, stream, clusters);
    case 64:
      return run_tc_pn<P, 64>(args, stream, clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p, long long s0, long long s1, long long s2) {
  // strides in bf16 elements: 8 elements are 16 bytes
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

int run_tc(const BwdArgs& args, cudaStream_t stream, int* clusters) {
  if (args.Q > MAX_ROWS || tc_smem_bytes(args.Q, args.P, args.N) > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!clusters &&
      (!aligned16(args.x, args.B > 1 ? args.x_sb : 0, args.x_ss,
                  args.H > 1 ? args.x_sh : 0) ||
       !aligned16(args.b, args.B > 1 ? args.b_sb : 0, args.b_ss,
                  args.G > 1 ? args.b_sg : 0) ||
       !aligned16(args.c, args.B > 1 ? args.c_sb : 0, args.c_ss,
                  args.G > 1 ? args.c_sg : 0) ||
       !aligned16(args.dy, 0, 0, 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the P / N menu (TC_DIMS in the wrapper)
  switch (args.P) {
    case 16:
      return run_tc_p<16>(args, stream, clusters);
    case 32:
      return run_tc_p<32>(args, stream, clusters);
    case 48:
      return run_tc_p<48>(args, stream, clusters);
    case 64:
      return run_tc_p<64>(args, stream, clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The gradient of mist_ssd_scan's y.  x (B, S, H, P) and b/c (B, S, G, N):
// bf16 (dtype 1) or f32 (dtype 0), the last dim contiguous, other strides
// in elements, as the forward takes them; dt (B, S, H) f32 with strides;
// a (H,) f32.  dy, dx (B, S, H, P) contiguous in x's dtype; ddt (B, S, H)
// and da (H,) f32; db/dc (B, S, G, N) contiguous in b's dtype.  states:
// the forward's (S/Q - 1, B, H, N, P) f32 (entering states); scratch:
// parts (2, B, S, H / CL, N) f32 with CL = tc_cluster(H, G) for bf16 and
// 1 for f32 (bwd_cluster in the wrapper), da_parts (B, H, S/Q) f32,
// dstates like states, sync 1 + (S/Q - 1) B H int32 zeros.  S % Q == 0.
// bf16 runs the tensor-core kernel: P and N in 16, 32, 48, 64, Q <= 256,
// x/b/c/dy bases and strides 16-byte aligned.  f32 runs the CUDA-core
// kernel: P and N <= 64 and the chunk's rows within shared memory.
// Returns cudaGetLastError() after the launches.
extern "C" int mist_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* dy, const void* states, void* dx, void* ddt,
    void* da, void* db, void* dc, void* parts, void* da_parts,
    void* dstates, void* sync, int B, int S, int H, int G, int P, int N,
    int Q, int dtype, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, void* stream) {
  if (P < 1 || P > MAX_DIM || N < 1 || N > MAX_DIM || Q < 1 || S % Q ||
      G < 1 || H % G || !sync || (S > Q && (!states || !dstates)) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs args{x,
               static_cast<const float*>(dt),
               static_cast<const float*>(a),
               b,
               c,
               dy,
               static_cast<const float*>(states),
               dx,
               static_cast<float*>(ddt),
               static_cast<float*>(da),
               db,
               dc,
               static_cast<float*>(parts),
               static_cast<float*>(da_parts),
               static_cast<float*>(dstates),
               static_cast<int*>(sync),
               B, S, H, G, P, N, Q, dtype == 1 ? tc_cluster(H, G) : 1,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run_tc(args, s, nullptr) : launch_f32(args, s);
}

// How many clusters of the bf16 backward at (B, S, H, G, P, N, Q) fit on
// the current device at once (cudaOccupancyMaxActiveClusters), in *out.
extern "C" int mist_ssd_scan_bwd_occupancy(int B, int S, int H, int G, int P,
                                           int N, int Q, int* out) {
  if (!out || G < 1 || H % G || Q < 1 || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs args{};
  args.B = B;
  args.S = S;
  args.H = H;
  args.G = G;
  args.P = P;
  args.N = N;
  args.Q = Q;
  args.CL = tc_cluster(H, G);
  return run_tc(args, nullptr, out);
}
