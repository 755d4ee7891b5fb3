// Mamba2 SSD chunk scan for Hopper (sm_90a), written by hand.
//
// Replaces: src/repro/kernels/ssd_scan.py :: _ssd_kernel (the Pallas TPU
// kernel behind ssd_scan_pallas <- ops.ssd_scan <- models/ssm.ssd_chunked).
// Computes the same function: per chunk of Q steps,
//   cum   = cumsum(dt * a)                       (inclusive, in the chunk)
//   y     = ((C B^T) * exp(mask(cum_t - cum_s)) * dt_s) x  +  (C exp(cum)) h
//   h     = h * exp(cum[-1]) + (B * w)^T x,   w = exp(cum[-1] - cum) * dt
// with the causal mask applied BEFORE the exp (s > t never reaches the
// exp), the state h (N x P, f32) handed from each chunk to the next, and y
// rounded to x's dtype once.  Unlike the TPU kernel it also writes the
// final state hT as (B, H, P, N) f32 -- the layout of the reference's
// ssd_chunked and of the Mamba cache -- which the reference recomputes with
// its jnp path when a serving handoff needs it.
//
// What bounds it on an H100: at the serving prefill shape (B 4, S 1024,
// H 80, P 64, N 64, chunk 256, bf16, ssm_groups 1) the function moves
// 91.5 MB (x and y dominate) and does ~16 GFLOP (the causal half of the
// intra-chunk products): 27 us at 3.35 TB/s against 16 us at the bf16
// tensor-core rate, so bytes bound it -- if the products run on the
// tensor cores.  On the CUDA cores in f32 the same work needs ~230 us.
//
// The bf16 route (ssd_scan_tc_kernel), and what it does about that:
// - One block per work item (batch, head, chunk): 1,280 items at the
//   serving shape, not 320 serial walks over the chunks.  Everything an
//   item can do without the entering state runs first: the cumsum (a
//   block-wide scan), and its own chunk's state L = (B * w)^T x.
// - The state is handed along the chunks by a chain.  An item waits for
//   the state that leaves chunk c - 1 (a flag read with ld.acquire.gpu),
//   computes h_out = h_in exp(cum[-1]) + L in f32, and publishes it at once
//   (the state through an f32 scratch of (B, H, nc - 1, N, P), then
//   st.release.gpu of its flag); the last chunk writes hT instead.  So the
//   chain's critical path is one elementwise pass over N x P per chunk.
//   Only then are y's products formed, from the chunk's x, B and C and the
//   entering state.  Forming L before the wait and y after it publishes
//   the state as early as possible and keeps one 16-row y tile live at a
//   time, so two blocks fit an SM.
// - No deadlock: a block takes its item from an atomic ticket, not from
//   blockIdx, and tickets run chunk-major (every chunk-0 item, then every
//   chunk-1 item, ...).  An item waits only on an item with a smaller
//   ticket, which some resident or finished block already holds.  The
//   wrapper zeroes the ticket counter and the flags (one torch.zeros) for
//   every call.  Each item's sums run in a fixed order whatever its
//   ticket, so two calls agree bit for bit.
// - Every product runs on the tensor cores: mma.sync m16n8k16, bf16
//   operands from ldmatrix (or from registers), f32 sums.  Where the
//   rounding goes:
//     C B^T              exact products: C and B are bf16 in the model.
//     scores x           scores = G * exp(cum_t - cum_s) * dt_s in f32,
//                        split into bf16 hi + lo (two products); x exact.
//                        Kept in registers: the m16n8 accumulator layout
//                        is the next product's A fragment.  One bf16
//                        rounding of the scores alone would put y past its
//                        bf16 tolerance against the f32 plain version at
//                        the serving distributions (the CPU tests rehearse
//                        both plans).
//     (B * w)^T x        B * w in f32, split into bf16 hi + lo: hT is held
//                        to 2e-4 in f32; x exact.
//     (C exp(cum)) h     C h_in with h_in split into bf16 hi + lo, each
//                        output row then scaled by exp(cum_t) in f32: the
//                        same function, with C exact.
//     state recurrence   f32 on the CUDA cores (N x P elements an item).
//   A split operand v = hi + lo keeps ~16 bits of v's 24; the products
//   are exact in f32 and summed in f32.
// - The exp trap: exp(cum_t - cum_s) is never factored into
//   exp(cum_t) exp(-cum_s) -- cum falls to about -180 over a chunk of 256
//   at the serving shape and exp(180) overflows f32.  Each score takes ex2
//   of its own difference in the log2 domain, 2^(ct - ls) with
//   ct = cum_t log2(e) and ls = cum_s log2(e) - log2(dt_s), which folds
//   dt_s into the exponent; the causal mask is applied before the ex2, and
//   only on the diagonal tile.
// - Loads: x and B of the chunk come in as bf16 rows by cp.async (16
//   bytes a thread; strided views of the conv output, row stride conv_dim,
//   so every base and stride must be 16-byte aligned -- the wrapper checks
//   it), into rows padded by 8 elements so that ldmatrix reads are free of
//   bank conflicts.  C is read per 16-row block straight into the A
//   fragments (it feeds only its own rows).  Rows past a ragged Q are
//   zeros with dt = 0, so any chunk up to the shared memory's limit works.
// - Work split: for L a warp takes one 16-row block of n and up to four
//   n8 tiles of p, so one split A fragment feeds four accumulators; for y
//   warp w takes the 16-row blocks w and 2W - 1 - w (then 2W + w,
//   4W - 1 - w, ...), so every warp gets the same number of key tiles
//   below the diagonal.  Warps issue in order, so each product group loads
//   its fragments first and then issues its MMAs hi-then-lo over
//   independent accumulators.  P and N are template arguments (16, 32, 48
//   or 64 each), so the fragment loops are straight-line code.
// Shared memory at chunk 256, P = N = 64: x and B (36 KB each, padded),
// h_in hi/lo (18 KB), cum / log2-offsets / w -- 95,280 bytes, two blocks
// per SM.  Chunk 512 takes 172,080 bytes, one block per SM.
//
// The f32 route (ssd_scan_f32_kernel) keeps the port's first CUDA-core
// kernel: a bf16 tensor core cannot hold f32 x to 2e-4 (x would need its
// own hi/lo split on top of every other), and f32 inputs are not on the
// model's path.  One block owns one (batch, head) and walks its chunks in
// order, with the f32 state in shared memory, which it also writes to the
// same scratch of states as the bf16 route when given one (the backward,
// csrc/ssd_scan_bwd.cu, reads the state entering each chunk); query and key rows go in
// 64-row tiles (only tiles on or below the diagonal), each thread of the
// 16 x 16 block owning a 4 x 4 register tile of every product.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB, a block's dynamic limit
constexpr int MAX_DIM = 64;       // the largest P and N either route takes

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* hT;
  float* states;  // the chain's (nc - 1, B, H, N, P) f32 (f32: optional)
  int* sync;      // bf16 route: ticket counter, then (nc - 1) x B x H flags
  int B, S, H, G, P, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

// ---------------------------------------------------------------------------
// bf16 route: tensor cores, chunks in parallel, the state handed along
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;
constexpr int TC_WARPS = 8;
constexpr int ROW_BLOCK = 16;  // rows of one m16n8k16 tile; Q is padded to it
constexpr int SMEM_PAD = 8;    // bf16 elements after every shared row
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int padded_rows(int Q) {
  return (Q + ROW_BLOCK - 1) / ROW_BLOCK * ROW_BLOCK;
}

// bytes of shared memory: x (Qp x P+8) and B (Qp x N+8) bf16, the entering
// state as bf16 hi and lo (2 x P x N+8), cum / log2 offsets / w (Qp f32
// each), the scan's warp sums and the ticket
__host__ __device__ inline int tc_smem_bytes(int Q, int P, int N) {
  const int Qp = padded_rows(Q);
  return 2 * (Qp * (P + SMEM_PAD) + Qp * (N + SMEM_PAD) +
              2 * P * (N + SMEM_PAD)) +
         4 * (3 * Qp + TC_WARPS + 4);
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ldmatrix on a shared-window address (smem_addr): x4 loads four 8 x 8
// bf16 matrices, the rows of matrix i addressed by lanes 8i..8i+7
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

// (v0, v1) -> bf16 pairs hi and lo with hi + lo ~ v (v0 in the low half)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - f.x, v1 - f.y));
}

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

// one score in the log2 domain: G * exp(cum_t - cum_s) * dt_s is
// G * 2^(ct - ls) with ct = cum_t log2(e) and ls = cum_s log2(e) - log2(dt_s)
// (dt_s = 0 gives ls = +inf and a score of 0); on the diagonal tile the
// causal mask is applied before the exp
__device__ __forceinline__ float score(float gv, float ct, float ls,
                                       bool keep) {
  return gv * ex2(keep ? ct - ls : -INFINITY);
}

// P and N are template arguments, so that every fragment loop and shared
// stride is a constant and each product runs straight-line
template <int P, int N>
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_scan_tc_kernel(const SsdArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = args.S, H = args.H, Q = args.Q;
  const int Qp = padded_rows(Q);
  constexpr int LX = P + SMEM_PAD, LB = N + SMEM_PAD;
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB = sX + Qp * LX;
  __nv_bfloat16* sHhi = sB + Qp * LB;  // entering state, [p][n]
  __nv_bfloat16* sHlo = sHhi + P * LB;
  float* sCum = reinterpret_cast<float*>(sHlo + P * LB);  // cum log2(e)
  float* sLs = sCum + Qp;  // log2-domain key offsets (dt on the way)
  float* sW = sLs + Qp;
  float* sWarp = sW + Qp;
  int* sTicket = reinterpret_cast<int*>(sWarp + TC_WARPS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int nc = S / Q, BH = args.B * H;

  // the work item: tickets run chunk-major, so a chunk's predecessor
  // always holds a smaller ticket
  if (tid == 0) *sTicket = atomicAdd(args.sync, 1);
  __syncthreads();
  const int ticket = *sTicket;
  const int c = ticket / BH, bh = ticket % BH, b = bh / H, h = bh % H;
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

  // x and B of the chunk by cp.async, 4 rows a warp at a time (8 lanes of
  // 16-byte vectors a row); padded rows are zeros
  constexpr int xv = P / 8, bv = N / 8;  // 16-byte vectors a row
  {
    const int v = lane & 7;
    for (int s = 4 * warp + (lane >> 3); s < Qp; s += 4 * TC_WARPS) {
      if (v < xv) {
        __nv_bfloat16* dst = sX + s * LX + 8 * v;
        if (s < Q)
          cp_async16(dst, xb + s * args.x_ss + 8 * v);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      if (v < bv) {
        __nv_bfloat16* dst = sB + s * LB + 8 * v;
        if (s < Q)
          cp_async16(dst, bb + s * args.b_ss + 8 * v);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  for (int i = tid; i < Qp; i += TC_THREADS)
    sLs[i] = i < Q ? dtb[i * args.dt_ss] : 0.f;  // dt, until the scan is done
  __syncthreads();

  // cum = inclusive cumsum of dt * a: each thread a run of rows, then a
  // scan of the runs' sums across the block
  const int per = (Qp + TC_THREADS - 1) / TC_THREADS;
  const int i0 = tid * per;
  {
    float run = 0.f;
    for (int k = 0; k < per; ++k)
      if (i0 + k < Qp) {
        run += sLs[i0 + k] * a;
        sCum[i0 + k] = run;
      }
    float v = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) sWarp[warp] = v;
    __syncthreads();
    float carry = v - run;
    for (int w = 0; w < warp; ++w) carry += sWarp[w];
    for (int k = 0; k < per; ++k)
      if (i0 + k < Qp) sCum[i0 + k] += carry;
  }
  __syncthreads();
  const float cum_last = sCum[Qp - 1];  // padded rows add dt = 0
  __syncthreads();
  // w = exp(cum[-1] - cum) dt for the state; cum and dt move to the log2
  // domain of the scores: sCum = cum log2(e), sLs = sCum - log2(dt)
  for (int k = 0; k < per; ++k)
    if (i0 + k < Qp) {
      const float cum = sCum[i0 + k], dt = sLs[i0 + k];
      sW[i0 + k] = expf(cum_last - cum) * dt;
      sCum[i0 + k] = cum * LOG2E;
      sLs[i0 + k] = cum * LOG2E - log2f(dt);
    }
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix lane offsets: lanes 8i..8i+7 address matrix i.  "rows" walks
  // rows 0-7, 0-7, 8-15, 8-15 and columns 0, 8, 0, 8 (a 16 x 16 tile as
  // A fragment, or as two n8 B fragments when the rows are n); "cols" walks
  // rows 0-7, 8-15, 0-7, 8-15 and columns 0, 0, 8, 8 (a k16 x n16 tile
  // stored k-major, transposed to two n8 B fragments)
  const int rows_r = (lane & 7) + (lane >> 4) * 8, rows_c = (lane & 8);
  const int cols_r = (lane & 7) + (lane & 8), cols_c = (lane >> 4) * 8;
  const uint32_t sB_rows = smem_addr(sB + rows_r * LB + rows_c);
  const uint32_t sX_cols = smem_addr(sX + cols_r * LX + cols_c);
  const uint32_t sH_rows = smem_addr(sHhi + rows_r * LB + rows_c);
  constexpr uint32_t B_step = 16 * LB * 2, X_step = 16 * LX * 2;  // 16 rows
  constexpr uint32_t H_lo = P * LB * 2;  // sHlo - sHhi

  // L = (B * w)^T x: (N x Q) (Q x P) in m16n8 tiles of (n, p).  A warp
  // takes one 16-row block of n and up to four neighbouring n8 tiles of p,
  // so the A fragment of B * w (split into bf16 hi + lo) is formed once per
  // k step and feeds four independent accumulators
  constexpr int nt8 = P / 8, nk = N / 16;
  const int nks = Qp / 16;
  constexpr int wpr = TC_WARPS / nk;          // warps per 16 rows of n
  const int l_rn = warp / wpr;                // >= nk: no L work
  constexpr int l_cnt = (nt8 + wpr - 1) / wpr;  // p tiles a warp, <= 4
  const int l_pc0 = (warp % wpr) * l_cnt;
  const int l_tiles = l_rn < nk ? max(0, min(l_cnt, nt8 - l_pc0)) : 0;
  const uint32_t sX_x2 = smem_addr(sX + cols_r * LX);  // lanes 0-15 used
  float lacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) lacc[j][e] = 0.f;
  if (l_tiles > 0) {
#pragma unroll 2
    for (int ks = 0; ks < nks; ++ks) {
      const float2 w0 =
          *reinterpret_cast<const float2*>(sW + 16 * ks + 2 * t4);
      const float2 w1 =
          *reinterpret_cast<const float2*>(sW + 16 * ks + 8 + 2 * t4);
      uint32_t af[4], ahi[4], alo[4], xf[4][2];
      ldsm_x4_t(af, sB_rows + ks * B_step + 32 * l_rn);  // B^T as A
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < l_tiles)
          ldsm_x2_t(xf[j][0], xf[j][1],
                    sX_x2 + ks * X_step + 16 * (l_pc0 + j));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = unpack(af[e]);
        const float2 w = e < 2 ? w0 : w1;
        split2(v.x * w.x, v.y * w.y, ahi[e], alo[e]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < l_tiles) mma(lacc[j], ahi, xf[j][0], xf[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < l_tiles) mma(lacc[j], alo, xf[j][0], xf[j][1]);
    }
  }

  // the chain: wait for the state leaving chunk c - 1
  if (c > 0) {
    if (tid == 0) {
      const int* flag = args.sync + 1 + (c - 1) * BH + bh;
      while (ld_acquire(flag) == 0) __nanosleep(64);
    }
    __syncthreads();
  }
  // h_out = h_in exp(cum[-1]) + L, published at once; h_in goes to shared
  // memory as bf16 hi + lo for y's C h_in
  constexpr long long NP = static_cast<long long>(N) * P;
  const float dec = expf(cum_last);
  const float* h_in =
      c > 0 ? args.states + ((c - 1) * static_cast<long long>(BH) + bh) * NP
            : nullptr;
  float* h_out =
      c < nc - 1 ? args.states + (c * static_cast<long long>(BH) + bh) * NP
                 : nullptr;
  float* hTb = args.hT + bh * NP;  // (B, H, P, N)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= l_tiles) continue;
    const int p = 8 * (l_pc0 + j) + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = 16 * l_rn + g + 8 * r;
      float2 hv = make_float2(0.f, 0.f);
      if (c > 0) {
        hv = __ldcg(reinterpret_cast<const float2*>(h_in + n * P + p));
        uint32_t hi, lo;
        split2(hv.x, hv.y, hi, lo);
        const __nv_bfloat162 hi2 = *reinterpret_cast<__nv_bfloat162*>(&hi);
        const __nv_bfloat162 lo2 = *reinterpret_cast<__nv_bfloat162*>(&lo);
        sHhi[p * LB + n] = hi2.x;
        sHhi[(p + 1) * LB + n] = hi2.y;
        sHlo[p * LB + n] = lo2.x;
        sHlo[(p + 1) * LB + n] = lo2.y;
      }
      const float o0 = hv.x * dec + lacc[j][2 * r];
      const float o1 = hv.y * dec + lacc[j][2 * r + 1];
      if (c < nc - 1) {
        __stcg(reinterpret_cast<float2*>(h_out + n * P + p),
               make_float2(o0, o1));
      } else {
        hTb[p * N + n] = o0;
        hTb[(p + 1) * N + n] = o1;
      }
    }
  }
  __syncthreads();  // the state is out, and sHhi / sHlo are written
  if (tid == 0 && c < nc - 1) {
    __threadfence();  // cumulative: the block's stores, seen through the
    st_release(args.sync + 1 + c * BH + bh, 1);  // barrier, then the flag
  }

  // y, one 16-row block at a time: exp(cum_t) (C h_in) + scores x
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(args.y) +
                      ((static_cast<long long>(b) * S + c0) * H + h) * P;
  const long long y_ss = static_cast<long long>(H) * P;
  const int nrb = Qp / ROW_BLOCK;
  const int rounds = 2 * ((nrb + 2 * TC_WARPS - 1) / (2 * TC_WARPS));
  for (int k = 0; k < rounds; ++k) {
    const int rb = (k / 2) * 2 * TC_WARPS +
                   (k % 2 == 0 ? warp : 2 * TC_WARPS - 1 - warp);
    if (rb >= nrb) continue;
    const int t_lo = ROW_BLOCK * rb + g, t_hi = t_lo + 8;

    // C's A fragments straight from global memory (zeros past Q)
    uint32_t cf[4][4];
    const uint32_t* c_lo =
        reinterpret_cast<const uint32_t*>(cb + t_lo * args.c_ss);
    const uint32_t* c_hi =
        reinterpret_cast<const uint32_t*>(cb + t_hi * args.c_ss);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int col = 8 * kk + t4;  // in bf16 pairs: n = 16 kk + 2 t4
      const bool on = kk < nk;
      cf[kk][0] = on && t_lo < Q ? __ldg(c_lo + col) : 0u;
      cf[kk][1] = on && t_hi < Q ? __ldg(c_hi + col) : 0u;
      cf[kk][2] = on && t_lo < Q ? __ldg(c_lo + col + 4) : 0u;
      cf[kk][3] = on && t_hi < Q ? __ldg(c_hi + col + 4) : 0u;
    }
    const float ct_lo = sCum[t_lo], ct_hi = sCum[t_hi];

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    if (c > 0) {
      // hi, then lo: eight independent accumulators between two products
      // into the same one
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nk) continue;
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          uint32_t hf[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < P / 16)
              ldsm_x4(hf[q], sH_rows + part * H_lo + q * B_step + 32 * kk);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < P / 16) {
              mma(acc[2 * q], cf[kk], hf[q][0], hf[q][1]);
              mma(acc[2 * q + 1], cf[kk], hf[q][2], hf[q][3]);
            }
        }
      }
      const float e_lo = exp2f(ct_lo), e_hi = exp2f(ct_hi);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e_lo;
        acc[j][1] *= e_lo;
        acc[j][2] *= e_hi;
        acc[j][3] *= e_hi;
      }
    }

    // intra-chunk: one 16-key tile; the causal mask only on the diagonal
    auto key_tile = [&](const int kb, const bool diag) {
      // G = C B^T over N, even and odd k steps in separate accumulators
      float gacc[2][2][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[h2][jj][e] = 0.f;
      uint32_t bf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) ldsm_x4(bf[kk], sB_rows + kb * B_step + 32 * kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) {
          mma(gacc[kk & 1][0], cf[kk], bf[kk][0], bf[kk][1]);
          mma(gacc[kk & 1][1], cf[kk], bf[kk][2], bf[kk][3]);
        }
      uint32_t xf[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < P / 16) ldsm_x4_t(xf[q], sX_cols + kb * X_step + 32 * q);
      // scores in f32, split to bf16 hi + lo A fragments in registers
      uint32_t shi[4], slo[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int sc = 8 * jj + 2 * t4;  // key column in the tile
        const float2 ls =
            *reinterpret_cast<const float2*>(sLs + ROW_BLOCK * kb + sc);
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[e] = gacc[0][jj][e] + gacc[1][jj][e];
        split2(score(gv[0], ct_lo, ls.x, !diag || sc <= g),
               score(gv[1], ct_lo, ls.y, !diag || sc + 1 <= g),
               shi[2 * jj], slo[2 * jj]);
        split2(score(gv[2], ct_hi, ls.x, !diag || sc <= g + 8),
               score(gv[3], ct_hi, ls.y, !diag || sc + 1 <= g + 8),
               shi[2 * jj + 1], slo[2 * jj + 1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < P / 16) {
          mma(acc[2 * q], shi, xf[q][0], xf[q][1]);
          mma(acc[2 * q + 1], shi, xf[q][2], xf[q][3]);
        }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < P / 16) {
          mma(acc[2 * q], slo, xf[q][0], xf[q][1]);
          mma(acc[2 * q + 1], slo, xf[q][2], xf[q][3]);
        }
    };
    for (int kb = 0; kb < rb; ++kb) key_tile(kb, false);
    key_tile(rb, true);

    // y rounded to bf16 once
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= nt8) continue;
      const int p = 8 * j + 2 * t4;
      if (t_lo < Q)
        *reinterpret_cast<__nv_bfloat162*>(yb + t_lo * y_ss + p) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      if (t_hi < Q)
        *reinterpret_cast<__nv_bfloat162*>(yb + t_hi * y_ss + p) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA cores, one block per (batch, head)
// ---------------------------------------------------------------------------

constexpr int NUM_THREADS = 256;  // 16 x 16
constexpr int TILE = 64;          // query / key rows per tile; max P and N

// floats of shared memory: x (Q x P), B (Q x N+1), a C tile (64 x N+1), a
// score tile (64 x 65), the state (N x P), and cum / dt / w (Q each)
__host__ __device__ inline long long smem_floats(int Q, int P, int N) {
  return static_cast<long long>(Q) * P + static_cast<long long>(Q) * (N + 1) +
         TILE * (N + 1) + TILE * (TILE + 1) + N * P + 3LL * Q;
}

__global__ void __launch_bounds__(NUM_THREADS)
ssd_scan_f32_kernel(const SsdArgs args) {
  extern __shared__ __align__(16) float smem[];
  const int S = args.S, H = args.H, P = args.P, N = args.N, Q = args.Q;
  const int LB = N + 1, LS = TILE + 1;
  float* sX = smem;
  float* sB = sX + Q * P;
  float* sC = sB + Q * LB;
  float* sS = sC + TILE * LB;
  float* sH = sS + TILE * LS;
  float* sCum = sH + N * P;
  float* sDt = sCum + Q;
  float* sW = sDt + Q;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / args.G);
  const float a = args.a[h];

  const float* xb =
      static_cast<const float*>(args.x) + b * args.x_sb + h * args.x_sh;
  const float* dtb = args.dt + b * args.dt_sb + h * args.dt_sh;
  const float* bb =
      static_cast<const float*>(args.b) + b * args.b_sb + g * args.b_sg;
  const float* cb =
      static_cast<const float*>(args.c) + b * args.c_sb + g * args.c_sg;
  // y is contiguous (B, S, H, P)
  float* yb = static_cast<float*>(args.y) +
              (static_cast<long long>(b) * S * H + h) * P;
  const long long y_ss = static_cast<long long>(H) * P;

  // this thread's columns over P and rows over N, clamped for the reads
  // (the writes check the bounds)
  int pc[4], nc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pc[j] = min(tx + 16 * j, P - 1);
    nc[j] = min(ty + 16 * j, N - 1);
  }

  for (int i = tid; i < N * P; i += NUM_THREADS) sH[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < Q * P; i += NUM_THREADS) {
      const int s = i / P, p = i % P;
      sX[i] = xb[(c0 + s) * args.x_ss + p];
    }
    for (int i = tid; i < Q * N; i += NUM_THREADS) {
      const int s = i / N, n = i % N;
      sB[s * LB + n] = bb[(c0 + s) * args.b_ss + n];
    }
    for (int i = tid; i < Q; i += NUM_THREADS)
      sDt[i] = dtb[(c0 + i) * args.dt_ss];
    __syncthreads();

    // cum = inclusive cumsum of dt * a over the chunk: one warp, 32 steps
    // at a time (shuffle scan) plus the carry
    if (warp == 0) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? sDt[i] * a : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (i < Q) sCum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int i = tid; i < Q; i += NUM_THREADS)
      sW[i] = expf(cum_last - sCum[i]) * sDt[i];

    for (int t0 = 0; t0 < Q; t0 += TILE) {
      __syncthreads();  // the C and score tiles are free
      for (int i = tid; i < TILE * N; i += NUM_THREADS) {
        const int r = i / N, n = i % N;
        sC[r * LB + n] =
            t0 + r < Q ? cb[(c0 + t0 + r) * args.c_ss + n] : 0.f;
      }
      __syncthreads();

      float t_cum[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        t_cum[i] = t < Q ? sCum[t] : 0.f;
      }

      // intra-chunk: key tiles on or below the diagonal
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const int s_end = min(Q, t0 + TILE);
      for (int s0 = 0; s0 < s_end; s0 += TILE) {
        const int s_cnt = min(TILE, s_end - s0);
        // G = C B^T over N (keys past s_cnt read finite smem; masked below)
        float gacc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gacc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LB + n];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = sB[min(s0 + tx + 16 * j, Q - 1) * LB + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              gacc[i][j] = fmaf(cv[i], bv[j], gacc[i][j]);
        }
        // scores = G * exp(cum_t - cum_s) * dt_s, masked before the exp
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float v = 0.f;
            if (s <= t && t < Q)
              v = gacc[i][j] * expf(t_cum[i] - sCum[s]) * sDt[s];
            sS[(ty + 16 * i) * LS + tx + 16 * j] = v;
          }
        }
        __syncthreads();
        // y += scores x
        for (int k = 0; k < s_cnt; ++k) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = sS[(ty + 16 * i) * LS + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = sX[(s0 + k) * P + pc[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
        __syncthreads();
      }

      // inter-chunk: (C exp(cum)) h, from the state entering the chunk
      float acc2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LB + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = sH[n * P + pc[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc2[i][j] = fmaf(cv[i], hv[j], acc2[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= Q) continue;
        const float e = expf(t_cum[i]);
        float* yrow = yb + (c0 + t) * y_ss;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = acc[i][j] + acc2[i][j] * e;
        }
      }
    }

    // state update: h = h * exp(cum[-1]) + (B * w)^T x
    __syncthreads();  // every read of the entering state is done
    float hacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) hacc[i][j] = 0.f;
    for (int s = 0; s < Q; ++s) {
      const float w = sW[s];
      float bw[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bw[i] = sB[s * LB + nc[i]] * w;
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = sX[s * P + pc[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hacc[i][j] = fmaf(bw[i], xv[j], hacc[i][j]);
    }
    const float dec = expf(cum_last);
    // the state leaving every chunk but the last also goes to the scratch
    // the backward reads, (nc - 1, B, H, N, P) as the bf16 route writes it
    float* h_out =
        args.states && c0 + Q < S
            ? args.states + ((c0 / Q) * static_cast<long long>(args.B * H) +
                             blockIdx.x) * N * P
            : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (n < N && p < P) {
          const float v = sH[n * P + p] * dec + hacc[i][j];
          sH[n * P + p] = v;
          if (h_out) h_out[n * P + p] = v;
        }
      }
    }
  }

  __syncthreads();
  float* hb = args.hT + (static_cast<long long>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += NUM_THREADS) {
    const int p = i / N, n = i % N;
    hb[i] = sH[n * P + p];
  }
}

int launch_f32(const SsdArgs& args, cudaStream_t stream) {
  const long long smem = smem_floats(args.Q, args.P, args.N) * 4;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_f32_kernel<<<args.B * args.H, NUM_THREADS, static_cast<int>(smem),
                        stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, long long s0, long long s1, long long s2) {
  // strides in bf16 elements: 8 elements are 16 bytes
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

template <int P, int N>
int launch_tc_pn(const SsdArgs& args, int smem, cudaStream_t stream) {
  static bool configured = false;  // the attributes hold for the process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_tc_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_scan_tc_kernel<P, N>,
          cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long items =
      static_cast<long long>(args.B) * args.H * (args.S / args.Q);
  ssd_scan_tc_kernel<P, N><<<static_cast<unsigned>(items), TC_THREADS, smem,
                             stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_tc_p(const SsdArgs& args, int smem, cudaStream_t stream) {
  switch (args.N) {
    case 16:
      return launch_tc_pn<P, 16>(args, smem, stream);
    case 32:
      return launch_tc_pn<P, 32>(args, smem, stream);
    case 48:
      return launch_tc_pn<P, 48>(args, smem, stream);
    case 64:
      return launch_tc_pn<P, 64>(args, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_tc(const SsdArgs& args, cudaStream_t stream) {
  const int smem = tc_smem_bytes(args.Q, args.P, args.N);
  if (smem > MAX_SMEM || !args.sync || (args.S > args.Q && !args.states) ||
      !aligned16(args.x, args.B > 1 ? args.x_sb : 0, args.x_ss,
                 args.H > 1 ? args.x_sh : 0) ||
      !aligned16(args.b, args.B > 1 ? args.b_sb : 0, args.b_ss,
                 args.G > 1 ? args.b_sg : 0) ||
      !aligned16(args.c, args.B > 1 ? args.c_sb : 0, args.c_ss,
                 args.G > 1 ? args.c_sg : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // the P / N menu (TC_DIMS in the wrapper)
  switch (args.P) {
    case 16:
      return launch_tc_p<16>(args, smem, stream);
    case 32:
      return launch_tc_p<32>(args, smem, stream);
    case 48:
      return launch_tc_p<48>(args, smem, stream);
    case 64:
      return launch_tc_p<64>(args, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (B, S, H, P) and b/c (B, S, G, N): bf16 (dtype 1) or f32 (dtype 0), the
// last dim contiguous, other strides in elements; G divides H.  dt (B, S, H)
// f32 with strides; a (H,) f32.  y (B, S, H, P) in x's dtype and hT
// (B, H, P, N) f32 are contiguous.  S % Q == 0, P and N <= 64.
// bf16 runs the tensor-core kernel: P and N multiples of 16, x/b/c bases and
// strides 16-byte aligned, `states` an f32 scratch of (S/Q - 1, B, H, N, P)
// and `sync` 1 + (S/Q - 1) B H int32 zeros.  f32 runs the CUDA-core kernel
// (a bf16 tensor core cannot hold f32 x to 2e-4), ignores `sync` and writes
// the same states when `states` is not null.  The states are chunk-major:
// the state leaving chunk c (entering c + 1) of item (b, h) starts at
// ((c B + b) H + h) N P.
// Returns cudaGetLastError() after the launch.
extern "C" int mist_ssd_scan(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* hT, void* states, void* sync, int B, int S,
    int H, int G, int P, int N, int Q, int dtype, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, void* stream) {
  if (P < 1 || P > MAX_DIM || N < 1 || N > MAX_DIM || Q < 1 || S % Q ||
      G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs args{x,     static_cast<const float*>(dt),
               static_cast<const float*>(a),
               b,     c,     y,     static_cast<float*>(hT),
               static_cast<float*>(states), static_cast<int*>(sync),
               B,     S,     H,     G,     P,     N,     Q,
               x_sb,  x_ss,  x_sh,  dt_sb, dt_ss, dt_sh,
               b_sb,  b_ss,  b_sg,  c_sb,  c_ss,  c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(args, s);
    case 1:
      return launch_tc(args, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
