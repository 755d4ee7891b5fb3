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
// dt and the forward's f32 states and writes dx, dB, dC and ddt: ~147 MB,
// 44 us at 3.35 TB/s.  Its products (the causal half of G, dS, dx, dB and
// dC over each chunk, and four Q x N x P state products) are ~38 GFLOP:
// 38 us at the bf16 tensor-core rate, so bytes bound the function.  This
// first kernel runs every product on the CUDA cores in f32 (~48 GFLOP with
// G and dS formed twice, 0.72 ms at the 67 TFLOP/s f32 rate): it is right
// and simple, not fast.
//
// Design:
// - One block per work item (batch, head, chunk), taken from an atomic
//   ticket in REVERSE chunk-major order (every last-chunk item first).  dH
//   goes from chunk to chunk backwards through an f32 scratch (nc - 1, B,
//   H, N, P) and a flag per item, the forward's chain walked the other
//   way: an item forms its own part of dH_in (sum_t exp(cum_t) C_t dy_t^T)
//   first, waits for dH of the chunk after it (ld.acquire.gpu), publishes
//   dH_in at once (st.release.gpu) and only then forms the rest.  An item
//   waits only on an item with a smaller ticket, held by a resident or a
//   finished block, so the chain cannot deadlock; the wrapper zeroes the
//   ticket and the flags for every call.
// - The chunk's x, dy, B and C stay in shared memory in their own dtype
//   (rows padded to whole 64-row tiles with zeros and dt = 0, so any chunk
//   that fits works), with the f32 vectors over its rows (cum, dt, the two
//   exps, the row and column sums of M, ddt's direct part, dy.y_inter, u),
//   H_in and dH.  Every product is a 64 x 64 tile on a 16 x 16 thread grid,
//   each thread a 4 x 4 register tile, summed in f32 in a fixed order.
//   Pass A walks the row tiles t and, for every column tile s <= t, forms
//   G and dS, W = dS L dt_s (through a shared 64 x 65 tile) and dC_t;
//   pass B walks the column tiles s and, for every t >= s, forms them
//   again and dx_s and dB_s from the scores and W.  Row sums reduce over
//   the 16 lanes of a half-warp by shuffles, column sums through a shared
//   16 x 64 tile: each in one fixed order.
// - dB and dC are shared by the H / G heads of a group: each item writes
//   its f32 part per head to a scratch (2, B, S, H, N), and a second kernel
//   sums the parts of each group in head order and rounds once; da's part
//   per item goes to a (B, H, nc) scratch that the same kernel sums in
//   order.  No float atomics: two calls give the same bits.
// Shared memory at chunk 256, P = N = 64, bf16: 219,200 bytes, one block
// per SM; f32 inputs fit chunks up to 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB, a block's dynamic limit
constexpr int MAX_DIM = 64;       // the largest P and N
constexpr int THREADS = 256;      // 16 x 16
constexpr int TILE = 64;          // rows of a square tile
constexpr int WARPS = THREADS / 32;
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
  float* parts;           // (2, B, S, H, N): dB and dC per head
  float* da_parts;        // (B, H, nc)
  float* dstates;         // (nc - 1, B, H, N, P): the chain of dH
  int* sync;              // ticket counter, then (nc - 1) x B x H flags
  int B, S, H, G, P, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// elements of padding after every shared row of x, dy, B and C: rows of
// 64 elements then start 33 (bf16) or 65 (f32) words apart, so the 16
// rows a half-warp reads at one column fall in 16 banks
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return sizeof(T) == 2 ? 2 : 1;
}

__host__ __device__ inline int tile_rows(int Q) {
  return (Q + TILE - 1) / TILE * TILE;
}

// bytes of shared memory (bwd_smem_bytes in the wrapper): x, dy, B and C
// (Qp rows each), nine f32 vectors of Qp, two 64 x 65 f32 tiles, the
// 2 x 16 x 64 column partials, H_in and dH (N x P+1 each), and 16 words of
// block scratch
template <typename T>
__host__ __device__ inline long long bwd_smem_bytes(int Q, int P, int N) {
  const long long Qp = tile_rows(Q);
  constexpr int PAD = row_pad<T>();
  return static_cast<long long>(sizeof(T)) * 2 * Qp * (P + PAD + N + PAD) +
         4LL * (9 * Qp + 2 * TILE * (TILE + 1) + 2 * 16 * TILE +
                2LL * N * (P + 1) + 16);
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

// the sum over the 16 lanes of a half-warp (lanes tx = 0..15 of one ty)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// the sum over a warp, lane 0's in one fixed order, given to every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return __shfl_sync(FULL, v, 0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_kernel(const BwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PAD = row_pad<T>();
  const int S = args.S, H = args.H, P = args.P, N = args.N, Q = args.Q;
  const int Qp = tile_rows(Q);
  const int LP = P + PAD, LN = N + PAD, LH = P + 1, LT = TILE + 1;
  T* sX = reinterpret_cast<T*>(smem_raw);
  T* sDY = sX + Qp * LP;
  T* sB = sDY + Qp * LP;
  T* sC = sB + Qp * LN;
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
  const T* xb = static_cast<const T*>(args.x) + b * args.x_sb +
                h * args.x_sh + c0 * args.x_ss;
  const T* bb = static_cast<const T*>(args.b) + b * args.b_sb +
                grp * args.b_sg + c0 * args.b_ss;
  const T* cb = static_cast<const T*>(args.c) + b * args.c_sb +
                grp * args.c_sg + c0 * args.c_ss;
  const float* dtb = args.dt + b * args.dt_sb + h * args.dt_sh +
                     c0 * args.dt_ss;
  const long long row_hp = static_cast<long long>(H) * P;  // dy / dx rows
  const long long off_hp =
      (static_cast<long long>(b) * S + c0) * row_hp + static_cast<long long>(h) * P;
  const T* dyb = static_cast<const T*>(args.dy) + off_hp;
  T* dxb = static_cast<T*>(args.dx) + off_hp;
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
  const T zero = from_f<T>(0.f);
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
      cv[i] = to_f(sC[t * LN + min(ty + 16 * i, N - 1)]) * e;
#pragma unroll
    for (int j = 0; j < 4; ++j) yv[j] = to_f(sDY[t * LP + pp[j]]);
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
      for (int i = 0; i < 4; ++i) cv[i] = to_f(sC[(t0 + ty + 16 * i) * LN + n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = to_f(sB[(s0 + tx + 16 * j) * LN + n]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[i][j] = fmaf(cv[i], bv[j], gv[i][j]);
    }
    for (int p = 0; p < P; ++p) {
      float yv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        yv[i] = to_f(sDY[(t0 + ty + 16 * i) * LP + p]);
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = to_f(sX[(s0 + tx + 16 * j) * LP + p]);
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
        yv[i] = to_f(sDY[(t0 + ty + 16 * i) * LP + p]);
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
        if (tx + 16 * j < N) d = fmaf(to_f(sC[t * LN + tx + 16 * j]), accC[i][j], d);
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
        for (int j = 0; j < 4; ++j) bv[j] = to_f(sB[(s0 + k) * LN + nn[j]]);
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
      for (int i = 0; i < 4; ++i) bv[i] = to_f(sB[(s0 + ty + 16 * i) * LN + n]);
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
      for (int i = 0; i < 4; ++i) xv[i] = to_f(sX[(s0 + ty + 16 * i) * LP + p]);
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
        if (tx + 16 * j < N) v = fmaf(to_f(sB[s * LN + tx + 16 * j]), accB[i][j], v);
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
          yv[j] = to_f(sDY[(t0 + k) * LP + pp[j]]);
          cv[j] = to_f(sC[(t0 + k) * LN + nn[j]]);
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
        if (tx + 16 * j < P) dxb[s * row_hp + tx + 16 * j] = from_f<T>(accX[i][j]);
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

// dB and dC: each (b, s, g, n) the sum of its group's heads' parts in head
// order, rounded once; then da: each head the sum of its (b, chunk) parts
// in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const BwdArgs args) {
  const long long bsgn =
      static_cast<long long>(args.B) * args.S * args.G * args.N;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int rep = args.H / args.G;
  if (i < 2 * bsgn) {
    const int which = i >= bsgn;  // 0: dB, 1: dC
    const long long j = i - which * bsgn;
    const int n = static_cast<int>(j % args.N);
    const long long rest = j / args.N;
    const int g = static_cast<int>(rest % args.G);
    const long long bs = rest / args.G;
    const float* src =
        args.parts + which * (bsgn / args.G * args.H) +
        (bs * args.H + static_cast<long long>(g) * rep) * args.N + n;
    float sum = 0.f;
    for (int r = 0; r < rep; ++r) sum += src[static_cast<long long>(r) * args.N];
    static_cast<T*>(which ? args.dc : args.db)[j] = from_f<T>(sum);
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
int launch_bwd(const BwdArgs& args, cudaStream_t stream) {
  const long long smem = bwd_smem_bytes<T>(args.Q, args.P, args.N);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // the attribute holds for the process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long items =
      static_cast<long long>(args.B) * args.H * (args.S / args.Q);
  ssd_bwd_kernel<T><<<static_cast<unsigned>(items), THREADS,
                      static_cast<int>(smem), stream>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work =
      2LL * args.B * args.S * args.G * args.N + args.H;
  ssd_bwd_reduce_kernel<T><<<static_cast<unsigned>((work + THREADS - 1) /
                                                   THREADS),
                             THREADS, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The gradient of mist_ssd_scan's y.  x (B, S, H, P) and b/c (B, S, G, N):
// bf16 (dtype 1) or f32 (dtype 0), the last dim contiguous, other strides
// in elements, as the forward takes them; dt (B, S, H) f32 with strides;
// a (H,) f32.  dy, dx (B, S, H, P) contiguous in x's dtype; ddt (B, S, H)
// and da (H,) f32; db/dc (B, S, G, N) contiguous in b's dtype.  states:
// the forward's (S/Q - 1, B, H, N, P) f32 (entering states); scratch:
// parts (2, B, S, H, N) f32, da_parts (B, H, S/Q) f32, dstates like
// states, sync 1 + (S/Q - 1) B H int32 zeros.  S % Q == 0, P and N <= 64.
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
      G < 1 || H % G || !sync || (S > Q && (!states || !dstates)))
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
               B, S, H, G, P, N, Q,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(args, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(args, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
