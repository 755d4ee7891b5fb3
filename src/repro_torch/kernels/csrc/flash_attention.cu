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
//   S = Q K^T as m64nBNk16 (BN keys a tile, 128 or 64) with Q and K read
//   from shared memory through descriptors (K-major), and O += P V with P
//   from registers -- the S
//   accumulator re-packed to bf16 in place, since each warp's accumulator
//   layout is the A-fragment layout -- and V from shared memory, MN-major
//   (transposed).  No head dim is padded in the math.
// - One producer thread moves every tile by TMA.  Each copy lands on a
//   "full" mbarrier, and rows past the end of q, k or v are zero-filled by
//   the hardware.  Q is double-buffered, K tiles of BN keys ring through
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

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_M = 128;    // query rows per work item, 64 per warpgroup
constexpr int BLOCK_N = 128;    // keys per K/V tile at the plan's default:
                                // the kernel's template parameter BN, which
                                // the tile menu (kernels/tiles.py) also
                                // sets to 64
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

__host__ __device__ constexpr int tile_bytes(int rows, int hd) {
  return rows * hd * 2;
}
__host__ __device__ constexpr int smem_bytes(int hd, int bn) {
  return Q_STAGES * tile_bytes(BLOCK_M, hd) +
         (K_STAGES + V_STAGES) * tile_bytes(bn, hd) + 8 * N_BARS;
}

// TMA descriptors of q (boxes of 128 rows), k, v (BN rows) and o (64 rows, one
// warpgroup's): per tensor the panel of head_dim columns [0, 64) (or
// [0, 32) at hd 32), and at hd 80 the panel [64, 80)
struct alignas(64) Maps {
  CUtensorMap q[2], k[2], v[2], o[2];
};

// named barriers 1 and 2 (0 is __syncthreads) over the 256 consumer
// threads: warpgroup w waits on barrier 1 + w before it issues its
// products, and then lets the other warpgroup issue
__device__ __forceinline__ void wg_turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wg_turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
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

// work item -> its first query row, batch and head, heaviest causal first
__device__ __forceinline__ void decode_item(int item, int BH, int nq, int H,
                                            int& q0, int& b, int& h) {
  q0 = (nq - 1 - item / BH) * BLOCK_M;
  b = (item % BH) / H;
  h = (item % BH) % H;
}

template <int HD, int BN>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int B, int H, int KV, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int KSTEPS = HD / 16;       // k16 steps of Q K^T over head_dim
  constexpr int NT_O = HD / 8;          // 8-column chunks of O
  constexpr int NT_S = BN / 8;          // 8-column chunks of S
  constexpr int PSTEPS = BN / 16;       // k16 steps of P V over the key tile
  constexpr int TILE = tile_bytes(BLOCK_M, HD);   // a Q tile
  constexpr int KV_TILE = tile_bytes(BN, HD);     // a K or V tile

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);
  const uint32_t sK = sQ + Q_STAGES * TILE;
  const uint32_t sV = sK + K_STAGES * KV_TILE;
  // mbarriers, 8 bytes each: for every stage a "full" one (the producer's
  // copies landed) and an "empty" one (all 8 consumer warps are done)
  const uint32_t qfull = sV + V_STAGES * KV_TILE;
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
    return (kv_end + BN - 1) / BN;
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
          load_tile<HD, BN>(sK + ks * KV_TILE, maps.k, j * BN, h / group,
                            b, kfull + 8 * ks);
          mbar_wait(vempty + 8 * vs, ((g / V_STAGES) & 1) ^ 1);
          load_tile<HD, BN>(sV + vs * KV_TILE, maps.v, j * BN, h / group,
                            b, vfull + 8 * vs);
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
      const int k0 = j * BN;
      const int ks = g % K_STAGES;
      const int vp = (g + V_STAGES - 1) % V_STAGES;  // V of tile g - 1
      mbar_wait(kfull + 8 * ks, (g / K_STAGES) & 1);
      if (j > 0) mbar_wait(vfull + 8 * vp, ((g - 1) / V_STAGES) & 1);
      const uint32_t kt = sK + ks * KV_TILE, vt = sV + vp * KV_TILE;
      wg_turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss<BN>(s, kmajor_desc<HD, BLOCK_M>(qt, wg * 64, kk),
                     kmajor_desc<HD, BN>(kt, 0, kk), kk > 0);
      wgmma_commit();
      if (j > 0) {
#pragma unroll
        for (int kk = 0; kk < PSTEPS; ++kk)
          pv_product<HD, BN>(acc, pa[kk], vt, kk);
      }
      wgmma_commit();
      wg_turn_pass(wg);
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      release(kempty + 8 * ks, true);

      float alpha[2];
      if (c <= 0.f || k0 + BN > Sk || (causal && k0 + BN - 1 > qg))
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
    // O += P V of the last tile.  Causal: where its keys from BN / 2 on lie
    // past every row of this warpgroup (the first warpgroup's diagonal
    // tile at BN 128, its last tile at BN 64), their P is 0 and only the
    // first BN / 2 keys are multiplied.
    if (n_tiles > 0) {
      const int vp = (g + V_STAGES - 1) % V_STAGES;
      mbar_wait(vfull + 8 * vp, ((g - 1) / V_STAGES) & 1);
      const uint32_t vt = sV + vp * KV_TILE;
      wgmma_fence();
      if (causal && (n_tiles - 1) * BN + BN / 2 >= qg + 64) {
#pragma unroll
        for (int kk = 0; kk < PSTEPS / 2; ++kk)
          pv_product<HD, BN>(acc, pa[kk], vt, kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < PSTEPS; ++kk)
          pv_product<HD, BN>(acc, pa[kk], vt, kk);
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


template <int HD, int BN>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int KV, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes(HD, BN);
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
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
      !make_maps(maps.k, k, B, Sk, KV, HD, k_sb, k_ss, k_sh, BN) ||
      !make_maps(maps.v, v, B, Sk, KV, HD, v_sb, v_ss, v_sh, BN) ||
      !make_maps(maps.o, o, B, Sq, H, HD, o_ss * Sq, o_ss, HD, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int items = ((Sq + BLOCK_M - 1) / BLOCK_M) * B * H;
  const int grid = items < sms ? items : sms;
  flash_fwd_kernel<HD, BN><<<grid, NUM_THREADS, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, H,
      KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bn(int bn, const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int Sq, int Sk, int H, int KV,
              long long q_sb, long long q_ss, long long q_sh, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
              long long v_sh, float scale, int causal, cudaStream_t s) {
  switch (bn) {
    case 64:
      return launch<HD, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb, q_ss,
                            q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                            causal, s);
    case BLOCK_N:
      return launch<HD, BLOCK_N>(q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb,
                                 q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                 v_sh, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd): bf16, strides in elements, the
// head_dim stride 1.  o (B, Sq, H, hd) bf16 and lse (B, H, Sq) f32 are
// contiguous.  block_n: keys per K/V tile, 64 or 128.  Returns
// cudaGetLastError() after the launch.
extern "C" int mist_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int causal,
    int block_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_bn<32>(block_n, q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb,
                           q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                           scale, causal, s);
    case 64:
      return launch_bn<64>(block_n, q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb,
                           q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                           scale, causal, s);
    case 80:
      return launch_bn<80>(block_n, q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb,
                           q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                           scale, causal, s);
    case 128:
      return launch_bn<128>(block_n, q, k, v, o, lse, B, Sq, Sk, H, KV, q_sb,
                            q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
