// Flash-attention backward for Hopper (sm_90a), written by hand.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py ::
// _fa_kernel, which the reference takes through jax.custom_vjp
// (kernels/ops.py:109-144) with the blocked jnp backward _blocked_bwd
// (ops.py:75-106).  Computes the same function: from q, k, v, o, dO and the
// forward's natural-log lse, delta = rowsum(dO * O) in f32, P = exp(S * scale
// - lse) with S = q k^T summed in f32 and the causal mask q pos >= k pos
// (both counted from 0), then dV = P^T dO with P rounded to bf16, dP = dO V^T
// in f32, dS = P * (dP - delta) * scale rounded to bf16, dK = dS^T q and
// dQ = dS k, every product summed in f32 and each output rounded to bf16
// once.  GQA: the H / KV query heads of one KV head add into its dK and dV
// in f32, in registers.
//
// What bounds it on an H100: tensor-core operations.  At granite's training
// shape (B 1, S 4096, H 32, KV 8, hd 128, causal) the five products take
// 343.7 GFLOP against ~100 MB of traffic, far above the ~295 FLOP/byte bf16
// ridge: 0.3475 ms at 989 TFLOP/s.
//
// What the design does about that (the FlashAttention-3 backward, kept
// deterministic):
// - One pass over the keys, 5 products: a block owns BN keys of one
//   (batch, KV head), BN = 128 or 64 (the kernel's template parameter, the
//   tile menu of kernels/tiles.py; 128 unless the plan asks for 64); each of
//   its BN / 64 consumer warpgroups holds dK and dV of 64 keys in f32
//   registers.  The block walks the query tiles of 64 rows at
//   or after its keys (causal), last tile first, and in each all H / KV
//   query heads of the group.  Per (key tile, query tile) every warpgroup
//   forms S^T = K q^T and dP^T = V dO^T (wgmma, both operands in shared
//   memory), then P^T and dS^T in registers (exp in the log2 domain, as the
//   forward).  dS^T goes to shared memory in bf16 and P^T is re-packed in
//   place to bf16 A fragments for dV += P^T dO (wgmma RS, dO MN-major).
//   Both warpgroups read the dS^T tile: dQ = dS K over the block's BN keys
//   (SS, both operands MN-major; each warpgroup one 64-column head_dim panel
//   of K, at hd 64 and 32 the first alone, and at BN 64 the one warpgroup
//   every panel in turn), then dK += dS^T q over their own rows (SS, q
//   MN-major), so the dQ part is staged while dK runs.
// - A producer warpgroup hands its registers to the consumers (setmaxnreg:
//   a block launches with 168 a thread, 64,512 in all, and 24 x 128 +
//   240 x 256 fits them; at BN 64 a block of 256 threads launches with as
//   many registers as a thread can have, and no warpgroup hands any over).  One thread loads K and V once and the q and dO
//   tiles, with their rows of lse and delta, by TMA through a ring of
//   Q_STAGES on full/empty mbarriers, so the next tile's loads overlap this
//   tile's products.  A second thread writes dQ out (below).
// - dQ without a second pass, and deterministic: the consumers stage each
//   dQ part (64 rows, f32) in shared memory, and the writer thread adds it
//   into an f32 dq_accum (B, Sq, H, hd) with a TMA store (key tile 0) or a
//   TMA reduce-add (the others), in ascending key-tile order: it waits, with
//   acquire loads, until the counter of its (batch, head, query tile) equals
//   its key tile's index n (the number of key tiles before it, all of which
//   reach every query tile that it reaches), frees the stage once the copy
//   has read it, waits for the copy to complete, and bumps the counter with
//   release semantics.  No add is unordered, so two calls agree bit for bit.
// - No deadlock: a block waits only on blocks of smaller key tiles of its
//   (batch, KV head), which never wait on it.  So every block a block waits
//   on must have started before it.  Laying the grid out with key tiles
//   varying slowest in blockIdx would give that only if the hardware
//   dispatched blocks in blockIdx order; instead a block takes its (key
//   tile, batch, KV head) from an atomic ticket, key-tile-major (every key
//   tile 0 first, the heaviest under causal masking): the blocks it waits
//   on hold smaller tickets, taken by blocks already running.  The ticket
//   decides only which block computes which tile, not any result.  Blocks
//   of one (batch, KV head) walk the query tiles in the same order, so each
//   finds its predecessor ahead of it.
// - A pre-pass writes delta and lse * log2(e) in rows padded to whole query
//   tiles (padding rows: delta 0, lse +inf, so P = 0 there without a mask)
//   and zeroes the ticket and the counters; a post-pass rounds dq_accum to
//   bf16.  The wrapper allocates the scratch with torch.empty.
// - Registers: dK and dV of 64 keys (hd / 2 f32 each a thread), S^T and
//   dP^T of a 64-row query tile (32 each); the dQ part reuses dP^T's.
//   Query tiles of 64 keep every head dim inside the 240 a consumer thread
//   has, with no spill.  Shared memory: 230,480 bytes at hd 128.

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BLOCK_N = 128;    // keys per block at the plan's default: the
                                // kernel's template parameter BN, which the
                                // tile menu (kernels/tiles.py) also sets to
                                // 64 (one consumer warpgroup)
constexpr int BLOCK_M = 64;     // query rows per tile
constexpr int Q_STAGES = 2;     // q and dO tiles (with lse, delta) in the ring
constexpr int DS_STAGES = 2;    // dS^T tiles: the next tile's is written
                                // while the other warpgroup's dQ reads this
constexpr int DQ_STAGES = 2;    // f32 dQ parts on their way out
constexpr int CONSUMERS = 256;  // two warpgroups of 64 keys (at BLOCK_N)
// a block of bn keys: a consumer warpgroup for every 64, and a producer
// warpgroup
__host__ __device__ constexpr int consumers(int bn) {
  return CONSUMERS * bn / BLOCK_N;
}
__host__ __device__ constexpr int num_threads(int bn) {
  return consumers(bn) + 128;
}
// registers a thread after the producer hands its share to the consumers
// (BN 128; at BN 64 every thread keeps what it launched with)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
// mbarriers: K/V loaded; q/dO full and empty; dQ part full and empty
constexpr int N_BARS = 1 + 2 * Q_STAGES + 2 * DQ_STAGES;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int kv_tile_bytes(int bn, int hd) {
  return bn * hd * 2;
}
__host__ __device__ constexpr int q_tile_bytes(int hd) {
  return BLOCK_M * hd * 2;
}
__host__ __device__ constexpr int ds_tile_bytes(int bn) {
  return bn * BLOCK_M * 2;
}
__host__ __device__ constexpr int dq_tile_bytes(int hd) {
  return BLOCK_M * hd * 4;
}
__host__ __device__ constexpr int smem_bytes(int hd, int bn) {
  return 2 * kv_tile_bytes(bn, hd) + 2 * Q_STAGES * q_tile_bytes(hd) +
         DS_STAGES * ds_tile_bytes(bn) + DQ_STAGES * dq_tile_bytes(hd) +
         2 * Q_STAGES * BLOCK_M * 4 + 8 * N_BARS + 8;  // + the ticket
}

// TMA descriptors: q, dO (boxes of 64 rows), k, v (BN rows), each in its
// head_dim panels; dq_accum (f32, 64 rows) in panels of 32 columns (128-byte
// rows) and, at hd 80, one of 16
struct alignas(64) Maps {
  CUtensorMap q[2], k[2], v[2], dout[2], dq[2];
};

// The f32 dQ part of one tile (64 x HD) in shared memory as the TMA reads
// it: 32-column panels of 128-byte rows with the 128-byte swizzle, and at
// hd 80 a last panel of 16 columns (64-byte rows and swizzle).
template <int HD>
struct DqPanels {
  static constexpr int FULL = HD / 32;
  static constexpr int REST = HD % 32;
  static constexpr int COUNT = FULL + (REST ? 1 : 0);
  __host__ __device__ static constexpr int offset(int p) {
    return p * BLOCK_M * 128;
  }
  // byte offset of (row, col) in the part
  __device__ static uint32_t at(int row, int col) {
    const int p = col / 32;
    const int rowbytes = (p < FULL ? 32 : REST) * 4;
    const uint32_t lin = row * rowbytes + (col - 32 * p) * 4;
    return offset(p) + (lin ^ (((lin >> 7) & (rowbytes / 16 - 1)) << 4));
  }
};

// Pre-pass.  For every (b, i, h) row, i < SqP (Sq padded to whole query
// tiles): delta[b, h, i] = sum_d dO * O in f32 and lse2[b, h, i] =
// lse * log2(e); padding rows get 0 and +inf.  Zeroes the n_sync ints of
// `sync` (the ticket and the dQ counters).  Half a warp per row, 16 bytes
// of O and of dO a lane.
__global__ void __launch_bounds__(256)
fa_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ lse2,
                   float* __restrict__ delta, int* __restrict__ sync,
                   int n_sync, int Sq, int SqP, int H, int hd) {
  const int b = blockIdx.y;  // rows of one batch: (i, h), i < SqP
  if (b == 0)
    for (int i = blockIdx.x * 256 + threadIdx.x; i < n_sync;
         i += gridDim.x * 256)
      sync[i] = 0;
  const int lane = threadIdx.x & 31, sub = lane & 15;
  const int r = blockIdx.x * 16 + (threadIdx.x >> 4);
  const int h = r % H, i = r / H;
  const bool real = r < SqP * H && i < Sq;
  float acc = 0.f;
  if (real) {
    const long long row =
        ((static_cast<long long>(b) * Sq + i) * H + h) * hd;
    for (int c = sub * 8; c < hd; c += 128) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + row + c);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + row + c);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&av[e]));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&dv[e]));
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)  // within the half warp
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && r < SqP * H) {
    const long long out = (static_cast<long long>(b) * H + h) * SqP + i;
    delta[out] = acc;
    lse2[out] = real ? lse[(static_cast<long long>(b) * H + h) * Sq + i] *
                           LOG2E
                     : __int_as_float(0x7f800000);  // +inf: P = 0
  }
}

// Post-pass: dq = bf16(dq_accum), 4 elements a thread and step
__global__ void __launch_bounds__(256)
fa_bwd_dq_round_kernel(const float4* __restrict__ acc,
                       uint2* __restrict__ dq, long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * 256) {
    const float4 a = acc[i];
    dq[i] = make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
}

// dK += dS^T q for queries [16 kk, 16 kk + 16): A = the warpgroup's rows
// of the dS^T tile `dst` (K-major), B = the q tile `qt` (64 rows, MN-major),
// N = head_dim in the panels pv_product uses
template <int HD, int BN>
__device__ __forceinline__ void dk_product(float (&acc)[HD / 8][4],
                                           uint32_t dst, int wg, uint32_t qt,
                                           int kk) {
  using P = Panels<HD>;
  const uint64_t da = kmajor_desc<BLOCK_M, BN>(dst, wg * 64, kk);
  const int rows = kk * 16;
  if constexpr (HD == 128) {
    wgmma_ss_mn128<0>(acc, da,
                      smem_desc(qt + rows * 128,
                                P::template offset<BLOCK_M>(1), 1024, 1));
  } else if constexpr (HD == 80) {
    wgmma_ss_mn64<0>(acc, da, smem_desc(qt + rows * 128, 16, 1024, 1));
    wgmma_ss_mn16<8>(acc, da,
                     smem_desc(qt + P::template offset<BLOCK_M>(1) +
                                   rows * 32,
                               16, 256, 3));
  } else if constexpr (HD == 64) {
    wgmma_ss_mn64<0>(acc, da, smem_desc(qt + rows * 128, 16, 1024, 1));
  } else {
    wgmma_ss_mn32<0>(acc, da, smem_desc(qt + rows * 64, 16, 512, 2));
  }
}

// dQ (64 x one head_dim panel) = dS K over the block's BN keys: A = dS
// from the dS^T tile `dst` (keys x 64 queries, 128-byte rows: MN-major),
// B = panel `p` of the K tile `kt` (MN-major).
template <int HD, int BN>
__device__ __forceinline__ void dq_product(float (&dq)[8][4], uint32_t dst,
                                           uint32_t kt, int p) {
  using P = Panels<HD>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t da = smem_desc(dst + kk * 16 * 128, 16, 1024, 1);
    const int keys = kk * 16;
    if constexpr (HD == 32) {
      wgmma_ss_t<32>(reinterpret_cast<float(&)[4][4]>(dq), da,
                     smem_desc(kt + keys * 64, 16, 512, 2), kk > 0);
    } else if (P::cols(p) == 64) {
      wgmma_ss_t<64>(dq, da,
                     smem_desc(kt + P::template offset<BN>(p) +
                                   keys * 128,
                               16, 1024, 1),
                     kk > 0);
    } else {
      wgmma_ss_t<16>(reinterpret_cast<float(&)[2][4]>(dq), da,
                     smem_desc(kt + P::template offset<BN>(p) +
                                   keys * 32,
                               16, 256, 3),
                     kk > 0);
    }
  }
}

// x, hidden from the optimiser: the wgmma descriptors and per-thread
// shared-memory offsets derived from it are recomputed in the loop where
// they are used, instead of being hoisted out of it and held in registers
// across every item
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void ld_shared_f2(uint32_t addr, float& x,
                                             float& y) {
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x), "=f"(y)
               : "r"(addr));
}
__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x,
                                             float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

template <int HD, int BN>
__global__ void __launch_bounds__(num_threads(BN), 1)
flash_bwd_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta, int* __restrict__ sync,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H,
                 int KV, int Sq, int Sk, int SqP, float scale, int causal) {
  constexpr int KSTEPS = HD / 16;       // k16 steps of S^T, dP^T over hd
  constexpr int NT = HD / 8;            // 8-column chunks of dK, dV
  constexpr int NT_S = BLOCK_M / 8;     // 8-column chunks of S^T, dP^T
  constexpr int PSTEPS = BLOCK_M / 16;  // k16 steps of dV, dK over queries
  constexpr int KV_TILE = kv_tile_bytes(BN, HD), Q_TILE = q_tile_bytes(HD);
  constexpr int DS_TILE = ds_tile_bytes(BN), DQ_TILE = dq_tile_bytes(HD);
  constexpr int CONSUMER_THREADS = consumers(BN);
  constexpr int NWG = BN / 64;          // consumer warpgroups
  using DQ = DqPanels<HD>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sK = smem_u32(smem_raw);
  const uint32_t sV = sK + KV_TILE;
  const uint32_t sQ = sV + KV_TILE;
  const uint32_t sDO = sQ + Q_STAGES * Q_TILE;
  const uint32_t sDS = sDO + Q_STAGES * Q_TILE;
  const uint32_t sDQ = sDS + DS_STAGES * DS_TILE;
  const uint32_t sL = sDQ + DQ_STAGES * DQ_TILE;  // lse2 rows, per stage
  const uint32_t sD = sL + Q_STAGES * BLOCK_M * 4;  // delta rows
  const uint32_t kvfull = sD + Q_STAGES * BLOCK_M * 4;
  const uint32_t qfull = kvfull + 8, qempty = qfull + 8 * Q_STAGES;
  const uint32_t dqfull = qempty + 8 * Q_STAGES;
  const uint32_t dqempty = dqfull + 8 * DQ_STAGES;
  int* s_ticket =  // after the mbarriers
      reinterpret_cast<int*>(smem_raw + (dqempty + 8 * DQ_STAGES - sK));

  const int tid = threadIdx.x;
  const int warp_id = tid >> 5, lane = tid & 31;
  const int nm = SqP / BLOCK_M, G = H / KV;
  if (tid == 0) {
    *s_ticket = atomicAdd(sync, 1);
    mbar_init(kvfull, 1);
    for (int i = 0; i < Q_STAGES; ++i) {
      mbar_init(qfull + 8 * i, 1);  // the producer's arrival
      mbar_init(qempty + 8 * i, CONSUMER_THREADS / 32);
    }
    for (int i = 0; i < DQ_STAGES; ++i) {
      mbar_init(dqfull + 8 * i, CONSUMER_THREADS / 32);
      mbar_init(dqempty + 8 * i, 1);  // the writer's arrival
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the work: key tile n (key-tile-major tickets), batch b, KV head kvh
  const int ticket = *s_ticket;
  const int n = ticket / (B * KV), b = (ticket % (B * KV)) / KV,
            kvh = ticket % KV;
  const int k0 = n * BN;
  // query tiles [m0, nm) reach these keys; items run last tile first and,
  // in each, over the group's heads
  const int m0 = causal ? min(nm, k0 / BLOCK_M) : 0;
  const int n_items = (nm - m0) * G;
  int* counters = sync + 1;
  auto item = [&](int it, int& m, int& h) {
    m = nm - 1 - it / G;
    h = kvh * G + it % G;
  };

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform
  if (role == CONSUMER_THREADS / 128) {
    if constexpr (NWG == 2) regs_down<PRODUCER_REGS>();
    if (tid == CONSUMER_THREADS && n_items > 0) {
      // the loader: K and V once, then q, dO, lse2 and delta per item
      mbar_expect(kvfull, 2 * KV_TILE);
      load_panels<HD, BN>(sK, maps.k, k0, kvh, b, kvfull);
      load_panels<HD, BN>(sV, maps.v, k0, kvh, b, kvfull);
#pragma unroll 1
      for (int it = 0; it < n_items; ++it) {
        int m, h;
        item(it, m, h);
        const int s = it % Q_STAGES;
        mbar_wait(qempty + 8 * s, ((it / Q_STAGES) & 1) ^ 1);
        const uint32_t bar = qfull + 8 * s;
        mbar_expect(bar, 2 * Q_TILE + 2 * BLOCK_M * 4);
        load_panels<HD, BLOCK_M>(sQ + s * Q_TILE, maps.q, m * BLOCK_M, h, b,
                                 bar);
        load_panels<HD, BLOCK_M>(sDO + s * Q_TILE, maps.dout, m * BLOCK_M,
                                 h, b, bar);
        const long long row = (static_cast<long long>(b) * H + h) * SqP +
                              m * BLOCK_M;
        bulk_load(sL + s * BLOCK_M * 4, lse2 + row, BLOCK_M * 4, bar);
        bulk_load(sD + s * BLOCK_M * 4, delta + row, BLOCK_M * 4, bar);
      }
    } else if (tid == CONSUMER_THREADS + 32) {
      // the dQ writer: each part, in ascending key-tile order per
      // (batch, head, query tile)
#pragma unroll 1
      for (int it = 0; it < n_items; ++it) {
        int m, h;
        item(it, m, h);
        const int s = it % DQ_STAGES;
        mbar_wait(dqfull + 8 * s, (it / DQ_STAGES) & 1);
        int* cnt = counters + (static_cast<long long>(b) * H + h) * nm + m;
        while (ld_acquire(cnt) < n) __nanosleep(32);
        fence_proxy_async_global();
        const uint32_t part = sDQ + s * DQ_TILE;
#pragma unroll
        for (int p = 0; p < DQ::COUNT; ++p)
          tma_store_or_add(maps.dq + (p < DQ::FULL ? 0 : 1),
                           part + DQ::offset(p), 32 * p, m * BLOCK_M, h, b,
                           n > 0);
        bulk_commit_if(true);
        bulk_wait_if<true>(true);  // the part is read: its stage is free
        mbar_arrive_if(dqempty + 8 * s, true);
        bulk_wait_if<false>(true);  // complete: visible in global memory
        fence_proxy_async_global();
        red_release_add(cnt, 1);
      }
    }
    return;
  }

  // The consumers: BN / 64 warpgroups of 64 keys each
  if constexpr (NWG == 2) regs_up<CONSUMER_REGS>();
  const int wg = role;
  const int warp = __shfl_sync(0xffffffffu, warp_id & 3, 0);  // in the wg
  const int g = lane >> 2, t = lane & 3;
  const float c = scale * LOG2E;
  const int kw0 = k0 + wg * 64;  // the warpgroup's first key
  const int key[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
  // the head_dim panels of dQ this warpgroup forms: its own (at BN 128;
  // none at hd 64 and 32 for the second), or every one in turn (BN 64)
  const bool has_dq = wg < Panels<HD>::COUNT;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (n_items > 0) mbar_wait(kvfull, 0);
  for (int it = 0; it < n_items; ++it) {
    int m, h;
    item(it, m, h);
    const int q0 = m * BLOCK_M;
    const int s = it % Q_STAGES;
    const uint32_t qt = sQ + s * Q_TILE, dot = sDO + s * Q_TILE;
    const uint32_t dst = sDS + (it % DS_STAGES) * DS_TILE;
    const uint32_t kt = opaque(sK), vt = kt + KV_TILE;
    const int ln = static_cast<int>(opaque(lane));
    const int g = ln >> 2, t = ln & 3;
    const int key0 = kw0 + warp * 16 + g;  // this thread's first key
    mbar_wait(qfull + 8 * s, (it / Q_STAGES) & 1);

    // S^T = K q^T and dP^T = V dO^T, 64 keys x 64 queries
    float st[NT_S][4], dp[NT_S][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss<BLOCK_M>(st, kmajor_desc<HD, BN>(kt, wg * 64, kk),
                        kmajor_desc<HD, BLOCK_M>(qt, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss<BLOCK_M>(dp, kmajor_desc<HD, BN>(vt, wg * 64, kk),
                        kmajor_desc<HD, BLOCK_M>(dot, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is done; dP^T may still run
    fence_regs(st);

    // P^T = exp2(S^T c - lse2), 0 where masked (rows past Sq: lse2 = +inf)
    const uint32_t lrow = sL + s * BLOCK_M * 4, drow = sD + s * BLOCK_M * 4;
    const bool mask = (causal && q0 < kw0 + 63) || kw0 + 64 > Sk;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      float l[2];
      ld_shared_f2(lrow + (j * 8 + 2 * t) * 4, l[0], l[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(st[j][e], c, -l[e & 1]));
        if (mask) {
          const int kp = key0 + 8 * (e >> 1), qp = q0 + j * 8 + 2 * t + (e & 1);
          if (kp >= Sk || (causal && qp < kp)) p = 0.f;
        }
        st[j][e] = p;
      }
    }
    wgmma_wait<0>();  // dP^T is done
    fence_regs(dp);

    // per 8-query chunk: dS^T = P^T (dP^T - delta) scale, rounded to bf16
    // into shared memory (rows of 64 queries, 128 bytes, 128-byte swizzle),
    // and P^T re-packed in place to bf16 A fragments; a chunk's f32 P^T and
    // dP^T die here, which keeps the warpgroup's registers inside its share
    uint32_t pa[PSTEPS][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      float d[2];
      ld_shared_f2(drow + (j * 8 + 2 * t) * 4, d[0], d[1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wg * 64 + warp * 16 + g + 8 * r;  // key in the block
        st_shared_b32(
            dst + row * 128 + ((j ^ (row & 7)) << 4) + 4 * t,
            pack_bf16(st[j][2 * r] * (dp[j][2 * r] - d[0]) * scale,
                      st[j][2 * r + 1] * (dp[j][2 * r + 1] - d[1]) * scale));
        pa[j / 2][2 * (j & 1) + r] = pack_bf16(st[j][2 * r], st[j][2 * r + 1]);
      }
    }
    // dV += P^T dO
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
      pv_product<HD, BLOCK_M>(dva, pa[kk], dot, kk);
    wgmma_commit();
    fence_proxy_async_shared();
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");

    // the dQ part = dS K, one head_dim panel per warpgroup, summed in dP^T's
    // registers (dead by now: an accumulator of its own would leave S^T and
    // dP^T too few registers to be in flight together, and ptxas would
    // serialize every wgmma); then dK += dS^T q over the warpgroup's rows
    // of dS^T
    float (&dq)[8][4] = dp;
    wgmma_fence();
    if (has_dq) dq_product<HD, BN>(dq, dst, kt, wg);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk)
      dk_product<HD, BN>(dka, dst, wg, qt, kk);
    wgmma_commit();
    wgmma_wait<1>();  // dV and the dQ part are done; dK may still run
    fence_regs(dva);
    fence_regs(pa);
    if (has_dq) fence_regs(dq);

    // stage the dQ part (f32) for the writer, while dK runs
    const int ps = it % DQ_STAGES;
    const uint32_t part = sDQ + ps * DQ_TILE;
    auto stage = [&](int p) {  // head_dim panel p of the part
      const int cols = Panels<HD>::cols(p);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j * 8 >= cols) break;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          st_shared_f2(part + DQ::at(warp * 16 + g + 8 * r,
                                     p * 64 + j * 8 + 2 * t),
                       dq[j][2 * r], dq[j][2 * r + 1]);
      }
    };
    mbar_wait(dqempty + 8 * ps, ((it / DQ_STAGES) & 1) ^ 1);
    if (has_dq) stage(wg);
    if constexpr (NWG == 1) {
      // the one warpgroup forms the other panels in turn, in dQ's
      // registers again (dK may still run)
#pragma unroll
      for (int p = 1; p < Panels<HD>::COUNT; ++p) {
        wgmma_fence();
        dq_product<HD, BN>(dq, dst, kt, p);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        stage(p);
      }
    }
    if (has_dq) fence_proxy_async_shared();
    wgmma_wait<0>();  // dK is done too
    fence_regs(dka);
    mbar_arrive_if(qempty + 8 * s, lane == 0);  // q, dO of this stage read
    __syncwarp();
    mbar_arrive_if(dqfull + 8 * ps, lane == 0);
  }

  // dK and dV of the warpgroup's 64 keys, rounded once to bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Sk) continue;
    const long long base =
        ((static_cast<long long>(b) * Sk + key[r]) * KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + base + col) =
          pack_bf16(dka[j][2 * r], dka[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + col) =
          pack_bf16(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

// the scratch of one call, in one buffer: dq_accum f32 (B, Sq, H, hd), then
// lse2 and delta f32 (B, H, SqP), then the ticket and the counters, int32
// (1 + B * H * SqP / BLOCK_M), whatever the key tile
struct Scratch {
  float *dq_accum, *lse2, *delta;
  int* sync;
  int n_sync;
};
Scratch carve(void* base, int B, int Sq, int H, int hd) {
  const long long SqP = (Sq + BLOCK_M - 1) / BLOCK_M * BLOCK_M;
  Scratch s;
  s.dq_accum = static_cast<float*>(base);
  s.lse2 = s.dq_accum + static_cast<long long>(B) * Sq * H * hd;
  const long long rows = static_cast<long long>(B) * H * SqP;
  s.delta = s.lse2 + rows;
  s.sync = reinterpret_cast<int*>(s.delta + rows);
  s.n_sync = static_cast<int>(1 + rows / BLOCK_M);
  return s;
}

template <int HD, int BN>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, void* scratch, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Sk, int H, int KV,
           float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes(HD, BN);
  static_assert(smem <= 232448, "a block has 227 KB of shared memory");
  if (encode_fn() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_kernel<HD, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  const Scratch s = carve(scratch, B, Sq, H, HD);
  const int SqP = (Sq + BLOCK_M - 1) / BLOCK_M * BLOCK_M;
  Maps maps;
  const long long qs = static_cast<long long>(H) * HD;  // contiguous rows
  const long long ks = static_cast<long long>(KV) * HD;
  if (!make_maps(maps.q, q, B, Sq, H, HD, qs * Sq, qs, HD, BLOCK_M) ||
      !make_maps(maps.dout, dout, B, Sq, H, HD, qs * Sq, qs, HD, BLOCK_M) ||
      !make_maps(maps.k, k, B, Sk, KV, HD, ks * Sk, ks, HD, BN) ||
      !make_maps(maps.v, v, B, Sk, KV, HD, ks * Sk, ks, HD, BN) ||
      !make_map(&maps.dq[0], s.dq_accum, B, Sq, H, HD, qs * Sq, qs, HD,
                32, BLOCK_M, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4) ||
      (HD % 32 != 0 &&
       !make_map(&maps.dq[1], s.dq_accum, B, Sq, H, HD, qs * Sq, qs, HD,
                 HD % 32, BLOCK_M, CU_TENSOR_MAP_SWIZZLE_64B,
                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4)))
    return static_cast<int>(cudaErrorInvalidValue);

  // both passes move bytes: half a warp for every row (a thread for every
  // 4 elements), all in flight at once
  const dim3 prep_grid((SqP * H + 15) / 16, B);
  fa_bwd_prep_kernel<<<prep_grid, 256, 0, stream>>>(
      o, dout, lse, s.lse2, s.delta, s.sync, s.n_sync, Sq, SqP, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nk = (Sk + BN - 1) / BN;
  flash_bwd_kernel<HD, BN><<<nk * B * KV, num_threads(BN), smem, stream>>>(
      maps, s.lse2, s.delta, s.sync, dk, dv, B, H, KV, Sq, Sk, SqP, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(B) * Sq * H * HD / 4;
  fa_bwd_dq_round_kernel<<<static_cast<int>((n4 + 255) / 256), 256, 0,
                           stream>>>(
      reinterpret_cast<const float4*>(s.dq_accum), reinterpret_cast<uint2*>(dq),
      n4);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bn(int bn, const bf16* q, const bf16* k, const bf16* v,
              const bf16* o, const bf16* dout, const float* lse,
              void* scratch, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
              int Sk, int H, int KV, float scale, int causal,
              cudaStream_t s) {
  switch (bn) {
    case 64:
      return launch<HD, 64>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B,
                            Sq, Sk, H, KV, scale, causal, s);
    case BLOCK_N:
      return launch<HD, BLOCK_N>(q, k, v, o, dout, lse, scratch, dq, dk, dv,
                                 B, Sq, Sk, H, KV, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq (B, Sq, H, hd) and k, v, dk, dv (B, Sk, KV, hd): bf16,
// contiguous, 16-byte aligned.  lse (B, H, Sq) f32 from the forward.
// scratch: 16-byte aligned, 4 * (B Sq H hd + 2 B H SqP + 1 + B H SqP / 64)
// bytes, SqP = Sq rounded up to a multiple of 64; nothing in it is read
// before this call writes it.  block_n: keys a block owns, 64 or 128.
// Returns cudaGetLastError() after the launches (the first error stops
// them).
extern "C" int mist_flash_attn_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* scratch, void* dq, void* dk,
                                   void* dv, int B, int Sq, int Sk, int H,
                                   int KV, int hd, float scale, int causal,
                                   int block_n, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *o_ = static_cast<const bf16*>(o),
             *do_ = static_cast<const bf16*>(dout);
  const float* l_ = static_cast<const float*>(lse);
  bf16 *dq_ = static_cast<bf16*>(dq), *dk_ = static_cast<bf16*>(dk),
       *dv_ = static_cast<bf16*>(dv);
  switch (hd) {
    case 32:
      return launch_bn<32>(block_n, q_, k_, v_, o_, do_, l_, scratch, dq_,
                           dk_, dv_, B, Sq, Sk, H, KV, scale, causal, s);
    case 64:
      return launch_bn<64>(block_n, q_, k_, v_, o_, do_, l_, scratch, dq_,
                           dk_, dv_, B, Sq, Sk, H, KV, scale, causal, s);
    case 80:
      return launch_bn<80>(block_n, q_, k_, v_, o_, do_, l_, scratch, dq_,
                           dk_, dv_, B, Sq, Sk, H, KV, scale, causal, s);
    case 128:
      return launch_bn<128>(block_n, q_, k_, v_, o_, do_, l_, scratch, dq_,
                            dk_, dv_, B, Sq, Sk, H, KV, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
