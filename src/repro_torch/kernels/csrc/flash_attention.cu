// Flash-attention forward for Hopper (sm_90a), written by hand with mma.sync.
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
// bf16 ridge: tensor-core operations bound it.
//
// What the design does about that: both products (S = Q K^T and O += P V)
// run on the tensor cores as m16n8k16 bf16 mma.sync with f32 accumulation.
// S and P never leave registers: the accumulator fragment of S is
// re-packed in place as the A fragment of P, so the softmax needs only
// quad shuffles.  One block owns 64 query rows of one (batch, head), 16 per
// warp; each 64-row K/V tile is staged once in shared memory and read by
// all four warps.  GQA indexes the KV head as h / (H / KV) instead of
// broadcasting it.  Causal blocks stop at their last query row, so tiles
// above the diagonal are skipped.  Ragged Sq/Sk are masked in the kernel.
// Three 64-row bf16 tiles at hd 128 take 51 KB, past the 48 KB static
// limit, so shared memory is dynamic (cudaFuncSetAttribute).  Head dims 32,
// 64, 80 (zamba2's 2560 / 32) and 128: each is a multiple of 16 (the mma's
// k16 step) and its padded row of hd + 8 bf16 is a multiple of 16 bytes,
// so the 16-byte vector loads of load_tile stay aligned.  Not yet
// done (later work): wgmma, TMA loads, a multi-stage K/V ring, warp
// specialisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;     // query rows per block, 16 per warp
constexpr int BLOCK_N = 64;     // key/value rows per tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int PAD = 8;          // bf16 pad per shared row: spreads banks
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_u16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// rows [row0, row0 + ROWS) of a (rows, HD) matrix with row stride
// `stride` into shared memory; rows at or past `nrows` are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int LDS = HD + PAD;
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NUM_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int KV, int Sq, int Sk,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float scale, int causal) {
  constexpr int LDS = HD + PAD;
  constexpr int KSTEPS = HD / 16;       // k16 steps of Q K^T over head_dim
  constexpr int NT_O = HD / 8;          // n8 tiles of O over head_dim
  constexpr int NT_S = BLOCK_N / 8;     // n8 tiles of S over the key tile
  constexpr int PSTEPS = BLOCK_N / 16;  // k16 steps of P V over the key tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * LDS;
  __nv_bfloat16* sV = sK + BLOCK_N * LDS;
  const uint16_t* sVu = reinterpret_cast<const uint16_t*>(sV);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread in group
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  // heaviest causal tiles (largest q0) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  load_tile<HD, BLOCK_M>(sQ, qb, q_ss, q0, Sq);
  __syncthreads();

  // this thread's rows of the warp's 16-row slice: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(sQ + r0 * LDS + c);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(sQ + (r0 + 8) * LDS + c);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(sQ + r0 * LDS + c + 8);
    qf[kk][3] =
        *reinterpret_cast<const uint32_t*>(sQ + (r0 + 8) * LDS + c + 8);
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};  // per-thread partial sums over its columns
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};

  // causal: keys past the block's last query row are masked for every row
  const int kv_end = causal ? min(Sk, q0 + BLOCK_M) : Sk;

  for (int k0 = 0; k0 < kv_end; k0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD, BLOCK_N>(sK, kb, k_ss, k0, Sk);
    load_tile<HD, BLOCK_N>(sV, vb, v_ss, k0, Sk);
    __syncthreads();

    // S = Q K^T (f32)
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = sK + (j * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        bf[1] = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[j], qf[kk], bf);
      }
    }

    // scale, mask, running max (row = e >> 1: 0 -> r0, 1 -> r0 + 8)
    float mcur[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < Sk && (!causal || qrow[e >> 1] >= col);
        const float x = ok ? s[j][e] * scale : NEG_INF;
        s[j][e] = x;
        mcur[e >> 1] = fmaxf(mcur[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mcur[r] = fmaxf(mcur[r], __shfl_xor_sync(0xffffffffu, mcur[r], 1));
      mcur[r] = fmaxf(mcur[r], __shfl_xor_sync(0xffffffffu, mcur[r], 2));
      const float m_new = fmaxf(m_i[r], mcur[r]);
      alpha[r] = __expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m_i[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
    l_i[0] = alpha[0] * l_i[0] + rs[0];
    l_i[1] = alpha[1] * l_i[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, P (bf16) taken straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * t;  // key row in the tile
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const int col = n * 8 + g;
        uint32_t bf[2];
        bf[0] = pack_u16(sVu[kr * LDS + col], sVu[(kr + 1) * LDS + col]);
        bf[1] = pack_u16(sVu[(kr + 8) * LDS + col],
                         sVu[(kr + 9) * LDS + col]);
        mma_16816(acc[n], pa, bf);
      }
    }
  }

  // epilogue: full row sums, clamp, normalise, write o and lse
  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[r] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= Sq) continue;
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * Sq + qrow[r]) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + col) =
          pack_bf16(acc[n][2 * r] / l_row[r], acc[n][2 * r + 1] / l_row[r]);
    }
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qrow[r]] =
          m_i[r] + logf(l_row[r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int KV, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, int causal, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (HD + PAD) *
                   static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<HD><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, KV, Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, scale, causal);
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
