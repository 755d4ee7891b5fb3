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
// 343.6 GFLOP against ~100 MB of traffic, far above the ~295 FLOP/byte bf16
// ridge: 0.347 ms at 989 TFLOP/s.
//
// What the design does about that, as a first, simple kernel: every product
// is mma.sync m16n8k16 (bf16 operands from ldmatrix or from registers, f32
// sums), and nothing is written but the outputs.  It is deterministic and
// uses no atomics, at the price of forming S and dP twice:
// - fa_bwd_delta_kernel: delta, one warp per (batch, row, head).
// - fa_bwd_dkdv_kernel: one block of 4 warps per (batch, KV head, tile of 64
//   keys); each warp owns 16 keys, holds their dK and dV in registers, and
//   walks the group's query heads and, for each, the query tiles of 32 rows
//   at or after its key tile (causal) with K and V staying in shared memory.
//   Working with S^T = K q^T puts keys on the rows of every accumulator, so
//   P^T and dS^T feed dV and dK straight from registers as A fragments.
// - fa_bwd_dq_kernel: one block of 4 warps per (batch, head, tile of 64
//   query rows), heaviest causal tiles first; each warp owns 16 rows and
//   their dQ, and walks the key tiles of 64 up to the diagonal.
// Tiles sit in shared memory in rows padded by 8 elements, so that ldmatrix
// reads are free of bank conflicts, and are loaded with cp.async; rows past
// the end of q or k are zero-filled and masked.  Single-buffered: the loads
// of the next tile wait for the last product of this one.  wgmma, TMA and
// warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;  // 4 warps of 16 rows each
constexpr int PAD = 8;        // bf16 elements of padding per shared row
constexpr int DKV_KN = 64;    // dK/dV kernel: keys per block
constexpr int DKV_QM = 32;    // dK/dV kernel: query rows per inner tile
constexpr int DQ_QM = 64;     // dQ kernel: query rows per block
constexpr int DQ_KN = 64;     // dQ kernel: keys per inner tile
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int dkdv_smem_bytes(int hd) {
  return (2 * DKV_KN + 2 * DKV_QM) * (hd + PAD) * 2 + 2 * DKV_QM * 4;
}
__host__ __device__ constexpr int dq_smem_bytes(int hd) {
  return (2 * DQ_QM + 2 * DQ_KN) * (hd + PAD) * 2;
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

// four 8 x 8 bf16 matrices, the rows of matrix i addressed by lanes 8i..8i+7
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

// (lo, hi) rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ROWS rows of HD elements from g (row r at g + (row0 + r) * stride) into
// shared rows of HD + PAD; rows at or past `nrows` are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, cc = c - r * CH;
    bf16* dst = s + r * (HD + PAD) + cc * 8;
    if (row0 + r < nrows)
      cp_async16(dst, g + (row0 + r) * stride + cc * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in f32, one warp
// per (b, i, h) row of the contiguous (B, Sq, H, hd) tensors
__global__ void __launch_bounds__(256)
fa_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    float* __restrict__ delta, int B, int Sq, int H,
                    int hd) {
  const int lane = threadIdx.x & 31;
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long stride = static_cast<long long>(gridDim.x) * 8;
  for (long long r = blockIdx.x * 8LL + (threadIdx.x >> 5); r < rows;
       r += stride) {
    const __nv_bfloat162* o2 =
        reinterpret_cast<const __nv_bfloat162*>(o + r * hd);
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(dout + r * hd);
    float acc = 0.f;
    for (int j = lane; j < hd / 2; j += 32) {
      const float2 a = __bfloat1622float2(o2[j]);
      const float2 b = __bfloat1622float2(d2[j]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const long long h = r % H, i = (r / H) % Sq, b = r / (static_cast<long long>(H) * Sq);
      delta[(b * H + h) * Sq + i] = acc;
    }
  }
}

// dK and dV of DKV_KN keys of one (batch, KV head)
template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Sq, int Sk, int H, int KV,
                   float scale, int causal) {
  constexpr int LD = HD + PAD, KS = HD / 16, NT = HD / 8;
  constexpr int QN = DKV_QM / 8;  // n-tiles of query columns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + DKV_KN * LD;
  bf16* sQ = sV + DKV_KN * LD;
  bf16* sO = sQ + DKV_QM * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + DKV_QM * LD);  // lse * log2(e)
  float* sD = sL + DKV_QM;                                  // delta

  const int k0 = blockIdx.x * DKV_KN, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int G = H / KV;
  const long long qstride = static_cast<long long>(H) * HD;
  const long long kstride = static_cast<long long>(KV) * HD;
  const long long kbase = (static_cast<long long>(b) * Sk * KV + kvh) * HD;
  load_rows<HD, DKV_KN>(sK, k + kbase, kstride, k0, Sk);
  load_rows<HD, DKV_KN>(sV, v + kbase, kstride, k0, Sk);

  // ldmatrix lane addresses: A from row-major rows; B from rows indexed by
  // n (non-transposed); B from rows indexed by k (transposed)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3),
            b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3),
            t_col = (lane >> 4) * 8;
  const uint32_t sK_a = smem_addr(sK + (warp * 16 + a_row) * LD + a_col);
  const uint32_t sV_a = smem_addr(sV + (warp * 16 + a_row) * LD + a_col);
  const uint32_t sQ_b = smem_addr(sQ + b_row * LD + b_col);
  const uint32_t sO_b = smem_addr(sO + b_row * LD + b_col);
  const uint32_t sQ_t = smem_addr(sQ + t_row * LD + t_col);
  const uint32_t sO_t = smem_addr(sO + t_row * LD + t_col);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
  const float sl2 = scale * LOG2E;
  const int nq = (Sq + DKV_QM - 1) / DKV_QM;
  const int qt0 = causal ? k0 / DKV_QM : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const long long qbase = (static_cast<long long>(b) * Sq * H + h) * HD;
    const float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* drow = delta + (static_cast<long long>(b) * H + h) * Sq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * DKV_QM;
      __syncthreads();  // every warp is done with the last tile
      load_rows<HD, DKV_QM>(sQ, q + qbase, qstride, q0, Sq);
      load_rows<HD, DKV_QM>(sO, dout + qbase, qstride, q0, Sq);
      for (int i = threadIdx.x; i < DKV_QM; i += THREADS) {
        const bool in = q0 + i < Sq;
        sL[i] = in ? lrow[q0 + i] * LOG2E : 0.f;
        sD[i] = in ? drow[q0 + i] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K q^T: 16 keys x DKV_QM queries per warp
      float s[QN][4];
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, sK_a + kk * 32);
#pragma unroll
        for (int jp = 0; jp < QN / 2; ++jp) {
          uint32_t bq[4];
          ldsm_x4(bq, sQ_b + (jp * 16 * LD + kk * 16) * 2);
          mma(s[2 * jp], a, bq[0], bq[1]);
          mma(s[2 * jp + 1], a, bq[2], bq[3]);
        }
      }
      // P^T = exp(S^T scale - lse), 0 where masked
      const bool edge = (causal && q0 < k0 + DKV_KN) || q0 + DKV_QM > Sq;
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t4 + (e & 1);
          float p = ex2(fmaf(s[j][e], sl2, -sL[qi]));
          if (edge) {
            const int qp = q0 + qi, kp = e < 2 ? key0 : key1;
            if ((causal && qp < kp) || qp >= Sq) p = 0.f;
          }
          s[j][e] = p;
        }
      // dV += P^T dO, P^T as bf16 A fragments straight from registers
#pragma unroll
      for (int kk = 0; kk < QN / 2; ++kk) {
        const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                               pack(s[2 * kk][2], s[2 * kk][3]),
                               pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bo[4];
          ldsm_x4_t(bo, sO_t + (kk * 16 * LD + np * 16) * 2);
          mma(dva[2 * np], a, bo[0], bo[1]);
          mma(dva[2 * np + 1], a, bo[2], bo[3]);
        }
      }
      // dP^T = V dO^T
      float dp[QN][4];
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, sV_a + kk * 32);
#pragma unroll
        for (int jp = 0; jp < QN / 2; ++jp) {
          uint32_t bo[4];
          ldsm_x4(bo, sO_b + (jp * 16 * LD + kk * 16) * 2);
          mma(dp[2 * jp], a, bo[0], bo[1]);
          mma(dp[2 * jp + 1], a, bo[2], bo[3]);
        }
      }
      // dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int j = 0; j < QN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t4 + (e & 1);
          s[j][e] = s[j][e] * (dp[j][e] - sD[qi]) * scale;
        }
      // dK += dS^T q
#pragma unroll
      for (int kk = 0; kk < QN / 2; ++kk) {
        const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                               pack(s[2 * kk][2], s[2 * kk][3]),
                               pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bq[4];
          ldsm_x4_t(bq, sQ_t + (kk * 16 * LD + np * 16) * 2);
          mma(dka[2 * np], a, bq[0], bq[1]);
          mma(dka[2 * np + 1], a, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait_all();  // K and V, when no query tile reached this block

  const long long o0 = ((static_cast<long long>(b) * Sk + key0) * KV + kvh) * HD;
  const long long o1 = o0 + 8 * kstride;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t4;
    if (key0 < Sk) {
      *reinterpret_cast<uint32_t*>(dk + o0 + col) = pack(dka[j][0], dka[j][1]);
      *reinterpret_cast<uint32_t*>(dv + o0 + col) = pack(dva[j][0], dva[j][1]);
    }
    if (key1 < Sk) {
      *reinterpret_cast<uint32_t*>(dk + o1 + col) = pack(dka[j][2], dka[j][3]);
      *reinterpret_cast<uint32_t*>(dv + o1 + col) = pack(dva[j][2], dva[j][3]);
    }
  }
}

// dQ of DQ_QM query rows of one (batch, head)
template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int Sq, int Sk, int H, int KV, float scale, int causal) {
  constexpr int LD = HD + PAD, KS = HD / 16, NT = HD / 8;
  constexpr int KN8 = DQ_KN / 8;  // n-tiles of key columns
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + DQ_QM * LD;  // dO
  bf16* sK = sO + DQ_QM * LD;
  bf16* sV = sK + DQ_KN * LD;

  // the heaviest causal tiles (the last rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_QM;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long qstride = static_cast<long long>(H) * HD;
  const long long kstride = static_cast<long long>(KV) * HD;
  const long long qbase = (static_cast<long long>(b) * Sq * H + h) * HD;
  const long long kbase = (static_cast<long long>(b) * Sk * KV + kvh) * HD;
  load_rows<HD, DQ_QM>(sQ, q + qbase, qstride, q0, Sq);
  load_rows<HD, DQ_QM>(sO, dout + qbase, qstride, q0, Sq);

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq;
  const float* drow = delta + (static_cast<long long>(b) * H + h) * Sq;
  const float l0 = row0 < Sq ? lrow[row0] * LOG2E : 0.f;
  const float l1 = row1 < Sq ? lrow[row1] * LOG2E : 0.f;
  const float d0 = row0 < Sq ? drow[row0] : 0.f;
  const float d1 = row1 < Sq ? drow[row1] : 0.f;

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3),
            b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3),
            t_col = (lane >> 4) * 8;
  const uint32_t sQ_a = smem_addr(sQ + (warp * 16 + a_row) * LD + a_col);
  const uint32_t sO_a = smem_addr(sO + (warp * 16 + a_row) * LD + a_col);
  const uint32_t sK_b = smem_addr(sK + b_row * LD + b_col);
  const uint32_t sV_b = smem_addr(sV + b_row * LD + b_col);
  const uint32_t sK_t = smem_addr(sK + t_row * LD + t_col);

  float dqa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  const float sl2 = scale * LOG2E;
  const int nk = (Sk + DQ_KN - 1) / DQ_KN;
  const int last = (q0 + DQ_QM < Sq ? q0 + DQ_QM : Sq) - 1;
  const int kend = causal ? min(nk, last / DQ_KN + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int kb = kt * DQ_KN;
    __syncthreads();  // every warp is done with the last K/V tile
    load_rows<HD, DQ_KN>(sK, k + kbase, kstride, kb, Sk);
    load_rows<HD, DQ_KN>(sV, v + kbase, kstride, kb, Sk);
    cp_async_wait_all();
    __syncthreads();

    // S = q K^T: 16 rows x DQ_KN keys per warp
    float s[KN8][4];
#pragma unroll
    for (int j = 0; j < KN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQ_a + kk * 32);
#pragma unroll
      for (int jp = 0; jp < KN8 / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, sK_b + (jp * 16 * LD + kk * 16) * 2);
        mma(s[2 * jp], a, bk[0], bk[1]);
        mma(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }
    const bool edge = (causal && kb + DQ_KN - 1 > q0) || kb + DQ_KN > Sk;
#pragma unroll
    for (int j = 0; j < KN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], sl2, -(e < 2 ? l0 : l1)));
        if (edge) {
          const int kp = kb + j * 8 + 2 * t4 + (e & 1);
          const int qp = e < 2 ? row0 : row1;
          if ((causal && kp > qp) || kp >= Sk) p = 0.f;
        }
        s[j][e] = p;
      }
    // dP = dO V^T
    float dp[KN8][4];
#pragma unroll
    for (int j = 0; j < KN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sO_a + kk * 32);
#pragma unroll
      for (int jp = 0; jp < KN8 / 2; ++jp) {
        uint32_t bv[4];
        ldsm_x4(bv, sV_b + (jp * 16 * LD + kk * 16) * 2);
        mma(dp[2 * jp], a, bv[0], bv[1]);
        mma(dp[2 * jp + 1], a, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta) scale
#pragma unroll
    for (int j = 0; j < KN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = s[j][e] * (dp[j][e] - (e < 2 ? d0 : d1)) * scale;
    // dQ += dS K, dS as bf16 A fragments straight from registers
#pragma unroll
    for (int kk = 0; kk < KN8 / 2; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, sK_t + (kk * 16 * LD + np * 16) * 2);
        mma(dqa[2 * np], a, bk[0], bk[1]);
        mma(dqa[2 * np + 1], a, bk[2], bk[3]);
      }
    }
  }

  const long long o0 = qbase + static_cast<long long>(row0) * qstride;
  const long long o1 = o0 + 8 * qstride;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + o0 + col) = pack(dqa[j][0], dqa[j][1]);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + o1 + col) = pack(dqa[j][2], dqa[j][3]);
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Sk, int H, int KV,
           float scale, int causal, cudaStream_t stream) {
  constexpr int smem_dkdv = dkdv_smem_bytes(HD), smem_dq = dq_smem_bytes(HD);
  static const cudaError_t attr_dkdv = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dkdv);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (attr_dkdv != cudaSuccess) return static_cast<int>(attr_dkdv);
  if (attr_dq != cudaSuccess) return static_cast<int>(attr_dq);

  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long want = (rows + 7) / 8;
  const int delta_grid = static_cast<int>(want < 4096 ? want : 4096);
  fa_bwd_delta_kernel<<<delta_grid, 256, 0, stream>>>(o, dout, delta, B, Sq,
                                                       H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dkdv((Sk + DKV_KN - 1) / DKV_KN, KV, B);
  fa_bwd_dkdv_kernel<HD><<<grid_dkdv, THREADS, smem_dkdv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dq((Sq + DQ_QM - 1) / DQ_QM, H, B);
  fa_bwd_dq_kernel<HD><<<grid_dq, THREADS, smem_dq, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq (B, Sq, H, hd) and k, v, dk, dv (B, Sk, KV, hd): bf16,
// contiguous, 16-byte aligned.  lse (B, H, Sq) f32 from the forward;
// delta (B, H, Sq) f32 scratch, written here.  Returns cudaGetLastError()
// after the launches (the first error stops them).
extern "C" int mist_flash_attn_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, float scale, int causal,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *o_ = static_cast<const bf16*>(o),
             *do_ = static_cast<const bf16*>(dout);
  const float* l_ = static_cast<const float*>(lse);
  float* d_ = static_cast<float*>(delta);
  bf16 *dq_ = static_cast<bf16*>(dq), *dk_ = static_cast<bf16*>(dk),
       *dv_ = static_cast<bf16*>(dv);
  switch (hd) {
    case 32:
      return launch<32>(q_, k_, v_, o_, do_, l_, d_, dq_, dk_, dv_, B, Sq, Sk,
                        H, KV, scale, causal, s);
    case 64:
      return launch<64>(q_, k_, v_, o_, do_, l_, d_, dq_, dk_, dv_, B, Sq, Sk,
                        H, KV, scale, causal, s);
    case 80:
      return launch<80>(q_, k_, v_, o_, do_, l_, d_, dq_, dk_, dv_, B, Sq, Sk,
                        H, KV, scale, causal, s);
    case 128:
      return launch<128>(q_, k_, v_, o_, do_, l_, d_, dq_, dk_, dv_, B, Sq,
                         Sk, H, KV, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
