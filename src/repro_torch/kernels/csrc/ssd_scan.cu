// Mamba2 SSD chunk scan for Hopper (sm_90a), written by hand.
//
// Replaces: src/repro/kernels/ssd_scan.py :: _ssd_kernel (the Pallas TPU
// kernel behind ssd_scan_pallas <- ops.ssd_scan <- models/ssm.ssd_chunked).
// Computes the same function, in f32 throughout: per chunk of Q steps,
//   cum   = cumsum(dt * a)                       (inclusive, in the chunk)
//   y     = ((C B^T) * exp(mask(cum_t - cum_s)) * dt_s) x  +  (C exp(cum)) h
//   h     = h * exp(cum[-1]) + (B * w)^T x,   w = exp(cum[-1] - cum) * dt
// with the causal mask applied BEFORE the exp (s > t never reaches expf),
// the state h (N x P, f32) carried over the chunks in order, and y rounded
// to x's dtype once.  Unlike the TPU kernel it also writes the final state
// hT as (B, H, P, N) f32 -- the layout of the reference's ssd_chunked and of
// the Mamba cache -- which the reference recomputes with its jnp path when a
// serving handoff needs it.
//
// What bounds it on an H100: at the serving prefill shape (B 4, S 1024,
// H 80, P 64, N 64, chunk 256, bf16, ssm_groups 1) the function needs
// ~16 GFLOP (causal half of the intra-chunk products) and ~91 MB of traffic
// (x and y dominate), so on the data sheet bytes bound it (~27 us) -- but
// only if the products ran on the bf16 tensor cores.  This kernel runs them
// in f32 on the CUDA cores (67 TFLOP/s peak), where the same work needs
// ~230 us: operations bound it, and it is the f32 FMA rate that it chases.
//
// What the design does about that: the TPU kernel runs the chunks on a
// sequential grid axis with the state in VMEM scratch; on Hopper blocks run
// in any order, so one block owns one (batch, head) and loops over the
// chunks itself, with the state in shared memory for the whole loop.  A
// chunk's x and B (Q rows, f32) are staged in shared memory once and read by
// every product.  The (Q, Q) score matrix (256 KB in f32 at chunk 256) does
// not fit a block's 227 KB, so it is never formed: query rows go in tiles of
// 64, key rows in tiles of 64, and only tiles on or below the diagonal are
// computed.  Each thread of the 16 x 16 block owns a 4 x 4 register tile
// (rows ty + 16 i, columns tx + 16 j) of every product, so shared-memory
// reads are broadcasts or unit-stride; rows of B and C are padded by one
// float so column reads spread over the banks.  B and C are read per group
// (h / (H / G)), so with ssm_groups 1 every head of a batch row reads the
// same B/C rows instead of a repeated copy.  ~181 KB of dynamic shared
// memory at chunk 256: one block per SM.  Not yet done (later work): bf16
// tensor-core products (mma.sync / wgmma) where both operands are bf16, a
// cp.async prefetch of the next chunk, two blocks per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;  // 16 x 16
constexpr int TILE = 64;          // query / key rows per tile; max P and N
constexpr int MAX_SMEM = 232448;  // 227 KB, a block's dynamic limit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  void* y;
  float* hT;
  int S, H, G, P, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

// floats of shared memory: x (Q x P), B (Q x N+1), a C tile (64 x N+1), a
// score tile (64 x 65), the state (N x P), and cum / dt / w (Q each)
__host__ __device__ inline long long smem_floats(int Q, int P, int N) {
  return static_cast<long long>(Q) * P + static_cast<long long>(Q) * (N + 1) +
         TILE * (N + 1) + TILE * (TILE + 1) + N * P + 3LL * Q;
}

template <typename T>
__global__ void __launch_bounds__(NUM_THREADS)
ssd_scan_kernel(const SsdArgs args) {
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

  const T* xb = static_cast<const T*>(args.x) + b * args.x_sb + h * args.x_sh;
  const float* dtb = args.dt + b * args.dt_sb + h * args.dt_sh;
  const T* bb = static_cast<const T*>(args.b) + b * args.b_sb + g * args.b_sg;
  const T* cb = static_cast<const T*>(args.c) + b * args.c_sb + g * args.c_sg;
  // y is contiguous (B, S, H, P)
  T* yb = static_cast<T*>(args.y) + (static_cast<long long>(b) * S * H + h) * P;
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
      sX[i] = to_f32(xb[(c0 + s) * args.x_ss + p]);
    }
    for (int i = tid; i < Q * N; i += NUM_THREADS) {
      const int s = i / N, n = i % N;
      sB[s * LB + n] = to_f32(bb[(c0 + s) * args.b_ss + n]);
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
            t0 + r < Q ? to_f32(cb[(c0 + t0 + r) * args.c_ss + n]) : 0.f;
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
        T* yrow = yb + (c0 + t) * y_ss;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yrow[p] = from_f32<T>(acc[i][j] + acc2[i][j] * e);
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (n < N && p < P) sH[n * P + p] = sH[n * P + p] * dec + hacc[i][j];
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

template <typename T>
int launch(const SsdArgs& args, int B, cudaStream_t stream) {
  const long long smem = smem_floats(args.Q, args.P, args.N) * 4;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<B * args.H, NUM_THREADS, static_cast<int>(smem),
                       stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) and b/c (B, S, G, N): bf16 (dtype 1) or f32 (dtype 0), the
// last dim contiguous, other strides in elements; G divides H.  dt (B, S, H)
// f32 with strides; a (H,) f32.  y (B, S, H, P) in x's dtype and hT
// (B, H, P, N) f32 are contiguous.  S % Q == 0, P and N <= 64.
// Returns cudaGetLastError() after the launch.
extern "C" int mist_ssd_scan(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* hT, int B, int S, int H, int G, int P,
    int N, int Q, int dtype, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, void* stream) {
  if (P < 1 || P > TILE || N < 1 || N > TILE || Q < 1 || S % Q || G < 1 ||
      H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs args{x,    static_cast<const float*>(dt), static_cast<const float*>(a),
               b,    c,    y,    static_cast<float*>(hT),
               S,    H,    G,    P,    N,    Q,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(args, B, s);
    case 1:
      return launch<__nv_bfloat16>(args, B, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
