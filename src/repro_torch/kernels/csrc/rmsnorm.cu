// Fused RMSNorm for Hopper (sm_90a), written by hand.
//
// Replaces: src/repro/kernels/rmsnorm.py :: _rmsnorm_kernel (the Pallas TPU
// kernel behind rmsnorm <- ops.rmsnorm).  Computes, per row of a (rows, d)
// matrix, x * rsqrt(mean(x^2) + eps) * f32(scale) in f32, rounded once to
// the input dtype.
//
// What bounds it on an H100: memory.  It reads x once and writes y once
// (d * 2 bytes each way per bf16 row) and does ~4 flops per element, far
// below the card's ~295 FLOP/byte ridge: 4096 x 4096 bf16 moves 67 MB,
// ~20 us at 3.35 TB/s.
//
// What the design does about that: one warp per row, so a row needs no
// __syncthreads and its sum of squares is one warp-shuffle reduction.  A
// block of 8 warps walks the rows in a grid-stride loop, and the grid is
// the number of blocks the card holds at once (or fewer for few rows).
// - Register-resident widths (d 2048, 2560 and 4096, 16-byte aligned rows):
//   the row stays in registers between the sum and the scale pass, so x is read
//   from device memory exactly once, as 16-byte vectors, vector i * 32 +
//   lane of the row in lane `lane` (each load instruction of a warp reads
//   512 contiguous bytes).  NV, the vectors per lane, is a template
//   argument: bf16 16 at d 4096, 10 at d 2560 and 8 at d 2048 (64, 40 and
//   32 registers), f32 32, 20 and 16.  The scale is read once per block as 16-byte vectors,
//   converted to f32 once and kept in shared memory (16 KB at d 4096),
//   laid out so that each lane's float4 reads are conflict-free.  Shared
//   memory and not registers: at f32 x and d 4096 the row alone takes 128
//   registers a lane, and f32 scale would take 128 more.  The first row's
//   loads are issued before the scale is staged, so both are in flight
//   together; that one __syncthreads per block is the only barrier.
// - Every other width (and unaligned rows): the generic kernel, also one
//   warp per row, sums the row in one pass and scales it in a second pass
//   that re-reads x (from L1/L2) and the scale from global memory, with
//   16-byte vectors when the rows are aligned and scalar loads otherwise.
// Stores are 16-byte vectors wherever the loads are.
//
// The backward (mist_rmsnorm_bwd) replaces the gradient that jax.grad takes
// through the reference's norm (src/repro/models/layers.py:30-40), which
// the JAX model differentiates.  Per row, from x and the incoming gradient
// g, it recomputes r = rsqrt(mean(x^2) + eps) and, in f32,
//   dx = r * (g * s - xhat * mean(g * s * xhat)),  xhat = x * r,
// rounded once to x's dtype, and dscale = sum over rows of g * xhat in f32,
// rounded to scale's dtype.  Memory bounds it too: it reads x and g and
// writes dx (100.7 MB at 4096 x 4096 bf16, ~30 us at 3.35 TB/s).
//
// What the design does about that: one block per SM (the wrapper's grid),
// each owning a contiguous band of rows, balanced to within one row, and
// every row read from device memory once.
// - Ring widths (d 2048, 2560 and 4096, 16-byte aligned rows): one producer
//   thread streams the band, BWD_STAGE_ROWS rows of x and of g a stage,
//   into a ring of shared memory with 1-D bulk copies (one for x, one for g:
//   the rows of a stage are contiguous), on full/empty mbarriers; the ring
//   takes up to BWD_RING_BYTES, so that at least 64 KB are in flight.  The
//   consumer warps own columns: thread t holds vectors t, t + CT, ... of
//   every row (CT consumer threads, BWD_COLS columns each, so a warp's
//   16-byte reads and writes cover 512 contiguous bytes), with its scale
//   converted to f32 once and its dscale partial in f32 registers.  The
//   2 * BWD_STAGE_ROWS row sums of a stage (x^2 and g s x) take one
//   reduction: warp shuffles, a small shared array and one named barrier
//   among the consumer warps, after which the stage goes back to the
//   producer, which never waits on the consumers otherwise.  dx leaves as
//   16-byte stores.
// - Every other width (and unaligned rows): 8 warps over BWD_ROWS rows of
//   the band at a time, each thread the same columns of every row, its
//   dscale partials in shared memory no other thread touches (d * 4 bytes:
//   rows up to 57,856 wide); the row sums are one block reduction, and a
//   second pass re-reads the rows (from L1/L2) to write dx.
// Each block writes its f32 column partials to a (blocks, d) scratch.  The
// launch is cooperative, so the blocks are co-resident (the launch fails
// otherwise: nothing waits on a block that is not running); after a grid
// sync each block sums a slice of 32-column groups over the partials: warp
// w of its nw warps adds the partials of blocks [w * per, (w + 1) * per) in
// ascending order, and warp 0 adds the nw sums in ascending warp order.
// The order is fixed by the grid, whatever order the blocks finish in: no
// atomic decides a sum, and two calls agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;  // rows in flight per block, one per warp
constexpr int NUM_THREADS = WARPS * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows of exactly NV * 32 vectors of 16 bytes, held in registers.
template <typename T, typename S, int NV>
__global__ void __launch_bounds__(NUM_THREADS)
rmsnorm_resident_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ y, int rows, float eps,
                        int scale_vec) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector of x
  constexpr int D = NV * 32 * V;
  constexpr int F4 = V / 4;          // float4 of scale per vector of x
  constexpr int VS = 16 / sizeof(S); // elements per 16-byte vector of scale
  // element j of vector i * 32 + lane sits at ((i * F4 + j / 4) * 32 +
  // lane) * 4 + j % 4: a warp's float4 reads cover 512 contiguous bytes
  __shared__ __align__(16) float s_scale[D];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  int row = blockIdx.x * WARPS + warp;

  uint4 buf[NV];
  if (row < rows) {
    const uint4* xr = reinterpret_cast<const uint4*>(
        x + static_cast<long long>(row) * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) buf[i] = xr[i * 32 + lane];
  }
  // stage the scale as f32, once per block
  if (scale_vec) {
    for (int u = threadIdx.x; u < D / VS; u += NUM_THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(scale)[u];
      const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
      for (int q = 0; q < VS; ++q) {
        const int el = u * VS + q, vec = el / V, j = el % V;
        s_scale[(((vec >> 5) * F4 + j / 4) * 32 + (vec & 31)) * 4 + j % 4] =
            to_f32(e[q]);
      }
    }
  } else {
    for (int el = threadIdx.x; el < D; el += NUM_THREADS) {
      const int vec = el / V, j = el % V;
      s_scale[(((vec >> 5) * F4 + j / 4) * 32 + (vec & 31)) * 4 + j % 4] =
          to_f32(scale[el]);
    }
  }
  __syncthreads();

  for (bool first = true; row < rows; row += stride, first = false) {
    if (!first) {
      const uint4* xr = reinterpret_cast<const uint4*>(
          x + static_cast<long long>(row) * D);
#pragma unroll
      for (int i = 0; i < NV; ++i) buf[i] = xr[i * 32 + lane];
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
    // the scale pass converts the packed row again instead of keeping the
    // sum pass's f32 values alive (128 more registers at bf16 d 4096)
#pragma unroll
    for (int i = 0; i < NV; ++i)
      asm volatile("" : "+r"(buf[i].x), "+r"(buf[i].y), "+r"(buf[i].z),
                   "+r"(buf[i].w));
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<long long>(row) * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const T* e = reinterpret_cast<const T*>(&buf[i]);
      const float4* sc = reinterpret_cast<const float4*>(s_scale);
      float sv[V];
#pragma unroll
      for (int k = 0; k < F4; ++k) {
        const float4 f = sc[(i * F4 + k) * 32 + lane];
        sv[4 * k] = f.x;
        sv[4 * k + 1] = f.y;
        sv[4 * k + 2] = f.z;
        sv[4 * k + 3] = f.w;
      }
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        oe[j] = from_f32<T>(to_f32(e[j]) * r * sv[j]);
      yr[i * 32 + lane] = out;
    }
  }
}

// Any width: one warp per row, two passes over the row.
template <typename T, typename S>
__global__ void __launch_bounds__(NUM_THREADS)
rmsnorm_generic_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                       T* __restrict__ y, int rows, int d, float eps,
                       int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + warp; row < rows; row += stride) {
    const T* xr = x + static_cast<long long>(row) * d;
    T* yr = y + static_cast<long long>(row) * d;
    float ss = 0.f;
    if (vec_ok) {
      for (int i = lane; i < d / V; i += 32) {
        const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f32(e[j]);
          ss = fmaf(f, f, ss);
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float f = to_f32(xr[i]);
        ss = fmaf(f, f, ss);
      }
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    if (vec_ok) {
      for (int i = lane; i < d / V; i += 32) {
        const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
        const T* e = reinterpret_cast<const T*>(&raw);
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j)
          oe[j] = from_f32<T>(to_f32(e[j]) * r * to_f32(scale[i * V + j]));
        reinterpret_cast<uint4*>(yr)[i] = out;
      }
    } else {
      for (int i = lane; i < d; i += 32)
        yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
    }
  }
}

// the blocks of `kernel` that the card holds at once (asked once per kernel)
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NUM_THREADS,
                                                0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// one warp per row, at most the resident blocks
inline int grid_for(int rows, int most) {
  const int want = (rows + WARPS - 1) / WARPS;
  return want < most ? want : most;
}

template <typename T, typename S, int NV>
int launch_resident(const void* x, const void* scale, void* y, int rows,
                    float eps, cudaStream_t stream) {
  const int scale_vec =
      reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
      (NV * 32 * (16 / sizeof(T)) * sizeof(S)) % 16 == 0;
  auto kernel = rmsnorm_resident_kernel<T, S, NV>;
  static const int most = resident_blocks(kernel);
  kernel<<<grid_for(rows, most), NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rows, eps, scale_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int vec_ok, cudaStream_t stream) {
  // the register-resident widths (rmsnorm.py's RESIDENT_WIDTHS)
  constexpr int V = 16 / sizeof(T);
  if (vec_ok && d == 4096)
    return launch_resident<T, S, 4096 / (32 * V)>(x, scale, y, rows, eps,
                                                  stream);
  if (vec_ok && d == 2560)
    return launch_resident<T, S, 2560 / (32 * V)>(x, scale, y, rows, eps,
                                                  stream);
  if (vec_ok && d == 2048)
    return launch_resident<T, S, 2048 / (32 * V)>(x, scale, y, rows, eps,
                                                  stream);
  auto kernel = rmsnorm_generic_kernel<T, S>;
  static const int most = resident_blocks(kernel);
  kernel<<<grid_for(rows, most), NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rows, d, eps, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int BWD_COLS = 16;        // ring route: columns per consumer thread
constexpr int BWD_STAGE_ROWS = 2;   // ring route: rows of x and of g a stage
constexpr int BWD_RING_BYTES = 196608;  // ring route: shared memory of the ring
constexpr int BWD_MAX_STAGES = 8;
constexpr int BWD_ROWS = 4;  // generic route: rows per block reduction
// dynamic shared memory a block may have on an H100, less the static part
constexpr int BWD_SMEM_MAX = 232448 - 1024;

// stages of the ring for stages of `bytes`
__host__ __device__ constexpr int ring_stages(int bytes) {
  return BWD_RING_BYTES / bytes < BWD_MAX_STAGES ? BWD_RING_BYTES / bytes
                                                 : BWD_MAX_STAGES;
}

// the rows [lo, hi) of this block's band: balanced to within one row
__device__ __forceinline__ void row_band(int rows, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(blockIdx.x) * rows /
                        gridDim.x);
  hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * rows /
                        gridDim.x);
}

// Once every block of the (cooperative) grid has written its row of `part`
// (gridDim.x, d) and passed the grid sync: dscale[c] = the f32 sum of
// part[b][c] over the blocks, in a fixed order.  The blocks fall into runs
// of `per` = ceil(blocks / NW) consecutive blocks; block b takes columns
// [b * span, (b + 1) * span), span a whole number of 32-column groups, and
// each of its warps one run and one 32-column group at a time (with fewer
// runs than warps, the spare warps take more groups).  A warp adds its run's
// partials in ascending block order, and the runs' sums are added in
// ascending run order (rmsnorm.py's bwd_dscale_order).
template <typename S, int NW>
__device__ __forceinline__ void combine_dscale(const float* __restrict__ part,
                                               S* __restrict__ dscale, int d,
                                               float (*s_comb)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = gridDim.x;
  const int per = (g + NW - 1) / NW, runs = (g + per - 1) / per;
  const int groups = NW / runs;  // 32-column groups a step
  const int run = warp % runs, sub = warp / runs;
  const int b0 = run * per, b1 = min(g, b0 + per);
  const int span = ((d + g - 1) / g + 31) / 32 * 32;
  const int c0 = blockIdx.x * span, c_end = min(d, c0 + span);
  for (int step = c0; step < c0 + span; step += 32 * groups) {
    const int c = step + 32 * sub + lane;
    const bool mine = sub < groups && c < c_end;
    float acc = 0.f;
    if (mine) {
#pragma unroll 4
      for (int b = b0; b < b1; ++b)
        acc += __ldcg(part + static_cast<long long>(b) * d + c);
    }
    if (runs == 1) {  // the same for the whole block
      if (mine) dscale[c] = from_f32<S>(acc);
      continue;
    }
    s_comb[warp][lane] = acc;
    __syncthreads();
    if (run == 0 && mine) {
      float t = 0.f;
      for (int r = 0; r < runs; ++r) t += s_comb[sub * runs + r][lane];
      dscale[c] = from_f32<S>(t);
    }
    __syncthreads();
  }
}

// Ring route: rows of CW * 32 * BWD_COLS elements, 16-byte aligned.  CW
// consumer warps and one producer warp.
template <typename T, typename S, int CW>
__global__ void __launch_bounds__((CW + 1) * 32, 1)
rmsnorm_bwd_ring_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                        const S* __restrict__ scale, T* __restrict__ dx,
                        float* __restrict__ part, S* __restrict__ dscale,
                        int rows, float eps) {
  using namespace hopper;
  constexpr int V = 16 / sizeof(T);    // elements per 16-byte vector
  constexpr int NV = BWD_COLS / V;     // vectors per consumer thread
  constexpr int CT = CW * 32;          // consumer threads
  constexpr int D = CT * BWD_COLS;
  constexpr int R = BWD_STAGE_ROWS;
  constexpr int ROW_BYTES = D * static_cast<int>(sizeof(T));
  constexpr int STAGE_BYTES = 2 * R * ROW_BYTES;  // x rows, then g rows
  constexpr int STAGES = ring_stages(STAGE_BYTES);
  static_assert(STAGES >= 2, "the ring needs two stages");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];  // full, then empty
  __shared__ float s_red[2][CW][2 * R];
  __shared__ float s_comb[CW + 1][32];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int lo, hi;
  row_band(rows, lo, hi);
  const int nrows = hi - lo, nst = (nrows + R - 1) / R;
  const uint32_t ring0 = smem_u32(ring), full0 = smem_u32(bars),
                 empty0 = full0 + 8 * STAGES;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);   // the producer's arrival
      mbar_init(empty0 + 8 * st, 1);  // one consumer's, after the reduction
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CW) {
    // producer: stage k holds rows lo + k R ... of x, then the same of g
    if (lane == 0) {
      for (int k = 0; k < nst; ++k) {
        const int slot = k % STAGES;
        if (k >= STAGES) mbar_wait(empty0 + 8 * slot, (k / STAGES - 1) & 1);
        const uint32_t bytes = min(R, nrows - k * R) * ROW_BYTES;
        const long long off = static_cast<long long>(lo + k * R) * D;
        const uint32_t dst = ring0 + slot * STAGE_BYTES;
        mbar_expect(full0 + 8 * slot, 2 * bytes);
        bulk_load(dst, x + off, bytes, full0 + 8 * slot);
        bulk_load(dst + R * ROW_BYTES, gy + off, bytes, full0 + 8 * slot);
      }
    }
    __syncwarp();
  } else {
    // consumers: vector i of this thread is vector i * CT + tid of a row
    float sc[NV][V], dpart[NV][V];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sc[i][j] = to_f32(scale[(i * CT + tid) * V + j]);
        dpart[i][j] = 0.f;
      }
    for (int k = 0; k < nst; ++k) {
      const int slot = k % STAGES, n = min(R, nrows - k * R);
      mbar_wait(full0 + 8 * slot, (k / STAGES) & 1);
      const uint4* xs = reinterpret_cast<const uint4*>(ring + slot * STAGE_BYTES);
      const uint4* gs = xs + R * (ROW_BYTES / 16);
      uint4 xv[R][NV], gv[R][NV];
      float acc[2 * R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        float ss = 0.f, gsx = 0.f;
        if (rr < n) {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            xv[rr][i] = xs[rr * (ROW_BYTES / 16) + i * CT + tid];
            gv[rr][i] = gs[rr * (ROW_BYTES / 16) + i * CT + tid];
            const T* xe = reinterpret_cast<const T*>(&xv[rr][i]);
            const T* ge = reinterpret_cast<const T*>(&gv[rr][i]);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float xf = to_f32(xe[j]);
              ss = fmaf(xf, xf, ss);
              gsx = fmaf(to_f32(ge[j]) * sc[i][j], xf, gsx);
            }
          }
        }
        acc[2 * rr] = ss;
        acc[2 * rr + 1] = gsx;
      }
      // one reduction for the stage's rows (s_red double-buffered, so one
      // barrier a stage suffices); then the stage goes back to the producer
      float (*red)[2 * R] = s_red[k & 1];
#pragma unroll
      for (int q = 0; q < 2 * R; ++q) {
        const float v = warp_sum(acc[q]);
        if (lane == 0) red[warp][q] = v;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
      mbar_arrive_if(empty0 + 8 * slot, tid == 0);
#pragma unroll
      for (int q = 0; q < 2 * R; ++q) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < CW; ++w) v += red[w][q];
        acc[q] = v;
      }
      // dx = r g s - x r^3 mean(g s x); dscale partial += g x r
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        if (rr >= n) break;
        const float r = rsqrtf(acc[2 * rr] / static_cast<float>(D) + eps);
        const float c = r * r * r * (acc[2 * rr + 1] / static_cast<float>(D));
        uint4* dr = reinterpret_cast<uint4*>(
            dx + static_cast<long long>(lo + k * R + rr) * D);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const T* xe = reinterpret_cast<const T*>(&xv[rr][i]);
          const T* ge = reinterpret_cast<const T*>(&gv[rr][i]);
          uint4 out;
          T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = to_f32(xe[j]), gf = to_f32(ge[j]);
            oe[j] = from_f32<T>(r * gf * sc[i][j] - xf * c);
            dpart[i][j] = fmaf(gf, xf * r, dpart[i][j]);
          }
          dr[i * CT + tid] = out;
        }
      }
    }
    float4* pb = reinterpret_cast<float4*>(
        part + static_cast<long long>(blockIdx.x) * D);
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        pb[(i * CT + tid) * (V / 4) + q] =
            make_float4(dpart[i][4 * q], dpart[i][4 * q + 1],
                        dpart[i][4 * q + 2], dpart[i][4 * q + 3]);
  }
  cg::this_grid().sync();
  combine_dscale<S, CW + 1>(part, dscale, D, s_comb);
}

// Generic route: any width up to BWD_SMEM_MAX / 4.  8 warps over BWD_ROWS
// rows of the band at a time, two passes over each row.
template <typename T, typename S>
__global__ void __launch_bounds__(NUM_THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                   const S* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ part, S* __restrict__ dscale,
                   int rows, int d, float eps, int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  // the column partials; with vectors, element j of vector u sits at
  // j * nvec + u, so that a warp's updates fall in distinct banks
  extern __shared__ __align__(16) float s_part[];
  __shared__ float s_red[2][WARPS][2 * BWD_ROWS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nvec = vec_ok ? d / V : 0;
  int lo, hi;
  row_band(rows, lo, hi);
  for (int j = tid; j < d; j += NUM_THREADS) s_part[j] = 0.f;
  __syncthreads();

  int it = 0;
  for (int r0 = lo; r0 < hi; r0 += BWD_ROWS, ++it) {
    // pass 1: per row, sum x^2 and sum g s x over this thread's columns
    float acc[2 * BWD_ROWS];
#pragma unroll
    for (int i = 0; i < 2 * BWD_ROWS; ++i) acc[i] = 0.f;
#pragma unroll
    for (int rr = 0; rr < BWD_ROWS; ++rr) {
      const int row = r0 + rr;
      if (row >= hi) break;
      const T* xr = x + static_cast<long long>(row) * d;
      const T* gr = gy + static_cast<long long>(row) * d;
      float ss = 0.f, gsx = 0.f;
      if (vec_ok) {
        for (int u = tid; u < nvec; u += NUM_THREADS) {
          const uint4 xv = reinterpret_cast<const uint4*>(xr)[u];
          const uint4 gv = reinterpret_cast<const uint4*>(gr)[u];
          const T* xe = reinterpret_cast<const T*>(&xv);
          const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = to_f32(xe[j]);
            ss = fmaf(xf, xf, ss);
            gsx = fmaf(to_f32(ge[j]) * to_f32(scale[u * V + j]), xf, gsx);
          }
        }
      } else {
        for (int j = tid; j < d; j += NUM_THREADS) {
          const float xf = to_f32(xr[j]);
          ss = fmaf(xf, xf, ss);
          gsx = fmaf(to_f32(gr[j]) * to_f32(scale[j]), xf, gsx);
        }
      }
      acc[2 * rr] = ss;
      acc[2 * rr + 1] = gsx;
    }
    // one block reduction for all BWD_ROWS rows (s_red double-buffered, so
    // one barrier an iteration suffices)
    float (*red)[2 * BWD_ROWS] = s_red[it & 1];
#pragma unroll
    for (int i = 0; i < 2 * BWD_ROWS; ++i) {
      const float v = warp_sum(acc[i]);
      if (lane == 0) red[warp][i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * BWD_ROWS; ++i) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w][i];
      acc[i] = v;
    }
    // pass 2: dx = r g s - x r^3 mean(g s x); dscale partial += g x r
#pragma unroll
    for (int rr = 0; rr < BWD_ROWS; ++rr) {
      const int row = r0 + rr;
      if (row >= hi) break;
      const float r = rsqrtf(acc[2 * rr] / static_cast<float>(d) + eps);
      const float c = r * r * r * (acc[2 * rr + 1] / static_cast<float>(d));
      const T* xr = x + static_cast<long long>(row) * d;
      const T* gr = gy + static_cast<long long>(row) * d;
      T* dr = dx + static_cast<long long>(row) * d;
      if (vec_ok) {
        for (int u = tid; u < nvec; u += NUM_THREADS) {
          const uint4 xv = reinterpret_cast<const uint4*>(xr)[u];
          const uint4 gv = reinterpret_cast<const uint4*>(gr)[u];
          const T* xe = reinterpret_cast<const T*>(&xv);
          const T* ge = reinterpret_cast<const T*>(&gv);
          uint4 out;
          T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = to_f32(xe[j]), gf = to_f32(ge[j]);
            oe[j] = from_f32<T>(r * gf * to_f32(scale[u * V + j]) - xf * c);
            float& sp = s_part[j * nvec + u];
            sp = fmaf(gf, xf * r, sp);
          }
          reinterpret_cast<uint4*>(dr)[u] = out;
        }
      } else {
        for (int j = tid; j < d; j += NUM_THREADS) {
          const float xf = to_f32(xr[j]), gf = to_f32(gr[j]);
          dr[j] = from_f32<T>(r * gf * to_f32(scale[j]) - xf * c);
          s_part[j] = fmaf(gf, xf * r, s_part[j]);
        }
      }
    }
  }
  __syncthreads();
  float* pb = part + static_cast<long long>(blockIdx.x) * d;
  for (int j = tid; j < d; j += NUM_THREADS)
    pb[j] = s_part[vec_ok ? (j % V) * nvec + j / V : j];
  cg::this_grid().sync();  // also a block barrier: s_part is free again
  combine_dscale<S, WARPS>(part, dscale, d,
                           reinterpret_cast<float(*)[32]>(s_part));
}

// a cooperative launch of `kernel` with `smem` bytes of dynamic shared
// memory (at most `smem_max`, set once per kernel): it fails, and runs
// nothing, when the grid's blocks cannot all be resident at once
template <auto kernel>
int launch_cooperative(int blocks, int threads, int smem, int smem_max,
                       void** args, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(threads),
      args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S, int CW>
int launch_bwd_ring(const T* x, const T* gy, const S* scale, T* dx,
                    float* part, S* dscale, int rows, float eps, int blocks,
                    cudaStream_t stream) {
  constexpr int D = CW * 32 * BWD_COLS;
  constexpr int STAGE_BYTES =
      2 * BWD_STAGE_ROWS * D * static_cast<int>(sizeof(T));
  constexpr int SMEM = ring_stages(STAGE_BYTES) * STAGE_BYTES;
  void* args[] = {&x, &gy, &scale, &dx, &part, &dscale, &rows, &eps};
  return launch_cooperative<rmsnorm_bwd_ring_kernel<T, S, CW>>(
      blocks, (CW + 1) * 32, SMEM, SMEM, args, stream);
}

template <typename T, typename S>
int launch_bwd(const void* x_, const void* gy_, const void* scale_,
               void* dx_, void* dscale_, void* part_, int rows, int d,
               float eps, int vec_ok, int blocks, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* gy = static_cast<const T*>(gy_);
  const S* scale = static_cast<const S*>(scale_);
  T* dx = static_cast<T*>(dx_);
  S* dscale = static_cast<S*>(dscale_);
  float* part = static_cast<float*>(part_);
  // the ring widths (rmsnorm.py's BWD_RING_WIDTHS)
  if (vec_ok) switch (d) {
      case 2560:
        return launch_bwd_ring<T, S, 2560 / (32 * BWD_COLS)>(
            x, gy, scale, dx, part, dscale, rows, eps, blocks, stream);
      case 4096:
        return launch_bwd_ring<T, S, 4096 / (32 * BWD_COLS)>(
            x, gy, scale, dx, part, dscale, rows, eps, blocks, stream);
      case 2048:
        return launch_bwd_ring<T, S, 2048 / (32 * BWD_COLS)>(
            x, gy, scale, dx, part, dscale, rows, eps, blocks, stream);
    }
  // the column partials, and after the grid sync the combine's WARPS x 32
  const int smem = (d > WARPS * 32 ? d : WARPS * 32) *
                   static_cast<int>(sizeof(float));
  if (smem > BWD_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &gy, &scale, &dx, &part, &dscale, &rows, &d, &eps,
                  &vec_ok};
  return launch_cooperative<rmsnorm_bwd_kernel<T, S>>(
      blocks, NUM_THREADS, smem, BWD_SMEM_MAX, args, stream);
}

}  // namespace

// x, y (rows, d) contiguous; scale (d,) contiguous.  dtype codes: 0 = f32,
// 1 = bf16.  vec_ok: x and y are 16-byte aligned and d * sizeof(x) is a
// multiple of 16.  Returns cudaGetLastError() after the launch.
extern "C" int mist_rmsnorm(const void* x, const void* scale, void* y,
                            int rows, int d, float eps, int x_dtype,
                            int scale_dtype, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps,
                                                vec_ok, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, vec_ok, s);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, y, rows, d, eps, vec_ok, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, vec_ok, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// x, gy, dx (rows, d) contiguous, gy and dx of x's dtype; scale and dscale
// (d,) of scale's dtype; part (blocks, d) f32 scratch.  dtype codes and
// vec_ok as in mist_rmsnorm (vec_ok also covers gy and dx).  `blocks` is
// the grid, at most rows and at most the SMs (a cooperative launch of a
// grid the card cannot hold at once fails): each block owns a band of rows
// and writes one row of part.  Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int mist_rmsnorm_bwd(const void* x, const void* gy,
                                const void* scale, void* dx, void* dscale,
                                void* part, int rows, int d, float eps,
                                int x_dtype, int scale_dtype, int vec_ok,
                                int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, gy, scale, dx, dscale, part, rows, d, eps, vec_ok, blocks, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, gy, scale, dx, dscale, part,
                                            rows, d, eps, vec_ok, blocks, s);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch_bwd<float, float>(x, gy, scale, dx, dscale, part, rows, d,
                                    eps, vec_ok, blocks, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, gy, scale, dx, dscale, part,
                                            rows, d, eps, vec_ok, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
