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
// What the design does about that: one block per row, so any number of
// rows works and every row is one independent pass; 16-byte vector loads
// and stores when the row is 16-byte aligned (plain loads otherwise); the
// f32 sum of squares is reduced with warp shuffles and one shared-memory
// step across warps.  The second pass re-reads the row, which at d 4096
// (8 KB) is still in L1/L2, so device memory sees one read and one write.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;

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

template <typename T, typename S>
__global__ void __launch_bounds__(NUM_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, int d, float eps, int vec_ok) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const T* xr = x + static_cast<long long>(blockIdx.x) * d;
  T* yr = y + static_cast<long long>(blockIdx.x) * d;

  float ss = 0.f;
  if (vec_ok) {
    for (int i = threadIdx.x; i < d / V; i += NUM_THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += NUM_THREADS) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float part[NUM_THREADS / 32];
  __shared__ float total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float p = lane < NUM_THREADS / 32 ? part[lane] : 0.f;
    p = warp_sum(p);
    if (lane == 0) total = p;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  if (vec_ok) {
    for (int i = threadIdx.x; i < d / V; i += NUM_THREADS) {
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
    for (int i = threadIdx.x; i < d; i += NUM_THREADS)
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, int vec_ok, cudaStream_t stream) {
  rmsnorm_kernel<T, S><<<rows, NUM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), d, eps, vec_ok);
  return static_cast<int>(cudaGetLastError());
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
