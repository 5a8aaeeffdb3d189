// Helpers shared by the instance-norm kernels (instance_norm.cu,
// instance_norm_bwd.cu): element conversions, 16-byte packs and a block-wide
// sum of two floats.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tem {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// VEC consecutive elements moved as one load or store (16 bytes for VEC > 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Sum of (a, b) over a block of kThreads threads; the result is valid in
// thread 0. Call it at most once per kernel (it owns one shared buffer).
__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float2 warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 s = lane < kThreads / 32 ? warp_sums[lane] : make_float2(0.f, 0.f);
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_down_sync(0xffffffffu, s.x, off);
      s.y += __shfl_down_sync(0xffffffffu, s.y, off);
    }
    a = s.x;
    b = s.y;
  }
  return make_float2(a, b);
}

// The chunk [begin, end) of its row that block blockIdx.x handles: the grid
// is rows x splits, and block b takes row b / splits, chunk b % splits.
struct Chunk {
  int64_t row, begin, end;
};

__device__ __forceinline__ Chunk block_chunk(int64_t L, int64_t chunk, int splits) {
  Chunk c;
  c.row = blockIdx.x / splits;
  c.begin = chunk * (blockIdx.x % splits);
  c.end = c.begin + chunk < L ? c.begin + chunk : L;
  return c;
}

}  // namespace tem
