// Parameter-free instance norm over the spatial axes of a channel-first
// (N, C, *spatial) tensor, for Hopper (sm_90a): the backward.
//
// Replaces the Pallas TPU kernel torch_em_tpu/ops/pallas/norm.py:_bwd_kernel
// (driven by _norm_bwd, the custom VJP of instance_norm_pallas). Same math:
// per (sample, channel) row of length L, with the forward's f32 mean and rstd,
//   xhat = (x - mean) * rstd
//   dx   = rstd * (g - mean(g) - xhat * mean(g * xhat))
// computed in f32 and written in x's type.
//
// Rows reach 2.1 M elements in training (13 M at inference), far beyond one
// SM's shared memory, and blocks run in no order, so the two row means come
// from a split reduction with no atomics (the result is deterministic):
//   pass 1: grid of rows x splits; each block reads one chunk of x and g,
//           recomputes xhat, and reduces the chunk to an f32 partial
//           (sum g, sum g * xhat) in a scratch buffer;
//   pass 2: same grid; each block folds its row's partials into the two
//           means, reads its chunk of x and g again and writes dx.
// Bound: bytes. The function must read x and g and write dx once, 3 * L *
// itemsize per row; this kernel reads x and g twice, 5 * L * itemsize. One
// read of each (a row resident across a cluster, or TMA-fed tiles) is later
// work.
//
// Plain C interface, loaded with ctypes. The caller allocates dx and the
// scratch buffer, and passes PyTorch's current stream. The function returns
// cudaGetLastError() after each launch; the caller raises on nonzero.

#include "common.cuh"

namespace {

using namespace tem;

// chunk and L are multiples of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
grad_partials(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ mean,
              const float* __restrict__ rstd, float2* __restrict__ partial, int64_t L,
              int64_t chunk, int splits) {
  const Chunk c = block_chunk(L, chunk, splits);
  const float m = mean[c.row], r = rstd[c.row];
  const T* xr = x + c.row * L;
  const T* gr = g + c.row * L;
  float sg = 0.f, sgx = 0.f;
  for (int64_t i = c.begin + (int64_t)threadIdx.x * VEC; i < c.end; i += (int64_t)kThreads * VEC) {
    const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    const Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(gr + i);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gv = to_float(pg.v[k]);
      sg += gv;
      sgx += gv * ((to_float(px.v[k]) - m) * r);
    }
  }
  const float2 t = block_sum(sg, sgx);
  if (threadIdx.x == 0) partial[blockIdx.x] = t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
grad_apply(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ mean,
           const float* __restrict__ rstd, const float2* __restrict__ partial,
           T* __restrict__ dx, int64_t L, int64_t chunk, int splits) {
  __shared__ float means[2];
  const Chunk c = block_chunk(L, chunk, splits);
  const float2* pr = partial + c.row * splits;
  float sg = 0.f, sgx = 0.f;
  for (int i = threadIdx.x; i < splits; i += kThreads) {
    sg += pr[i].x;
    sgx += pr[i].y;
  }
  const float2 t = block_sum(sg, sgx);
  if (threadIdx.x == 0) {
    means[0] = t.x / (float)L;
    means[1] = t.y / (float)L;
  }
  __syncthreads();
  const float mg = means[0], mgx = means[1];
  const float m = mean[c.row], r = rstd[c.row];
  const T* xr = x + c.row * L;
  const T* gr = g + c.row * L;
  T* dr = dx + c.row * L;
  for (int64_t i = c.begin + (int64_t)threadIdx.x * VEC; i < c.end; i += (int64_t)kThreads * VEC) {
    const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    const Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(gr + i);
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xhat = (to_float(px.v[k]) - m) * r;
      o.v[k] = from_float<T>(r * (to_float(pg.v[k]) - mg - xhat * mgx));
    }
    *reinterpret_cast<Pack<T, VEC>*>(dr + i) = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* g, const void* mean, const void* rstd, void* dx,
           void* partial, int64_t rows, int64_t L, int64_t chunk, int splits,
           cudaStream_t stream) {
  const int64_t blocks = rows * splits;
  grad_partials<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<float2*>(partial), L, chunk, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_apply<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float2*>(partial), static_cast<T*>(dx),
      L, chunk, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x, g and dx share it. vec: elements per
// load, 1 or 16 bytes' worth (4 for float32, 8 for bfloat16); the caller
// picks 16 bytes only when x, g and dx are 16-byte aligned and L is a
// multiple of it. mean and rstd hold rows floats each, chunk is a multiple of
// vec, splits = ceil(L / chunk), and partial holds rows * splits float2.
extern "C" int tem_instance_norm_bwd(const void* x, const void* g, const void* mean,
                                     const void* rstd, void* dx, void* partial, int64_t rows,
                                     int64_t L, int64_t chunk, int splits, int dtype, int vec,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, g, mean, rstd, dx, partial, rows, L, chunk, splits, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, g, mean, rstd, dx, partial, rows, L, chunk, splits, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, g, mean, rstd, dx, partial, rows, L, chunk, splits, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, g, mean, rstd, dx, partial, rows, L, chunk, splits, s);
  return (int)cudaErrorInvalidValue;
}
