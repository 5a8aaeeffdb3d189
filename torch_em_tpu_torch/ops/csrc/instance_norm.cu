// Parameter-free instance norm over the spatial axes of a channel-first
// (N, C, *spatial) tensor, for Hopper (sm_90a): the forward.
//
// Replaces the Pallas TPU kernel torch_em_tpu/ops/pallas/norm.py:_fwd_kernel
// (driven by _norm_fwd). Same math: per (sample, channel) row of length L,
// f32 sum and sum of squares in one read, mean = sum / L,
// rstd = rsqrt(E[x^2] - mean^2 + eps), y = (x - mean) * rstd in x's type,
// and the row's f32 mean and rstd, which the backward (instance_norm_bwd.cu)
// reads.
//
// In the channel-first layout each (n, c) row is contiguous, so a row is a
// flat range of L elements. Rows at the main path's widths hold up to 13 M
// elements, far beyond one SM's shared memory, so the reduction is split:
//   pass 1: grid of rows x splits; each block reduces one chunk of its row
//           to an f32 (sum, sumsq) partial in a scratch buffer;
//   pass 2: same grid; each block folds its row's partials into mean and
//           rstd, then normalises its chunk and writes it; the block of
//           chunk 0 also writes the row's mean and rstd.
// The work is bound by memory traffic (x read twice, y written once). A
// one-read design (a row resident across a cluster) is left for later.
//
// Plain C interface, loaded with ctypes. The caller allocates y, mean, rstd
// and the scratch buffer, and passes PyTorch's current stream. The function
// returns cudaGetLastError() after each launch; the caller raises on nonzero.

#include "common.cuh"

namespace {

using namespace tem;

// chunk and L are multiples of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
row_partials(const T* __restrict__ x, float2* __restrict__ partial, int64_t L,
             int64_t chunk, int splits) {
  const Chunk c = block_chunk(L, chunk, splits);
  const T* xr = x + c.row * L;
  float s = 0.f, q = 0.f;
  for (int64_t i = c.begin + (int64_t)threadIdx.x * VEC; i < c.end; i += (int64_t)kThreads * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = to_float(p.v[k]);
      s += v;
      q += v * v;
    }
  }
  const float2 t = block_sum(s, q);
  if (threadIdx.x == 0) partial[blockIdx.x] = t;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
row_normalize(const T* __restrict__ x, const float2* __restrict__ partial,
              T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int64_t L, int64_t chunk, int splits, float eps) {
  __shared__ float mean_rstd[2];
  const Chunk c = block_chunk(L, chunk, splits);
  const float2* pr = partial + c.row * splits;
  float s = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < splits; i += kThreads) {
    s += pr[i].x;
    q += pr[i].y;
  }
  const float2 t = block_sum(s, q);
  if (threadIdx.x == 0) {
    const float mean = t.x / (float)L;
    const float rstd = rsqrtf(t.y / (float)L - mean * mean + eps);
    mean_rstd[0] = mean;
    mean_rstd[1] = rstd;
    if (c.begin == 0) {
      mean_out[c.row] = mean;
      rstd_out[c.row] = rstd;
    }
  }
  __syncthreads();
  const float mean = mean_rstd[0], rstd = mean_rstd[1];
  const T* xr = x + c.row * L;
  T* yr = y + c.row * L;
  for (int64_t i = c.begin + (int64_t)threadIdx.x * VEC; i < c.end; i += (int64_t)kThreads * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o.v[k] = from_float<T>((to_float(p.v[k]) - mean) * rstd);
    *reinterpret_cast<Pack<T, VEC>*>(yr + i) = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, void* y, void* mean, void* rstd, void* partial, int64_t rows,
           int64_t L, int64_t chunk, int splits, float eps, cudaStream_t stream) {
  const int64_t blocks = rows * splits;
  row_partials<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float2*>(partial), L, chunk, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_normalize<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float2*>(partial), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), L, chunk, splits, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec: elements per load, 1 or 16 bytes'
// worth (4 for float32, 8 for bfloat16); the caller picks 16 bytes only when
// x and y are 16-byte aligned and L is a multiple of it. chunk is a multiple
// of vec, splits = ceil(L / chunk), partial holds rows * splits float2, and
// mean and rstd hold rows floats each.
extern "C" int tem_instance_norm_fwd(const void* x, void* y, void* mean, void* rstd,
                                     void* partial, int64_t rows, int64_t L, int64_t chunk,
                                     int splits, int dtype, int vec, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, y, mean, rstd, partial, rows, L, chunk, splits, eps, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, y, mean, rstd, partial, rows, L, chunk, splits, eps, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, y, mean, rstd, partial, rows, L, chunk, splits, eps, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, y, mean, rstd, partial, rows, L, chunk, splits, eps, s);
  return (int)cudaErrorInvalidValue;
}
