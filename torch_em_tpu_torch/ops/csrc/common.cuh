// The three row paths shared by the instance-norm kernels (instance_norm.cu,
// instance_norm_bwd.cu), and their helpers.
//
// Both kernels work on rows: the (sample, channel) rows of a channel-first
// (N, C, *spatial) tensor, each a contiguous range of L elements. Per row a
// kernel reduces two f32 sums over the whole row, folds them into the row's
// coefficients, then writes one output element per input element from them.
// An Op says what the sums, the coefficients and the output are:
//
//   struct Op {
//     static constexpr int kIn;          // inputs per element (x; or x and g)
//     struct Row {...};                  // per-row values, trivially copyable
//     Row start(row);                    // before the sums (e.g. saved stats)
//     void add(const Row&, const float* v, float& a, float& b);  // v[kIn]
//     Row finish(row, Row, float2 sums, L, bool writer);  // writer: one block per row
//     float apply(const Row&, const float* v);            // the output element
//   };
//
// Each input element is read once from device memory on paths A and B; on
// path C the second read is arranged to come from L2. The plan (block
// counts, cluster size, slice per block) comes from the caller, which is
// ops/instance_norm.py:plan; launch() checks that it fits the kernels.
//
// A. row_in_registers: one block per row of at most kThreadsA * kItemsA
//    elements. Each thread keeps its up to kItemsA elements of every input in
//    registers, the block reduces, then normalises from the registers.
// B. row_in_cluster: a thread-block cluster of n blocks per row. Each block
//    copies its slice of the row into shared memory (cp.async), reduces it, and the
//    blocks exchange their two partial sums through distributed shared
//    memory; each then normalises its slice from shared memory.
// C. row_through_l2: a cooperative (all blocks resident) persistent grid;
//    `in_flight` rows at a time, `per_row` blocks each. A block reduces its
//    slice (read from device memory), publishes its partial and counts its
//    arrival on the row's counter, waits for the row's other blocks, folds
//    all partials, and re-reads its slice in reverse order, from L2, with
//    last-use loads and streaming stores so the output evicts the input last.
//
// All sums fold in a fixed order and no float is added atomically, so two
// calls on the same input give bitwise-equal results.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tem {

namespace cg = cooperative_groups;

constexpr int kThreadsA = 512;   // path A: most threads of a block (the plan may use fewer)
constexpr int kItemsA = 32;      // path A: elements of each input one thread holds
constexpr int kThreadsB = 1024;  // path B: threads of a block
constexpr int kThreadsC = 512;   // path C: threads of a block
constexpr int kBlocksPerSmC = 2; // path C: blocks the plan puts on one SM
constexpr int kSmemB = 225 * 1024;  // path B: most dynamic shared memory of a block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// Round to nearest even, as torch's .to(dtype).
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// VEC consecutive elements moved as one load or store (16 bytes for VEC > 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// kLastUse: a 16-byte load that marks its line first to evict (path C's re-read).
template <typename T, int VEC, bool kLastUse = false>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  Pack<T, VEC> out;
  if constexpr (kLastUse && sizeof(Pack<T, VEC>) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &u, 16);
  } else {
    out = *reinterpret_cast<const Pack<T, VEC>*>(p);
  }
  return out;
}

// kStreaming: a 16-byte store that marks its line first to evict (path C).
template <typename T, int VEC, bool kStreaming = false>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& v) {
  if constexpr (kStreaming && sizeof(Pack<T, VEC>) == 16) {
    uint4 u;
    memcpy(&u, &v, 16);
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
    *reinterpret_cast<Pack<T, VEC>*>(p) = v;
  }
}

// The inputs and the output of a launch: `rows` rows of L elements each.
template <typename T, int NIN>
struct Rows {
  const T* in[NIN];
  T* out;
  int64_t L;
};

// v[k][n] = element k of the pack at `off` of input n.
template <typename T, int VEC, int NIN, bool kLastUse = false>
__device__ __forceinline__ void load(const Rows<T, NIN>& a, int64_t off, float (&v)[VEC][NIN]) {
#pragma unroll
  for (int n = 0; n < NIN; ++n) {
    const Pack<T, VEC> p = load_pack<T, VEC, kLastUse>(a.in[n] + off);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k][n] = to_float(p.v[k]);
  }
}

template <typename T, int VEC, bool kStreaming = false, class Op, int NIN>
__device__ __forceinline__ void apply_store(T* dst, const Op& op, const typename Op::Row& r,
                                            const float (&v)[VEC][NIN]) {
  Pack<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = from_float<T>(op.apply(r, v[k]));
  store_pack<T, VEC, kStreaming>(dst, o);
}

// Sum of (a, b) over the block (blockDim.x a multiple of 32); the result is
// valid in thread 0. `scratch` is 32 float2 of shared memory; the barrier on
// entry lets a block call this more than once.
__device__ __forceinline__ float2 block_sum(float a, float b, float2* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 s = lane < (int)blockDim.x / 32 ? scratch[lane] : make_float2(0.f, 0.f);
    for (int off = 16; off > 0; off >>= 1) {
      s.x += __shfl_down_sync(0xffffffffu, s.x, off);
      s.y += __shfl_down_sync(0xffffffffu, s.y, off);
    }
    a = s.x;
    b = s.y;
  }
  return make_float2(a, b);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// ---- path A: the row in registers ----------------------------------------

template <typename T, int VEC, class Op>
__global__ void __launch_bounds__(kThreadsA)
row_in_registers(Rows<T, Op::kIn> a, Op op) {
  constexpr int kPacks = kItemsA / VEC;
  __shared__ float2 scratch[32];
  __shared__ typename Op::Row shared_row;
  const int64_t row = blockIdx.x;
  const int64_t base = row * a.L;
  typename Op::Row r = op.start(row);
  float v[kPacks][VEC][Op::kIn];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int p = 0; p < kPacks; ++p) {
    const int64_t i = ((int64_t)p * blockDim.x + threadIdx.x) * VEC;
    if (i < a.L) {
      load<T, VEC>(a, base + i, v[p]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) op.add(r, v[p][k], s, q);
    }
  }
  const float2 t = block_sum(s, q, scratch);
  if (threadIdx.x == 0) shared_row = op.finish(row, r, t, a.L, true);
  __syncthreads();
  r = shared_row;
#pragma unroll
  for (int p = 0; p < kPacks; ++p) {
    const int64_t i = ((int64_t)p * blockDim.x + threadIdx.x) * VEC;
    if (i < a.L) apply_store<T, VEC>(a.out + base + i, op, r, v[p]);
  }
}

// ---- path B: the row in a cluster's shared memory -------------------------

// span: elements of the row per block, a multiple of 16 bytes' worth.
template <typename T, int VEC, class Op>
__global__ void __launch_bounds__(kThreadsB)
row_in_cluster(Rows<T, Op::kIn> a, int64_t span, Op op) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* held = reinterpret_cast<T*>(smem);  // Op::kIn slices of span elements
  __shared__ float2 scratch[32];
  __shared__ float2 partial;
  __shared__ typename Op::Row shared_row;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), n = cluster.num_blocks();
  const int64_t row = blockIdx.x / n;
  const int64_t base = row * a.L;
  const int64_t begin = (int64_t)rank * span;
  const int64_t end = begin + span < a.L ? begin + span : a.L;
  // copy the slice in: 16-byte cp.async keeps every copy of a thread in flight
  // at once; the scalar path (misaligned or odd rows) copies through registers
  for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += (int64_t)kThreadsB * VEC) {
#pragma unroll
    for (int m = 0; m < Op::kIn; ++m) {
      T* dst = held + m * span + (i - begin);
      if constexpr (sizeof(Pack<T, VEC>) == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(a.in[m] + base + i)
                     : "memory");
      } else {
        store_pack<T, VEC>(dst, load_pack<T, VEC>(a.in[m] + base + i));
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  typename Op::Row r = op.start(row);
  float s = 0.f, q = 0.f;
  for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += (int64_t)kThreadsB * VEC) {
    float v[VEC][Op::kIn];
#pragma unroll
    for (int m = 0; m < Op::kIn; ++m) {
      const Pack<T, VEC> p = load_pack<T, VEC>(held + m * span + (i - begin));
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k][m] = to_float(p.v[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) op.add(r, v[k], s, q);
  }
  const float2 t = block_sum(s, q, scratch);
  if (threadIdx.x == 0) partial = t;
  cluster.sync();  // every block's partial is written
  if (threadIdx.x == 0) {
    float2 sum = make_float2(0.f, 0.f);
    for (unsigned k = 0; k < n; ++k) {
      const float2 p = *cluster.map_shared_rank(&partial, k);
      sum.x += p.x;
      sum.y += p.y;
    }
    shared_row = op.finish(row, r, sum, a.L, rank == 0);
  }
  cluster.sync();  // every block has read the others' partials; shared_row is set
  r = shared_row;
  for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += (int64_t)kThreadsB * VEC) {
    float v[VEC][Op::kIn];
#pragma unroll
    for (int m = 0; m < Op::kIn; ++m) {
      const Pack<T, VEC> p = load_pack<T, VEC>(held + m * span + (i - begin));
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k][m] = to_float(p.v[k]);
    }
    apply_store<T, VEC>(a.out + base + i, op, r, v);
  }
}

// ---- path C: the second read from L2 -------------------------------------

// Grid: in_flight * per_row blocks, all resident (cooperative launch).
// Block b takes rows b / per_row, + in_flight, ..., and slice b % per_row of
// each, span elements long. partial holds rows * per_row float2, arrived
// rows ints; the caller zeroes both before every launch.
template <typename T, int VEC, class Op>
__global__ void __launch_bounds__(kThreadsC, kBlocksPerSmC)
row_through_l2(Rows<T, Op::kIn> a, int64_t rows, int per_row, int in_flight, int64_t span,
               float2* __restrict__ partial, int* __restrict__ arrived, Op op) {
  __shared__ float2 scratch[32];
  __shared__ typename Op::Row shared_row;
  const int slot = blockIdx.x / per_row, part = blockIdx.x % per_row;
  const int64_t begin = (int64_t)part * span;
  const int64_t end = begin + span < a.L ? begin + span : a.L;
  const int64_t stride = (int64_t)kThreadsC * VEC;
  const int64_t steps = end > begin ? (end - begin + stride - 1) / stride : 0;
  for (int64_t row = slot; row < rows; row += in_flight) {
    const int64_t base = row * a.L;
    typename Op::Row r = op.start(row);
    float s = 0.f, q = 0.f;
#pragma unroll 4
    for (int64_t i = begin + (int64_t)threadIdx.x * VEC; i < end; i += stride) {
      float v[VEC][Op::kIn];
      load<T, VEC>(a, base + i, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) op.add(r, v[k], s, q);
    }
    const float2 t = block_sum(s, q, scratch);
    if (threadIdx.x == 0) {
      partial[row * per_row + part] = t;
      __threadfence();
      atomicAdd(arrived + row, 1);
      // the row's other blocks are resident (cooperative launch), so this ends
      while (load_acquire(arrived + row) < per_row) __nanosleep(100);
      __threadfence();
    }
    __syncthreads();
    float fs = 0.f, fq = 0.f;
    for (int k = threadIdx.x; k < per_row; k += kThreadsC) {
      const float2 p = __ldcg(partial + row * per_row + k);
      fs += p.x;
      fq += p.y;
    }
    const float2 sum = block_sum(fs, fq, scratch);
    if (threadIdx.x == 0) shared_row = op.finish(row, r, sum, a.L, part == 0);
    __syncthreads();
    r = shared_row;
    // newest first: what pass 1 read last is likeliest still in L2
    for (int64_t k = steps - 1; k >= 0; --k) {
      const int64_t i = begin + k * stride + (int64_t)threadIdx.x * VEC;
      if (i < end) {
        float v[VEC][Op::kIn];
        load<T, VEC, Op::kIn, true>(a, base + i, v);
        apply_store<T, VEC, true>(a.out + base + i, op, r, v);
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------

// path: 0 = A, 1 = B, 2 = C. blocks, cluster (B: cluster size; C: per_row),
// threads, smem (B's dynamic shared memory), span (B, C) and in_flight (C)
// come from ops/instance_norm.py:plan.
struct Plan {
  int path;
  int64_t blocks;
  int cluster, threads, smem;
  int64_t span;
  int in_flight;
};

// The integer arguments of a launch, one int64 array that the caller builds
// once per shape (fewer arguments to convert on every call): rows, L, path,
// blocks, cluster, threads, smem, span, in_flight, dtype, vec.
struct Launch {
  int64_t rows, L;
  Plan plan;
  int dtype, vec;
};

inline Launch read_launch(const int64_t* a) {
  return Launch{a[0], a[1], Plan{(int)a[2], a[3], (int)a[4], (int)a[5], (int)a[6], a[7], (int)a[8]},
                (int)a[9], (int)a[10]};
}

template <typename T, int VEC, class Op>
cudaError_t launch_typed(const void* const* in, void* out, int64_t rows, int64_t L, const Plan& p,
                         void* scratch, const Op& op, cudaStream_t stream) {
  Rows<T, Op::kIn> a;
  for (int m = 0; m < Op::kIn; ++m) a.in[m] = static_cast<const T*>(in[m]);
  a.out = static_cast<T*>(out);
  a.L = L;
  if (p.path == 0) {
    if (p.blocks != rows || p.threads <= 0 || p.threads % 32 || p.threads > kThreadsA ||
        (int64_t)p.threads * kItemsA < L)
      return cudaErrorInvalidValue;
    row_in_registers<T, VEC, Op><<<(unsigned)p.blocks, p.threads, 0, stream>>>(a, op);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)p.blocks);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (p.path == 1) {
    if (p.blocks != rows * p.cluster || p.cluster > 8 || p.threads != kThreadsB || p.smem > kSmemB ||
        (int64_t)p.cluster * p.span < L || (int64_t)Op::kIn * p.span * sizeof(T) > p.smem)
      return cudaErrorInvalidValue;
    // per call: the attribute is per device
    err = cudaFuncSetAttribute(row_in_cluster<T, VEC, Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemB);
    if (err != cudaSuccess) return err;
    cfg.blockDim = dim3(kThreadsB);
    cfg.dynamicSmemBytes = p.smem;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    err = cudaLaunchKernelEx(&cfg, row_in_cluster<T, VEC, Op>, a, p.span, op);
  } else if (p.path == 2) {
    if (p.blocks != (int64_t)p.cluster * p.in_flight || p.threads != kThreadsC ||
        (int64_t)p.cluster * p.span < L)
      return cudaErrorInvalidValue;
    float2* partial = static_cast<float2*>(scratch);
    int* arrived = reinterpret_cast<int*>(partial + rows * p.cluster);
    cfg.blockDim = dim3(kThreadsC);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    err = cudaLaunchKernelEx(&cfg, row_through_l2<T, VEC, Op>, a, rows, p.cluster, p.in_flight,
                             p.span, partial, arrived, op);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, as a refused <<<>>> launch is cleared
    return err;
  }
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. vec: elements per load, 1
// or 16 bytes' worth (4 for float32, 8 for the 16-bit types); the caller
// picks 16 bytes only when every tensor is 16-byte aligned and L is a
// multiple of it.
template <class Op>
int launch(const int64_t* args, const void* const* in, void* out, void* scratch, const Op& op,
           void* stream) {
  const Launch l = read_launch(args);
  const int dtype = l.dtype, vec = l.vec;
  const int64_t rows = l.rows, L = l.L;
  const Plan& p = l.plan;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) err = launch_typed<float, 4>(in, out, rows, L, p, scratch, op, s);
  if (dtype == 0 && vec == 1) err = launch_typed<float, 1>(in, out, rows, L, p, scratch, op, s);
  if (dtype == 1 && vec == 8) err = launch_typed<__nv_bfloat16, 8>(in, out, rows, L, p, scratch, op, s);
  if (dtype == 1 && vec == 1) err = launch_typed<__nv_bfloat16, 1>(in, out, rows, L, p, scratch, op, s);
  if (dtype == 2 && vec == 8) err = launch_typed<__half, 8>(in, out, rows, L, p, scratch, op, s);
  if (dtype == 2 && vec == 1) err = launch_typed<__half, 1>(in, out, rows, L, p, scratch, op, s);
  return (int)err;
}

}  // namespace tem
