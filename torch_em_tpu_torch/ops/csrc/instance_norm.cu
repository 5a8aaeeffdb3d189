// Parameter-free instance norm over the spatial axes of a channel-first
// (N, C, *spatial) tensor, for Hopper (sm_90a): the forward.
//
// Replaces the Pallas TPU kernel torch_em_tpu/ops/pallas/norm.py:_fwd_kernel
// (driven by _norm_fwd). Same math: per (sample, channel) row of length L,
// f32 sum and sum of squares in one read, mean = sum / L,
// rstd = rsqrt(E[x^2] - mean^2 + eps) with no clamp, y = (x - mean) * rstd in
// x's type, and the row's f32 mean and rstd, which the backward
// (instance_norm_bwd.cu) reads; the caller may pass null for both (inference).
//
// Bound: bytes. The function must read x once and write y once,
// 2 * L * itemsize per row; its arithmetic is a few operations per byte.
// The TPU kernel holds a whole slab in VMEM and reads it once; a Hopper SM
// holds at most 227 KB, so common.cuh picks one of three paths per row length
// (ops/instance_norm.py:plan), each reading x once from device memory:
//   A. L <= 16384 (registers): the deep levels, training (16,32,32),
//      (8,16,16) and serving (10,36,36); one launch, no scratch, which is what
//      matters there, since at these sizes launch and host cost set the time;
//   B. the row fits a cluster's shared memory, at most 8 blocks (the portable
//      cluster size) of 225 KB: training (32,64,64), (32,128,128) and serving
//      (20,72,72), (40,144,144) in 16-bit types, (32,64,64) and (20,72,72) in
//      f32;
//   C. larger rows (training (32,256,256), serving (40,288,288) and
//      (40,576,576), and f32 (32,128,128), (40,144,144)): the row is read
//      from device memory, then re-read from L2 by the same block after the
//      row's statistics are known.
// On the H100 path B runs at 49-74% of the byte bound and path C at 56-64%
// (the blocks of a row wait for each other once per row), where a plain copy
// of the same bytes reaches 87-91% (chip_smoke.py; PERF.md, Findings).
//
// Plain C interface, loaded with ctypes. The caller allocates y, mean, rstd
// and, for path C, the zeroed scratch, and passes PyTorch's current stream.
// The function returns the launch's CUDA error; the caller raises on nonzero.

#include "common.cuh"

namespace {

struct Forward {
  static constexpr int kIn = 1;
  float* mean;  // (rows,) or null
  float* rstd;
  float eps;
  struct Row {
    float mean, rstd;
  };
  __device__ Row start(int64_t) const { return {0.f, 0.f}; }
  __device__ void add(const Row&, const float* v, float& a, float& b) const {
    a += v[0];
    b += v[0] * v[0];
  }
  __device__ Row finish(int64_t row, Row r, float2 t, int64_t L, bool writer) const {
    r.mean = t.x / (float)L;
    r.rstd = rsqrtf(t.y / (float)L - r.mean * r.mean + eps);
    if (writer && mean != nullptr) {
      mean[row] = r.mean;
      rstd[row] = r.rstd;
    }
    return r;
  }
  __device__ float apply(const Row& r, const float* v) const { return (v[0] - r.mean) * r.rstd; }
};

}  // namespace

// args: the 11 integers of tem::Launch. scratch (path C) holds
// rows * cluster float2 and rows ints, zeroed.
extern "C" int tem_instance_norm_fwd(const void* x, void* y, void* mean, void* rstd, void* scratch,
                                     const int64_t* args, float eps, void* stream) {
  const void* in[1] = {x};
  const Forward op{static_cast<float*>(mean), static_cast<float*>(rstd), eps};
  return tem::launch(args, in, y, scratch, op, stream);
}
