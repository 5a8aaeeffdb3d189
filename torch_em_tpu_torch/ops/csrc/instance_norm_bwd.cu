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
// Bound: bytes. The function must read x and g and write dx once,
// 3 * L * itemsize per row. The two row means are needed before any dx, so
// each element is used twice; common.cuh's paths (ops/instance_norm.py:plan)
// keep the second use out of device memory:
//   A. L <= 16384: x and g of a row in registers (training (16,32,32),
//      (8,16,16));
//   B. x and g of a row fit a cluster's shared memory, at most 8 blocks of
//      225 KB: training (32,64,64);
//   C. larger rows: training (32,256,256) and (32,128,128), whose x and g are
//      re-read from L2 once the row's means are known. On the H100 a cluster
//      of 16 blocks for (32,128,128) in bf16 ran slower than path C
//      (PERF.md, Findings), so clusters stop at the portable 8.
//
// Plain C interface, loaded with ctypes. The caller allocates dx and, for
// path C, the zeroed scratch, and passes PyTorch's current stream. The
// function returns the launch's CUDA error; the caller raises on nonzero.

#include "common.cuh"

namespace {

struct Backward {
  static constexpr int kIn = 2;  // x, g
  const float* mean;
  const float* rstd;
  struct Row {
    float m, r, mg, mgx;
  };
  __device__ Row start(int64_t row) const { return {mean[row], rstd[row], 0.f, 0.f}; }
  __device__ void add(const Row& w, const float* v, float& a, float& b) const {
    a += v[1];
    b += v[1] * ((v[0] - w.m) * w.r);
  }
  __device__ Row finish(int64_t, Row w, float2 t, int64_t L, bool) const {
    w.mg = t.x / (float)L;
    w.mgx = t.y / (float)L;
    return w;
  }
  __device__ float apply(const Row& w, const float* v) const {
    const float xhat = (v[0] - w.m) * w.r;
    return w.r * (v[1] - w.mg - xhat * w.mgx);
  }
};

}  // namespace

// x, g and dx share dtype; mean and rstd hold rows floats each. args: the
// 11 integers of tem::Launch. scratch (path C) holds rows * cluster float2
// and rows ints, zeroed.
extern "C" int tem_instance_norm_bwd(const void* x, const void* g, const void* mean,
                                     const void* rstd, void* dx, void* scratch,
                                     const int64_t* args, void* stream) {
  const void* in[2] = {x, g};
  const Backward op{static_cast<const float*>(mean), static_cast<const float*>(rstd)};
  return tem::launch(args, in, dx, scratch, op, stream);
}
