// The smooth half of a physics substep, for Hopper (sm_90a): one launch
// per substep computes, for every env, the body frames, the com-based
// inertias and motion axes, the body velocities, the mass matrix, the bias
// forces, the actuator and passive forces, qfrc_smooth and, for a model
// with a block-arrow layout, the arrow factor and qacc_smooth.
//
// The counterpart of the JAX package's compiled pipeline.forward before
// collision (nightmare_rl_tpu/physics/pipeline.py:59-82), which XLA fuses
// into a few fusions of the vmapped step; the JAX package has no Pallas
// kernel for it.  Eagerly, the port's plain version (ops/smooth.py::plain)
// is ~2,450 small launches per nightmare_v3 substep, one per statement per
// body.  The arithmetic is smooth_env.cuh's, which the CPU tests also run
// through the host driver csrc/smooth_host.cpp with teams of 1 and 32 host
// threads.
//
// What bounds it on an H100.  The bytes: per nightmare_v3 env it reads 67
// values (qpos, qvel, ctrl) and writes ~2,700 (cinert's 720 and ximat's
// 180 only because KinOut exposes them), ~22 MB at 2048 envs in float32,
// ~7 us at 3.35 TB/s; the operations, ~40 k per env, are ~1 us at
// float32's 67 TFLOP/s.  But per env the work is a chain of dependent
// steps down and up a tree of depth 4 (20 bodies), so the time is the
// latency of that chain with 1 to 6 lanes of a warp busy on most of it.
//
// The design, simple first: one warp per env, four envs per block, the
// env's whole workspace in shared memory (3,192 values for the hexapod,
// 12.8 KB in float32: 16 envs an SM, one wave at 2048 envs; cinert
// becomes the composite inertia in place once it is stored);
// the lanes take the bodies of one tree depth at a time (the hexapod's 6
// legs side by side), then the entries of each 6x6 block, the 576 entries
// of M, one branch each for the arrow factor's Ld and W.  Each value is
// computed by one lane with the plain version's order of operations, so a
// replay equals the eager launch bit for bit.  The outputs are copied from
// shared memory at the end, each field's per-env block by consecutive
// lanes.  No tensor cores and no fast math: float64 round-off, IEEE
// divisions where the plain version divides.

#include <cuda_runtime.h>

#include <cstring>

#include "smooth_env.cuh"
#include "launch.cuh"

namespace {

using smooth_env::Layout;
using smooth_env::SmoothArgs;
constexpr int kMaxEnvsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(common::kLanes * kMaxEnvsPerBlock)
    smooth_kernel(const __grid_constant__ SmoothArgs<T> a, int envs_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / common::kLanes;
  const int n = blockIdx.x * envs_per_block + warp;
  if (n >= a.N) return;
  T* ws = reinterpret_cast<T*>(smem_raw) +
          static_cast<size_t>(warp) * a.L.w_elems;
  smooth_env::smooth_one(common::WarpTeam{}, a, n, ws);
}

template <typename T>
int launch(const int* layout, int nlayout, const int* topo, const T* cst,
           const T* qpos, const T* qvel, const T* ctrl, void* const* outs,
           int nouts, int N, int envs_per_block, int smem,
           cudaStream_t stream) {
  if (nlayout != smooth_env::kLayoutInts || nouts != smooth_env::kNumOuts)
    return static_cast<int>(cudaErrorInvalidValue);
  SmoothArgs<T> a;
  std::memcpy(&a.L, layout, sizeof(Layout));
  a.topo = topo;
  a.cst = cst;
  a.qpos = qpos;
  a.qvel = qvel;
  a.ctrl = ctrl;
  for (int k = 0; k < smooth_env::kNumOuts; ++k)
    a.out[k] = static_cast<T*>(outs[k]);
  a.N = N;
  if (N <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock ||
      a.L.w_elems <= 0 ||
      static_cast<size_t>(smem) <
          static_cast<size_t>(envs_per_block) * a.L.w_elems * sizeof(T))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(smooth_kernel<T>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + envs_per_block - 1) / envs_per_block;
  smooth_kernel<T><<<blocks, common::kLanes * envs_per_block, smem,
                     stream>>>(a, envs_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The Layout's field names, comma-separated, in order.
extern "C" const char* smooth_layout_names() {
  return smooth_env::kLayoutNames;
}

#define SMOOTH_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const int* layout, int nlayout, const int* topo,      \
                      const T* cst, const T* qpos, const T* qvel,           \
                      const T* ctrl, void* const* outs, int nouts, int N,   \
                      int envs_per_block, int smem, void* stream) {         \
    return launch<T>(layout, nlayout, topo, cst, qpos, qvel, ctrl, outs,    \
                     nouts, N, envs_per_block, smem,                        \
                     static_cast<cudaStream_t>(stream));                    \
  }

SMOOTH_ENTRY(smooth_f32, float)
SMOOTH_ENTRY(smooth_f64, double)

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory and `envs_per_block` warps each, into *blocks.
extern "C" int smooth_blocks_per_sm(int itemsize, int envs_per_block, int smem,
                                    int* blocks) {
  const void* kernel =
      itemsize == 4 ? reinterpret_cast<const void*>(smooth_kernel<float>)
                    : reinterpret_cast<const void*>(smooth_kernel<double>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, common::kLanes * envs_per_block, smem);
  return static_cast<int>(e);
}
