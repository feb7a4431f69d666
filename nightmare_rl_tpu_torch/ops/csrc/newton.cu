// Batched Newton/elliptic constraint solve, for Hopper (sm_90a): one launch
// per physics substep.
//
// The counterpart of the JAX package's compiled nightmare_rl_tpu/physics/
// newton.py::solve (:214-340: the Newton steps a lax.scan, the line-search
// grid a vmap, the refinements a lax.scan), which XLA fuses into one
// program; the JAX package has no Pallas kernel for it.  Eagerly, the
// port's plain version (physics/newton.py::solve) is tens of thousands of
// small launches per env step.  The arithmetic is newton_env.cuh's, which
// the CPU tests also run through the host driver csrc/newton_host.cpp.
//
// What bounds it on an H100.  Per env a solve is a chain: `iterations`
// Newton steps (8 on anymal_c), each forming H = M + J^T D J + the cone
// blocks (nv = 18, nefc = 96: ~34k multiply-adds), factoring it (nv^3/6),
// and 1 + 12 + ls_refine evaluations of phi'(alpha) over the rows and
// contacts, each ended by reductions over the env's rows.  The bytes (J,
// M and the row data once, the outputs once) are ~9.8 MB at 2048 envs in
// float32, ~3 us at 3.35 TB/s; the operations ~1 GFLOP, ~15 us at 67
// TFLOP/s.  So the operations bound it, and with the chain of dependent
// steps and reductions the time is issue and latency of that chain, times
// the waves of envs.
//
// What the design does about it (a simple design first):
//   * One warp per env, several envs per block (one warp each); a warp
//     without an env returns whole, so no shuffle waits on it and no
//     block-wide barrier is needed.
//   * The env's J, M, row and contact data, H and the vectors live in
//     shared memory for the whole solve (newton_env.cuh's layout, 14.3 KB
//     an env on anymal_c's shape in float32, so that 16 envs share an SM
//     and 2048 envs run in one wave; the dynamic shared memory is raised
//     above 48 KB once per kernel and device, as in pgs.cu, so a captured
//     launch is the launch alone).
//   * A middle-zone contact's Hessian block is two rank-one terms, added
//     one contact at a time from two vectors of nv elements, so the
//     workspace holds no per-contact vectors.
//   * Rows and contacts are spread over the lanes for the residual, the
//     forces and each phi' evaluation; the 12 grid candidates are
//     evaluated in one pass over the rows; every reduction is an xor
//     butterfly that leaves the same sum in each lane, so the line
//     search's branches are uniform.
//   * H's lower triangle is spread over the lanes, factored column by
//     column in place, and the triangular solves go column by column with
//     __syncwarp between columns.
//   * Divisions by a contact's mu_c and T are taken once, as s_i =
//     mus_i / mu_c per solve and 1/T per zone evaluation.
// No tensor cores and no TF32: the kernel is held to float64 round-off.
//
// Rounding: sums run in other orders than the plain version's and nvcc
// contracts multiply-adds into FMAs.  Where the refinements end on the
// round-off floor of phi', the rule "take the bracket's low end when
// phi' > 0" is decided by that noise, as it is between the JAX package's
// own vmapped and per-env solves.

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "newton_env.cuh"

namespace {

using newton_env::Args;

constexpr int kWarpLanes = 32;
constexpr int kMaxEnvsPerBlock = 4;
// Blocks of kMaxEnvsPerBlock envs that one SM must hold at once: in float32
// the registers are held to 128 a thread so that 16 envs (512 threads)
// fit, as their shared memory does on anymal_c's shape: one wave at 2048
// envs.  Float64 takes what it needs.
template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 4 : 1;
};

// A warp as newton_env's team (host and device, as newton_env's functions
// are; only the device side ever runs).
struct WarpTeam {
  __host__ __device__ int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x & (kWarpLanes - 1);
#else
    return 0;
#endif
  }
  __host__ __device__ int size() const { return kWarpLanes; }
  template <typename T>
  __host__ __device__ T sum(T v) const {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int o = kWarpLanes / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
#endif
    return v;
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarpLanes * kMaxEnvsPerBlock,
                                  MinBlocks<T>::value)
    newton_kernel(const Args<T> a, int envs_per_block, int env_elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarpLanes;
  const int n = blockIdx.x * envs_per_block + warp;
  if (n >= a.N) return;
  T* work = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(warp) * env_elems;
  newton_env::solve_one(WarpTeam(), a, n, work);
}

// The dynamic shared memory a kernel may take above 48 KB is raised once
// per kernel and device (see pgs.cu).
cudaError_t allow_smem(const void* kernel, int smem) {
  struct Allowed {
    const void* kernel;
    int device;
    int smem;
  };
  static std::mutex mu;
  static std::vector<Allowed> allowed;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  Allowed* hit = nullptr;
  for (Allowed& al : allowed)
    if (al.kernel == kernel && al.device == device) hit = &al;
  if (hit != nullptr && smem <= hit->smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  if (hit != nullptr)
    hit->smem = smem;
  else
    allowed.push_back({kernel, device, smem});
  return cudaSuccess;
}

template <typename T>
int launch(const Args<T>& a, int envs_per_block, int env_elems, int smem,
           cudaStream_t stream) {
  if (a.N <= 0) return 0;
  const bool ok =
      a.nefc > 0 && a.nv > 0 && a.nc >= 0 && a.nplain >= 0 &&
      a.nplain <= a.nefc && a.nmus >= 0 && a.iterations >= 0 &&
      a.ls_refine >= 0 && envs_per_block >= 1 &&
      envs_per_block <= kMaxEnvsPerBlock &&
      env_elems >= newton_env::env_elems(a.nefc, a.nv, a.nc, a.nmus) &&
      env_elems % 4 == 0 &&
      static_cast<size_t>(smem) >=
          static_cast<size_t>(envs_per_block) * env_elems * sizeof(T);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(newton_kernel<T>);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (a.N + envs_per_block - 1) / envs_per_block;
  newton_kernel<T><<<blocks, kWarpLanes * envs_per_block, smem, stream>>>(
      a, envs_per_block, env_elems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> args(const T* J, const T* aref, const T* R, const T* fl,
             const unsigned char* quad, const T* mu, const unsigned char* act,
             const T* mus, const T* M, const T* a0, const T* x0, T* force,
             T* qfrc, T* qacc, const int* desc, int N, int nefc, int nv,
             int nc, int nplain, int nmus, int iterations, int ls_refine) {
  return Args<T>{J, aref, R, fl, quad, mu, act, mus, M, a0, x0, force, qfrc,
                 qacc, desc, N, nefc, nv, nc, nplain, nmus, iterations,
                 ls_refine};
}

}  // namespace

#define NEWTON_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* J, const T* aref, const T* R, const T* fl,   \
                      const unsigned char* quad, const T* mu,               \
                      const unsigned char* act, const T* mus, const T* M,   \
                      const T* a0, const T* x0, T* force, T* qfrc, T* qacc, \
                      const int* desc, int N, int nefc, int nv, int nc,     \
                      int nplain, int nmus, int iterations, int ls_refine,  \
                      int envs_per_block, int env_elems, int smem,          \
                      void* stream) {                                       \
    return launch<T>(args<T>(J, aref, R, fl, quad, mu, act, mus, M, a0, x0, \
                             force, qfrc, qacc, desc, N, nefc, nv, nc,      \
                             nplain, nmus, iterations, ls_refine),          \
                     envs_per_block, env_elems, smem,                       \
                     static_cast<cudaStream_t>(stream));                    \
  }

NEWTON_ENTRY(newton_f32, float)
NEWTON_ENTRY(newton_f64, double)

// Elements of one env's shared-memory workspace (newton_env.cuh's layout),
// for tools that size another build's launch.
extern "C" int newton_env_elems(int nefc, int nv, int nc, int nmus) {
  return newton_env::env_elems(nefc, nv, nc, nmus);
}

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory and `envs_per_block` warps each, into *blocks.
extern "C" int newton_blocks_per_sm(int itemsize, int envs_per_block, int smem,
                                    int* blocks) {
  const void* kernel =
      itemsize == 4 ? reinterpret_cast<const void*>(newton_kernel<float>)
                    : reinterpret_cast<const void*>(newton_kernel<double>);
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kWarpLanes * envs_per_block, smem);
  return static_cast<int>(e);
}
