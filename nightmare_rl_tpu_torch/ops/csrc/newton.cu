// Batched Newton/elliptic constraint solve, for Hopper (sm_90a): one launch
// per physics substep.
//
// The counterpart of the JAX package's compiled nightmare_rl_tpu/physics/
// newton.py::solve (:214-340: the Newton steps a lax.scan, the line-search
// grid a vmap, the refinements a lax.scan), which XLA fuses into one
// program; the JAX package has no Pallas kernel for it.  Eagerly, the
// port's plain version (physics/newton.py::solve) is tens of thousands of
// small launches per env step.  The arithmetic is newton_env.cuh's, which
// the CPU tests also run through the host driver csrc/newton_host.cpp with
// teams of host threads that split the loops as the lanes do.
//
// What bounds it on an H100.  Not the operations or the bytes: on
// anymal_c's rows (nv = 18, nefc = 96, 8 Newton steps, 8 refinements, 2048
// envs, float32) they bound it at ~6-10 us, and one launch takes ~0.3 ms.
// Per env a solve is a chain of dependent steps (the factor's columns, the
// solves' columns, each phi' evaluation ended by a reduction over the env,
// each refinement waiting on the last), so the time is the latency of
// that chain and the issue slots of the 16 warps that share an SM.  Every
// choice below shortens the chain or takes instructions out of it.  One
// wave: 16 envs resident per SM (132 x 16 = 2112 >= 2048): float32 is held
// to 128 registers (MinBlocks) and has no spill (float64: 206 registers),
// and the workspace to ~14 KB an env (13,968 B on anymal_c's shape).
//
// What the design does (the first design, measured before this one: a
// Newton step was 61 us, of it the Hessian 18, the grid 15, the factor 11
// and the solves 7; tools/profile_newton.py --timeline):
//   * Live items only.  Most rows of a solve add nothing (on the main path
//     ~85 % of the contacts are inactive, and one-sided rows are rarely
//     active): an item whose force is 0 at every x is dropped once per
//     solve, where all of J is finite (newton_env.cuh), so the residual,
//     the gradient, Jp and the line search walk ~a quarter of the rows.
//   * The Hessian: each lane forms 3x3 tiles of H's lower triangle in
//     registers, one shared load of a J entry feeding 3 FMAs, in one pass
//     over the items with curvature (listed by the forces pass); a middle-
//     zone contact's rank-one terms come from the rows the tile has loaded
//     (no __syncwarp per contact).
//   * The factor and the solves in registers: lane i holds row i of H, the
//     slots sized at compile time to nv rounded up to 4 (float32: one
//     instantiation per size up to 32; float64, no speed path, the largest
//     only; above 32 the workspace path).  Column j's entries go to the
//     lanes by __shfl_sync, with no branch between a column's shuffles (so
//     they overlap) and no division where the entry is 0 (the division's
//     slow path takes zero dividends, and H has many exact zeros); each
//     lane keeps 1 / L_ii for the solves, which then have no division; the
//     factor's columns reach the back solve through shared memory once.
//   * The line search: no global load (the cone layout and mus are staged
//     once per solve); the 12 grid candidates go to the lanes, each lane
//     one candidate and a share of the items, so a dozen live items keep 24
//     lanes busy, and each candidate's sums are gathered from its two lanes
//     by shuffles; the contact's force and curvature take both zones' terms
//     and select, without a branch per row; each lane holds its first item
//     in registers across the refinements.
//   * Loops over nv are unrolled by 6, so their loads (M's rows from
//     device memory) overlap.
//   * One warp per env, four envs per block; a warp without an env returns
//     whole, so no shuffle waits on it and no block-wide barrier is
//     needed.  The dynamic shared memory is raised above 48 KB once per
//     kernel and device, as in pgs.cu, so a captured launch is the launch
//     alone.
// No tensor cores and no TF32: the kernel is held to float64 round-off.
//
// Rounding: sums run in other orders than the plain version's, nvcc
// contracts multiply-adds into FMAs, and the solves multiply by 1 / L_ii.
// Where the refinements end on the round-off floor of phi', the rule "take
// the bracket's low end when phi' > 0" is decided by that noise, as it is
// between the JAX package's own vmapped and per-env solves.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "newton_env.cuh"

namespace {

using common::allow_smem;

using newton_env::Args;

constexpr int kWarpLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxEnvsPerBlock = 4;
// Blocks of kMaxEnvsPerBlock envs that one SM must hold at once: in float32
// the registers are held to 128 a thread so that 16 envs (512 threads)
// fit, as their shared memory does on anymal_c's shape: one wave at 2048
// envs.  Float64 takes what it needs.
template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 4 : 1;
};

// Built with -DNEWTON_TIMELINE (tools/profile_newton.py --timeline), lane 0
// of the warp of each of the first kTimelineEnvs envs stamps the card's
// global timer (ns) at newton_env's stamp points into g_timeline;
// otherwise a stamp is nothing.
#ifdef NEWTON_TIMELINE
constexpr int kTimelineEnvs = 8192, kStamps = newton_env::kStampEnd + 1;
__device__ long long g_timeline[kTimelineEnvs * kStamps];
#endif

// A warp as newton_env's team (host and device, as newton_env's functions
// are; only the device side ever runs): lane i holds row i of the factor.
// `env` is the warp's env, for the timeline's stamps.
struct WarpTeam {
  static constexpr int kRows = 1;
  int env;
  __host__ __device__ int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x & (kWarpLanes - 1);
#else
    return 0;
#endif
  }
  __host__ __device__ int size() const { return kWarpLanes; }
  // K xor butterflies, one level at a time over all K, so that their
  // shuffles overlap; every lane ends with the bitwise same sums.
  template <int K, typename T>
  __host__ __device__ void sum_n(T (&v)[K]) const {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int o = kWarpLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFull, v[k], o);
#endif
  }
  template <typename T>
  __host__ __device__ T sum(T v) const {
    T one[1] = {v};
    sum_n(one);
    return one[0];
  }
  template <typename T>
  __host__ __device__ T bcast(T v, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(kFull, v, src);
#else
    (void)src;
    return v;
#endif
  }
  __host__ __device__ int prefix(bool p, int& total) const {
#ifdef __CUDA_ARCH__
    const unsigned b = __ballot_sync(kFull, p);
    total = __popc(b);
    return __popc(b & ((1u << rank()) - 1u));
#else
    total = p ? 1 : 0;
    return 0;
#endif
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  __host__ __device__ void stamp(int k) const {
#if defined(__CUDA_ARCH__) && defined(NEWTON_TIMELINE)
    if (k >= 0 && (threadIdx.x & (kWarpLanes - 1)) == 0 &&
        env < kTimelineEnvs) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      g_timeline[env * kStamps + k] = t;
    }
#else
    (void)k;
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
  newton_env::solve_one(WarpTeam{n}, a, n, work);
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

#ifdef NEWTON_TIMELINE
// The stamps of the last launch's first envs (kStamps per env) into out[n]
// on the host.
extern "C" int newton_timeline(long long* out, int n) {
  if (n > kTimelineEnvs * kStamps) n = kTimelineEnvs * kStamps;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_timeline, static_cast<size_t>(n) * sizeof(long long)));
}

// Stamps per env.
extern "C" int newton_timeline_stamps() { return kStamps; }
#endif

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
