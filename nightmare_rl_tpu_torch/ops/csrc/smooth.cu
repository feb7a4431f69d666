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
// ~7 us at 3.35 TB/s; the operations, ~27 k per env, are ~1 us at
// float32's 67 TFLOP/s.  But per env the work is a chain of dependent
// steps down and up a tree of depth 4 (20 bodies) and through the arrow
// factor's square roots and divisions, so the time is the latency of that
// chain, with 1 to 7 lanes of a warp busy on much of it, and the issue
// slots of the 16 warps that share an SM.
//
// The design (the first one, measured before this one: 57.8 us an env, of
// it the arrow factor 13.7 and its solve 5.9, M 8.1, the tree levels 20;
// tools/profile_smooth.py --timeline): one warp per env, eight envs per
// block (one wave of 2,112 at 16 envs an SM), the env's workspace in
// shared memory (3,140 values for the hexapod), and
//   * the model's tables (topology, constants) staged in shared memory
//     once per block, so every index and constant of a dependent chain is
//     a shared load;
//   * the tree walked a round of chains at a time (smooth_env.cuh): a lane
//     carries one chain (a leg) down in registers, frames, then velocities
//     and accelerations in one walk, and sums bottom-up with the chain's
//     bodies and values in registers, a sync a round (the hexapod: the
//     base, then its six legs) instead of one a tree level;
//   * the arrow factor and solve a branch per lane in registers, the legs'
//     W and y columns one per lane, the Schur complement's factor a row per
//     lane (arrow_factor_solve);
//   * M's lower triangle only, two entries per lane at once;
//   * the output stores four loads in flight, their loops kept rolled: a
//     cold launch fetches the kernel's code from memory once, and its size
//     (~7 k instructions) shows in the launch's time.
// Each value is computed by one lane with the plain version's order of
// operations, so a replay equals the eager launch bit for bit, and the
// results equal the first design's wherever the compilers contract alike.
// No tensor cores and no fast math: float64 round-off, IEEE divisions where
// the plain version divides.

#include <cuda_runtime.h>

#include <cstring>

#include "smooth_env.cuh"
#include "launch.cuh"

namespace {

using smooth_env::Layout;
using smooth_env::SmoothArgs;

// Bytes of shared memory that a block's copy of the tables takes: the
// constants, then the topology, each padded to 16 bytes
// (ops/smooth.py::table_bytes).
__host__ __device__ inline int table_bytes(const Layout& L, int itemsize) {
  return (L.ncst * itemsize + 15) / 16 * 16 + (L.ntopo * 4 + 15) / 16 * 16;
}
constexpr int kMaxEnvsPerBlock = 8;

// Built with -DSMOOTH_TIMELINE (tools/profile_smooth.py --timeline), lane 0
// of the warp of each of the first kTimelineEnvs envs stamps the card's
// global timer (ns) at the ends of smooth_one's phases into g_timeline;
// otherwise a stamp is nothing.
#ifdef SMOOTH_TIMELINE
constexpr int kTimelineEnvs = 8192, kStamps = smooth_env::kSmoothStamps;
__device__ long long g_timeline[2 * kTimelineEnvs * kStamps];
#endif

template <typename T>
__global__ void __launch_bounds__(common::kLanes * kMaxEnvsPerBlock)
    smooth_kernel(const __grid_constant__ SmoothArgs<T> a, int envs_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the model's tables, staged once per block: every index and constant of
  // a dependent chain is then a shared load
  T* cst = reinterpret_cast<T*>(smem_raw);
  int* topo = reinterpret_cast<int*>(smem_raw +
                                     (a.L.ncst * sizeof(T) + 15) / 16 * 16);
  for (int i = threadIdx.x; i < a.L.ncst; i += blockDim.x) cst[i] = a.cst[i];
  for (int i = threadIdx.x; i < a.L.ntopo; i += blockDim.x)
    topo[i] = a.topo[i];
  __syncthreads();
  const int warp = threadIdx.x / common::kLanes;
  const int n = blockIdx.x * envs_per_block + warp;
  if (n >= a.N) return;
  T* ws = reinterpret_cast<T*>(smem_raw + table_bytes(a.L, sizeof(T))) +
          static_cast<size_t>(warp) * a.L.w_elems;
#ifdef SMOOTH_TIMELINE
  const common::StampedWarpTeam<kStamps, kTimelineEnvs> tm{{}, g_timeline, n};
  smooth_env::smooth_one(tm, a, n, ws, topo, cst);
#else
  smooth_env::smooth_one(common::WarpTeam{}, a, n, ws, topo, cst);
#endif
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
      a.L.w_elems <= 0 || a.L.ntopo < 0 || a.L.ncst < 0 ||
      static_cast<size_t>(smem) <
          static_cast<size_t>(table_bytes(a.L, sizeof(T))) +
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

#ifdef SMOOTH_TIMELINE
// The stamps of the last launch's first envs (kStamps per env) into out[n]
// on the host: the global timer's (ns) with cycles 0, the SM's cycle
// counter's with cycles 1.
extern "C" int smooth_timeline(long long* out, int n, int cycles) {
  if (n > kTimelineEnvs * kStamps) n = kTimelineEnvs * kStamps;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_timeline, static_cast<size_t>(n) * sizeof(long long),
      cycles ? sizeof(long long) * kTimelineEnvs * kStamps : 0));
}

// Stamps per env.
extern "C" int smooth_timeline_stamps() { return kStamps; }
#endif

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
