// The integrator's update of a physics substep, for Hopper (sm_90a): one
// launch per substep solves, for every env, the implicitfast system
// (M - h diag(vel_deriv - damping)) qacc = qfrc_smooth + qfrc_constraint
// or Euler's with implicit damping (M + h diag(damping)) v+ = M v + h qfrc
// through the block-arrow factor (plain Euler needs no solve), updates
// qvel, integrates qpos by joint type (the free joint's quaternion
// included) and resets an env whose qpos or qvel is not finite or reaches
// 1e10 (mj_checkPos / mj_checkVel) to the reference pose.
//
// The counterpart of the JAX package's compiled update in pipeline.step
// (nightmare_rl_tpu/physics/pipeline.py:125-191), which XLA fuses into the
// vmapped step; the JAX package has no Pallas kernel for it.  Eagerly, the
// port's plain version (ops/integrate.py::plain_update) is ~290 small
// launches per substep.  The arithmetic is smooth_env.cuh's update_one,
// whose arrow factor and solve kernel 1 (csrc/smooth.cu) shares; the CPU
// tests run it through the host driver csrc/smooth_host.cpp.
//
// What bounds it on an H100.  The bytes: per nightmare_v3 env it reads M
// (576 values) and 6 vectors of 24-25 and writes 73 values, ~6 MB at 2048
// envs in float32, ~2 us at 3.35 TB/s.  Per env it is a short chain (the
// 3x3 leg factors and solves side by side, the 6x6 base factor and solve),
// so latency bounds it in practice.
//
// The design (the first one: 28.0 us an env, of it the factor 14.1 and
// the solve 5.8; tools/profile_smooth.py --timeline): one warp per env,
// eight envs per block; the env's M copied to shared memory a column per
// lane (its loads in flight together) with an odd row stride, so a lane
// per row meets no bank twice, its diagonal shifted; the factor and solve
// of smooth_env.cuh's arrow_factor_solve (a branch per lane in registers,
// the Schur complement a row per lane); one lane per joint for the
// position update; the reset decided by one warp vote.  No fast math.

#include <cuda_runtime.h>

#include <cstring>

#include "smooth_env.cuh"
#include "launch.cuh"

namespace {

using smooth_env::Layout;
using smooth_env::UpdateArgs;
constexpr int kMaxEnvsPerBlock = 8;

// Built with -DSMOOTH_TIMELINE (tools/profile_smooth.py --timeline), lane 0
// of the warp of each of the first kTimelineEnvs envs stamps the card's
// global timer (ns) at the ends of update_one's phases into g_timeline;
// otherwise a stamp is nothing.
#ifdef SMOOTH_TIMELINE
constexpr int kTimelineEnvs = 8192, kStamps = smooth_env::kUpdateStamps;
__device__ long long g_timeline[2 * kTimelineEnvs * kStamps];
#endif

template <typename T>
__global__ void __launch_bounds__(common::kLanes * kMaxEnvsPerBlock)
    integrate_kernel(const __grid_constant__ UpdateArgs<T> a,
                     int envs_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / common::kLanes;
  const int n = blockIdx.x * envs_per_block + warp;
  if (n >= a.N) return;
  T* ws = reinterpret_cast<T*>(smem_raw) +
          static_cast<size_t>(warp) * a.L.u_elems;
#ifdef SMOOTH_TIMELINE
  const common::StampedWarpTeam<kStamps, kTimelineEnvs> tm{{}, g_timeline, n};
  smooth_env::update_one(tm, a, n, ws);
#else
  smooth_env::update_one(common::WarpTeam{}, a, n, ws);
#endif
}

template <typename T>
int launch(const int* layout, int nlayout, const int* topo, const T* cst,
           const T* M, const T* qfrc_smooth, const T* qfrc_constraint,
           const T* qacc, const T* qpos, const T* qvel, T* qpos_out,
           T* qvel_out, T* qacc_warmstart, int N, int envs_per_block, int smem,
           cudaStream_t stream) {
  if (nlayout != smooth_env::kLayoutInts)
    return static_cast<int>(cudaErrorInvalidValue);
  UpdateArgs<T> a;
  std::memcpy(&a.L, layout, sizeof(Layout));
  a.topo = topo;
  a.cst = cst;
  a.M = M;
  a.qfrc_smooth = qfrc_smooth;
  a.qfrc_constraint = qfrc_constraint;
  a.qacc = qacc;
  a.qpos = qpos;
  a.qvel = qvel;
  a.qpos_out = qpos_out;
  a.qvel_out = qvel_out;
  a.qacc_warmstart = qacc_warmstart;
  a.N = N;
  if (N <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock ||
      a.L.nbranch < 1 || a.L.u_elems <= 0 ||
      static_cast<size_t>(smem) <
          static_cast<size_t>(envs_per_block) * a.L.u_elems * sizeof(T))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(integrate_kernel<T>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + envs_per_block - 1) / envs_per_block;
  integrate_kernel<T><<<blocks, common::kLanes * envs_per_block, smem,
                        stream>>>(a, envs_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define INTEGRATE_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const int* layout, int nlayout, const int* topo,      \
                      const T* cst, const T* M, const T* qfrc_smooth,       \
                      const T* qfrc_constraint, const T* qacc,              \
                      const T* qpos, const T* qvel, T* qpos_out,            \
                      T* qvel_out, T* qacc_warmstart, int N,                \
                      int envs_per_block, int smem, void* stream) {         \
    return launch<T>(layout, nlayout, topo, cst, M, qfrc_smooth,            \
                     qfrc_constraint, qacc, qpos, qvel, qpos_out, qvel_out, \
                     qacc_warmstart, N, envs_per_block, smem,               \
                     static_cast<cudaStream_t>(stream));                    \
  }

INTEGRATE_ENTRY(integrate_f32, float)
INTEGRATE_ENTRY(integrate_f64, double)

#ifdef SMOOTH_TIMELINE
// The stamps of the last launch's first envs (kStamps per env) into out[n]
// on the host: the global timer's (ns) with cycles 0, the SM's cycle
// counter's with cycles 1.
extern "C" int integrate_timeline(long long* out, int n, int cycles) {
  if (n > kTimelineEnvs * kStamps) n = kTimelineEnvs * kStamps;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_timeline, static_cast<size_t>(n) * sizeof(long long),
      cycles ? sizeof(long long) * kTimelineEnvs * kStamps : 0));
}

// Stamps per env.
extern "C" int integrate_timeline_stamps() { return kStamps; }
#endif

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory and `envs_per_block` warps each, into *blocks.
extern "C" int integrate_blocks_per_sm(int itemsize, int envs_per_block,
                                       int smem, int* blocks) {
  const void* kernel =
      itemsize == 4 ? reinterpret_cast<const void*>(integrate_kernel<float>)
                    : reinterpret_cast<const void*>(integrate_kernel<double>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, common::kLanes * envs_per_block, smem);
  return static_cast<int>(e);
}
