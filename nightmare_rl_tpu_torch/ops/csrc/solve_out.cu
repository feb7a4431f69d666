// The contact solve's output stage, for Hopper (sm_90a): one launch per
// physics substep, after the solve, in each of the solve's forms (the legs
// kernel's, the dense kernel's and Newton's), computes for every env
// qfrc_constraint = Jᵀf, qacc, the normal force of every candidate point
// (the groups' scatter and the pairs' adds) and the touch sensors
// S nforce, each instantiated per dtype.
//
// The counterpart of the JAX package's compiled step after its solve
// (nightmare_rl_tpu/physics/solver.py:454-457 and 477-478, qfrc and qacc;
// :746-747, the same after Newton's noslip; :757-772, the scatter;
// nightmare_rl_tpu/physics/pipeline.py:100, sensordata = S @ nforce),
// which XLA fuses into the vmapped step; the JAX package has no Pallas
// kernel for it.  Eagerly, the port's plain version (ops/solve_out.py::
// plain: a batched product, an add, a sum and a scatter per contact group,
// two scatter_adds, the sensors' product) is ~13 small launches per
// substep.  The arithmetic is solve_out_env.cuh's, which the CPU tests
// also run through the host driver csrc/solve_out_host.cpp.
//
// What bounds it on an H100.  The bytes: per nightmare_v3 env (nefc 112,
// nv 24, 40 points, 13 sensors, 24 selected points and 4 pairs) in the legs
// form it reads J (2,688 values) and f, dq and qacc_smooth, the selected
// points' and the pairs' indices, and writes qfrc, qacc, nforce and the
// sensors, ~11.6 KB an env, ~24 MB at 2048 envs in float32, ~7 us at 3.35
// TB/s with J read whole (chip_smoke.py's solve-out-kernel phase counts a
// call's bytes; anymal_c's Newton form reads no J: ~0.5 us).  The
// operations, Jᵀf's 2.7 k multiply-adds an env, take ~0.2 us at 67
// TFLOP/s.
//
// The design: a warp per env, up to eight envs a block, as many as let the
// most envs reside on an SM (ops/solve_out.py::geometry); the sensor
// matrix staged in shared memory per block; the env's f and J staged in
// shared memory by cp.async copies all in flight at once, then Jᵀf a lane
// per dof down J's column over the rows; M⁻¹ (the dense form) staged in
// J's place between the phases; a lane per slot for the slots' forces, a
// lane per point for the scatter (the slots walked in the scatter's
// order: no atomics), a lane per sensor; the env's qfrc, slots and nforce
// in shared memory between the phases.  Every product in plain float
// arithmetic, no tensor core.  The first design read J from global memory
// in the lanes' sum over the rows, a chain of dependent loads: at 2048
// envs on an H100 80GB HBM3 at 700 W, 30.3 us alone (this one 24.6) and
// 17.5 us a launch in the env step (this one 14.0), though 12.9 us back to
// back with J in L2 (this one 14.2); anymal_c's Newton form, which reads
// no J, is ~1 us slower for the staging of f (tools/profile_solve_out.py
// --against, tools/profile_step.py --by-module; PERF.md §6).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstring>

#include "launch.cuh"
#include "solve_out_env.cuh"

namespace {

using solve_out_env::Args;
using solve_out_env::Params;

constexpr int kMaxEnvsPerBlock = 8;

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Elements of an env's staged J (M⁻¹ in its place for kDense; none for
// kNewton, which reads no J).
__host__ __device__ inline int jm_elems(const Params& P) {
  if (P.form == solve_out_env::kNewton) return 0;
  const int rows = P.form == solve_out_env::kDense && P.nv > P.nefc ? P.nv
                                                                     : P.nefc;
  return rows * P.nv;
}

// Bytes of an env's share of a block's shared memory: its f, its staged J
// or M⁻¹, its workspace's T and its int elements, each padded to 16 bytes
// (ops/solve_out.py::geometry).
__host__ __device__ inline int env_bytes(const Params& P, int itemsize) {
  return align16(P.nefc * itemsize) + align16(jm_elems(P) * itemsize) +
         align16(solve_out_env::work_elems(P) * itemsize) +
         align16(solve_out_env::iwork_elems(P) * 4);
}

// The block's bytes before the envs' shares: the sensor matrix.
__host__ __device__ inline int table_bytes(const Params& P, int itemsize) {
  return align16(P.nsensor * P.ncp * itemsize);
}

// `count` elements from global to shared memory by the warp's lanes,
// asynchronously (cp.async): 16 bytes a copy where both ends are 16-byte
// aligned, else an element a copy.  The caller commits and waits.
template <typename T>
__device__ inline void stage(T* dst, const T* src, int count, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  int done = 0;
  if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) ==
      0) {
    done = count / kPer * kPer;
    for (int i = lane * kPer; i < done; i += common::kLanes * kPer)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  }
  for (int i = done + lane; i < count; i += common::kLanes)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
}

__device__ inline void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
}

// A warp per env: it stages the env's f and J in shared memory, runs
// forces_one, stages M⁻¹ in J's place (kDense) and runs outputs_one.
template <typename T>
__global__ void __launch_bounds__(common::kLanes * kMaxEnvsPerBlock)
    solve_out_kernel(const __grid_constant__ Args<T> a, int envs_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Params& P = a.P;
  T* S = reinterpret_cast<T*>(smem_raw);
  const int nS = P.nsensor * P.ncp;
  for (int i = threadIdx.x; i < nS; i += blockDim.x) S[i] = a.S[i];
  __syncthreads();
  const int warp = threadIdx.x / common::kLanes;
  const int lane = threadIdx.x % common::kLanes;
  const int n = blockIdx.x * envs_per_block + warp;
  if (n >= a.N) return;
  unsigned char* env = smem_raw + table_bytes(P, sizeof(T)) +
                       static_cast<size_t>(warp) * env_bytes(P, sizeof(T));
  T* f = reinterpret_cast<T*>(env);
  T* jm = reinterpret_cast<T*>(env + align16(P.nefc * sizeof(T)));
  T* w = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(jm) +
                              align16(jm_elems(P) * sizeof(T)));
  int* wi = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(w) +
      align16(solve_out_env::work_elems(P) * sizeof(T)));
  const int64_t e = n;
  stage(f, a.f + e * P.nefc, P.nefc, lane);
  if (P.form != solve_out_env::kNewton)
    stage(jm, a.J + e * P.nefc * P.nv, P.nefc * P.nv, lane);
  stage_wait();
  const common::WarpTeam tm{};
  solve_out_env::forces_one(tm, a, n, f, jm, w, wi);
  if (P.form == solve_out_env::kDense) {
    stage(jm, a.Minv + e * P.nv * P.nv, P.nv * P.nv, lane);
    stage_wait();
  }
  solve_out_env::outputs_one(tm, a, n, jm, S, w, wi);
}

template <typename T>
int launch(const int* params, int nparams, const void* const* ins, int nins,
           void* const* outs, int nouts, int N, int envs_per_block, int smem,
           cudaStream_t stream) {
  if (nparams != solve_out_env::kNumParams ||
      nins != 6 + solve_out_env::kMaxGroups + 2 || nouts != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  std::memcpy(&a.P, params, sizeof(Params));
  if (!solve_out_env::params_ok(a.P))
    return static_cast<int>(cudaErrorInvalidValue);
  a.N = N;
  a.f = static_cast<const T*>(ins[0]);
  a.J = static_cast<const T*>(ins[1]);
  a.dq = static_cast<const T*>(ins[2]);
  a.Minv = static_cast<const T*>(ins[3]);
  a.qacc_smooth = static_cast<const T*>(ins[4]);
  a.S = static_cast<const T*>(ins[5]);
  for (int g = 0; g < solve_out_env::kMaxGroups; ++g)
    a.idx[g] = static_cast<const int64_t*>(ins[6 + g]);
  a.pa = static_cast<const int64_t*>(ins[6 + solve_out_env::kMaxGroups]);
  a.pb = static_cast<const int64_t*>(ins[7 + solve_out_env::kMaxGroups]);
  a.qfrc = static_cast<T*>(outs[0]);
  a.qacc = static_cast<T*>(outs[1]);
  a.nforce = static_cast<T*>(outs[2]);
  a.sens = static_cast<T*>(outs[3]);
  if (N <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock ||
      static_cast<int64_t>(smem) <
          table_bytes(a.P, sizeof(T)) +
              static_cast<int64_t>(envs_per_block) * env_bytes(a.P, sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(solve_out_kernel<T>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + envs_per_block - 1) / envs_per_block;
  solve_out_kernel<T><<<blocks, common::kLanes * envs_per_block, smem,
                        stream>>>(a, envs_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The parameters' names, comma-separated, in order.
extern "C" const char* solve_out_param_names() {
  return solve_out_env::kParamNames;
}

#define SOLVE_OUT_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const int* params, int nparams,                        \
                      const void* const* ins, int nins, void* const* outs,   \
                      int nouts, int N, int envs_per_block, int smem,        \
                      void* stream) {                                        \
    return launch<T>(params, nparams, ins, nins, outs, nouts, N,             \
                     envs_per_block, smem,                                   \
                     static_cast<cudaStream_t>(stream));                     \
  }

SOLVE_OUT_ENTRY(solve_out_f32, float)
SOLVE_OUT_ENTRY(solve_out_f64, double)

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory and `envs_per_block` warps each, into *blocks.
extern "C" int solve_out_blocks_per_sm(int itemsize, int envs_per_block,
                                       int smem, int* blocks) {
  const void* kernel =
      itemsize == 4 ? reinterpret_cast<const void*>(solve_out_kernel<float>)
                    : reinterpret_cast<const void*>(solve_out_kernel<double>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, common::kLanes * envs_per_block, smem);
  return static_cast<int>(e);
}
