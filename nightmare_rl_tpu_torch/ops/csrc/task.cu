// The task half of an env step, for Hopper (sm_90a): two launches per env
// step, `pre` before the physics (the actions' scaling and clip, the
// control law) and `post` after it (the readings, command resampling,
// terminations, the reset bookkeeping, the reward terms, the observation),
// each instantiated per robot (nightmare_v3, anymal_c) and per dtype.
//
// The counterpart of the JAX package's compiled env step around
// pipeline.step (nightmare_rl_tpu/envs/nightmare_v3.py:182-361,
// nightmare_rl_tpu/envs/anymal_c.py:183-293), which XLA fuses into a few
// fusions of the vmapped step; the JAX package has no Pallas kernel for it.
// Eagerly, the port's plain version (ops/task.py) is ~150 small launches
// per env step.  The arithmetic is task_env.cuh's, which the CPU tests
// also run through the host driver csrc/task_host.cpp.
//
// What bounds it on an H100.  The bytes: per nightmare_v3 env post reads
// the physics state's qpos, qvel, cvel, xipos and sensordata (~330
// values: cvel and xipos are read at the base body only), the previous
// state's arrays and this step's draws (~130), and writes the reset qpos
// and qvel, the new state's arrays, the observation and the reward terms
// (~250); ~1.5-2 KB an env, ~3.5 MB at 2048 envs in float32, ~1 us at
// 3.35 TB/s (chip_smoke.py's task-kernel phase counts a call's bytes).  The
// operations, a few hundred per env, take far less.  Either is below the
// ~5 us that a launch takes on the card: the kernels are bound by launch
// latency and by one env's chain of dependent loads.
//
// The design: a team of eight lanes per env, eight envs a block of 64
// threads; every lane of a team computes the env's scalars (the loads of
// one value by the team are one broadcast), the lanes split the stores of
// the env's arrays, so a team needs no shuffle, no sync and no shared
// memory.  A whole warp per env (the first design) spent 32 lanes on the
// same scalars: at 4096 envs issue-bound, 29.3 against 18.4 us alone for
// nightmare_v3's post on an H100 80GB HBM3 at 700 W (tools/profile_task.py,
// PERF.md §6 PR 17).  No fast
// math and no FMA contraction: the plain version's rounding op for op
// (task_env.cuh), so that the decisions agree with it exactly.

#include <cuda_runtime.h>

#include <cstring>

#include "launch.cuh"
#include "task_env.cuh"

namespace {

using task_env::Ints;
using task_env::PostArgs;
using task_env::PreArgs;
using task_env::Reals;

// An env's team: TASK_LANES lanes of one warp; TASK_THREADS threads a
// block (tools/profile_task.py builds other shapes with -D to time them).
#ifndef TASK_LANES
#define TASK_LANES 8
#endif
#ifndef TASK_THREADS
#define TASK_THREADS 64
#endif
constexpr int kLanesPerEnv = TASK_LANES;
constexpr int kThreads = TASK_THREADS;
constexpr int kEnvsPerBlock = kThreads / kLanesPerEnv;
static_assert(common::kLanes % kLanesPerEnv == 0, "a team within a warp");

// kLanesPerEnv consecutive lanes of a warp as an env's team.  The members
// never wait for each other (task_env.cuh), so a team needs no sync.
struct LaneTeam {
  __host__ __device__ int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x % kLanesPerEnv;
#else
    return 0;
#endif
  }
  __host__ __device__ int size() const { return kLanesPerEnv; }
};

template <typename T, int Rb>
__global__ void __launch_bounds__(kThreads)
    task_pre_kernel(const __grid_constant__ PreArgs<T> a) {
  const int n = blockIdx.x * kEnvsPerBlock + threadIdx.x / kLanesPerEnv;
  if (n >= a.N) return;
  task_env::pre_one<T, Rb>(LaneTeam{}, a, n);
}

template <typename T, int Rb>
__global__ void __launch_bounds__(kThreads)
    task_post_kernel(const __grid_constant__ PostArgs<T> a) {
  const int n = blockIdx.x * kEnvsPerBlock + threadIdx.x / kLanesPerEnv;
  if (n >= a.N) return;
  task_env::post_one<T, Rb>(LaneTeam{}, a, n);
}

// The parameter blocks, checked: 0 or cudaErrorInvalidValue.
inline int read_params(const int* ints, int nints, const double* reals,
                       int nreals, Ints* I, Reals* R) {
  if (nints != task_env::kNumInts || nreals != task_env::kNumReals)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(I, ints, sizeof(Ints));
  std::memcpy(R, reals, sizeof(Reals));
  if (!task_env::params_ok(*I)) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

inline int blocks(int N) { return (N + kEnvsPerBlock - 1) / kEnvsPerBlock; }

template <typename T>
int launch_pre(const int* ints, int nints, const double* reals, int nreals,
               const T* cst, const T* const* ins, int nins, T* const* outs,
               int nouts, int N, cudaStream_t stream) {
  PreArgs<T> a;
  int err = read_params(ints, nints, reals, nreals, &a.I, &a.R);
  if (err != 0) return err;
  if (nins != task_env::kNumPreIns || nouts != task_env::kNumPreOuts)
    return static_cast<int>(cudaErrorInvalidValue);
  a.cst = cst;
  for (int k = 0; k < nins; ++k) a.in[k] = ins[k];
  for (int k = 0; k < nouts; ++k) a.out[k] = outs[k];
  a.N = N;
  if (N <= 0) return 0;
  const dim3 grid(blocks(N)), block(kThreads);
  if (a.I.robot == task_env::kNightmareV3)
    task_pre_kernel<T, task_env::kNightmareV3><<<grid, block, 0, stream>>>(a);
  else
    task_pre_kernel<T, task_env::kAnymalC><<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_post(const int* ints, int nints, const double* reals, int nreals,
                const T* cst, const void* const* ins, int nins,
                void* const* outs, int nouts, int N, cudaStream_t stream) {
  PostArgs<T> a;
  int err = read_params(ints, nints, reals, nreals, &a.I, &a.R);
  if (err != 0) return err;
  if (nins != task_env::kNumPostIns || nouts != task_env::kNumPostOuts)
    return static_cast<int>(cudaErrorInvalidValue);
  a.cst = cst;
  for (int k = 0; k < nins; ++k) a.in[k] = ins[k];
  for (int k = 0; k < nouts; ++k) a.out[k] = outs[k];
  a.N = N;
  if (N <= 0) return 0;
  const dim3 grid(blocks(N)), block(kThreads);
  if (a.I.robot == task_env::kNightmareV3)
    task_post_kernel<T, task_env::kNightmareV3><<<grid, block, 0, stream>>>(a);
  else
    task_post_kernel<T, task_env::kAnymalC><<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The parameter blocks' field names, comma-separated, in order.
extern "C" const char* task_int_names() { return task_env::kIntNames; }
extern "C" const char* task_real_names() { return task_env::kRealNames; }

#define TASK_ENTRY(PRE, POST, T)                                              \
  extern "C" int PRE(const int* ints, int nints, const double* reals,        \
                     int nreals, const T* cst, const T* const* ins, int nins, \
                     T* const* outs, int nouts, int N, void* stream) {       \
    return launch_pre<T>(ints, nints, reals, nreals, cst, ins, nins, outs,   \
                         nouts, N, static_cast<cudaStream_t>(stream));       \
  }                                                                           \
  extern "C" int POST(const int* ints, int nints, const double* reals,       \
                      int nreals, const T* cst, const void* const* ins,      \
                      int nins, void* const* outs, int nouts, int N,         \
                      void* stream) {                                         \
    return launch_post<T>(ints, nints, reals, nreals, cst, ins, nins, outs,  \
                          nouts, N, static_cast<cudaStream_t>(stream));      \
  }

TASK_ENTRY(task_pre_f32, task_post_f32, float)
TASK_ENTRY(task_pre_f64, task_post_f64, double)
