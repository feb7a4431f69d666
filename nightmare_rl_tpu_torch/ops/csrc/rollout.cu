// The rollout step's policy half and trajectory stores, for Hopper
// (sm_90a): two launches per rollout step, `act` before env.step (the
// actor's and critic's MLPs, the sampling std, the action and its
// log-probability, row t of the trajectory's obs, action, value, logp, mu
// and sigma) and `store` after it (the timeout bootstrap into row t of the
// rewards, the done flags, env 0's record row, the finished episodes' count
// and term sums, t + 1), each instantiated per dtype.
//
// The counterpart of the JAX package's compiled rollout step around
// env.step (nightmare_rl_tpu/rl/ppo.py:153-185, with
// models/actor_critic.py's sample_action and log_prob :133-143), which XLA
// fuses inside lax.scan; the JAX package has no Pallas kernel for it.
// Eagerly, the port's plain version (ops/rollout.py: cuBLAS addmm, ELU,
// the elementwise ops, index_copy_, the sums) is ~45 small launches per
// rollout step.  The arithmetic is rollout_env.cuh's, which the CPU tests
// also run through the host driver csrc/rollout_host.cpp.
//
// What bounds it on an H100.  act, per env of nightmare_v3's policy (66
// observations, [54, 42, 30] hidden units, 18 actions, both nets): ~14.7k
// multiply-adds, 60 MFLOP at 2048 envs, 0.9 us at 67 TFLOP/s in float32
// outside the tensor cores; its bytes, the observations and eps read, the
// six rows and the caller's action and value written, ~0.9 KB an env, ~1.9
// MB at 2048 envs, 0.6 us at 3.35 TB/s.  store moves ~50 B an env and a
// row of the record.  Both are below the ~3-5 us that a launch takes.
//
// The design.  act runs a block of 256 threads per tile of 16 envs.  The
// block stages the layers' weights in shared memory as they lie, each
// unit's row padded to an odd length, with cp.async copies all in flight at
// once (nightmare_v3's and anymal_c's nets fit whole, ~60 KB in float32;
// the recurrent heads' 512-wide inputs go in chunks), and the envs' inputs
// feature-major; a thread computes one unit for four envs (four
// independent chains, the weight read once for the four), and the actor's
// and critic's layers follow each other with a sync between layers.  No
// tensor cores: every product in full float32, as the port's nets run
// (models/actor_critic.py, full_float32).  store is one block of
// kStoreLanes threads: a lane's envs' loads issued together, the rows and
// the record row written, the finished sums by lane in registers and then
// a fixed tree, so a replay equals the eager call bit for bit.  The first
// design (a thread per (env, unit) pair of a layer, weights staged
// transposed element by element, 256 lanes in store) took 54.8 and 21.8 us
// alone at 2048 envs on an H100 80GB HBM3 at 700 W (PERF.md §6 PR 18):
// its staging and its chains of dependent shared-memory loads were
// latency-bound.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "rollout_env.cuh"

namespace {

using common::BlockTeam;
using rollout_env::ActArgs;
using rollout_env::StoreArgs;

constexpr int kActThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kActThreads)
    rollout_act_kernel(const __grid_constant__ ActArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  rollout_env::act_block(BlockTeam{}, a, blockIdx.x, reinterpret_cast<T*>(smem));
}

template <typename T>
__global__ void __launch_bounds__(rollout_env::kStoreLanes)
    rollout_store_kernel(const __grid_constant__ StoreArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  rollout_env::store_block(BlockTeam{}, a, smem);
}

template <typename T>
int launch_act(const int* ints, int nints, const double* reals, int nreals,
               const void* const* ptrs, int nptrs, cudaStream_t stream) {
  ActArgs<T> a;
  if (!rollout_env::read_act(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.N == 0) return 0;
  const int smem = rollout_env::act_smem_elems(a) * static_cast<int>(sizeof(T));
  const void* kernel = reinterpret_cast<const void*>(rollout_act_kernel<T>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (a.N + a.E - 1) / a.E;
  rollout_act_kernel<T><<<blocks, kActThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_store(const int* ints, int nints, const double* reals, int nreals,
                 const void* const* ptrs, int nptrs, cudaStream_t stream) {
  StoreArgs<T> a;
  if (!rollout_env::read_store(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = rollout_env::store_smem_bytes(a);
  const void* kernel = reinterpret_cast<const void*>(rollout_store_kernel<T>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rollout_store_kernel<T><<<1, rollout_env::kStoreLanes, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The blocks' field names, comma-separated, in order.
extern "C" const char* rollout_act_int_names() {
  return rollout_env::kActIntNames;
}
extern "C" const char* rollout_act_real_names() {
  return rollout_env::kActRealNames;
}
extern "C" const char* rollout_act_ptr_names() {
  return rollout_env::kActPtrNames;
}
extern "C" const char* rollout_store_int_names() {
  return rollout_env::kStoreIntNames;
}
extern "C" const char* rollout_store_real_names() {
  return rollout_env::kStoreRealNames;
}
extern "C" const char* rollout_store_ptr_names() {
  return rollout_env::kStorePtrNames;
}

// act's shared memory per block in bytes (0 for arguments it does not take).
#define ROLLOUT_SMEM_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const int* ints, int nints, const double* reals,       \
                      int nreals, const void* const* ptrs, int nptrs) {      \
    ActArgs<T> a;                                                             \
    if (!rollout_env::read_act(ints, nints, reals, nreals, ptrs, nptrs, &a))  \
      return 0;                                                               \
    return rollout_env::act_smem_elems(a) * static_cast<int>(sizeof(T));      \
  }

#define ROLLOUT_ENTRY(ACT, STORE, T)                                          \
  extern "C" int ACT(const int* ints, int nints, const double* reals,        \
                     int nreals, const void* const* ptrs, int nptrs,         \
                     void* stream) {                                          \
    return launch_act<T>(ints, nints, reals, nreals, ptrs, nptrs,            \
                         static_cast<cudaStream_t>(stream));                 \
  }                                                                           \
  extern "C" int STORE(const int* ints, int nints, const double* reals,      \
                       int nreals, const void* const* ptrs, int nptrs,       \
                       void* stream) {                                        \
    return launch_store<T>(ints, nints, reals, nreals, ptrs, nptrs,          \
                           static_cast<cudaStream_t>(stream));               \
  }

ROLLOUT_ENTRY(rollout_act_f32, rollout_store_f32, float)
ROLLOUT_ENTRY(rollout_act_f64, rollout_store_f64, double)
ROLLOUT_SMEM_ENTRY(rollout_act_smem_f32, float)
ROLLOUT_SMEM_ENTRY(rollout_act_smem_f64, double)
