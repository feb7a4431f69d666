// Host driver of csrc/rollout_env.cuh: the rollout kernels' arithmetic run
// on the CPU by a team of `team` host threads in place of a block's threads
// (act's blocks in series, each with one workspace for its shared memory;
// the team's copies into it plain assignments),
// with the plain C interface of csrc/rollout.cu less the stream, and the
// team's size in its place.  The CPU tests (tests/test_torch_rollout_kernel.py)
// build it with g++ (ops/build.py::build_host) and hold it against the
// plain versions and the JAX package; it is not on any path of the port.

#include <vector>

#include "host_team.h"
#include "rollout_env.cuh"

namespace {

// host_team's team with rollout_env's copies: plain assignments.
struct HostTeam {
  const host_team::ThreadTeam& tm;
  int rank() const { return tm.rank(); }
  int size() const { return tm.size(); }
  void sync() const { tm.sync(); }
  template <typename T>
  void copy(T* dst, const T* src) const {
    *dst = *src;
  }
  void copy_wait() const {}
};

template <typename T>
int act(const int* ints, int nints, const double* reals, int nreals,
        const void* const* ptrs, int nptrs, int team) {
  rollout_env::ActArgs<T> a;
  if (team < 1 || team > rollout_env::kMaxTeam ||
      !rollout_env::read_act(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return 1;
  std::vector<T> work(rollout_env::act_smem_elems(a));
  const int blocks = (a.N + a.E - 1) / a.E;
  return host_team::run(blocks, team,
                        [&](const host_team::ThreadTeam& tm, int blk) {
                          rollout_env::act_block(HostTeam{tm}, a, blk,
                                                 work.data());
                        });
}

template <typename T>
int store(const int* ints, int nints, const double* reals, int nreals,
          const void* const* ptrs, int nptrs, int team) {
  rollout_env::StoreArgs<T> a;
  if (team < 1 || team > rollout_env::kMaxTeam ||
      !rollout_env::read_store(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return 1;
  std::vector<double> work(
      (rollout_env::store_smem_bytes(a) + sizeof(double) - 1) / sizeof(double));
  return host_team::run(1, team, [&](const host_team::ThreadTeam& tm, int) {
    rollout_env::store_block(HostTeam{tm}, a, work.data());
  });
}

}  // namespace

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

#define ROLLOUT_HOST_ENTRY(ACT, STORE, T)                                     \
  extern "C" int ACT(const int* ints, int nints, const double* reals,        \
                     int nreals, const void* const* ptrs, int nptrs,         \
                     int team) {                                              \
    return act<T>(ints, nints, reals, nreals, ptrs, nptrs, team);            \
  }                                                                           \
  extern "C" int STORE(const int* ints, int nints, const double* reals,      \
                       int nreals, const void* const* ptrs, int nptrs,       \
                       int team) {                                            \
    return store<T>(ints, nints, reals, nreals, ptrs, nptrs, team);          \
  }

ROLLOUT_HOST_ENTRY(rollout_act_host_f32, rollout_store_host_f32, float)
ROLLOUT_HOST_ENTRY(rollout_act_host_f64, rollout_store_host_f64, double)
