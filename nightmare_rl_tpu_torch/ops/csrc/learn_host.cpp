// Host driver of csrc/learn_env.cuh: the learning kernels' arithmetic run
// on the CPU by a team of `team` host threads in place of a block's threads
// (the grid's blocks in series, each with one workspace for its shared
// memory; then every group's sum, each net's grid sum and the losses, or
// adam's norm, lr and bias corrections, which the kernels leave to the last
// block of each to arrive; then adam's step, block by block), with the
// plain C interface of csrc/learn.cu less the stream, and the team's size in
// its place.  The CPU tests (tests/test_torch_learn_kernel.py,
// tests/test_torch_ppo.py) build it with g++ (ops/build.py::build_host) and
// hold it against the plain versions and the JAX package; it is not on any
// path of the port.

#include <vector>

#include "host_team.h"
#include "learn_env.cuh"

namespace {

// host_team's team with learn_env's copies: plain assignments.
struct HostTeam {
  const host_team::ThreadTeam& tm;
  int rank() const { return tm.rank(); }
  int size() const { return tm.size(); }
  void sync() const { tm.sync(); }
  template <typename T>
  void copy(T* dst, const T* src) const {
    *dst = *src;
  }
  template <int N, typename T>
  void copy_n(T* dst, const T* src) const {
    for (int u = 0; u < N; ++u) dst[u] = src[u];
  }
  void copy_wait() const {}
  void stamp(int) const {}
};

template <typename T>
int gae(const int* ints, int nints, const double* reals, int nreals,
        const void* const* ptrs, int nptrs, int team) {
  learn_env::GaeArgs<T> a;
  if (team < 1 || team > learn_env::kMaxTeam ||
      !learn_env::read_gae(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return 1;
  std::vector<T> lanes(learn_env::kGaeLanes);
  if (host_team::run(a.blocks, team,
                     [&](const host_team::ThreadTeam& tm, int blk) {
                       learn_env::gae_block(HostTeam{tm}, a, blk, lanes.data());
                     }))
    return 1;
  return host_team::run(1, team, [&](const host_team::ThreadTeam& tm, int) {
    learn_env::gae_final(HostTeam{tm}, a);
  });
}

template <typename T>
int grads(const int* ints, int nints, const double* reals, int nreals,
          const void* const* ptrs, int nptrs, int team) {
  learn_env::GradsArgs<T> a;
  if (team < 1 || team > learn_env::kMaxTeam ||
      !learn_env::read_grads(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return 1;
  std::vector<T> work(learn_env::grads_smem_elems(a));
  if (host_team::run(a.blocks[0] + a.blocks[1], team,
                     [&](const host_team::ThreadTeam& tm, int blk) {
                       learn_env::grads_block(HostTeam{tm}, a, blk,
                                              work.data());
                     }))
    return 1;
  if (host_team::run(a.groups[0] + a.groups[1], team,
                     [&](const host_team::ThreadTeam& tm, int g) {
                       const int k = g < a.groups[0] ? 0 : 1;
                       learn_env::grads_group(HostTeam{tm}, a, k,
                                              k == 0 ? g : g - a.groups[0]);
                     }))
    return 1;
  if (host_team::run(2, team, [&](const host_team::ThreadTeam& tm, int k) {
        learn_env::grads_final(HostTeam{tm}, a, k);
      }))
    return 1;
  return host_team::run(1, team, [&](const host_team::ThreadTeam& tm, int) {
    learn_env::grads_losses(HostTeam{tm}, a);
  });
}

template <typename T>
int adam(const int* ints, int nints, const double* reals, int nreals,
         const void* const* ptrs, int nptrs, int team) {
  learn_env::AdamArgs<T> a;
  if (team < 1 || team > learn_env::kMaxTeam ||
      !learn_env::read_adam(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return 1;
  std::vector<T> lanes(learn_env::kAdamThreads);
  if (host_team::run(a.blocks, team,
                     [&](const host_team::ThreadTeam& tm, int blk) {
                       learn_env::adam_sums(HostTeam{tm}, a, blk, lanes.data());
                     }))
    return 1;
  if (host_team::run(1, team, [&](const host_team::ThreadTeam& tm, int) {
        learn_env::adam_final(HostTeam{tm}, a, lanes.data());
      }))
    return 1;
  return host_team::run(a.blocks, team,
                        [&](const host_team::ThreadTeam& tm, int blk) {
                          learn_env::adam_step(HostTeam{tm}, a, blk);
                        });
}

}  // namespace

#define LEARN_NAMES_ENTRY(NAME, S)                                            \
  extern "C" const char* NAME() { return learn_env::S; }
LEARN_NAMES_ENTRY(learn_gae_int_names, kGaeIntNames)
LEARN_NAMES_ENTRY(learn_gae_real_names, kGaeRealNames)
LEARN_NAMES_ENTRY(learn_gae_ptr_names, kGaePtrNames)
LEARN_NAMES_ENTRY(learn_grads_int_names, kGradsIntNames)
LEARN_NAMES_ENTRY(learn_grads_real_names, kGradsRealNames)
LEARN_NAMES_ENTRY(learn_grads_ptr_names, kGradsPtrNames)
LEARN_NAMES_ENTRY(learn_adam_int_names, kAdamIntNames)
LEARN_NAMES_ENTRY(learn_adam_real_names, kAdamRealNames)
LEARN_NAMES_ENTRY(learn_adam_ptr_names, kAdamPtrNames)

#define LEARN_HOST_ENTRY(NAME, FN, T)                                         \
  extern "C" int NAME(const int* ints, int nints, const double* reals,       \
                      int nreals, const void* const* ptrs, int nptrs,        \
                      int team) {                                             \
    return FN<T>(ints, nints, reals, nreals, ptrs, nptrs, team);             \
  }

LEARN_HOST_ENTRY(learn_gae_host_f32, gae, float)
LEARN_HOST_ENTRY(learn_gae_host_f64, gae, double)
LEARN_HOST_ENTRY(learn_grads_host_f32, grads, float)
LEARN_HOST_ENTRY(learn_grads_host_f64, grads, double)
LEARN_HOST_ENTRY(learn_adam_host_f32, adam, float)
LEARN_HOST_ENTRY(learn_adam_host_f64, adam, double)
