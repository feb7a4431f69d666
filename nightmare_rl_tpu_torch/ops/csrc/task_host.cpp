// Host driver of csrc/task_env.cuh: the task kernels' per-env arithmetic
// run on the CPU by a team of `team` threads (the envs in series), with
// the plain C interface of csrc/task.cu less the stream, and the team's
// size in its place.  The members split every env's stores as the
// kernels' warp lanes do (host_team.h), so a team of 32 runs the warp's
// partition.  The CPU tests (tests/test_torch_task_kernel.py,
// tests/test_torch_env.py, tests/test_torch_anymal.py) build it with g++
// (ops/build.py::build_host) and hold it against the plain version and the
// JAX package; it is not on any path of the port.

#include <cstring>

#include "host_team.h"
#include "task_env.cuh"

namespace {

using task_env::Ints;
using task_env::Reals;

inline int read_params(const int* ints, int nints, const double* reals,
                       int nreals, int team, Ints* I, Reals* R) {
  if (nints != task_env::kNumInts || nreals != task_env::kNumReals ||
      team < 1 || team > task_env::kMaxTeam)
    return 1;
  std::memcpy(I, ints, sizeof(Ints));
  std::memcpy(R, reals, sizeof(Reals));
  if (!task_env::params_ok(*I)) return 1;
  return 0;
}

template <typename T>
int pre(const int* ints, int nints, const double* reals, int nreals,
        const T* cst, const T* const* ins, int nins, T* const* outs,
        int nouts, int N, int team) {
  task_env::PreArgs<T> a;
  if (read_params(ints, nints, reals, nreals, team, &a.I, &a.R) != 0 ||
      nins != task_env::kNumPreIns || nouts != task_env::kNumPreOuts)
    return 1;
  a.cst = cst;
  for (int k = 0; k < nins; ++k) a.in[k] = ins[k];
  for (int k = 0; k < nouts; ++k) a.out[k] = outs[k];
  a.N = N;
  const bool nightmare = a.I.robot == task_env::kNightmareV3;
  return host_team::run(N, team, [&](const host_team::ThreadTeam& tm, int n) {
    if (nightmare)
      task_env::pre_one<T, task_env::kNightmareV3>(tm, a, n);
    else
      task_env::pre_one<T, task_env::kAnymalC>(tm, a, n);
  });
}

template <typename T>
int post(const int* ints, int nints, const double* reals, int nreals,
         const T* cst, const void* const* ins, int nins, void* const* outs,
         int nouts, int N, int team) {
  task_env::PostArgs<T> a;
  if (read_params(ints, nints, reals, nreals, team, &a.I, &a.R) != 0 ||
      nins != task_env::kNumPostIns || nouts != task_env::kNumPostOuts)
    return 1;
  a.cst = cst;
  for (int k = 0; k < nins; ++k) a.in[k] = ins[k];
  for (int k = 0; k < nouts; ++k) a.out[k] = outs[k];
  a.N = N;
  const bool nightmare = a.I.robot == task_env::kNightmareV3;
  return host_team::run(N, team, [&](const host_team::ThreadTeam& tm, int n) {
    if (nightmare)
      task_env::post_one<T, task_env::kNightmareV3>(tm, a, n);
    else
      task_env::post_one<T, task_env::kAnymalC>(tm, a, n);
  });
}

}  // namespace

extern "C" const char* task_int_names() { return task_env::kIntNames; }
extern "C" const char* task_real_names() { return task_env::kRealNames; }

#define TASK_HOST_ENTRY(PRE, POST, T)                                         \
  extern "C" int PRE(const int* ints, int nints, const double* reals,        \
                     int nreals, const T* cst, const T* const* ins, int nins, \
                     T* const* outs, int nouts, int N, int team) {           \
    return pre<T>(ints, nints, reals, nreals, cst, ins, nins, outs, nouts,   \
                  N, team);                                                   \
  }                                                                           \
  extern "C" int POST(const int* ints, int nints, const double* reals,       \
                      int nreals, const T* cst, const void* const* ins,      \
                      int nins, void* const* outs, int nouts, int N,         \
                      int team) {                                             \
    return post<T>(ints, nints, reals, nreals, cst, ins, nins, outs, nouts,  \
                   N, team);                                                  \
  }

TASK_HOST_ENTRY(task_pre_host_f32, task_post_host_f32, float)
TASK_HOST_ENTRY(task_pre_host_f64, task_post_host_f64, double)
