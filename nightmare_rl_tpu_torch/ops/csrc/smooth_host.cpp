// Host driver of csrc/smooth_env.cuh: the smooth and integrate kernels'
// per-env arithmetic run on the CPU by a team of `team` threads (the envs
// in series), with the plain C interfaces of csrc/smooth.cu and
// csrc/integrate.cu less the launch geometry and the stream, and the
// team's size in their place.  A team of one runs in the calling thread.
// The members split every loop as the kernels' warp lanes do (member rank
// owns rank + k * size), so a team of 32 runs the warp's partition.  The
// CPU tests (tests/test_torch_smooth_kernel.py) build it with g++
// (ops/build.py::build_host) and hold it against the JAX package; it is not
// on any path of the port.

#include <cstring>
#include <vector>

#include "host_team.h"
#include "smooth_env.cuh"

namespace {

using smooth_env::Layout;

// Runs one(tm, n, work) for every env n with a team of `team` threads
// sharing one workspace of `elems` elements.
template <typename T, typename F>
int run(int N, int elems, int team, F one) {
  if (elems <= 0) return 1;
  std::vector<T> work(elems);
  return host_team::run(N, team, [&](const host_team::ThreadTeam& tm, int n) {
    one(tm, n, work.data());
  });
}

template <typename T>
int smooth(const int* layout, int nlayout, const int* topo, const T* cst,
           const T* qpos, const T* qvel, const T* ctrl, void* const* outs,
           int nouts, int N, int team) {
  if (nlayout != smooth_env::kLayoutInts || nouts != smooth_env::kNumOuts)
    return 1;
  smooth_env::SmoothArgs<T> a;
  std::memcpy(&a.L, layout, sizeof(Layout));
  a.topo = topo;
  a.cst = cst;
  a.qpos = qpos;
  a.qvel = qvel;
  a.ctrl = ctrl;
  for (int k = 0; k < smooth_env::kNumOuts; ++k)
    a.out[k] = static_cast<T*>(outs[k]);
  a.N = N;
  return run<T>(N, a.L.w_elems, team,
                [&](const host_team::ThreadTeam& tm, int n, T* w) {
                  smooth_env::smooth_one(tm, a, n, w, a.topo, a.cst);
                });
}

template <typename T>
int update(const int* layout, int nlayout, const int* topo, const T* cst,
           const T* M, const T* qfrc_smooth, const T* qfrc_constraint,
           const T* qacc, const T* qpos, const T* qvel, T* qpos_out,
           T* qvel_out, T* qacc_warmstart, int N, int team) {
  if (nlayout != smooth_env::kLayoutInts) return 1;
  smooth_env::UpdateArgs<T> a;
  std::memcpy(&a.L, layout, sizeof(Layout));
  if (a.L.nbranch < 1) return 1;
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
  return run<T>(N, a.L.u_elems, team,
                [&](const host_team::ThreadTeam& tm, int n, T* w) {
                  smooth_env::update_one(tm, a, n, w);
                });
}

}  // namespace

extern "C" const char* smooth_layout_names() {
  return smooth_env::kLayoutNames;
}

#define SMOOTH_HOST_ENTRY(NAME, UPDATE, T)                                   \
  extern "C" int NAME(const int* layout, int nlayout, const int* topo,      \
                      const T* cst, const T* qpos, const T* qvel,           \
                      const T* ctrl, void* const* outs, int nouts, int N,   \
                      int team) {                                           \
    return smooth<T>(layout, nlayout, topo, cst, qpos, qvel, ctrl, outs,    \
                     nouts, N, team);                                       \
  }                                                                         \
  extern "C" int UPDATE(const int* layout, int nlayout, const int* topo,    \
                        const T* cst, const T* M, const T* qfrc_smooth,     \
                        const T* qfrc_constraint, const T* qacc,            \
                        const T* qpos, const T* qvel, T* qpos_out,          \
                        T* qvel_out, T* qacc_warmstart, int N, int team) {  \
    return update<T>(layout, nlayout, topo, cst, M, qfrc_smooth,            \
                     qfrc_constraint, qacc, qpos, qvel, qpos_out, qvel_out, \
                     qacc_warmstart, N, team);                              \
  }

SMOOTH_HOST_ENTRY(smooth_host_f32, integrate_host_f32, float)
SMOOTH_HOST_ENTRY(smooth_host_f64, integrate_host_f64, double)
