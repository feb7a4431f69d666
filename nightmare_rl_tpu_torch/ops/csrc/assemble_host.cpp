// Host driver of csrc/assemble_env.cuh: the assemble kernel's per-env
// arithmetic run on the CPU by a team of `team` threads (the envs in
// series), with the plain C interface of csrc/assemble.cu less the launch
// geometry and the stream, and the team's size in their place.  The
// members split every loop as the kernel's warp lanes do (host_team.h), so
// a team of 32 runs the warp's partition.  The CPU tests
// (tests/test_torch_assemble_kernel.py) build it with g++
// (ops/build.py::build_host) and hold it against the JAX package; it is not
// on any path of the port.

#include <cstring>
#include <vector>

#include "assemble_env.cuh"
#include "host_team.h"

namespace {

using assemble_env::Layout;

template <typename T>
int assemble(const int* layout, int nlayout, const int* topo, const T* cst,
             const T* pcst, const T* const* ins, int nins, void* const* outs,
             int nouts, int N, int team) {
  if (nlayout != assemble_env::kLayoutInts || nins != 7 ||
      nouts != assemble_env::kNumOuts)
    return 1;
  assemble_env::AssembleArgs<T> a;
  std::memcpy(&a.L, layout, sizeof(Layout));
  if (a.L.w_elems <= 0 || a.L.i_elems <= 0 ||
      a.L.Kp > assemble_env::kMaxPairs || team > assemble_env::kMaxTeam)
    return 1;
  a.topo = topo;
  a.cst = cst;
  a.pcst = pcst;
  a.xpos = ins[0];
  a.xquat = ins[1];
  a.subtree_com = ins[2];
  a.cdof = ins[3];
  a.qpos = ins[4];
  a.qvel = ins[5];
  a.qacc = ins[6];
  for (int k = 0; k < assemble_env::kNumOuts; ++k) a.out[k] = outs[k];
  a.N = N;
  std::vector<T> work(a.L.w_elems);
  std::vector<int> iwork(a.L.i_elems);
  return host_team::run(N, team, [&](const host_team::ThreadTeam& tm, int n) {
    assemble_env::assemble_one(tm, a, n, work.data(), iwork.data(), a.topo,
                               a.cst);
  });
}

}  // namespace

extern "C" const char* assemble_layout_names() {
  return assemble_env::kLayoutNames;
}

#define ASSEMBLE_HOST_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const int* layout, int nlayout, const int* topo,       \
                      const T* cst, const T* pcst, const T* const* ins,      \
                      int nins, void* const* outs, int nouts, int N,         \
                      int team) {                                            \
    return assemble<T>(layout, nlayout, topo, cst, pcst, ins, nins, outs,    \
                       nouts, N, team);                                      \
  }

ASSEMBLE_HOST_ENTRY(assemble_host_f32, float)
ASSEMBLE_HOST_ENTRY(assemble_host_f64, double)
