// Host driver of csrc/solve_out_env.cuh: the solve's output stage per env
// run on the CPU by a team of `team` threads (the envs in series), with the
// plain C interface of csrc/solve_out.cu less the stream, and the team's
// size in its place.  The members split every env's loops as the kernel's
// warp lanes do (host_team.h), so a team of 32 runs the warp's partition.
// The CPU tests (tests/test_torch_solve_out_kernel.py) build it with g++
// (ops/build.py::build_host) and hold it against the plain version; it is
// not on any path of the port.

#include <cstring>
#include <vector>

#include "host_team.h"
#include "solve_out_env.cuh"

namespace {

using solve_out_env::Params;

template <typename T>
int solve_out(const int* params, int nparams, const void* const* ins,
              int nins, void* const* outs, int nouts, int N, int team) {
  if (nparams != solve_out_env::kNumParams ||
      nins != 6 + solve_out_env::kMaxGroups + 2 || nouts != 4 ||
      team > solve_out_env::kMaxTeam)
    return 1;
  solve_out_env::Args<T> a;
  std::memcpy(&a.P, params, sizeof(Params));
  if (!solve_out_env::params_ok(a.P)) return 1;
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
  std::vector<T> work(solve_out_env::work_elems(a.P));
  std::vector<int> iwork(solve_out_env::iwork_elems(a.P));
  const int nefc = a.P.nefc, nv = a.P.nv;
  return host_team::run(N, team, [&](const host_team::ThreadTeam& tm, int n) {
    const int64_t e = n;
    solve_out_env::forces_one(tm, a, n, a.f + e * nefc,
                              a.J == nullptr ? nullptr : a.J + e * nefc * nv,
                              work.data(), iwork.data());
    solve_out_env::outputs_one(
        tm, a, n, a.Minv == nullptr ? nullptr : a.Minv + e * nv * nv, a.S,
        work.data(), iwork.data());
  });
}

}  // namespace

extern "C" const char* solve_out_param_names() {
  return solve_out_env::kParamNames;
}

#define SOLVE_OUT_HOST_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const int* params, int nparams,                        \
                      const void* const* ins, int nins, void* const* outs,   \
                      int nouts, int N, int team) {                          \
    return solve_out<T>(params, nparams, ins, nins, outs, nouts, N, team);   \
  }

SOLVE_OUT_HOST_ENTRY(solve_out_host_f32, float)
SOLVE_OUT_HOST_ENTRY(solve_out_host_f64, double)
