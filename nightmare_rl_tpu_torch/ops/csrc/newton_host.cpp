// Host driver of csrc/newton_env.cuh: the Newton kernel's per-env
// arithmetic run on the CPU, one thread, the envs in series, with the same
// plain C interface as csrc/newton.cu (less the launch geometry and the
// stream).  The CPU tests (tests/test_torch_newton_kernel.py) build it with
// g++ (ops/build.py::build_host) and hold it against the JAX package's
// newton.solve; it is not on any path of the port.

#include <vector>

#include "newton_env.cuh"

namespace {

// One thread as newton_env's team.
struct SerialTeam {
  int rank() const { return 0; }
  int size() const { return 1; }
  template <typename T>
  T sum(T v) const {
    return v;
  }
  void sync() const {}
};

template <typename T>
int run(const newton_env::Args<T>& a) {
  if (a.N < 0 || a.nefc <= 0 || a.nv <= 0 || a.nc < 0 || a.nplain < 0 ||
      a.nplain > a.nefc || a.nmus < 0 || a.iterations < 0 || a.ls_refine < 0)
    return 1;
  std::vector<T> work(newton_env::env_elems(a.nefc, a.nv, a.nc, a.nmus));
  for (int n = 0; n < a.N; ++n)
    newton_env::solve_one(SerialTeam(), a, n, work.data());
  return 0;
}

}  // namespace

#define NEWTON_HOST_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* J, const T* aref, const T* R, const T* fl,   \
                      const unsigned char* quad, const T* mu,               \
                      const unsigned char* act, const T* mus, const T* M,   \
                      const T* a0, const T* x0, T* force, T* qfrc, T* qacc, \
                      const int* desc, int N, int nefc, int nv, int nc,     \
                      int nplain, int nmus, int iterations, int ls_refine) { \
    return run<T>(newton_env::Args<T>{                                       \
        J, aref, R, fl, quad, mu, act, mus, M, a0, x0, force, qfrc, qacc,    \
        desc, N, nefc, nv, nc, nplain, nmus, iterations, ls_refine});        \
  }

NEWTON_HOST_ENTRY(newton_host_f32, float)
NEWTON_HOST_ENTRY(newton_host_f64, double)
