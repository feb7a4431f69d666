// Host driver of csrc/newton_env.cuh: the Newton kernel's per-env
// arithmetic run on the CPU by a team of `team` threads (the envs in
// series), with the same plain C interface as csrc/newton.cu less the
// launch geometry and the stream, and the team's size in their place.  A
// team of one runs in the calling thread.  The members split every loop as
// the kernel's warp lanes do (member rank owns rank + k * size), so a team
// whose size differs from 32 runs the same partition on other counts.  The
// CPU tests (tests/test_torch_newton_kernel.py) build it with g++
// (ops/build.py::build_host) and hold it against the JAX package's
// newton.solve; it is not on any path of the port.

#include <atomic>
#include <thread>
#include <vector>

#include "newton_env.cuh"

namespace {

// A barrier that spins (yielding) until every member has arrived.
class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait() {
    if (n_ == 1) return;
    const int gen = gen_.load(std::memory_order_acquire);
    if (count_.fetch_add(1, std::memory_order_acq_rel) == n_ - 1) {
      count_.store(0, std::memory_order_relaxed);
      gen_.fetch_add(1, std::memory_order_release);
    } else {
      while (gen_.load(std::memory_order_acquire) == gen)
        std::this_thread::yield();
    }
  }

 private:
  const int n_;
  std::atomic<int> count_{0}, gen_{0};
};

// What the members of a team share: the barrier and one row of slots per
// member for the collectives.
struct Common {
  static constexpr int kSlots = 2 * newton_env::kGrid;
  Common(int n) : barrier(n), slots(static_cast<size_t>(n) * kSlots) {}
  Barrier barrier;
  std::vector<double> slots;   // exact for float and double
};

// One member of a team of host threads as newton_env's team.  A collective
// writes the member's values to its slots, waits for all, reads the slots
// in rank order (so every member forms the bitwise same result) and waits
// again before the slots are reused.
struct ThreadTeam {
  static constexpr int kRows = newton_env::kRegNv;
  int r, n;
  Common* common;
  int rank() const { return r; }
  int size() const { return n; }
  void sync() const { common->barrier.wait(); }
  void stamp(int) const {}
  double* slot(int member) const {
    return common->slots.data() + static_cast<size_t>(member) * Common::kSlots;
  }
  template <int K, typename T>
  void sum_n(T (&v)[K]) const {
    static_assert(K <= Common::kSlots, "too many sums at once");
    for (int k = 0; k < K; ++k) slot(r)[k] = static_cast<double>(v[k]);
    sync();
    for (int k = 0; k < K; ++k) {
      T acc = T(0);
      for (int m = 0; m < n; ++m) acc += static_cast<T>(slot(m)[k]);
      v[k] = acc;
    }
    sync();
  }
  template <typename T>
  T sum(T v) const {
    T one[1] = {v};
    sum_n(one);
    return one[0];
  }
  template <typename T>
  T bcast(T v, int src) const {
    slot(r)[0] = static_cast<double>(v);
    sync();
    const T out = static_cast<T>(slot(src)[0]);
    sync();
    return out;
  }
  int prefix(bool p, int& total) const {
    slot(r)[0] = p ? 1.0 : 0.0;
    sync();
    int before = 0;
    total = 0;
    for (int m = 0; m < n; ++m) {
      const int v = slot(m)[0] != 0.0;
      before += m < r ? v : 0;
      total += v;
    }
    sync();
    return before;
  }
};

template <typename T>
int run(const newton_env::Args<T>& a, int team) {
  if (a.N < 0 || a.nefc <= 0 || a.nv <= 0 || a.nc < 0 || a.nplain < 0 ||
      a.nplain > a.nefc || a.nmus < 0 || a.iterations < 0 ||
      a.ls_refine < 0 || team < 1 || team > 64)
    return 1;
  std::vector<T> work(newton_env::env_elems(a.nefc, a.nv, a.nc, a.nmus));
  Common common(team);
  auto member = [&](int r) {
    const ThreadTeam tm{r, team, &common};
    for (int n = 0; n < a.N; ++n) {
      newton_env::solve_one(tm, a, n, work.data());
      tm.sync();   // the next env reuses the workspace
    }
  };
  std::vector<std::thread> threads;
  for (int r = 1; r < team; ++r) threads.emplace_back(member, r);
  member(0);
  for (std::thread& t : threads) t.join();
  return 0;
}

}  // namespace

#define NEWTON_HOST_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* J, const T* aref, const T* R, const T* fl,   \
                      const unsigned char* quad, const T* mu,               \
                      const unsigned char* act, const T* mus, const T* M,   \
                      const T* a0, const T* x0, T* force, T* qfrc, T* qacc, \
                      const int* desc, int N, int nefc, int nv, int nc,     \
                      int nplain, int nmus, int iterations, int ls_refine,  \
                      int team) {                                           \
    return run<T>(newton_env::Args<T>{                                       \
                      J, aref, R, fl, quad, mu, act, mus, M, a0, x0, force,  \
                      qfrc, qacc, desc, N, nefc, nv, nc, nplain, nmus,       \
                      iterations, ls_refine},                                \
                  team);                                                     \
  }

NEWTON_HOST_ENTRY(newton_host_f32, float)
NEWTON_HOST_ENTRY(newton_host_f64, double)
