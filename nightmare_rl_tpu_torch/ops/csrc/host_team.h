// The host drivers' team: a number of threads that split each env's loops
// as a kernel's warp lanes do (member rank owns rank + k * size), with
// smooth_env.cuh's team contract (rank, size, sync, any, stamp), and the
// loop that runs every env with one team.  Included by csrc/smooth_host.cpp
// and csrc/assemble_host.cpp.

#pragma once

#include <atomic>
#include <thread>
#include <vector>

namespace host_team {

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

struct ThreadTeam {
  int r, n;
  Barrier* barrier;
  char* votes;  // one slot per member, for any()
  int rank() const { return r; }
  int size() const { return n; }
  void sync() const { barrier->wait(); }
  bool any(bool p) const {
    votes[r] = p;
    barrier->wait();
    bool out = false;
    for (int k = 0; k < n; ++k) out = out || votes[k] != 0;
    barrier->wait();  // no member votes again before every member has read
    return out;
  }
  void stamp(int) const {}
};

// Runs one(tm, n) for every env n in series with a team of `team` threads
// (1 to 64; a team of one runs in the calling thread), the members synced
// after each env so that the next one may reuse its workspace.
template <typename F>
int run(int N, int team, F one) {
  if (N < 0 || team < 1 || team > 64) return 1;
  std::vector<char> votes(team);
  Barrier barrier(team);
  auto member = [&](int r) {
    const ThreadTeam tm{r, team, &barrier, votes.data()};
    for (int n = 0; n < N; ++n) {
      one(tm, n);
      tm.sync();
    }
  };
  std::vector<std::thread> threads;
  for (int r = 1; r < team; ++r) threads.emplace_back(member, r);
  member(0);
  for (std::thread& t : threads) t.join();
  return 0;
}

}  // namespace host_team
