// One env's output stage of the contact solve, written once for the CUDA
// kernel (csrc/solve_out.cu, a warp per env) and for the host driver
// (csrc/solve_out_host.cpp, a team of host threads), which the CPU tests
// hold against the plain version (ops/solve_out.py::plain).
//
// forces_one and outputs_one compute, from the solve's force f and what the
// solve's form leaves (Form):
//
// - qfrc = Jᵀf, and qacc = qacc_smooth + dq (kLegs: dq = M⁻¹Jᵀf from the
//   legs kernel's epilogue) or qacc_smooth + M⁻¹ qfrc (kDense); kNewton
//   takes qfrc and qacc as the Newton kernel returned them, and neither
//   is written;
// - nforce, the normal force of every candidate point: 0, then each
//   contact group's points set, in row order, to their rows' sum (a
//   pyramid's facets) or their first row (an elliptic cone), a later write
//   winning; then every pair's force added to its point a, in pair order,
//   then to its point b.  That is the order of the JAX package's
//   `.at[idx].set` / `.at[pair.a].add` / `.at[pair.b].add`
//   (nightmare_rl_tpu/physics/solver.py:757-772) and of the plain
//   version's scatter and scatter_add on the CPU.  Each member owns whole
//   points and walks the slot lists in that order, so no float atomics and
//   no order that changes from run to run;
// - sensordata = S nforce, the touch sensors (S: nsensor x ncp), each sum
//   over the points in ascending order, in plain float arithmetic.
//
// The sums run in index order (Jᵀf over the rows, M⁻¹ qfrc and S nforce
// over the columns); torch's products and reductions take other orders,
// so those values differ from the plain version's by round-off, and the
// scatter's sets and adds are the plain version's exactly.  A point index
// outside [0, ncp) adds to no point (the assembly never makes one).
//
// The work is shared by a Team of size() members (smooth_env.cuh's
// contract: rank(), size(), sync()): member r owns dofs, slots, points
// and sensors r, r + size(), ..., and a sync() parts the phases, so no
// value depends on the team's size.  An env runs in two phases,
// forces_one and outputs_one, which read the env's f, J and M⁻¹ through
// pointers: the kernel stages them in shared memory (M⁻¹ in J's place,
// between the phases), the host driver passes the rows in place.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SOLVE_OUT_HD __host__ __device__ __forceinline__
#else
#define SOLVE_OUT_HD inline
#endif

namespace solve_out_env {

enum Form { kLegs = 0, kDense = 1, kNewton = 2 };
constexpr int kMaxGroups = 4;   // contact groups at most (condim 3, 4, 5, 6)
constexpr int kMaxTeam = 64;    // host team members at most

// A contact group: its rows [off, off + n * nf), n points of nf rows each,
// and the row stride of its point indices (0 where every env has the same
// points).
struct Group {
  int off, n, nf, stride;
};

// The integer parameters, in order (ops/solve_out.py fills them by these
// names: the library reports them, solve_out_param_names).
#define SOLVE_OUT_PARAMS(X)                                                   \
  X(form) X(elliptic) X(nefc) X(nv) X(ncp) X(nsensor) X(ngroup)               \
  X(g0_off) X(g0_n) X(g0_nf) X(g0_stride)                                     \
  X(g1_off) X(g1_n) X(g1_nf) X(g1_stride)                                     \
  X(g2_off) X(g2_n) X(g2_nf) X(g2_stride)                                     \
  X(g3_off) X(g3_n) X(g3_nf) X(g3_stride)                                     \
  X(pair_off) X(npair) X(pair_nf)

struct Params {
  int form, elliptic, nefc, nv, ncp, nsensor, ngroup;
  Group g[kMaxGroups];
  int pair_off, npair, pair_nf;
};

#define SOLVE_OUT_NAME(name) #name ","
constexpr const char* kParamNames = SOLVE_OUT_PARAMS(SOLVE_OUT_NAME);
#undef SOLVE_OUT_NAME
#define SOLVE_OUT_COUNT(name) +1
constexpr int kNumParams = 0 SOLVE_OUT_PARAMS(SOLVE_OUT_COUNT);
#undef SOLVE_OUT_COUNT
static_assert(sizeof(Params) == kNumParams * sizeof(int),
              "Params is the parameter list's ints in order");

// The slots of the groups' points.
SOLVE_OUT_HD int group_slots(const Params& P) {
  int s = 0;
  for (int g = 0; g < P.ngroup; ++g) s += P.g[g].n;
  return s;
}

// An env's workspace: qfrc (nv), the slots' forces (groups' then pairs'),
// nforce (ncp) of T, rounded up to 4; the slots' points (the groups', then
// each pair's a and b) of int.
SOLVE_OUT_HD int work_elems(const Params& P) {
  return (P.nv + group_slots(P) + P.npair + P.ncp + 3) & ~3;
}
SOLVE_OUT_HD int iwork_elems(const Params& P) {
  return (group_slots(P) + 2 * P.npair + 3) & ~3;
}

// What the phases cannot compute: false for a shape outside their limits
// or rows outside nefc.
SOLVE_OUT_HD bool params_ok(const Params& P) {
  if (P.form < kLegs || P.form > kNewton || P.nefc < 0 || P.nv < 0 ||
      P.ncp < 0 || P.nsensor < 0 || P.ngroup < 0 || P.ngroup > kMaxGroups ||
      P.npair < 0)
    return false;
  for (int g = 0; g < P.ngroup; ++g) {
    const Group& G = P.g[g];
    if (G.n < 0 || G.nf < 1 || G.off < 0 || G.stride < 0 ||
        G.off + G.n * G.nf > P.nefc)
      return false;
  }
  return P.npair == 0 || (P.pair_nf >= 1 && P.pair_off >= 0 &&
                          P.pair_off + P.npair * P.pair_nf <= P.nefc);
}

template <typename T>
struct Args {
  Params P;
  int N;
  const T* f;            // (N, nefc)
  const T* J;            // (N, nefc, nv), kLegs and kDense
  const T* dq;           // (N, nv), kLegs
  const T* Minv;         // (N, nv, nv), kDense
  const T* qacc_smooth;  // (N, nv)
  const T* S;            // (nsensor, ncp)
  const int64_t* idx[kMaxGroups];  // each group's points (N, n), row stride
  const int64_t* pa;     // (N, npair)
  const int64_t* pb;
  T* qfrc;               // (N, nv), kLegs and kDense
  T* qacc;
  T* nforce;             // (N, ncp)
  T* sens;               // (N, nsensor)
};

// A slot's normal force: its first row (elliptic), or its rows' sum.
template <typename T>
SOLVE_OUT_HD T slot_force(const T* f, int row, int nf, bool elliptic) {
  if (elliptic) return f[row];
  T s = f[row];
  for (int i = 1; i < nf; ++i) s += f[row + i];
  return s;
}

// The workspace's views: qfrc (nv), the slots' forces (groups', then
// pairs'), nforce (ncp); the slots' points (groups'), each pair's a and b.
template <typename T>
struct Work {
  T *qfrc, *val, *nf;
  int *pt, *pa, *pb;
  SOLVE_OUT_HD Work(const Params& P, T* w, int* wi) {
    const int ngs = group_slots(P);
    qfrc = w;
    val = w + P.nv;
    nf = val + ngs + P.npair;
    pt = wi;
    pa = wi + ngs;
    pb = pa + P.npair;
  }
};

// Env n's first phase: qfrc = Jᵀf (kLegs, kDense) and the slots' points
// and forces; f (nefc) and J (nefc x nv) are the env's rows (the block's
// copies on the card), w and wi its workspace (work_elems of T,
// iwork_elems of int).  Ends with a sync.
template <typename T, typename Team>
SOLVE_OUT_HD void forces_one(const Team& tm, const Args<T>& a, int n,
                             const T* f, const T* J, T* w, int* wi) {
  const Params& P = a.P;
  const int r = tm.rank(), sz = tm.size();
  const int nv = P.nv, nefc = P.nefc;
  const int ngs = group_slots(P);
  const bool elliptic = P.elliptic != 0;
  const Work<T> W(P, w, wi);

  // qfrc = Jᵀf: a member per dof, down J's column over the rows in order
  if (P.form != kNewton) {
    for (int v = r; v < nv; v += sz) {
      T s = 0;
      for (int k = 0; k < nefc; ++k) s += J[k * nv + v] * f[k];
      W.qfrc[v] = s;
      a.qfrc[static_cast<int64_t>(n) * nv + v] = s;
    }
  }
  // the slots: each group's points and forces, then the pairs'
  int base = 0;
  for (int g = 0; g < P.ngroup; ++g) {
    const Group& G = P.g[g];
    const int64_t* idx = a.idx[g] + static_cast<int64_t>(n) * G.stride;
    for (int c = r; c < G.n; c += sz) {
      W.pt[base + c] = static_cast<int>(idx[c]);
      W.val[base + c] = slot_force(f, G.off + c * G.nf, G.nf, elliptic);
    }
    base += G.n;
  }
  for (int k = r; k < P.npair; k += sz) {
    const int64_t at = static_cast<int64_t>(n) * P.npair + k;
    W.pa[k] = static_cast<int>(a.pa[at]);
    W.pb[k] = static_cast<int>(a.pb[at]);
    W.val[ngs + k] = slot_force(f, P.pair_off + k * P.pair_nf, P.pair_nf,
                                elliptic);
  }
  tm.sync();
}

// Env n's second phase, after forces_one: qacc (kLegs, kDense; Minv the
// env's nv x nv M⁻¹ for kDense, the block's copy on the card), nforce and
// the sensors (S the sensor matrix, the block's copy on the card).
template <typename T, typename Team>
SOLVE_OUT_HD void outputs_one(const Team& tm, const Args<T>& a, int n,
                              const T* Minv, const T* S, T* w, int* wi) {
  const Params& P = a.P;
  const int r = tm.rank(), sz = tm.size();
  const int nv = P.nv, ncp = P.ncp;
  const int ngs = group_slots(P);
  const Work<T> W(P, w, wi);

  if (P.form != kNewton) {
    const T* a0 = a.qacc_smooth + static_cast<int64_t>(n) * nv;
    for (int v = r; v < nv; v += sz) {
      T x;
      if (P.form == kLegs) {
        x = a0[v] + a.dq[static_cast<int64_t>(n) * nv + v];
      } else {
        T s = 0;
        for (int j = 0; j < nv; ++j) s += Minv[v * nv + j] * W.qfrc[j];
        x = a0[v] + s;
      }
      a.qacc[static_cast<int64_t>(n) * nv + v] = x;
    }
  }
  // nforce: a member per point, the slots in the scatter's order
  for (int p = r; p < ncp; p += sz) {
    T x = 0;
    for (int s = 0; s < ngs; ++s)
      if (W.pt[s] == p) x = W.val[s];
    for (int k = 0; k < P.npair; ++k)
      if (W.pa[k] == p) x += W.val[ngs + k];
    for (int k = 0; k < P.npair; ++k)
      if (W.pb[k] == p) x += W.val[ngs + k];
    W.nf[p] = x;
    a.nforce[static_cast<int64_t>(n) * ncp + p] = x;
  }
  tm.sync();

  // the touch sensors: a member per sensor
  for (int s = r; s < P.nsensor; s += sz) {
    const T* row = S + static_cast<int64_t>(s) * ncp;
    T y = 0;
    for (int p = 0; p < ncp; ++p) y += row[p] * W.nf[p];
    a.sens[static_cast<int64_t>(n) * P.nsensor + s] = y;
  }
}

}  // namespace solve_out_env
