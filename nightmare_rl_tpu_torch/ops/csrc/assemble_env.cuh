// One env's collision and constraint-row assembly, written once for the
// CUDA kernel (csrc/assemble.cu, one warp per env) and for the host driver
// (csrc/assemble_host.cpp, a team of host threads), which the CPU tests
// hold against the JAX package.
//
// assemble_one computes, for one env, what the JAX package's compiled step
// computes between the smooth half and the constraint solve: the candidate
// points against the ground plane and the top-K deepest condim-3 points
// (nightmare_rl_tpu/physics/collision.py:57-79, solver.py:587), the top-Kp
// deepest sphere pairs with their frames (collision.py:82-131), every
// constraint row in the order [dof | condim-3 | condim > 3 ascending |
// pairs] (solver.py:52-292, 529-686: impedance, solref's stiffness and
// damping, the pyramidal facets or the elliptic per-direction rows, the
// dof friction and joint-limit rows), each row's leg slots for the
// leg-sparse PGS (solver.py:619-659), the Newton solve's row flags and
// cone coefficients, and b = J qacc_smooth - aref.  The plain PyTorch
// version is ops/assemble.py::plain (the port's collision.find_contacts,
// find_pair_contacts, solver.assemble and _legmeta); the arithmetic below
// follows it statement by statement, in its order of operations, so the
// two differ by the order of the row products' sums (torch's einsums).
//
// Selection.  The port's topk_smallest is a stable descending sort of -x:
// NaN first (torch sorts NaN above every number), then ascending x, ties
// (and NaNs among themselves) to the lower index.  `sort_key` is that
// order as one unsigned integer, a strict total order on (x, index), so a
// rank counted against every other candidate is the sort's position
// exactly.  The condim-3 points are ranked so, a count stopping at K.  The
// pairs (1,566 for anymal_c) are first reduced per member to a sorted list
// of its Kp best, then the lists merged two by two, a round a sync, into
// the Kp best of all: every pair that precedes one of the Kp best is itself
// in its member's list.
//
// The work is shared by a Team of size() members (smooth_env.cuh's
// contract: rank(), size(), sync(), stamp(k)); each item is computed by one
// member,
// each sum in one member in a fixed order, so the results do not depend on
// the team's size.  The phases, a sync between each: the candidate points
// (a member per point); the selections; the contact slots (a member per
// selected or static point and per selected pair: its frame, impedance,
// stiffness and damping); J, written to its output (a member per (row
// owner, dof): one point Jacobian column gives all of its owner's facets);
// the rows (a member per row, J read back: J·qvel, J·qacc, aref, R,
// bounds, slots, flags).
//
// NaN semantics follow torch's: comparisons with NaN are false, clamp
// propagates NaN, masks multiply (NaN * 0 is NaN).

#pragma once

#include <math.h>
#include <string.h>

#include "smooth_env.cuh"

namespace assemble_env {

using smooth_env::clamp;
using smooth_env::clamp_min;
using smooth_env::cross;

constexpr int kMaxTeam = 32;   // members at most (the pair lists' room)
constexpr int kMaxPairs = 8;   // Kp at most
constexpr int kPairBatch = 4;  // pair distances a member computes at once
constexpr int kRankBatch = 4;  // condim-3 points a member ranks at once
constexpr double kMinImp = 1e-4, kMaxImp = 0.9999;  // mjMINIMP, mjMAXIMP

// A row owner (t_owner, kOwnerInts each): a dof row or a contact slot,
// owning rows [row, row + nf).  Dof rows: a0 the dof, a1 its qpos address,
// a2 and a3 its leg slot (branch, has).  Contact slots: a0 the point of a
// static slot (-1 for a selected condim-3 point, the slot's rank), or the
// pair's rank; a1 the offset of its friction coefficients in the cone
// outputs; a2 the slot.
enum OwnerField { kKind, kRow, kNf, kDim, kA0, kA1, kA2, kA3, kOwnerInts };
enum Kind { kFriction = 0, kLower = 1, kUpper = 2, kPoint = 3, kPair = 4 };
// A dof row's constants (c_dofrow, kDofRowVals each).
enum DofRowField {
  kSolref = 0, kSolimp = 2, kInvweight = 7, kFrictionloss = 8, kRange = 9,
  kDofRowVals = 11
};
// Timer stamps (Team::stamp), each at the end of a phase of assemble_one;
// only a kernel built with -DASSEMBLE_TIMELINE stamps, else a stamp is
// nothing.
enum AssembleStamp {
  kStStart, kStPoints, kStRank3, kStPairScan, kStPairMerge, kStSlots, kStJ,
  kStRows, kAssembleStamps
};
// A contact slot's values in the workspace (w_slot, kSlotVals each).
enum SlotField {
  kRel = 0, kNormal = 3, kT1 = 6, kT2 = 9, kDist = 12, kImp = 13, kK = 14,
  kB = 15, kMu = 16, kIw = 17, kSlotVals = 20
};

// The Layout's fields, in order: sizes, then offsets into the int32
// topology table (t_*), into the float constants table (c_*), into an
// env's float workspace (w_*) and into its int workspace (i_*).  The
// wrapper (ops/assemble.py) reads the names from the library
// (assemble_layout_names) and fills the fields by name.
#define ASSEMBLE_LAYOUT(X)                                                    \
  X(nv) X(nq) X(nbody) X(ncp) X(npair) X(nc3) X(K) X(Kp) X(nslot) X(ndofrow)  \
  X(nowner) X(nefc) X(elliptic) X(ntopo) X(ncst)                              \
  X(t_cp_body) X(t_cp_root) X(t_cp_leg) X(t_c3) X(t_pair_a) X(t_pair_b)       \
  X(t_owner) X(t_row_owner) X(t_row_f)                                        \
  X(c_cp_pos) X(c_cp_radius) X(c_cp_friction) X(c_cp_frot) X(c_cp_solref)     \
  X(c_cp_solimp) X(c_cp_iw) X(c_mask) X(c_dofrow) X(c_impratio)               \
  X(c_sqrt_impratio)                                                          \
  X(w_keys) X(w_cp) X(w_slot) X(w_cdof) X(w_qvel) X(w_qacc) X(w_elems)        \
  X(i_slot_pt) X(i_slot_mask) X(i_elems)

struct Layout {
#define ASSEMBLE_FIELD(name) int name;
  ASSEMBLE_LAYOUT(ASSEMBLE_FIELD)
#undef ASSEMBLE_FIELD
};

#define ASSEMBLE_NAME(name) #name ","
static const char kLayoutNames[] = ASSEMBLE_LAYOUT(ASSEMBLE_NAME);
#undef ASSEMBLE_NAME

constexpr int kLayoutInts = sizeof(Layout) / sizeof(int);

// The outputs, each (N, per-env size) in this order; a null pointer is an
// output the caller does not take.  Indices are int64, leg ids int32,
// flags bool (one byte), the rest T.
enum Out {
  kOutCenter, kOutPos, kOutDist, kOutActive,  // (ncp, 3) (ncp, 3) (ncp) (ncp)
  kOutSel3, kOutPairSel, kOutPairA, kOutPairB,  // (K) (Kp) (Kp) (Kp)
  kOutJ, kOutAref, kOutR, kOutLo, kOutHi, kOutB,  // (nefc, nv), (nefc) each
  kOutLeg1, kOutLeg2, kOutHas1, kOutHas2,       // (nefc) each
  kOutQuad, kOutFl,                             // (nefc) each
  kOutConeMu, kOutConeMus, kOutConeActive,      // (nslot) (friction) (nslot)
  kNumOuts
};

template <typename T>
struct AssembleArgs {
  Layout L;
  const int* topo;
  const T* cst;
  const T* pcst;         // per pair: friction, solref (2), solimp (5)
  const T* xpos;         // (N, nbody, 3)
  const T* xquat;        // (N, nbody, 4)
  const T* subtree_com;  // (N, nbody, 3)
  const T* cdof;         // (N, nv, 6)
  const T* qpos;         // (N, nq)
  const T* qvel;         // (N, nv)
  const T* qacc;         // (N, nv): qacc_smooth
  void* out[kNumOuts];
  int N;
};

// topk_smallest's order (see the header) as unsigned integers: x's bits
// made monotone (NaN 0, before every number; -0 as +0) above the index.
template <typename T>
struct SortKey;
template <>
struct SortKey<float> {
  using bits = unsigned int;
  using type = unsigned long long;
};
template <>
struct SortKey<double> {
  using bits = unsigned long long;
  using type = unsigned __int128;
};

template <typename T>
SMOOTH_HD typename SortKey<T>::type sort_key(T x, int index) {
  using U = typename SortKey<T>::bits;
  using K = typename SortKey<T>::type;
  U u = 0;
  if (x == x) {
    const T y = x == T(0) ? T(0) : x;
    memcpy(&u, &y, sizeof(U));
    const U sign = U(1) << (8 * sizeof(U) - 1);
    u = (u & sign) ? ~u : (u | sign);
  }
  return (K(u) << 32) | K(static_cast<unsigned int>(index));
}

template <typename T>
SMOOTH_HD int key_index(typename SortKey<T>::type key) {
  return static_cast<int>(static_cast<unsigned int>(key));
}

// MuJoCo's sigmoid impedance d(pos) from solimp = (d0, dmax, width, mid,
// power) (solver.py::impedance).
template <typename T>
SMOOTH_HD T impedance(const T* si, T pos) {
  const T d0 = clamp(si[0], T(kMinImp), T(kMaxImp));
  const T dmax = clamp(si[1], T(kMinImp), T(kMaxImp));
  const T width = si[2], mid = si[3], power = si[4];
  const T x = clamp(fabs(pos) / clamp_min(width, T(1e-12)), T(0), T(1));
  T y;
  if (x < mid) {
    y = pow(x / clamp_min(mid, T(1e-12)), power - T(1)) * x;
  } else {
    y = T(1) - pow((T(1) - x) / clamp_min(T(1) - mid, T(1e-12)),
                   power - T(1)) * (T(1) - x);
  }
  return d0 + y * (dmax - d0);
}

// Stiffness and damping from solref (solver.py::_kb).
template <typename T>
SMOOTH_HD void kb(const T* sr, const T* si, T* K, T* B) {
  const T tc = sr[0], dr = sr[1];
  const T dmax = clamp(si[1], T(kMinImp), T(kMaxImp));
  if (tc > T(0)) {
    const T c = clamp_min(dmax * tc * dr, T(1e-12));
    *K = T(1) / (c * c);
    *B = T(2) / clamp_min(dmax * tc, T(1e-12));
  } else {
    *K = -tc;
    *B = -dr;
  }
}

// (1 - imp) / imp, the regularization's factor.
template <typename T>
SMOOTH_HD T imp_ratio(T imp) {
  return (T(1) - imp) / clamp_min(imp, T(1e-12));
}

// The candidate points' centers and the pairs' distances round as the
// plain version's torch ops round them on the card, so that the selections
// and their order agree with it wherever two distances differ (the kernel
// is built with -fmad=false): a cross product's component is
// fma(a1, b2, -(a2 * b1)) there and a 3-vector's norm sqrt((x0² + x2²) +
// x1²) (task_env.cuh's cross_diff and norm3, probed on an H100); on the
// host a1 * b2 - a2 * b1.
template <typename T>
SMOOTH_HD T cross_diff(T a, T b, T c, T d) {
#ifdef __CUDA_ARCH__
  return fma(a, b, -(c * d));
#else
  return a * b - c * d;
#endif
}

template <typename T>
SMOOTH_HD void cross_as_torch(const T* a, const T* b, T* o) {
  const T x = cross_diff(a[1], b[2], a[2], b[1]);
  const T y = cross_diff(a[2], b[0], a[0], b[2]);
  const T z = cross_diff(a[0], b[1], a[1], b[0]);
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

// core/quat.py::rotate: v + 2 (w (u x v) + u x (u x v)), each op rounded.
template <typename T>
SMOOTH_HD void rotate_as_torch(const T* v, const T* q, T* o) {
  T uv[3], uuv[3];
  cross_as_torch(q + 1, v, uv);
  cross_as_torch(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + T(2) * (q[0] * uv[k] + uuv[k]);
}

// A pair's signed distance from the two sphere centers.
template <typename T>
SMOOTH_HD T pair_dist(const T* ca, const T* cb, T ra, T rb, T* d, T* cd) {
  for (int k = 0; k < 3; ++k) d[k] = cb[k] - ca[k];
  const T x0 = d[0] * d[0], x1 = d[1] * d[1], x2 = d[2] * d[2];
  *cd = sqrt((x0 + x2) + x1);
  return *cd - (ra + rb);
}

template <typename T>
SMOOTH_HD T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The friction coefficient of direction i (< dim - 1) of a slot.
template <typename T>
SMOOTH_HD T slot_mu(const T* cst, const Layout& L, int kind, int p, T mu,
                    int i) {
  if (kind == kPair || i < 2) return mu;
  return cst[L.c_cp_frot + 3 * p + i - 2];
}

// (row, col) of a row-major (rows, n) matrix advanced by `by` elements.
SMOOTH_HD void advance(int by, int n, int* row, int* col) {
  *col += by;
  while (*col >= n) {
    *col -= n;
    ++*row;
  }
}

template <typename T>
SMOOTH_HD T* out_t(const AssembleArgs<T>& a, int k) {
  return static_cast<T*>(a.out[k]);
}

template <typename Team, typename T>
SMOOTH_HD void assemble_one(const Team& tm, const AssembleArgs<T>& a, int n,
                            T* w, int* wi, const int* topo, const T* cst) {
  const Layout& L = a.L;
  const int me = tm.rank(), ts = tm.size();
  const int nv = L.nv, nb = L.nbody, ncp = L.ncp, nefc = L.nefc;
  const size_t sn = static_cast<size_t>(n);
  const T* xpos = a.xpos + sn * nb * 3;
  const T* xquat = a.xquat + sn * nb * 4;
  const T* com = a.subtree_com + sn * nb * 3;
  T* cdof = w + L.w_cdof;
  T* qv = w + L.w_qvel;
  T* qa = w + L.w_qacc;
  // the candidate points: centers' x, y, z, then distances, ncp each
  T* cp = w + L.w_cp;
  T* J = out_t(a, kOutJ) + sn * nefc * nv;
  T* slots = w + L.w_slot;
  int* slot_pt = wi + L.i_slot_pt;
  // per slot: the offsets of its bodies' rows of the dof mask in cst (a
  // point's body: -1, its own; a pair's: a's, b's)
  int* slot_mask = wi + L.i_slot_mask;
  const int* owners = topo + L.t_owner;
  const T inf = T(INFINITY);
  tm.stamp(kStStart);

  // ---- the env's inputs, and the candidate points ----
  for (int i = me; i < 6 * nv; i += ts) cdof[i] = a.cdof[sn * 6 * nv + i];
  for (int i = me; i < nv; i += ts) {
    qv[i] = a.qvel[sn * nv + i];
    qa[i] = a.qacc[sn * nv + i];
  }
  T* o_center = out_t(a, kOutCenter);
  T* o_pos = out_t(a, kOutPos);
  T* o_dist = out_t(a, kOutDist);
  unsigned char* o_active = static_cast<unsigned char*>(a.out[kOutActive]);
  for (int p = me; p < ncp; p += ts) {
    const int body = topo[L.t_cp_body + p];
    T rv[3], c[3];
    rotate_as_torch(cst + L.c_cp_pos + 3 * p, xquat + 4 * body, rv);
    for (int k = 0; k < 3; ++k) c[k] = xpos[3 * body + k] + rv[k];
    const T dist = c[2] - cst[L.c_cp_radius + p];
    for (int k = 0; k < 3; ++k) cp[k * ncp + p] = c[k];
    cp[3 * ncp + p] = dist;
    const size_t at = sn * ncp + p;
    if (o_center != nullptr)
      for (int k = 0; k < 3; ++k) o_center[3 * at + k] = c[k];
    if (o_pos != nullptr) {
      o_pos[3 * at] = c[0];
      o_pos[3 * at + 1] = c[1];
      o_pos[3 * at + 2] = c[2] - cst[L.c_cp_radius + p];
    }
    if (o_dist != nullptr) o_dist[at] = dist;
    if (o_active != nullptr) o_active[at] = dist < T(0);
  }
  for (int s = me; s < L.nslot; s += ts) {
    const int* od = owners + (L.ndofrow + s) * kOwnerInts;
    if (od[kKind] == kPoint && od[kA0] >= 0) slot_pt[s] = od[kA0];
  }
  tm.sync();
  tm.stamp(kStPoints);

  // ---- the top-K condim-3 points: each one's rank among all of them ----
  using Key = typename SortKey<T>::type;
  Key* keys3 = reinterpret_cast<Key*>(w + L.w_keys);
  const int n3 = L.K > 0 ? L.nc3 : 0;
  for (int i = me; i < n3; i += ts)
    keys3[i] = sort_key(cp[3 * ncp + topo[L.t_c3 + i]], i);
  tm.sync();
  // kRankBatch points of a member at once, each key read once for all
  for (int i0 = me; i0 < n3; i0 += kRankBatch * ts) {
    Key ki[kRankBatch];
    int rank[kRankBatch];
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k) {
      const int i = i0 + k * ts;
      ki[k] = i < n3 ? keys3[i] : Key(0);
      rank[k] = i < n3 ? 0 : L.K;
    }
    for (int j = 0; j < n3; ++j) {
      const Key kj = keys3[j];
      bool open = false;
#pragma unroll
      for (int k = 0; k < kRankBatch; ++k) {
        rank[k] += kj < ki[k];
        open = open || rank[k] < L.K;
      }
      if (!open) break;
    }
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k)
      if (rank[k] < L.K) slot_pt[rank[k]] = topo[L.t_c3 + i0 + k * ts];
  }
  tm.stamp(kStRank3);

  // ---- the top-Kp pairs: each member's sorted Kp best (kPairBatch
  // distances at once), then the lists merged two by two ----
  const int Kp = L.Kp;
  if (Kp > 0) {
    const Key none = ~Key(0);
    Key* src = keys3 + n3;
    Key* dst = src + kMaxTeam * Kp;
    Key* mine = src + me * Kp;
    for (int j = 0; j < Kp; ++j) mine[j] = none;
    Key last = none;  // the Kp-th best so far
    for (int q0 = me; q0 < L.npair; q0 += kPairBatch * ts) {
      Key batch[kPairBatch];
#pragma unroll
      for (int k = 0; k < kPairBatch; ++k) {
        const int q = q0 + k * ts;
        batch[k] = none;
        if (q < L.npair) {
          const int pa = topo[L.t_pair_a + q], pb = topo[L.t_pair_b + q];
          const T ca[3] = {cp[pa], cp[ncp + pa], cp[2 * ncp + pa]};
          const T cb[3] = {cp[pb], cp[ncp + pb], cp[2 * ncp + pb]};
          T d[3], cd;
          batch[k] = sort_key(
              pair_dist(ca, cb, cst[L.c_cp_radius + pa],
                        cst[L.c_cp_radius + pb], d, &cd), q);
        }
      }
#pragma unroll
      for (int k = 0; k < kPairBatch; ++k) {
        const Key key = batch[k];
        if (!(key < last)) continue;
        int j = Kp - 1;
        for (; j > 0 && key < mine[j - 1]; --j) mine[j] = mine[j - 1];
        mine[j] = key;
        last = mine[Kp - 1];
      }
    }
    tm.sync();
    tm.stamp(kStPairScan);
    for (int n = ts; n > 1; n = (n + 1) / 2) {
      for (int i = me; i < (n + 1) / 2; i += ts) {
        const Key* x = src + 2 * i * Kp;
        const Key* y = 2 * i + 1 < n ? x + Kp : nullptr;
        for (int k = 0, ix = 0, iy = 0; k < Kp; ++k) {
          const bool take_x = y == nullptr || x[ix] < y[iy];
          dst[i * Kp + k] = take_x ? x[ix++] : y[iy++];
        }
      }
      tm.sync();
      Key* t = src;
      src = dst;
      dst = t;
    }
    for (int k = me; k < Kp; k += ts)
      if (src[k] != none) slot_pt[L.nslot - Kp + k] = key_index<T>(src[k]);
  }
  tm.sync();
  tm.stamp(kStPairMerge);

  // ---- the contact slots: frame, distance, impedance, K and B ----
  long long* o_sel3 = static_cast<long long*>(a.out[kOutSel3]);
  long long* o_psel = static_cast<long long*>(a.out[kOutPairSel]);
  long long* o_pa = static_cast<long long*>(a.out[kOutPairA]);
  long long* o_pb = static_cast<long long*>(a.out[kOutPairB]);
  T* o_cmu = out_t(a, kOutConeMu);
  T* o_cmus = out_t(a, kOutConeMus);
  unsigned char* o_cact = static_cast<unsigned char*>(a.out[kOutConeActive]);
  const int nmus = L.nslot > 0 ? owners[(L.nowner - 1) * kOwnerInts + kA1] +
                                     owners[(L.nowner - 1) * kOwnerInts + kDim] -
                                     1
                               : 0;
  for (int s = me; s < L.nslot; s += ts) {
    const int* od = owners + (L.ndofrow + s) * kOwnerInts;
    T* sd = slots + s * kSlotVals;
    const int q = slot_pt[s];
    const T* sr;
    const T* si;
    int p = q;
    if (od[kKind] == kPoint) {
      const T c[3] = {cp[q], cp[ncp + q], cp[2 * ncp + q]};
      const T dist = cp[3 * ncp + q];
      const T* o = com + 3 * topo[L.t_cp_root + q];
      sd[kRel] = c[0] - o[0];
      sd[kRel + 1] = c[1] - o[1];
      sd[kRel + 2] = (dist > T(0) ? T(0) : dist) * T(0.5) - o[2];
      sd[kDist] = dist;
      sd[kMu] = cst[L.c_cp_friction + q];
      sd[kIw] = cst[L.c_cp_iw + q];
      sr = cst + L.c_cp_solref + 2 * q;
      si = cst + L.c_cp_solimp + 5 * q;
      slot_mask[2 * s] = -1;
      slot_mask[2 * s + 1] = L.c_mask + topo[L.t_cp_body + q] * nv;
      if (od[kA0] < 0 && o_sel3 != nullptr) o_sel3[sn * L.K + s] = q;
    } else {
      const int pa = topo[L.t_pair_a + q], pb = topo[L.t_pair_b + q];
      const T ca[3] = {cp[pa], cp[ncp + pa], cp[2 * ncp + pa]};
      const T cb[3] = {cp[pb], cp[ncp + pb], cp[2 * ncp + pb]};
      const T ra = cst[L.c_cp_radius + pa], rb = cst[L.c_cp_radius + pb];
      T d[3], cd, nrm[3], t1[3], t2[3], mid[3];
      sd[kDist] = pair_dist(ca, cb, ra, rb, d, &cd);
      const T cdc = clamp_min(cd, T(1e-9));
      for (int k = 0; k < 3; ++k) nrm[k] = d[k] / cdc;
      const bool z = fabs(nrm[2]) < T(0.9);
      const T ref[3] = {z ? T(0) : T(1), T(0), z ? T(1) : T(0)};
      cross(ref, nrm, t1);
      const T tn = clamp_min(sqrt(dot3(t1, t1)), T(1e-9));
      for (int k = 0; k < 3; ++k) t1[k] = t1[k] / tn;
      cross(nrm, t1, t2);
      for (int k = 0; k < 3; ++k)
        mid[k] = T(0.5) * (ca[k] + ra * nrm[k] + cb[k] - rb * nrm[k]);
      const T* o = com + 3 * topo[L.t_cp_root + pb];
      for (int k = 0; k < 3; ++k) {
        sd[kRel + k] = mid[k] - o[k];
        sd[kNormal + k] = nrm[k];
        sd[kT1 + k] = t1[k];
        sd[kT2 + k] = t2[k];
      }
      const T* pc = a.pcst + 8 * q;
      sd[kMu] = pc[0];
      sd[kIw] = cst[L.c_cp_iw + pa] + cst[L.c_cp_iw + pb];
      sr = pc + 1;
      si = pc + 3;
      p = -1;
      slot_mask[2 * s] = L.c_mask + topo[L.t_cp_body + pa] * nv;
      slot_mask[2 * s + 1] = L.c_mask + topo[L.t_cp_body + pb] * nv;
      const size_t at = sn * Kp + od[kA0];
      if (o_psel != nullptr) {
        o_psel[at] = q;
        o_pa[at] = pa;
        o_pb[at] = pb;
      }
    }
    sd[kImp] = impedance(si, sd[kDist]);
    kb(sr, si, sd + kK, sd + kB);
    if (o_cmu != nullptr) {   // elliptic: every slot is a cone
      const size_t at = sn * L.nslot + s;
      o_cmu[at] = sd[kMu] / cst[L.c_sqrt_impratio];
      o_cact[at] = sd[kDist] < T(0);
      for (int i = 0; i < od[kDim] - 1; ++i)
        o_cmus[sn * nmus + od[kA1] + i] =
            slot_mu(cst, L, od[kKind], p, sd[kMu], i);
    }
  }
  tm.sync();
  tm.stamp(kStSlots);

  // ---- J: a member per (owner, dof), all of the owner's rows at once ----
  for (int it = me, u = me / nv, v = me - me / nv * nv; it < L.nowner * nv;
       it += ts, advance(ts, nv, &u, &v)) {
    const int* od = owners + u * kOwnerInts;
    const int kind = od[kKind];
    T* Jr = J + od[kRow] * nv + v;
    if (kind <= kUpper) {
      const T e = v == od[kA0] ? T(1) : T(0);
      Jr[0] = kind == kUpper ? T(-1) * e : e;
      continue;
    }
    const int s = u - L.ndofrow;
    const T* sd = slots + s * kSlotVals;
    const T* ang = cdof + 6 * v;
    const T* lin = ang + 3;
    const int* sm = slot_mask + 2 * s;
    const T mb = cst[sm[1] + v];
    const T m = sm[0] < 0 ? mb : mb - cst[sm[0] + v];
    T cr[3], jac[3], dirs[5], Jn;
    cross(ang, sd + kRel, cr);
    for (int k = 0; k < 3; ++k) jac[k] = (lin[k] + cr[k]) * m;
    const int q = slot_pt[s];
    const int nd = od[kDim] - 1;
    if (kind == kPoint) {
      Jn = jac[2];
      dirs[0] = jac[1];
      dirs[1] = -jac[0];
      dirs[2] = ang[2] * m;
      dirs[3] = ang[1] * m;
      dirs[4] = -(ang[0] * m);
    } else {
      Jn = dot3(jac, sd + kNormal);
      dirs[0] = dot3(jac, sd + kT1);
      dirs[1] = dot3(jac, sd + kT2);
    }
    if (L.elliptic) Jr[0] = Jn;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (i >= nd) break;
      if (L.elliptic) {
        Jr[(i + 1) * nv] = dirs[i];
      } else {
        const T md = slot_mu(cst, L, kind, q, sd[kMu], i) * dirs[i];
        Jr[2 * i * nv] = Jn + md;
        Jr[(2 * i + 1) * nv] = Jn - md;
      }
    }
  }
  tm.sync();
  tm.stamp(kStJ);

  // ---- the rows: a member per row ----
  const size_t rn = sn * nefc;
  T* o_aref = out_t(a, kOutAref);
  T* o_R = out_t(a, kOutR);
  T* o_lo = out_t(a, kOutLo);
  T* o_hi = out_t(a, kOutHi);
  T* o_b = out_t(a, kOutB);
  int* o_leg1 = static_cast<int*>(a.out[kOutLeg1]);
  int* o_leg2 = static_cast<int*>(a.out[kOutLeg2]);
  unsigned char* o_has1 = static_cast<unsigned char*>(a.out[kOutHas1]);
  unsigned char* o_has2 = static_cast<unsigned char*>(a.out[kOutHas2]);
  unsigned char* o_quad = static_cast<unsigned char*>(a.out[kOutQuad]);
  T* o_fl = out_t(a, kOutFl);
  const T impratio = cst[L.c_impratio];
  for (int r = me; r < nefc; r += ts) {
    const int u = topo[L.t_row_owner + r], f = topo[L.t_row_f + r];
    const int* od = owners + u * kOwnerInts;
    const int kind = od[kKind];
    const T* Jr = J + r * nv;
    T vel = T(0), acc = T(0);
    for (int v = 0; v < nv; ++v) {
      vel += Jr[v] * qv[v];
      acc += Jr[v] * qa[v];
    }
    T aref, R, lo = T(0), hi;
    int leg1 = 0, leg2 = 0;
    bool has1 = false, has2 = false;
    if (kind <= kUpper) {
      const T* dr = cst + L.c_dofrow + u * kDofRowVals;
      const T v = qv[od[kA0]];
      T K, B;
      kb(dr + kSolref, dr + kSolimp, &K, &B);
      if (kind == kFriction) {
        const T imp = dr[kSolimp];
        R = clamp_min(imp_ratio(imp) * dr[kInvweight], T(1e-12));
        aref = -B * v;
        lo = -dr[kFrictionloss];
        hi = dr[kFrictionloss];
      } else {
        const T q = a.qpos[sn * L.nq + od[kA1]];
        const T dist = kind == kLower ? q - dr[kRange] : dr[kRange + 1] - q;
        const T imp = impedance(dr + kSolimp, dist);
        const T sv = kind == kLower ? v : T(-1) * v;
        aref = -B * sv - K * imp * (dist > T(0) ? T(0) : dist);
        R = clamp_min(imp_ratio(imp) * dr[kInvweight], T(1e-12));
        hi = dist < T(0) ? inf : T(0);
      }
      leg1 = leg2 = od[kA2];
      has1 = od[kA3] != 0;
    } else {
      const T* sd = slots + (u - L.ndofrow) * kSlotVals;
      const T dist = sd[kDist], imp = sd[kImp], K = sd[kK], B = sd[kB];
      const T mu = sd[kMu], iw = sd[kIw];
      if (L.elliptic) {
        aref = -B * vel;
        const T R0 = clamp_min(imp_ratio(imp) * iw, T(1e-12));
        if (f == 0) {
          aref = aref + -(K * imp * dist);
          R = R0;
        } else {
          const int q = slot_pt[u - L.ndofrow];
          const T x = mu / slot_mu(cst, L, kind, kind == kPoint ? q : -1, mu,
                                   f - 1);
          R = R0 * (x * x) / impratio;
        }
      } else {
        aref = -B * vel - K * imp * dist;
        R = clamp_min(imp_ratio(imp) * T(2) * (mu * mu) * (T(1) + mu * mu) *
                          iw / impratio,
                      T(1e-12));
      }
      hi = dist < T(0) ? inf : T(0);
      const int q = slot_pt[u - L.ndofrow];
      if (kind == kPoint) {
        const int lp = topo[L.t_cp_leg + q];
        leg1 = leg2 = lp > 0 ? lp : 0;
        has1 = lp >= 0;
      } else {
        const int la = topo[L.t_cp_leg + topo[L.t_pair_a + q]];
        const int lb = topo[L.t_cp_leg + topo[L.t_pair_b + q]];
        leg1 = la > 0 ? la : 0;
        leg2 = lb > 0 ? lb : 0;
        has1 = la >= 0;
        has2 = lb >= 0 && la != lb;
      }
    }
    o_aref[rn + r] = aref;
    o_R[rn + r] = R;
    o_lo[rn + r] = lo;
    o_hi[rn + r] = hi;
    o_b[rn + r] = acc - aref;
    if (o_leg1 != nullptr) {
      o_leg1[rn + r] = leg1;
      o_leg2[rn + r] = leg2;
      o_has1[rn + r] = has1;
      o_has2[rn + r] = has2;
    }
    if (o_quad != nullptr) {
      const bool is_fl = lo < T(0);
      o_quad[rn + r] = !is_fl && hi > T(0) && !(L.elliptic && kind >= kPoint);
      o_fl[rn + r] = is_fl ? hi : T(0);
    }
  }
  tm.sync();
  tm.stamp(kStRows);
}

}  // namespace assemble_env
