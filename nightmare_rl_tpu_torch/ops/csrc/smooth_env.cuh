// One env's smooth dynamics and integrator update, written once for the
// CUDA kernels (csrc/smooth.cu and csrc/integrate.cu, one warp per env) and
// for the host driver (csrc/smooth_host.cpp, a team of host threads), which
// the CPU tests hold against the JAX package.
//
// smooth_one computes, for one env, what the JAX package's compiled
// pipeline.forward computes before collision (nightmare_rl_tpu/physics/
// pipeline.py:59-82): kinematics (kinematics.py:43), com_vel (:151), the
// CRB mass matrix (dynamics.py:23), the RNE bias (:47), actuation (:90),
// passive damping (:131), qfrc_smooth and, for a model with a block-arrow
// layout, the arrow factor and qacc_smooth (arrow.py:124, :137).
// update_one computes the integrator's update of pipeline.step (:125-191):
// the implicitfast or implicit-damping Euler solve through the arrow factor
// (or plain Euler), mj_integratePos and the mj_checkPos/mj_checkVel reset.
// The plain PyTorch versions are the port's physics/kinematics.py,
// physics/dynamics.py, physics/arrow.py (ops/smooth.py::plain) and
// ops/integrate.py::plain_update; the arithmetic below follows them
// statement by statement, in their order of operations, so that the two
// differ by the contraction of multiply-adds into FMAs and by the order of
// the few sums that torch leaves to a library (the 3x3 and 6x6 products,
// the einsums).
//
// The work is shared by a Team of size() members:
//   rank(), size()  member rank (0 <= rank < size); a member owns the items
//                   rank + k * size of a list;
//   sync()          orders the members' workspace writes before the reads
//                   that follow;
//   any(p)          true on every member if p is true on any (a vote; it
//                   orders nothing);
//   stamp(k)        records timer stamp k (SmoothStamp, UpdateStamp; only
//                   a kernel built with -DSMOOTH_TIMELINE stamps, else it is
//                   nothing).
// The kernels' team is a warp (__syncwarp); the host driver's a number of
// threads (a barrier).  Every item is computed by one member, each sum in
// one member in a fixed order, so the results do not depend on the team's
// size: the host driver at 1 and at 32 members and the kernel agree bit for
// bit where the compilers round alike.
//
// The tree is walked a round of chains at a time (a schedule made by the
// wrapper, ops/smooth.py::model_plan): a member carries one chain of bodies
// down (or up) in registers, so the hexapod's walk is the base, a sync,
// then its six legs side by side; bottom-up sums take the children of a
// body in descending index order, which is the order in which the plain
// version's loop over bodies adds them.  The arrow factor and solve run a
// branch per member in registers (arrow_factor_solve).  Every static table
// (topology, model constants) and every offset into them and into an env's
// workspace comes from the wrapper in a Layout, passed by value.
//
// NaN semantics follow torch's: comparisons with NaN are false, clamp
// propagates NaN, the Cholesky factor of the arrow blocks keeps the plain
// version's masks (x * 0 above the diagonal) and its square root of a
// pivot that is not positive, and the reset tests !(|x| < 1e10), which is
// true for NaN and inf.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SMOOTH_HD __host__ __device__ __forceinline__
#else
#define SMOOTH_HD inline
#endif

namespace smooth_env {

// Joint types and update kinds (physics/system.py; ops/integrate.py).
constexpr int kFree = 0, kSlide = 2, kHinge = 3;
constexpr int kEuler = 0, kImplicitFast = 1, kEulerDamped = 2;
constexpr int kBase = 6;  // dofs of the free base of a block-arrow layout

// Timer stamps (Team::stamp), each at the end of a phase: smooth_one's,
// with one stamp per round of the body frames' walk (rounds past
// kStampLevels share the last), and update_one's.  The velocities and the
// accelerations are one walk: kStVel and kStAcc stamp its end together.
constexpr int kStampLevels = 6;
enum SmoothStamp {
  kStStart, kStLoads, kStFrames,
  kStInertial = kStFrames + kStampLevels, kStSubtree, kStCom, kStCinert,
  kStVel, kStAcc, kStForces, kStComposite, kStFBias, kStMQfrc, kStFactor,
  kStSolve, kStStores, kSmoothStamps
};
enum UpdateStamp {
  kUpStart, kUpShift, kUpFactor, kUpSolve, kUpPos, kUpReset, kUpdateStamps
};

// The Layout's fields, in order: sizes (ntopo and ncst: the tables'
// elements), then offsets into the int32
// topology table (t_*), into the float constants table (c_*), into kernel
// 1's per-env workspace (w_*) and into kernel 2's (u_*).  The wrapper reads
// the names from the library (smooth_layout_names) and fills the fields by
// name.
#define SMOOTH_LAYOUT(X)                                                      \
  X(nbody) X(njnt) X(nv) X(nq) X(nu) X(nround) X(nbranch) X(bsize) X(update)  \
  X(ntopo) X(ncst)                                                            \
  X(t_parent) X(t_jntadr) X(t_jntnum) X(t_root) X(t_round_start)              \
  X(t_chain_start) X(t_chain_body) X(t_child_start) X(t_child) X(t_jtype)     \
  X(t_qadr) X(t_dadr) X(t_jbody) X(t_dof_body) X(t_mask) X(t_act_dof)         \
  X(t_act_qadr) X(t_act_ctrllim) X(t_act_forcelim) X(t_dof_act_start)         \
  X(t_dof_act)                                                                \
  X(c_body_pos) X(c_body_quat) X(c_body_ipos) X(c_body_iquat) X(c_mass)       \
  X(c_inertia) X(c_jnt_axis) X(c_jnt_pos) X(c_damping) X(c_armature)          \
  X(c_gravity) X(c_gear) X(c_gain) X(c_bias) X(c_ctrlrange) X(c_forcerange)   \
  X(c_qpos0) X(c_dt) X(c_vel_deriv)                                           \
  X(w_xpos) X(w_xquat) X(w_xipos) X(w_ximat) X(w_xanchor) X(w_xaxis)          \
  X(w_sub_mass) X(w_sub_mom) X(w_subtree_com) X(w_cinert) X(w_cdof)          \
  X(w_cvel) X(w_cdof_dot) X(w_F) X(w_M) X(w_cacc) X(w_cfrc)                  \
  X(w_force) X(w_qfrc_act) X(w_bias) X(w_qfrc) X(w_qpos) X(w_qvel) X(w_A)    \
  X(w_Ld) X(w_W) X(w_Ls) X(w_y) X(w_x) X(w_ctrl) X(w_elems)                  \
  X(u_M) X(u_A) X(u_Ld) X(u_W) X(u_Ls) X(u_rhs) X(u_y) X(u_x) X(u_qpos)      \
  X(u_qvel) X(u_qfrc) X(u_qacc) X(u_qvel0) X(u_qpos0) X(u_elems)

struct Layout {
#define SMOOTH_FIELD(name) int name;
  SMOOTH_LAYOUT(SMOOTH_FIELD)
#undef SMOOTH_FIELD
};

#define SMOOTH_NAME(name) #name ","
static const char kLayoutNames[] = SMOOTH_LAYOUT(SMOOTH_NAME);
#undef SMOOTH_NAME

constexpr int kLayoutInts = sizeof(Layout) / sizeof(int);

// Kernel 1's outputs, each (N, per-env size) in this order.
enum Out {
  kXpos, kXquat, kXipos, kXimat, kXanchor, kXaxis, kSubtreeCom, kCinert,
  kCdof, kCvel, kCdofDot, kM, kQfrcActuator, kActuatorForce, kQfrcSmooth,
  kOutLd, kOutW, kOutLs, kOutC, kQaccSmooth, kNumOuts
};

template <typename T>
struct SmoothArgs {
  Layout L;
  const int* topo;
  const T* cst;
  const T* qpos;   // (N, nq)
  const T* qvel;   // (N, nv)
  const T* ctrl;   // (N, nu)
  T* out[kNumOuts];
  int N;
};

template <typename T>
struct UpdateArgs {
  Layout L;
  const int* topo;
  const T* cst;
  const T* M;          // (N, nv, nv)
  const T* qfrc_smooth;
  const T* qfrc_constraint;
  const T* qacc;       // the contact solve's qacc
  const T* qpos;
  const T* qvel;
  T* qpos_out;
  T* qvel_out;
  T* qacc_warmstart;
  int N;
};

// ---- core/quat.py and core/spatial.py, on 3-, 4- and 6-vectors ----------

template <typename T>
SMOOTH_HD void cross(const T* a, const T* b, T* o) {
  const T x = a[1] * b[2] - a[2] * b[1];
  const T y = a[2] * b[0] - a[0] * b[2];
  const T z = a[0] * b[1] - a[1] * b[0];
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

// R(q) v: v + 2 (w (u x v) + u x (u x v)).
template <typename T>
SMOOTH_HD void rotate(const T* v, const T* q, T* o) {
  T uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + T(2) * (q[0] * uv[k] + uuv[k]);
}

template <typename T>
SMOOTH_HD void mul(const T* a, const T* b, T* o) {
  const T w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  const T x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  const T y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  const T z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w;
  o[1] = x;
  o[2] = y;
  o[3] = z;
}

template <typename T>
SMOOTH_HD T norm(const T* v, int n) {
  T s = T(0);
  for (int k = 0; k < n; ++k) s += v[k] * v[k];
  return sqrt(s);
}

// max(x, eps) that keeps NaN, as torch.clamp_min.
template <typename T>
SMOOTH_HD T clamp_min(T x, T eps) {
  return x < eps ? eps : x;
}

// torch.clamp(x, lo, hi) = min(max(x, lo), hi), NaN kept.
template <typename T>
SMOOTH_HD T clamp(T x, T lo, T hi) {
  const T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

template <typename T>
SMOOTH_HD void normalize(const T* q, T* o) {
  const T n = clamp_min(norm(q, 4), T(1e-12));
  for (int k = 0; k < 4; ++k) o[k] = q[k] / n;
}

template <typename T>
SMOOTH_HD void from_axis_angle(const T* axis, T angle, T* o) {
  const T half = T(0.5) * angle;
  const T s = sin(half);
  o[0] = cos(half);
  for (int k = 0; k < 3; ++k) o[k + 1] = axis[k] * s;
}

template <typename T>
SMOOTH_HD void to_mat(const T* q, T* m) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  m[0] = T(1) - T(2) * (y * y + z * z);
  m[1] = T(2) * (x * y - w * z);
  m[2] = T(2) * (x * z + w * y);
  m[3] = T(2) * (x * y + w * z);
  m[4] = T(1) - T(2) * (x * x + z * z);
  m[5] = T(2) * (y * z - w * x);
  m[6] = T(2) * (x * z - w * y);
  m[7] = T(2) * (y * z + w * x);
  m[8] = T(1) - T(2) * (x * x + y * y);
}

// q' = normalize(q ⊗ exp(½ ω dt)) (mju_quatIntegrate).
template <typename T>
SMOOTH_HD void quat_integrate(const T* q, const T* omega, T dt, T* o) {
  const T angle = norm(omega, 3);
  const T a = clamp_min(angle, T(1e-12));
  T axis[3], dq[4], p[4];
  for (int k = 0; k < 3; ++k) axis[k] = omega[k] / a;
  from_axis_angle(axis, angle * dt, dq);
  mul(q, dq, p);
  normalize(p, o);
}

// v x_m m = [w x a, w x b + u x a].
template <typename T>
SMOOTH_HD void motion_cross(const T* v, const T* m, T* o) {
  T wb[3], ua[3];
  cross(v, m, o);
  cross(v, m + 3, wb);
  cross(v + 3, m, ua);
  for (int k = 0; k < 3; ++k) o[3 + k] = wb[k] + ua[k];
}

// v x_f f = [w x t + u x n, w x n].
template <typename T>
SMOOTH_HD void force_cross(const T* v, const T* f, T* o) {
  T wt[3], un[3];
  cross(v, f, wt);
  cross(v + 3, f + 3, un);
  cross(v, f + 3, o + 3);
  for (int k = 0; k < 3; ++k) o[k] = wt[k] + un[k];
}

// 6x6 spatial inertia about a frame origin:
//   [ I + m cx cxᵀ   m cx ]
//   [ m cxᵀ          m 1  ]      cx = skew(c).
template <typename T>
SMOOTH_HD void inertia_matrix(T m, const T* Iw, const T* c, T* o) {
  const T cx[9] = {T(0), -c[2], c[1], c[2], T(0), -c[0], -c[1], c[0], T(0)};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      T s = cx[i * 3] * cx[j * 3];
      for (int k = 1; k < 3; ++k) s += cx[i * 3 + k] * cx[j * 3 + k];
      o[i * 6 + j] = Iw[i * 3 + j] + m * s;
      o[i * 6 + 3 + j] = m * cx[i * 3 + j];
      o[(3 + i) * 6 + j] = m * cx[j * 3 + i];
      o[(3 + i) * 6 + 3 + j] = m * (i == j ? T(1) : T(0));
    }
}

// o = A v for a 6x6 A.
template <typename T>
SMOOTH_HD void mat6_vec(const T* A, const T* v, T* o) {
  for (int i = 0; i < 6; ++i) {
    T s = A[i * 6] * v[0];
    for (int k = 1; k < 6; ++k) s += A[i * 6 + k] * v[k];
    o[i] = s;
  }
}

template <typename T>
SMOOTH_HD T dot6(const T* a, const T* b) {
  T s = a[0] * b[0];
  for (int k = 1; k < 6; ++k) s += a[k] * b[k];
  return s;
}

// ---- physics/arrow.py's factor and solves -------------------------------

// Leg blocks of at most kMaxBlock dofs (ops/smooth.py::model_plan refuses
// larger ones): a branch's factor and solves run in one member's registers.
constexpr int kMaxBlock = 3;

// L = chol(A) for an n x n A (n <= kN) held in registers (a, row stride
// kN; overwritten), with chol's operations in chol's order
// (arrow.py::_chol): each column of L (c = A[i][j] / sqrt(A[j][j]), c * 0
// above the diagonal) goes to l and to Lout (row stride ldl), then every
// entry of A takes its downdate (the last column's, which nothing reads, is
// left out).
template <int kN, typename T>
SMOOTH_HD void chol_regs(T* a, int n, T* l, T* Lout, int ldl) {
  for (int j = 0; j < kN; ++j) {
    if (j >= n) break;
    const T d = sqrt(a[j * kN + j]);
    for (int i = 0; i < kN; ++i)
      if (i < n) {
        const T c = a[i * kN + j] / d;
        l[i * kN + j] = i >= j ? c : c * T(0);
        Lout[i * ldl + j] = l[i * kN + j];
      }
    if (j + 1 < n)
      for (int i = 0; i < kN; ++i)
        for (int k = 0; k < kN; ++k)
          if (i < n && k < n)
            a[i * kN + k] = a[i * kN + k] - l[i * kN + j] * l[k * kN + j];
  }
}

// v = L^-1 v, then (with both) v = L^-T v, for the n x n lower factor l
// in registers (row stride kN), with the operations of arrow.py's
// _solve_tril and _solve_triu.
template <int kN, typename T>
SMOOTH_HD void tri_solves(const T* l, int n, T* v, bool both) {
  for (int i = 0; i < kN; ++i)
    if (i < n) {
      T acc = v[i];
      for (int k = 0; k < i; ++k) acc = acc - l[i * kN + k] * v[k];
      v[i] = acc / l[i * kN + i];
    }
  if (!both) return;
  for (int i = kN - 1; i >= 0; --i)
    if (i < n) {
      T acc = v[i];
      for (int k = i + 1; k < kN; ++k)
        if (k < n) acc = acc - l[k * kN + i] * v[k];
      v[i] = acc / l[i * kN + i];
    }
}

// The block-arrow factor of the nv x nv matrix M (workspace, row stride
// ldm) and x = M^-1 rhs (arrow.py::factor, arrow.py::solve_vec), with the
// plain version's operations, in four steps a sync apart:
//   1. one member per branch, in its registers: Ld_b = chol(D_b); then
//      one member per column of W_b = Ld_b^-1 C_b and per y_b = Ld_b^-T
//      Ld_b^-1 rhs_b;
//   2. one member per entry of S = B6 - sum_b W_bᵀ W_b (into S, 36
//      elements) and per base dof of rhs_base - Cᵀ y (into x);
//   3. one member per row of S, in its registers: Ls = chol(S), a column
//      at a time (the pivot and the column of L cross members through the
//      workspace, two syncs a column; then stamp `stamp`); member 0, in
//      its registers: x_base = Ls^-T Ls^-1 x_base;
//   4. one member per branch: x_b = y_b - Ld_b^-T (W_b x_base).
// Ld, W, Ls, y and x are written to the workspace; S holds kBase * kBase +
// kBase + 1 elements.
template <typename T, typename Team>
SMOOTH_HD void arrow_factor_solve(const Team& tm, const Layout& L, const T* M,
                                  int ldm, const T* rhs, T* S, T* Ld, T* W,
                                  T* Ls, T* y, T* x, int stamp) {
  constexpr int kB = kMaxBlock;
  const int B = L.nbranch, s = L.bsize, r = tm.rank(), sz = tm.size();
  for (int b = r; b < B; b += sz) {
    const int r0 = kBase + b * s;
    T a[kB * kB], l[kB * kB];
    for (int i = 0; i < kB; ++i)
      for (int k = 0; k < kB; ++k)
        if (i < s && k < s) a[i * kB + k] = M[(r0 + i) * ldm + r0 + k];
    chol_regs<kB>(a, s, l, Ld + b * s * s, s);
  }
  tm.sync();
  // item c < kBase of branch b: W_b's column c; item kBase: y_b
  for (int e = r; e < B * (kBase + 1); e += sz) {
    const int b = e / (kBase + 1), c = e - b * (kBase + 1), r0 = kBase + b * s;
    T l[kB * kB], v[kB];
    for (int i = 0; i < kB; ++i)
      for (int k = 0; k <= i; ++k)
        if (i < s) l[i * kB + k] = Ld[b * s * s + i * s + k];
    for (int i = 0; i < kB; ++i)
      if (i < s) v[i] = c < kBase ? M[(r0 + i) * ldm + c] : rhs[r0 + i];
    tri_solves<kB>(l, s, v, c == kBase);
    for (int i = 0; i < kB; ++i)
      if (i < s) {
        if (c < kBase)
          W[(b * s + i) * kBase + c] = v[i];
        else
          y[b * s + i] = v[i];
      }
  }
  tm.sync();
  for (int e = r; e < kBase * kBase + kBase; e += sz) {
    T acc = T(0);
    if (e < kBase * kBase) {
      const int i = e / kBase, j = e % kBase;
      for (int q = 0; q < B * s; ++q)
        acc += W[q * kBase + i] * W[q * kBase + j];
      S[e] = M[i * ldm + j] - acc;
    } else {
      const int k = e - kBase * kBase;
      for (int q = 0; q < B * s; ++q) acc += M[(kBase + q) * ldm + k] * y[q];
      x[k] = rhs[k] - acc;
    }
  }
  tm.sync();
  // chol's operations on S's rows i = r, r + size, ..., each in registers:
  // c = S[i][j] / sqrt(S[j][j]) (c * 0 above the diagonal), then S[i][k] -
  // L[i][j] L[k][j]
  T* piv = S + kBase * kBase;  // the pivot, then the column of L
  T rows[kBase][kBase];
  for (int q = 0; q < kBase; ++q)
    if (r + q * sz < kBase)
      for (int k = 0; k < kBase; ++k) rows[q][k] = S[(r + q * sz) * kBase + k];
  for (int j = 0; j < kBase; ++j) {
    for (int q = 0; q < kBase; ++q)
      if (r + q * sz == j) piv[0] = rows[q][j];
    tm.sync();
    const T d = sqrt(piv[0]);
    for (int q = 0; q < kBase; ++q) {
      const int i = r + q * sz;
      if (i < kBase) {
        const T c = rows[q][j] / d;
        piv[1 + i] = i >= j ? c : c * T(0);
        Ls[i * kBase + j] = piv[1 + i];
      }
    }
    tm.sync();
    if (j + 1 < kBase)
      for (int q = 0; q < kBase; ++q) {
        const int i = r + q * sz;
        if (i < kBase)
          for (int k = 0; k < kBase; ++k)
            rows[q][k] = rows[q][k] - piv[1 + i] * piv[1 + k];
      }
  }
  tm.stamp(stamp);
  if (r == 0) {
    T l[kBase * kBase], v[kBase];
    for (int k = 0; k < kBase * kBase; ++k) l[k] = Ls[k];
    for (int k = 0; k < kBase; ++k) v[k] = x[k];
    tri_solves<kBase>(l, kBase, v, true);
    for (int k = 0; k < kBase; ++k) x[k] = v[k];
  }
  tm.sync();
  for (int b = r; b < B; b += sz) {
    T* xb = x + kBase + b * s;
    const T* Wb = W + b * s * kBase;
    T l[kB * kB], v[kB];
    for (int i = 0; i < kB; ++i)
      for (int k = 0; k < kB; ++k)
        if (i < s && k <= i) l[i * kB + k] = Ld[b * s * s + i * s + k];
    for (int i = 0; i < kB; ++i)
      if (i < s) {
        T acc = Wb[i * kBase] * x[0];
        for (int k = 1; k < kBase; ++k) acc += Wb[i * kBase + k] * x[k];
        v[i] = acc;
      }
    for (int i = kB - 1; i >= 0; --i)
      if (i < s) {
        T acc = v[i];
        for (int k = i + 1; k < kB; ++k)
          if (k < s) acc = acc - l[k * kB + i] * v[k];
        v[i] = acc / l[i * kB + i];
      }
    for (int i = 0; i < kB; ++i)
      if (i < s) xb[i] = y[b * s + i] - v[i];
  }
  tm.sync();
}

// ---- kernel 1: one env's smooth dynamics ---------------------------------

// The tree walks.  Bodies 1.. form chains (ops/smooth.py::model_plan): a
// chain runs down from its head through bodies that have one child each
// and ends at a leaf or at a body with two or more children, each of which
// heads a chain of the next round; round 0's heads are the world's
// children.  A round's chains run side by side, one member each, the
// chain's running values (a frame, a velocity) in registers, and a sync
// ends the round: the hexapod's walk is the base, then the six legs.

// Forward kinematics of body b from its parent's frame (kinematics.py:52):
// pos and qt come in as the parent's and leave as b's, which are also
// written to the workspace.
template <typename T>
SMOOTH_HD void body_frame(const Layout& L, const int* __restrict__ tp,
                          const T* __restrict__ cst, const T* qpos, T* ws,
                          int b, T* pos, T* qt) {
  T r[3], t[4];
  rotate(cst + L.c_body_pos + 3 * b, qt, r);
  for (int k = 0; k < 3; ++k) pos[k] = pos[k] + r[k];
  mul(qt, cst + L.c_body_quat + 4 * b, t);
  for (int k = 0; k < 4; ++k) qt[k] = t[k];
  const int j0 = tp[L.t_jntadr + b], j1 = j0 + tp[L.t_jntnum + b];
  for (int j = j0; j < j1; ++j) {
    const int jt = tp[L.t_jtype + j], qa = tp[L.t_qadr + j];
    const T* axis = cst + L.c_jnt_axis + 3 * j;
    const T* jpos = cst + L.c_jnt_pos + 3 * j;
    T* anchor = ws + L.w_xanchor + 3 * j;
    T* xaxis = ws + L.w_xaxis + 3 * j;
    if (jt == kFree) {
      for (int k = 0; k < 3; ++k) pos[k] = qpos[qa + k];
      normalize(qpos + qa + 3, qt);
      for (int k = 0; k < 3; ++k) {
        anchor[k] = pos[k];
        xaxis[k] = axis[k];
      }
    } else if (jt == kHinge) {
      T aw[3], dq[4], an[3];
      rotate(jpos, qt, r);
      for (int k = 0; k < 3; ++k) an[k] = pos[k] + r[k];
      rotate(axis, qt, aw);
      from_axis_angle(axis, qpos[qa], dq);
      mul(qt, dq, t);
      for (int k = 0; k < 4; ++k) qt[k] = t[k];
      rotate(jpos, qt, r);
      for (int k = 0; k < 3; ++k) {
        pos[k] = an[k] - r[k];
        anchor[k] = an[k];
        xaxis[k] = aw[k];
      }
    } else {  // kSlide
      T aw[3];
      rotate(axis, qt, aw);
      for (int k = 0; k < 3; ++k) {
        pos[k] = pos[k] + aw[k] * qpos[qa];
        anchor[k] = pos[k];
        xaxis[k] = aw[k];
      }
    }
  }
  for (int k = 0; k < 3; ++k) ws[L.w_xpos + 3 * b + k] = pos[k];
  for (int k = 0; k < 4; ++k) ws[L.w_xquat + 4 * b + k] = qt[k];
}

// cvel[b], the cdof_dot of b's dofs and cacc[b] (kinematics.py::com_vel,
// dynamics.py::rne_bias's forward pass): v and acc come in as the parent's
// cvel and cacc and leave as b's, which are also written to the workspace.
// acc takes each joint's cdof_dot terms as soon as they are made, in the
// plain version's order (joints, then dofs, ascending).
template <typename T>
SMOOTH_HD void body_motion(const Layout& L, const int* __restrict__ tp,
                           const T* qvel, T* ws, int b, T* v, T* acc) {
  const T* cdof = ws + L.w_cdof;
  T* cdd = ws + L.w_cdof_dot;
  const int j0 = tp[L.t_jntadr + b], j1 = j0 + tp[L.t_jntnum + b];
  for (int j = j0; j < j1; ++j) {
    const int d = tp[L.t_dadr + j];
    if (tp[L.t_jtype + j] == kFree) {
      for (int k = 0; k < 6; ++k)
        v[k] = v[k] + cdof[6 * d + k] * qvel[d] +
               cdof[6 * (d + 1) + k] * qvel[d + 1] +
               cdof[6 * (d + 2) + k] * qvel[d + 2];
      T c[3][6];
      for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < 6; ++k) cdd[6 * (d + i) + k] = T(0);
        motion_cross(v, cdof + 6 * (d + 3 + i), c[i]);
        for (int k = 0; k < 6; ++k) cdd[6 * (d + 3 + i) + k] = c[i][k];
      }
      for (int k = 0; k < 6; ++k)
        v[k] = v[k] + cdof[6 * (d + 3) + k] * qvel[d + 3] +
               cdof[6 * (d + 4) + k] * qvel[d + 4] +
               cdof[6 * (d + 5) + k] * qvel[d + 5];
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 6; ++k) acc[k] = acc[k] + T(0) * qvel[d + i];
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 6; ++k)
          acc[k] = acc[k] + c[i][k] * qvel[d + 3 + i];
    } else {
      T c[6];
      motion_cross(v, cdof + 6 * d, c);
      for (int k = 0; k < 6; ++k) {
        cdd[6 * d + k] = c[k];
        v[k] = v[k] + cdof[6 * d + k] * qvel[d];
        acc[k] = acc[k] + c[k] * qvel[d];
      }
    }
  }
  for (int k = 0; k < 6; ++k) {
    ws[L.w_cvel + 6 * b + k] = v[k];
    ws[L.w_cacc + 6 * b + k] = acc[k];
  }
}

// Bodies of a chain that a member holds in registers in a bottom-up sum.
constexpr int kMaxChain = 4;

// x[b] += the sum of x over b's children, the children in descending index
// order (the order of the plain version's loop over bodies), bottom-up, for
// two fields at once (x1, w1 values per body; x2, w2), for every body but
// the world, and the world too with `world`.  A round's chains each take a
// group of members (size / chains of them, or one member several chains),
// which share the chain's values; a member walks its chain from the end up
// for each of its values: the chain's last body gathers its children
// (heads of the next round, done), every other body its one child, the
// running sum in a register.
template <typename T, typename Team>
SMOOTH_HD void tree_sums(const Team& tm, const Layout& L,
                         const int* __restrict__ tp, T* x1, int w1, T* x2,
                         int w2, bool world) {
  const int w = w1 + w2, r = tm.rank(), sz = tm.size();
  for (int rd = L.nround - 1; rd >= 0; --rd) {
    const int c0 = tp[L.t_round_start + rd];
    const int nch = tp[L.t_round_start + rd + 1] - c0;
    const int per = sz >= nch ? sz / nch : 1, groups = sz >= nch ? nch : sz;
    for (int g = r / per; g < nch && r < per * groups; g += groups) {
      const int c = c0 + g;
      const int i0 = tp[L.t_chain_start + c], i1 = tp[L.t_chain_start + c + 1];
      const int last = tp[L.t_chain_body + i1 - 1];
      const int ch0 = tp[L.t_child_start + last];
      const int ch1 = tp[L.t_child_start + last + 1];
      const int nb = i1 - i0;
      int bod[kMaxChain];  // a short chain's bodies, in registers
      for (int q = 0; q < kMaxChain; ++q)
        bod[q] = q < nb ? tp[L.t_chain_body + i0 + q] : 0;
      for (int k = r % per; k < w; k += per) {
        T* x = k < w1 ? x1 : x2;
        const int wk = k < w1 ? w1 : w2, kk = k < w1 ? k : k - w1;
        T acc = x[last * wk + kk];
        for (int ch = ch0; ch < ch1; ++ch)
          acc = acc + x[tp[L.t_child + ch] * wk + kk];
        x[last * wk + kk] = acc;
        if (nb <= kMaxChain) {  // the chain's values loaded at once
          T v[kMaxChain];
          for (int q = 0; q < kMaxChain - 1; ++q)
            if (q < nb - 1) v[q] = x[bod[q] * wk + kk];
          for (int q = kMaxChain - 2; q >= 0; --q)
            if (q < nb - 1) {
              acc = v[q] + acc;
              x[bod[q] * wk + kk] = acc;
            }
          continue;
        }
        for (int i = i1 - 2; i >= i0; --i) {
          const int b = tp[L.t_chain_body + i];
          acc = x[b * wk + kk] + acc;
          x[b * wk + kk] = acc;
        }
      }
    }
    tm.sync();
  }
  if (!world) return;
  for (int k = r; k < w; k += sz) {
    T* x = k < w1 ? x1 : x2;
    const int wk = k < w1 ? w1 : w2, kk = k < w1 ? k : k - w1;
    T acc = x[kk];
    for (int ch = tp[L.t_child_start]; ch < tp[L.t_child_start + 1]; ++ch)
      acc = acc + x[tp[L.t_child + ch] * wk + kk];
    x[kk] = acc;
  }
  tm.sync();
}

// Runs chain c of the walk down its bodies (frames), from the workspace's
// values of the head's parent.
template <typename T>
SMOOTH_HD void chain_frames(const Layout& L, const int* __restrict__ tp,
                            const T* __restrict__ cst, const T* qpos, T* ws,
                            int c) {
  const int i0 = tp[L.t_chain_start + c], i1 = tp[L.t_chain_start + c + 1];
  const int p = tp[L.t_parent + tp[L.t_chain_body + i0]];
  T pos[3], qt[4];
  for (int k = 0; k < 3; ++k) pos[k] = ws[L.w_xpos + 3 * p + k];
  for (int k = 0; k < 4; ++k) qt[k] = ws[L.w_xquat + 4 * p + k];
  for (int i = i0; i < i1; ++i)
    body_frame(L, tp, cst, qpos, ws, tp[L.t_chain_body + i], pos, qt);
}

// The same for the velocities and accelerations.
template <typename T>
SMOOTH_HD void chain_motion(const Layout& L, const int* __restrict__ tp,
                            const T* qvel, T* ws, int c) {
  const int i0 = tp[L.t_chain_start + c], i1 = tp[L.t_chain_start + c + 1];
  const int p = tp[L.t_parent + tp[L.t_chain_body + i0]];
  T v[6], acc[6];
  for (int k = 0; k < 6; ++k) {
    v[k] = ws[L.w_cvel + 6 * p + k];
    acc[k] = ws[L.w_cacc + 6 * p + k];
  }
  for (int i = i0; i < i1; ++i)
    body_motion(L, tp, qvel, ws, tp[L.t_chain_body + i], v, acc);
}

// Output k's block of env n (len values per env) from the workspace at
// src, by consecutive members; called once the field is final, after a
// sync.
template <typename T, typename Team>
SMOOTH_HD void store(const Team& tm, const SmoothArgs<T>& a, int k, int n,
                     const T* src, int len) {
  T* dst = a.out[k] + static_cast<long long>(n) * len;
  const int sz = tm.size();
  // four loads in flight, the loops kept rolled: the kernel's code, which
  // a cold launch fetches once, stays small
  int i = tm.rank();
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (; i + 3 * sz < len; i += 4 * sz) {
    T v[4];
    for (int q = 0; q < 4; ++q) v[q] = src[i + q * sz];
    for (int q = 0; q < 4; ++q) dst[i + q * sz] = v[q];
  }
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (; i < len; i += sz) dst[i] = src[i];
}

// The tables tp and cst are a.topo and a.cst or copies of them (the kernel
// stages them in shared memory).
template <typename T, typename Team>
SMOOTH_HD void smooth_one(const Team& tm, const SmoothArgs<T>& a, int n,
                          T* ws, const int* tp, const T* cst) {
  const Layout& L = a.L;
  const int nb = L.nbody, nj = L.njnt, nv = L.nv, nu = L.nu, r = tm.rank(),
            sz = tm.size();
  tm.stamp(kStStart);
  T* qpos = ws + L.w_qpos;
  T* qvel = ws + L.w_qvel;
  T* ctrl = ws + L.w_ctrl;
  for (int i = r; i < L.nq; i += sz) qpos[i] = a.qpos[n * L.nq + i];
  for (int i = r; i < nv; i += sz) qvel[i] = a.qvel[n * nv + i];
  for (int i = r; i < nu; i += sz) ctrl[i] = a.ctrl[n * nu + i];
  if (r == 0) {  // the world body
    for (int k = 0; k < 3; ++k) ws[L.w_xpos + k] = T(0);
    ws[L.w_xquat] = T(1);
    for (int k = 1; k < 4; ++k) ws[L.w_xquat + k] = T(0);
  }
  tm.sync();
  tm.stamp(kStLoads);

  // body frames, a round of chains at a time
  for (int rd = 0; rd < L.nround; ++rd) {
    for (int c = tp[L.t_round_start + rd] + r;
         c < tp[L.t_round_start + rd + 1]; c += sz)
      chain_frames(L, tp, cst, qpos, ws, c);
    tm.sync();
    tm.stamp(kStFrames + (rd < kStampLevels ? rd : kStampLevels - 1));
  }
  for (int rd = L.nround; rd < kStampLevels; ++rd) tm.stamp(kStFrames + rd);
  // inertial frames and the subtree sums' seeds (mass, then mass * xipos)
  for (int b = r; b < nb; b += sz) {
    T t[4], q[4];
    T* xipos = ws + L.w_xipos + 3 * b;
    const T* xq = ws + L.w_xquat + 4 * b;
    rotate(cst + L.c_body_ipos + 3 * b, xq, t);
    for (int k = 0; k < 3; ++k) xipos[k] = ws[L.w_xpos + 3 * b + k] + t[k];
    mul(xq, cst + L.c_body_iquat + 4 * b, q);
    to_mat(q, ws + L.w_ximat + 9 * b);
    const T m = cst[L.c_mass + b];
    ws[L.w_sub_mass + b] = m;
    for (int k = 0; k < 3; ++k) ws[L.w_sub_mom + 3 * b + k] = m * xipos[k];
  }
  tm.sync();
  tm.stamp(kStInertial);
  // subtree masses and moments, bottom-up
  tree_sums(tm, L, tp, ws + L.w_sub_mass, 1, ws + L.w_sub_mom, 3, true);
  tm.stamp(kStSubtree);
  for (int e = r; e < 3 * nb; e += sz)
    ws[L.w_subtree_com + e] =
        ws[L.w_sub_mom + e] / clamp_min(ws[L.w_sub_mass + e / 3], T(1e-12));
  tm.sync();
  store(tm, a, kXpos, n, ws + L.w_xpos, 3 * nb);
  store(tm, a, kXquat, n, ws + L.w_xquat, 4 * nb);
  store(tm, a, kXipos, n, ws + L.w_xipos, 3 * nb);
  store(tm, a, kXimat, n, ws + L.w_ximat, 9 * nb);
  store(tm, a, kXanchor, n, ws + L.w_xanchor, 3 * nj);
  store(tm, a, kXaxis, n, ws + L.w_xaxis, 3 * nj);
  store(tm, a, kSubtreeCom, n, ws + L.w_subtree_com, 3 * nb);
  tm.stamp(kStCom);

  // cinert about each tree's com (one body per member)
  for (int b = r; b < nb; b += sz) {
    const T* R = ws + L.w_ximat + 9 * b;
    const T* I = cst + L.c_inertia + 3 * b;
    const T* com = ws + L.w_subtree_com + 3 * tp[L.t_root + b];
    T Iw[9], c[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        T s = R[i * 3] * (I[0] * R[j * 3]);
        for (int k = 1; k < 3; ++k) s += R[i * 3 + k] * (I[k] * R[j * 3 + k]);
        Iw[i * 3 + j] = s;
      }
    for (int k = 0; k < 3; ++k) c[k] = ws[L.w_xipos + 3 * b + k] - com[k];
    T* ci = ws + L.w_cinert + 36 * b;
    inertia_matrix(cst[L.c_mass + b], Iw, c, ci);
  }
  // cdof, one joint per member
  for (int j = r; j < nj; j += sz) {
    const int b = tp[L.t_jbody + j];
    const T* o = ws + L.w_subtree_com + 3 * tp[L.t_root + b];
    const int d = tp[L.t_dadr + j], jt = tp[L.t_jtype + j];
    T* cd = ws + L.w_cdof + 6 * d;
    T u[3];
    if (jt == kFree) {
      T R[9];
      to_mat(ws + L.w_xquat + 4 * b, R);
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 6; ++k) cd[6 * i + k] = k == 3 + i ? T(1) : T(0);
      for (int k = 0; k < 3; ++k) u[k] = o[k] - ws[L.w_xpos + 3 * b + k];
      for (int i = 0; i < 3; ++i) {
        T* ci = cd + 6 * (3 + i);
        for (int k = 0; k < 3; ++k) ci[k] = R[k * 3 + i];
        cross(ci, u, ci + 3);
      }
    } else if (jt == kHinge) {
      const T* ax = ws + L.w_xaxis + 3 * j;
      for (int k = 0; k < 3; ++k) {
        u[k] = o[k] - ws[L.w_xanchor + 3 * j + k];
        cd[k] = ax[k];
      }
      cross(ax, u, cd + 3);
    } else {
      for (int k = 0; k < 3; ++k) {
        cd[k] = T(0);
        cd[3 + k] = ws[L.w_xaxis + 3 * j + k];
      }
    }
  }
  if (r == 0)
    for (int k = 0; k < 6; ++k) {
      ws[L.w_cvel + k] = T(0);
      ws[L.w_cacc + k] = k < 3 ? T(0) : -cst[L.c_gravity + k - 3];
    }
  tm.sync();
  store(tm, a, kCinert, n, ws + L.w_cinert, 36 * nb);
  store(tm, a, kCdof, n, ws + L.w_cdof, 6 * nv);
  tm.stamp(kStCinert);

  // cvel, cdof_dot and cacc, a round of chains at a time
  for (int rd = 0; rd < L.nround; ++rd) {
    for (int c = tp[L.t_round_start + rd] + r;
         c < tp[L.t_round_start + rd + 1]; c += sz)
      chain_motion(L, tp, qvel, ws, c);
    tm.sync();
  }
  store(tm, a, kCvel, n, ws + L.w_cvel, 6 * nb);
  store(tm, a, kCdofDot, n, ws + L.w_cdof_dot, 6 * nv);
  tm.stamp(kStVel);
  tm.stamp(kStAcc);
  // body forces f = I a + v x_f (I v)
  for (int b = r; b < nb; b += sz) {
    const T* ci = ws + L.w_cinert + 36 * b;
    const T* v = ws + L.w_cvel + 6 * b;
    T Ia[6], Iv[6], vf[6];
    mat6_vec(ci, v, Iv);
    mat6_vec(ci, ws + L.w_cacc + 6 * b, Ia);
    force_cross(v, Iv, vf);
    for (int k = 0; k < 6; ++k) ws[L.w_cfrc + 6 * b + k] = Ia[k] + vf[k];
  }
  tm.sync();
  tm.stamp(kStForces);
  // composite inertias and body forces, bottom-up (the roots give nothing
  // to the world); cinert, stored and read by the body forces, becomes the
  // composite inertia in place
  tree_sums(tm, L, tp, ws + L.w_cinert, 36, ws + L.w_cfrc, 6, false);
  tm.stamp(kStComposite);
  // F = crb[dof body] cdof, and the bias projected on cdof
  for (int d = r; d < nv; d += sz) {
    const int b = tp[L.t_dof_body + d];
    mat6_vec(ws + L.w_cinert + 36 * b, ws + L.w_cdof + 6 * d,
             ws + L.w_F + 6 * d);
    ws[L.w_bias + d] = dot6(ws + L.w_cdof + 6 * d, ws + L.w_cfrc + 6 * b);
  }
  // actuator forces
  for (int u = r; u < nu; u += sz) {
    const T gear = cst[L.c_gear + u];
    const T length = qpos[tp[L.t_act_qadr + u]] * gear;
    const T velocity = qvel[tp[L.t_act_dof + u]] * gear;
    T c = ctrl[u];
    if (tp[L.t_act_ctrllim + u])
      c = clamp(c, cst[L.c_ctrlrange + 2 * u], cst[L.c_ctrlrange + 2 * u + 1]);
    const T* bp = cst + L.c_bias + 3 * u;
    T f = cst[L.c_gain + u] * c + bp[0] + bp[1] * length + bp[2] * velocity;
    if (tp[L.t_act_forcelim + u])
      f = clamp(f, cst[L.c_forcerange + 2 * u], cst[L.c_forcerange + 2 * u + 1]);
    ws[L.w_force + u] = f;
  }
  tm.sync();
  tm.stamp(kStFBias);
  // M = tri + triᵀ - diag(tri) + diag(armature), tri = (cdof Fᵀ) * mask,
  // one member per entry of the lower triangle, written to both halves
  // (tij + tji is tji + tij), rows p and nv - 1 - p together (nv + 1
  // entries), two entries a member at once (their loads in flight
  // together); t_mask[i nv + j] = mask[i][j] + 2 mask[j][i]
  const int ne = (nv + 1) / 2 * (nv + 1);
  for (int e0 = r; e0 < ne; e0 += 2 * sz) {
    T m[2];
    int ij[2][2];
    for (int q = 0; q < 2; ++q) {
      const int e = e0 + q * sz;
      const int p = e / (nv + 1), t = e - p * (nv + 1);
      const int i = t <= p ? p : nv - 1 - p, j = t <= p ? t : t - p - 1;
      // past the end, or the middle row of an odd nv a second time
      const bool skip = e >= ne || (t > p && i == p);
      ij[q][0] = skip ? -1 : i;
      ij[q][1] = j;
      if (skip) continue;
      const int mk = tp[L.t_mask + i * nv + j];
      const T tij =
          dot6(ws + L.w_cdof + 6 * i, ws + L.w_F + 6 * j) * T(mk & 1);
      const T tji =
          dot6(ws + L.w_cdof + 6 * j, ws + L.w_F + 6 * i) * T(mk >> 1);
      m[q] = tij + tji;
      m[q] = m[q] - (i == j ? tij : T(0));
      m[q] = m[q] + (i == j ? cst[L.c_armature + i] : T(0));
    }
    for (int q = 0; q < 2; ++q) {
      const int i = ij[q][0], j = ij[q][1];
      if (i < 0) continue;
      ws[L.w_M + i * nv + j] = m[q];
      ws[L.w_M + j * nv + i] = m[q];
    }
  }
  // qfrc_actuator = gearᵀ force (index_add in actuator order: each dof's
  // actuators ascending), qfrc_smooth
  for (int d = r; d < nv; d += sz) {
    T q = T(0);
    for (int k = tp[L.t_dof_act_start + d]; k < tp[L.t_dof_act_start + d + 1];
         ++k) {
      const int u = tp[L.t_dof_act + k];
      q = q + cst[L.c_gear + u] * ws[L.w_force + u];
    }
    ws[L.w_qfrc_act + d] = q;
    const T passive = -cst[L.c_damping + d] * qvel[d];
    ws[L.w_qfrc + d] = q + passive - ws[L.w_bias + d];
  }
  tm.sync();
  store(tm, a, kM, n, ws + L.w_M, nv * nv);
  store(tm, a, kQfrcActuator, n, ws + L.w_qfrc_act, nv);
  store(tm, a, kActuatorForce, n, ws + L.w_force, nu);
  store(tm, a, kQfrcSmooth, n, ws + L.w_qfrc, nv);
  tm.stamp(kStMQfrc);
  if (L.nbranch == 0) return;
  const int B = L.nbranch, s = L.bsize;
  arrow_factor_solve(tm, L, ws + L.w_M, nv, ws + L.w_qfrc, ws + L.w_A,
                     ws + L.w_Ld, ws + L.w_W, ws + L.w_Ls, ws + L.w_y,
                     ws + L.w_x, kStFactor);
  tm.stamp(kStSolve);
  store(tm, a, kOutLd, n, ws + L.w_Ld, B * s * s);
  store(tm, a, kOutW, n, ws + L.w_W, B * s * kBase);
  store(tm, a, kOutLs, n, ws + L.w_Ls, kBase * kBase);
  store(tm, a, kQaccSmooth, n, ws + L.w_x, nv);
  // C: M's rows kBase.., columns ..kBase
  T* dst = a.out[kOutC] + static_cast<long long>(n) * B * s * kBase;
  for (int i = r; i < B * s * kBase; i += sz)
    dst[i] = ws[L.w_M + (kBase + i / kBase) * nv + i % kBase];
  tm.stamp(kStStores);
}

// ---- kernel 2: one env's integrator update -------------------------------

template <typename T, typename Team>
SMOOTH_HD void update_one(const Team& tm, const UpdateArgs<T>& a, int n,
                          T* ws) {
  const Layout& L = a.L;
  const int* tp = a.topo;
  const T* cst = a.cst;
  const int nv = L.nv, nq = L.nq, r = tm.rank(), sz = tm.size();
  tm.stamp(kUpStart);
  const long long ov = static_cast<long long>(n) * nv;
  const T dt = cst[L.c_dt];
  T* qvel = ws + L.u_qvel;
  T* qpos = ws + L.u_qpos;
  // every input at once, its loads in flight together: the forces' sum,
  // qacc, qvel, qpos and M (row stride ldm, odd for nv even, so that a
  // member per row meets no bank twice; one member per column)
  T* qfrc = ws + L.u_qfrc;
  T* qacc = ws + L.u_qacc;
  T* v0 = ws + L.u_qvel0;
  T* q0 = ws + L.u_qpos0;
  const int ldm = nv + 1;
  T* M = ws + L.u_M;
  for (int i = r; i < nv; i += sz) {
    qfrc[i] = a.qfrc_smooth[ov + i] + a.qfrc_constraint[ov + i];
    qacc[i] = a.qacc[ov + i];
    v0[i] = a.qvel[ov + i];
  }
  for (int i = r; i < nq; i += sz) q0[i] = a.qpos[n * nq + i];
  if (L.update != kEuler) {
    const T* Mg = a.M + ov * nv;
    for (int j = r; j < nv; j += sz)
      for (int i = 0; i < nv; ++i) M[i * ldm + j] = Mg[i * nv + j];
  }
  tm.sync();
  if (L.update == kEuler) {
    for (int i = r; i < nv; i += sz) qvel[i] = v0[i] + dt * qacc[i];
    for (int k = kUpShift; k <= kUpSolve; ++k) tm.stamp(k);
  } else {
    // the right side, then the update's matrix: M with its diagonal shifted
    T* rhs = ws + L.u_rhs;
    for (int i = r; i < nv; i += sz) {
      if (L.update == kImplicitFast) {
        rhs[i] = qfrc[i];
      } else {  // M v + h qfrc
        T mv = M[i * ldm] * v0[0];
        for (int j = 1; j < nv; ++j) mv += M[i * ldm + j] * v0[j];
        rhs[i] = mv + dt * qfrc[i];
      }
    }
    tm.sync();
    for (int i = r; i < nv; i += sz) {
      const T shift =
          L.update == kImplicitFast
              ? -(dt * (cst[L.c_vel_deriv + i] - cst[L.c_damping + i]))
              : dt * cst[L.c_damping + i];
      M[i * ldm + i] = M[i * ldm + i] + shift;
    }
    tm.sync();
    tm.stamp(kUpShift);
    arrow_factor_solve(tm, L, M, ldm, rhs, ws + L.u_A, ws + L.u_Ld,
                       ws + L.u_W, ws + L.u_Ls, ws + L.u_y, ws + L.u_x,
                       kUpFactor);
    tm.stamp(kUpSolve);
    const T* x = ws + L.u_x;
    for (int i = r; i < nv; i += sz)
      qvel[i] = L.update == kImplicitFast ? v0[i] + dt * x[i] : x[i];
  }
  // mj_integratePos, one joint per member
  for (int i = r; i < nq; i += sz) qpos[i] = q0[i];
  tm.sync();
  for (int j = r; j < L.njnt; j += sz) {
    const int qa = tp[L.t_qadr + j], d = tp[L.t_dadr + j];
    if (tp[L.t_jtype + j] == kFree) {
      for (int k = 0; k < 3; ++k) qpos[qa + k] = q0[qa + k] + dt * qvel[d + k];
      quat_integrate(q0 + qa + 3, qvel + d + 3, dt, qpos + qa + 3);
    } else {
      qpos[qa] = q0[qa] + dt * qvel[d];
    }
  }
  tm.sync();
  tm.stamp(kUpPos);
  // mj_checkPos / mj_checkVel: each member tests its values, one vote
  bool bad = false;
  for (int i = r; i < nq; i += sz) bad = bad || !(fabs(qpos[i]) < T(1e10));
  for (int i = r; i < nv; i += sz) bad = bad || !(fabs(qvel[i]) < T(1e10));
  bad = tm.any(bad);
  for (int i = r; i < nq; i += sz)
    a.qpos_out[static_cast<long long>(n) * nq + i] =
        bad ? cst[L.c_qpos0 + i] : qpos[i];
  for (int i = r; i < nv; i += sz) {
    a.qvel_out[ov + i] = bad ? T(0) : qvel[i];
    a.qacc_warmstart[ov + i] = bad ? T(0) : qacc[i];
  }
  tm.stamp(kUpReset);
}

}  // namespace smooth_env
