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
//                   that follow.
// The kernels' team is a warp (__syncwarp); the host driver's a number of
// threads (a barrier).  Every item is computed by one member, each sum in
// one member in a fixed order, so the results do not depend on the team's
// size: the host driver at 1 and at 32 members and the kernel agree bit for
// bit where the compilers round alike.
//
// The tree is walked a depth at a time (a level schedule made by the
// wrapper, ops/smooth.py::_plan): the members take the bodies of one level,
// so the hexapod's six legs run side by side; bottom-up sums take the
// children of a body in descending index order, which is the order in which
// the plain version's loop over bodies adds them.  Every static table
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

// The Layout's fields, in order: sizes, then offsets into the int32
// topology table (t_*), into the float constants table (c_*), into kernel
// 1's per-env workspace (w_*) and into kernel 2's (u_*).  The wrapper reads
// the names from the library (smooth_layout_names) and fills the fields by
// name.
#define SMOOTH_LAYOUT(X)                                                      \
  X(nbody) X(njnt) X(nv) X(nq) X(nu) X(nlevel) X(nbranch) X(bsize) X(update)  \
  X(t_parent) X(t_jntadr) X(t_jntnum) X(t_root) X(t_level_start)              \
  X(t_level_body) X(t_child_start) X(t_child) X(t_jtype) X(t_qadr) X(t_dadr)  \
  X(t_jbody) X(t_dof_body) X(t_mask) X(t_act_dof) X(t_act_qadr)               \
  X(t_act_ctrllim) X(t_act_forcelim)                                          \
  X(c_body_pos) X(c_body_quat) X(c_body_ipos) X(c_body_iquat) X(c_mass)       \
  X(c_inertia) X(c_jnt_axis) X(c_jnt_pos) X(c_damping) X(c_armature)          \
  X(c_gravity) X(c_gear) X(c_gain) X(c_bias) X(c_ctrlrange) X(c_forcerange)   \
  X(c_qpos0) X(c_dt) X(c_vel_deriv)                                           \
  X(w_xpos) X(w_xquat) X(w_xipos) X(w_ximat) X(w_xanchor) X(w_xaxis)          \
  X(w_sub_mass) X(w_sub_mom) X(w_subtree_com) X(w_cinert) X(w_cdof)          \
  X(w_cvel) X(w_cdof_dot) X(w_F) X(w_M) X(w_cacc) X(w_cfrc)                  \
  X(w_force) X(w_qfrc_act) X(w_bias) X(w_qfrc) X(w_qpos) X(w_qvel) X(w_A)    \
  X(w_Ld) X(w_W) X(w_Ls) X(w_y) X(w_x) X(w_elems)                             \
  X(u_M) X(u_A) X(u_Ld) X(u_W) X(u_Ls) X(u_rhs) X(u_y) X(u_x) X(u_qpos)      \
  X(u_qvel) X(u_elems)

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

// ---- physics/arrow.py's small routines, one member each ----------------

// L = chol(A) by unrolled outer-product elimination (arrow.py::_chol): A
// (n x n, row stride lda) is overwritten by the downdates; the strictly
// upper part of L is the plain version's c * 0.
template <typename T>
SMOOTH_HD void chol(T* A, int lda, int n, T* L, int ldl) {
  for (int j = 0; j < n; ++j) {
    const T d = sqrt(A[j * lda + j]);
    for (int i = 0; i < n; ++i) {
      const T c = A[i * lda + j] / d;
      L[i * ldl + j] = i >= j ? c : c * T(0);
    }
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < n; ++k)
        A[i * lda + k] = A[i * lda + k] - L[i * ldl + j] * L[k * ldl + j];
  }
}

// X = L^-1 B in place (B: n x m, row stride ldb) (arrow.py::_solve_tril).
template <typename T>
SMOOTH_HD void solve_tril(const T* L, int ldl, int n, T* B, int ldb, int m) {
  for (int i = 0; i < n; ++i)
    for (int c = 0; c < m; ++c) {
      T acc = B[i * ldb + c];
      for (int k = 0; k < i; ++k) acc = acc - L[i * ldl + k] * B[k * ldb + c];
      B[i * ldb + c] = acc / L[i * ldl + i];
    }
}

// X = L^-T B in place (arrow.py::_solve_triu).
template <typename T>
SMOOTH_HD void solve_triu(const T* L, int ldl, int n, T* B, int ldb, int m) {
  for (int i = n - 1; i >= 0; --i)
    for (int c = 0; c < m; ++c) {
      T acc = B[i * ldb + c];
      for (int k = i + 1; k < n; ++k)
        acc = acc - L[k * ldl + i] * B[k * ldb + c];
      B[i * ldb + c] = acc / L[i * ldl + i];
    }
}

// The block-arrow factor of the nv x nv matrix M (workspace, row-major):
// Ld_b = chol(D_b) and W_b = Ld_b^-1 C_b per branch (one member each),
// then S = B6 - sum_b W_bᵀ W_b (one entry each) and Ls = chol(S) (one
// member).  A holds nbranch * s * s + 36 scratch elements.
template <typename T, typename Team>
SMOOTH_HD void arrow_factor(const Team& tm, const Layout& L, const T* M, T* A,
                            T* Ld, T* W, T* Ls) {
  const int nv = L.nv, B = L.nbranch, s = L.bsize;
  for (int b = tm.rank(); b < B; b += tm.size()) {
    T* Ab = A + b * s * s;
    T* Wb = W + b * s * kBase;
    const int r0 = kBase + b * s;
    for (int i = 0; i < s; ++i) {
      for (int k = 0; k < s; ++k) Ab[i * s + k] = M[(r0 + i) * nv + r0 + k];
      for (int k = 0; k < kBase; ++k) Wb[i * kBase + k] = M[(r0 + i) * nv + k];
    }
    chol(Ab, s, s, Ld + b * s * s, s);
    solve_tril(Ld + b * s * s, s, s, Wb, kBase, kBase);
  }
  tm.sync();
  T* S = A + B * s * s;
  for (int e = tm.rank(); e < kBase * kBase; e += tm.size()) {
    const int i = e / kBase, j = e % kBase;
    T acc = T(0);
    for (int r = 0; r < B * s; ++r) acc += W[r * kBase + i] * W[r * kBase + j];
    S[e] = M[i * nv + j] - acc;
  }
  tm.sync();
  if (tm.rank() == 0) chol(S, kBase, kBase, Ls, kBase);
  tm.sync();
}

// x = M^-1 rhs from the arrow factor (arrow.py::solve_vec); M gives the
// coupling C (rows kBase.., columns ..kBase); y holds nv - kBase elements.
template <typename T, typename Team>
SMOOTH_HD void arrow_solve(const Team& tm, const Layout& L, const T* M,
                           const T* Ld, const T* W, const T* Ls, const T* rhs,
                           T* y, T* x) {
  const int nv = L.nv, B = L.nbranch, s = L.bsize;
  for (int b = tm.rank(); b < B; b += tm.size()) {
    T* yb = y + b * s;
    for (int i = 0; i < s; ++i) yb[i] = rhs[kBase + b * s + i];
    solve_tril(Ld + b * s * s, s, s, yb, 1, 1);
    solve_triu(Ld + b * s * s, s, s, yb, 1, 1);
  }
  tm.sync();
  if (tm.rank() == 0) {
    for (int k = 0; k < kBase; ++k) {
      T acc = T(0);
      for (int r = 0; r < B * s; ++r) acc += M[(kBase + r) * nv + k] * y[r];
      x[k] = rhs[k] - acc;
    }
    solve_tril(Ls, kBase, kBase, x, 1, 1);
    solve_triu(Ls, kBase, kBase, x, 1, 1);
  }
  tm.sync();
  for (int b = tm.rank(); b < B; b += tm.size()) {
    T* xb = x + kBase + b * s;
    const T* Wb = W + b * s * kBase;
    for (int i = 0; i < s; ++i) {
      T acc = Wb[i * kBase] * x[0];
      for (int k = 1; k < kBase; ++k) acc += Wb[i * kBase + k] * x[k];
      xb[i] = acc;
    }
    solve_triu(Ld + b * s * s, s, s, xb, 1, 1);
    for (int i = 0; i < s; ++i) xb[i] = y[b * s + i] - xb[i];
  }
  tm.sync();
}

// ---- kernel 1: one env's smooth dynamics ---------------------------------

// Forward kinematics of body b from its parent's frame (kinematics.py:52).
template <typename T>
SMOOTH_HD void body_frame(const Layout& L, const int* tp, const T* cst,
                          const T* qpos, T* ws, int b) {
  const int p = tp[L.t_parent + b];
  T* xpos = ws + L.w_xpos;
  T* xquat = ws + L.w_xquat;
  T pos[3], qt[4], r[3], t[4];
  rotate(cst + L.c_body_pos + 3 * b, xquat + 4 * p, r);
  for (int k = 0; k < 3; ++k) pos[k] = xpos[3 * p + k] + r[k];
  mul(xquat + 4 * p, cst + L.c_body_quat + 4 * b, qt);
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
      T aw[3], dq[4];
      rotate(jpos, qt, r);
      for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + r[k];
      rotate(axis, qt, aw);
      from_axis_angle(axis, qpos[qa], dq);
      mul(qt, dq, t);
      for (int k = 0; k < 4; ++k) qt[k] = t[k];
      rotate(jpos, qt, r);
      for (int k = 0; k < 3; ++k) {
        pos[k] = anchor[k] - r[k];
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
  for (int k = 0; k < 3; ++k) xpos[3 * b + k] = pos[k];
  for (int k = 0; k < 4; ++k) xquat[4 * b + k] = qt[k];
}

// cvel[b] and the cdof_dot of b's dofs from the parent's cvel
// (kinematics.py::com_vel).
template <typename T>
SMOOTH_HD void body_vel(const Layout& L, const int* tp, const T* qvel, T* ws,
                        int b) {
  const T* cdof = ws + L.w_cdof;
  T* cdd = ws + L.w_cdof_dot;
  T v[6];
  for (int k = 0; k < 6; ++k) v[k] = ws[L.w_cvel + 6 * tp[L.t_parent + b] + k];
  const int j0 = tp[L.t_jntadr + b], j1 = j0 + tp[L.t_jntnum + b];
  for (int j = j0; j < j1; ++j) {
    const int d = tp[L.t_dadr + j];
    if (tp[L.t_jtype + j] == kFree) {
      for (int k = 0; k < 6; ++k)
        v[k] = v[k] + cdof[6 * d + k] * qvel[d] +
               cdof[6 * (d + 1) + k] * qvel[d + 1] +
               cdof[6 * (d + 2) + k] * qvel[d + 2];
      for (int i = 0; i < 3; ++i) {
        for (int k = 0; k < 6; ++k) cdd[6 * (d + i) + k] = T(0);
        motion_cross(v, cdof + 6 * (d + 3 + i), cdd + 6 * (d + 3 + i));
      }
      for (int k = 0; k < 6; ++k)
        v[k] = v[k] + cdof[6 * (d + 3) + k] * qvel[d + 3] +
               cdof[6 * (d + 4) + k] * qvel[d + 4] +
               cdof[6 * (d + 5) + k] * qvel[d + 5];
    } else {
      motion_cross(v, cdof + 6 * d, cdd + 6 * d);
      for (int k = 0; k < 6; ++k) v[k] = v[k] + cdof[6 * d + k] * qvel[d];
    }
  }
  for (int k = 0; k < 6; ++k) ws[L.w_cvel + 6 * b + k] = v[k];
}

// cacc[b] from the parent's (dynamics.py::rne_bias, forward pass).
template <typename T>
SMOOTH_HD void body_acc(const Layout& L, const int* tp, const T* qvel, T* ws,
                        int b) {
  const T* cdd = ws + L.w_cdof_dot;
  T a[6];
  for (int k = 0; k < 6; ++k) a[k] = ws[L.w_cacc + 6 * tp[L.t_parent + b] + k];
  const int j0 = tp[L.t_jntadr + b], j1 = j0 + tp[L.t_jntnum + b];
  for (int j = j0; j < j1; ++j) {
    const int d = tp[L.t_dadr + j];
    const int n = tp[L.t_jtype + j] == kFree ? 6 : 1;
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < 6; ++k)
        a[k] = a[k] + cdd[6 * (d + i) + k] * qvel[d + i];
  }
  for (int k = 0; k < 6; ++k) ws[L.w_cacc + 6 * b + k] = a[k];
}

// x[p] += x[c] for the children c of each body p of level `lvl`, in
// descending index order, `width` elements per body; with `skip_world`,
// the world body (0) receives nothing.
template <typename T, typename Team>
SMOOTH_HD void gather_children(const Team& tm, const Layout& L, const int* tp,
                               T* x, int width, int lvl) {
  const int i0 = tp[L.t_level_start + lvl], i1 = tp[L.t_level_start + lvl + 1];
  const int n = (i1 - i0) * width;
  for (int e = tm.rank(); e < n; e += tm.size()) {
    const int p = tp[L.t_level_body + i0 + e / width], k = e % width;
    const int c0 = tp[L.t_child_start + p], c1 = tp[L.t_child_start + p + 1];
    T acc = x[p * width + k];
    for (int c = c0; c < c1; ++c) acc = acc + x[tp[L.t_child + c] * width + k];
    x[p * width + k] = acc;
  }
}

// Output k's block of env n (len values per env) from the workspace at
// off, by consecutive members; called once the field is final, after a
// sync.
template <typename T, typename Team>
SMOOTH_HD void store(const Team& tm, const SmoothArgs<T>& a, int k, int n,
                     const T* src, int len) {
  T* dst = a.out[k] + static_cast<long long>(n) * len;
  for (int i = tm.rank(); i < len; i += tm.size()) dst[i] = src[i];
}

template <typename T, typename Team>
SMOOTH_HD void smooth_one(const Team& tm, const SmoothArgs<T>& a, int n,
                          T* ws) {
  const Layout& L = a.L;
  const int* tp = a.topo;
  const T* cst = a.cst;
  const int nb = L.nbody, nj = L.njnt, nv = L.nv, nu = L.nu, r = tm.rank(),
            sz = tm.size();
  T* qpos = ws + L.w_qpos;
  T* qvel = ws + L.w_qvel;
  for (int i = r; i < L.nq; i += sz) qpos[i] = a.qpos[n * L.nq + i];
  for (int i = r; i < nv; i += sz) qvel[i] = a.qvel[n * nv + i];
  if (r == 0) {  // the world body
    for (int k = 0; k < 3; ++k) ws[L.w_xpos + k] = T(0);
    ws[L.w_xquat] = T(1);
    for (int k = 1; k < 4; ++k) ws[L.w_xquat + k] = T(0);
  }
  tm.sync();

  // body frames, a level at a time
  for (int lvl = 1; lvl < L.nlevel; ++lvl) {
    const int i0 = tp[L.t_level_start + lvl], i1 = tp[L.t_level_start + lvl + 1];
    for (int i = i0 + r; i < i1; i += sz)
      body_frame(L, tp, cst, qpos, ws, tp[L.t_level_body + i]);
    tm.sync();
  }
  // inertial frames and the subtree moments' seeds
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
  // subtree masses and moments, bottom-up
  for (int lvl = L.nlevel - 2; lvl >= 0; --lvl) {
    gather_children(tm, L, tp, ws + L.w_sub_mass, 1, lvl);
    gather_children(tm, L, tp, ws + L.w_sub_mom, 3, lvl);
    tm.sync();
  }
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
    for (int k = 0; k < 6; ++k) ws[L.w_cvel + k] = T(0);
  tm.sync();
  store(tm, a, kCinert, n, ws + L.w_cinert, 36 * nb);
  store(tm, a, kCdof, n, ws + L.w_cdof, 6 * nv);

  // cvel and cdof_dot, then cacc, a level at a time
  for (int lvl = 1; lvl < L.nlevel; ++lvl) {
    const int i0 = tp[L.t_level_start + lvl], i1 = tp[L.t_level_start + lvl + 1];
    for (int i = i0 + r; i < i1; i += sz)
      body_vel(L, tp, qvel, ws, tp[L.t_level_body + i]);
    tm.sync();
  }
  if (r == 0)
    for (int k = 0; k < 6; ++k)
      ws[L.w_cacc + k] = k < 3 ? T(0) : -cst[L.c_gravity + k - 3];
  tm.sync();
  store(tm, a, kCvel, n, ws + L.w_cvel, 6 * nb);
  store(tm, a, kCdofDot, n, ws + L.w_cdof_dot, 6 * nv);
  for (int lvl = 1; lvl < L.nlevel; ++lvl) {
    const int i0 = tp[L.t_level_start + lvl], i1 = tp[L.t_level_start + lvl + 1];
    for (int i = i0 + r; i < i1; i += sz)
      body_acc(L, tp, qvel, ws, tp[L.t_level_body + i]);
    tm.sync();
  }
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
  // composite inertias and body forces, bottom-up (the roots give nothing
  // to the world); cinert, stored and read by the body forces, becomes the
  // composite inertia in place
  for (int lvl = L.nlevel - 2; lvl >= 1; --lvl) {
    gather_children(tm, L, tp, ws + L.w_cinert, 36, lvl);
    gather_children(tm, L, tp, ws + L.w_cfrc, 6, lvl);
    tm.sync();
  }
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
    T c = a.ctrl[n * nu + u];
    if (tp[L.t_act_ctrllim + u])
      c = clamp(c, cst[L.c_ctrlrange + 2 * u], cst[L.c_ctrlrange + 2 * u + 1]);
    const T* bp = cst + L.c_bias + 3 * u;
    T f = cst[L.c_gain + u] * c + bp[0] + bp[1] * length + bp[2] * velocity;
    if (tp[L.t_act_forcelim + u])
      f = clamp(f, cst[L.c_forcerange + 2 * u], cst[L.c_forcerange + 2 * u + 1]);
    ws[L.w_force + u] = f;
  }
  tm.sync();
  // M = tri + triᵀ - diag(tri) + diag(armature), tri = (cdof Fᵀ) * mask
  for (int e = r; e < nv * nv; e += sz) {
    const int i = e / nv, j = e % nv;
    const T tij = dot6(ws + L.w_cdof + 6 * i, ws + L.w_F + 6 * j) *
                  T(tp[L.t_mask + e]);
    const T tji = dot6(ws + L.w_cdof + 6 * j, ws + L.w_F + 6 * i) *
                  T(tp[L.t_mask + j * nv + i]);
    T m = tij + tji;
    m = m - (i == j ? tij : T(0));
    ws[L.w_M + e] = m + (i == j ? cst[L.c_armature + i] : T(0));
  }
  // qfrc_actuator = gearᵀ force (index_add in actuator order), qfrc_smooth
  for (int d = r; d < nv; d += sz) {
    T q = T(0);
    for (int u = 0; u < nu; ++u)
      if (tp[L.t_act_dof + u] == d) q = q + cst[L.c_gear + u] * ws[L.w_force + u];
    ws[L.w_qfrc_act + d] = q;
    const T passive = -cst[L.c_damping + d] * qvel[d];
    ws[L.w_qfrc + d] = q + passive - ws[L.w_bias + d];
  }
  tm.sync();
  store(tm, a, kM, n, ws + L.w_M, nv * nv);
  store(tm, a, kQfrcActuator, n, ws + L.w_qfrc_act, nv);
  store(tm, a, kActuatorForce, n, ws + L.w_force, nu);
  store(tm, a, kQfrcSmooth, n, ws + L.w_qfrc, nv);
  if (L.nbranch == 0) return;
  const int B = L.nbranch, s = L.bsize;
  arrow_factor(tm, L, ws + L.w_M, ws + L.w_A, ws + L.w_Ld, ws + L.w_W,
               ws + L.w_Ls);
  arrow_solve(tm, L, ws + L.w_M, ws + L.w_Ld, ws + L.w_W, ws + L.w_Ls,
              ws + L.w_qfrc, ws + L.w_y, ws + L.w_x);
  store(tm, a, kOutLd, n, ws + L.w_Ld, B * s * s);
  store(tm, a, kOutW, n, ws + L.w_W, B * s * kBase);
  store(tm, a, kOutLs, n, ws + L.w_Ls, kBase * kBase);
  store(tm, a, kQaccSmooth, n, ws + L.w_x, nv);
  // C: M's rows kBase.., columns ..kBase
  T* dst = a.out[kOutC] + static_cast<long long>(n) * B * s * kBase;
  for (int i = r; i < B * s * kBase; i += sz)
    dst[i] = ws[L.w_M + (kBase + i / kBase) * nv + i % kBase];
}

// ---- kernel 2: one env's integrator update -------------------------------

template <typename T, typename Team>
SMOOTH_HD void update_one(const Team& tm, const UpdateArgs<T>& a, int n,
                          T* ws) {
  const Layout& L = a.L;
  const int* tp = a.topo;
  const T* cst = a.cst;
  const int nv = L.nv, nq = L.nq, r = tm.rank(), sz = tm.size();
  const long long ov = static_cast<long long>(n) * nv;
  const T dt = cst[L.c_dt];
  T* qvel = ws + L.u_qvel;
  T* qpos = ws + L.u_qpos;
  if (L.update == kEuler) {
    for (int i = r; i < nv; i += sz)
      qvel[i] = a.qvel[ov + i] + dt * a.qacc[ov + i];
  } else {
    // the update's matrix: M with its diagonal shifted, and the right side
    T* M = ws + L.u_M;
    T* rhs = ws + L.u_rhs;
    const T* Mg = a.M + ov * nv;
    for (int e = r; e < nv * nv; e += sz) {
      const int i = e / nv, j = e % nv;
      T shift = T(0);
      if (i == j)
        shift = L.update == kImplicitFast
                    ? -(dt * (cst[L.c_vel_deriv + i] - cst[L.c_damping + i]))
                    : dt * cst[L.c_damping + i];
      M[e] = i == j ? Mg[e] + shift : Mg[e];
    }
    for (int i = r; i < nv; i += sz) {
      const T qfrc = a.qfrc_smooth[ov + i] + a.qfrc_constraint[ov + i];
      if (L.update == kImplicitFast) {
        rhs[i] = qfrc;
      } else {  // M v + h qfrc
        T mv = Mg[i * nv] * a.qvel[ov];
        for (int j = 1; j < nv; ++j) mv += Mg[i * nv + j] * a.qvel[ov + j];
        rhs[i] = mv + dt * qfrc;
      }
    }
    tm.sync();
    arrow_factor(tm, L, M, ws + L.u_A, ws + L.u_Ld, ws + L.u_W, ws + L.u_Ls);
    arrow_solve(tm, L, M, ws + L.u_Ld, ws + L.u_W, ws + L.u_Ls, rhs,
                ws + L.u_y, ws + L.u_x);
    const T* x = ws + L.u_x;
    for (int i = r; i < nv; i += sz)
      qvel[i] = L.update == kImplicitFast ? a.qvel[ov + i] + dt * x[i] : x[i];
  }
  tm.sync();
  // mj_integratePos, one joint per member
  const T* q0 = a.qpos + static_cast<long long>(n) * nq;
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
  // mj_checkPos / mj_checkVel: every member scans the env
  bool bad = false;
  for (int i = 0; i < nq; ++i) bad = bad || !(fabs(qpos[i]) < T(1e10));
  for (int i = 0; i < nv; ++i) bad = bad || !(fabs(qvel[i]) < T(1e10));
  for (int i = r; i < nq; i += sz)
    a.qpos_out[static_cast<long long>(n) * nq + i] =
        bad ? cst[L.c_qpos0 + i] : qpos[i];
  for (int i = r; i < nv; i += sz) {
    a.qvel_out[ov + i] = bad ? T(0) : qvel[i];
    a.qacc_warmstart[ov + i] = bad ? T(0) : a.qacc[ov + i];
  }
}

}  // namespace smooth_env
