// One env's Newton/elliptic constraint solve, written once for the CUDA
// kernel (csrc/newton.cu, one warp per env) and for the host driver
// (csrc/newton_host.cpp, one thread, the envs in series), which the CPU
// tests hold against the JAX package.
//
// What it computes is nightmare_rl_tpu/physics/newton.py::solve (:214-340)
// for one env, rule for rule: the warmstart choice by total cost, then
// `iterations` Newton steps, each with the zone-aware Hessian, its
// Cholesky factor, p = -H^-1 grad and the bracketed line search (12 grid
// candidates, `ls_refine` guarded Newton/bisection refinements, the final
// choices), with no early exit.  The plain PyTorch version of the same
// function is nightmare_rl_tpu_torch/physics/newton.py::solve.
//
// The work is shared by a Team: `rank()` and `size()` split the loops,
// `sum()` reduces a partial sum over the team and leaves the same value in
// every member, `sync()` orders the members' shared-memory writes before
// the reads that follow.  The kernel's team is a warp (xor-shuffle
// butterfly, __syncwarp); the host driver's is one thread.  Every value
// that decides a branch (the line search's scalars) comes out of `sum()`,
// so all members of a team take the same branches.
//
// The rows are read in efc order.  Work items are the rows outside the
// cones (a static list) and the contacts of the cones, each contact a
// static (first row, condim, offset of its mus); per env the contact's mu,
// activity and physical friction per direction mus_i, with
// s_i = mus_i / max(mu, 1e-12) formed once per solve.  The Hessian is
//     H = M + sum_r wgt_r J_r J_r^T + sum_{middle-zone contacts}
//             (c2 u u^T - c2 gap mu/T v v^T)
// with the diagonal curvature wgt (D on active one-sided and quadratic
// friction rows and on bottom-zone contact rows, c2 gap mu/T s_i^2 on a
// middle-zone contact's friction rows) and, per middle-zone contact,
//     v = sum_i s_i what_i J_{c,i},   u = Jc^T (-1, mus_i what_i)
//                                       = mu_c v - J_{c,0}:
// the JAX package's Jc^T B Jc with B = c2 dg dg^T + c2 gap mu/T
// S (I - what what^T) S written out, its rank-one terms added one contact
// at a time.  The sums run in another order than the plain version's, and
// w_i = jar_i s_i and the divisions by T are products with s_i and 1/T:
// round-off only.
//
// NaN semantics follow torch's: comparisons with NaN are false, maximum,
// minimum and clamp_min propagate NaN, and a Hessian with a pivot that is
// not positive gives a NaN step for the whole env (ops/linalg.py::chol),
// which the null step alpha = 0 then carries into x (x + 0 * NaN).

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define NEWTON_HD __host__ __device__ __forceinline__
#define NEWTON_UNROLL _Pragma("unroll")
#else
#define NEWTON_HD inline
#define NEWTON_UNROLL
#endif

namespace newton_env {

constexpr int kMaxDim = 6;   // largest condim of a cone contact
constexpr int kGrid = 12;    // line-search candidates: 7 fractions, 5 multiples

NEWTON_HD float nsqrt(float x) { return sqrtf(x); }
NEWTON_HD double nsqrt(double x) { return sqrt(x); }
NEWTON_HD float nabs(float x) { return fabsf(x); }
NEWTON_HD double nabs(double x) { return fabs(x); }

template <typename T>
NEWTON_HD T nan_of() {
  return T(NAN);
}

// torch.maximum / torch.minimum: NaN if either operand is NaN
template <typename T>
NEWTON_HD T tmax(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
NEWTON_HD T tmin(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
// torch.clamp_min: NaN stays NaN
template <typename T>
NEWTON_HD T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}
// torch.sign: 0 for 0 and for NaN
template <typename T>
NEWTON_HD T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
NEWTON_HD T tiny() {
  return T(1e-12);
}

// ---------------------------------------------------------------------------
// the inputs of a batch, as the kernel and the host driver receive them
// ---------------------------------------------------------------------------

template <typename T>
struct Args {
  const T* J;                  // (N, nefc, nv)
  const T* aref;               // (N, nefc)
  const T* R;                  // (N, nefc)
  const T* fl;                 // (N, nefc) frictionloss, > 0 on dof-friction rows
  const unsigned char* quad;   // (N, nefc) activity of one-sided rows
  const T* mu;                 // (N, nc) regularized cone coefficient
  const unsigned char* act;    // (N, nc) contact activity
  const T* mus;                // (N, nmus) physical friction per direction
  const T* M;                  // (N, nv, nv)
  const T* a0;                 // (N, nv) qacc_smooth
  const T* x0;                 // (N, nv) warmstart, or null
  T* force;                    // (N, nefc)
  T* qfrc;                     // (N, nv)
  T* qacc;                     // (N, nv)
  // static: [rows outside the cones (nplain) | first row (nc) | condim (nc)
  //          | offset into mus (nc)]
  const int* desc;
  int N, nefc, nv, nc, nplain, nmus, iterations, ls_refine;
};

// Elements of T that one env's workspace takes (a multiple of 4, so that
// consecutive envs start 16-byte aligned in either precision).
NEWTON_HD int env_elems(int nefc, int nv, int nc, int nmus) {
  const int e = nefc * nv              // J
                + 2 * nv * nv          // M, H (factored in place)
                + 9 * nefc             // aref R D fl quad jar Jp f wgt
                + 6 * nc               // mu act c2 muc cu cv
                + 2 * nmus             // s, sw
                + 8 * nv;              // x a0 Mdx vec y Ld ub vb
  return (e + 3) & ~3;
}

// One env's workspace (shared memory in the kernel, the heap on the host).
template <typename T>
struct Env {
  int nefc, nv, nc, nplain;
  const int* plain;
  const int* cstart;
  const int* cdim;
  const int* cmus;
  const T* mus;                        // global: (nmus) of this env
  T *J, *M, *H, *aref, *R, *D, *fl, *quad, *jar, *Jp, *f, *wgt;
  T *mu, *act, *c2, *muc, *cu, *cv;    // per contact; cu = c2, cv = c2 gap
                                       // mu / T where middle-zone, else 0
  T *s, *sw;                           // per friction direction: s_i, and
                                       // s_i what_i where middle-zone
  T *x, *a0, *Mdx, *vec, *y, *Ld, *ub, *vb;

  NEWTON_HD Env(const Args<T>& a, int n, T* w)
      : nefc(a.nefc), nv(a.nv), nc(a.nc), nplain(a.nplain), plain(a.desc),
        cstart(a.desc + a.nplain), cdim(a.desc + a.nplain + a.nc),
        cmus(a.desc + a.nplain + 2 * a.nc),
        mus(a.mus + static_cast<long long>(n) * a.nmus) {
    J = w;         w += nefc * nv;
    M = w;         w += nv * nv;
    H = w;         w += nv * nv;
    aref = w;      w += nefc;
    R = w;         w += nefc;
    D = w;         w += nefc;
    fl = w;        w += nefc;
    quad = w;      w += nefc;
    jar = w;       w += nefc;
    Jp = w;        w += nefc;
    f = w;         w += nefc;
    wgt = w;       w += nefc;
    mu = w;        w += nc;
    act = w;       w += nc;
    c2 = w;        w += nc;
    muc = w;       w += nc;
    cu = w;        w += nc;
    cv = w;        w += nc;
    s = w;         w += a.nmus;
    sw = w;        w += a.nmus;
    x = w;         w += nv;
    a0 = w;        w += nv;
    Mdx = w;       w += nv;
    vec = w;       w += nv;
    y = w;         w += nv;
    Ld = w;        w += nv;
    ub = w;        w += nv;
    vb = w;
  }
};

// ---------------------------------------------------------------------------
// sums over the rows, in four interleaved partial sums (a sequential sum of
// nefc float32 terms loses ~nefc/4 times more than this)
// ---------------------------------------------------------------------------

// sum_r J[r][i] w[r] over n rows of J (nv columns)
template <typename T>
NEWTON_HD T col_dot(const T* J, int nv, int i, const T* w, int n) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int r = 0;
  for (; r + 3 < n; r += 4) {
    s0 += J[r * nv + i] * w[r];
    s1 += J[(r + 1) * nv + i] * w[r + 1];
    s2 += J[(r + 2) * nv + i] * w[r + 2];
    s3 += J[(r + 3) * nv + i] * w[r + 3];
  }
  for (; r < n; ++r) s0 += J[r * nv + i] * w[r];
  return (s0 + s1) + (s2 + s3);
}

// sum_r w[r] J[r][i] J[r][j] over n rows of J (nv columns)
template <typename T>
NEWTON_HD T col_dot2(const T* J, int nv, int i, int j, const T* w, int n) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int r = 0;
  for (; r + 3 < n; r += 4) {
    s0 += w[r] * J[r * nv + i] * J[r * nv + j];
    s1 += w[r + 1] * J[(r + 1) * nv + i] * J[(r + 1) * nv + j];
    s2 += w[r + 2] * J[(r + 2) * nv + i] * J[(r + 2) * nv + j];
    s3 += w[r + 3] * J[(r + 3) * nv + i] * J[(r + 3) * nv + j];
  }
  for (; r < n; ++r) s0 += w[r] * J[r * nv + i] * J[r * nv + j];
  return (s0 + s1) + (s2 + s3);
}

// ---------------------------------------------------------------------------
// the rows outside the cones
// ---------------------------------------------------------------------------

// Force and diagonal curvature of one row (one-sided or dof friction) at jr.
template <typename T>
NEWTON_HD void row_force(T jr, T D, T fl, bool qa, T& f, T& diag) {
  const bool is_fl = fl > T(0);
  const bool fl_mid = is_fl && (nabs(jr) * D <= fl);
  const bool quad = (qa && jr < T(0)) || fl_mid;
  f = quad ? (-D) * jr : T(0);
  if (is_fl && !fl_mid) f = -sgn(jr) * fl;
  diag = quad ? D : T(0);
}

// Its cost s(jr): quadratic where active, the linear continuation where a
// friction row saturates.
template <typename T>
NEWTON_HD T row_cost(T jr, T D, T R, T fl, bool qa) {
  const bool is_fl = fl > T(0);
  const bool fl_mid = is_fl && (nabs(jr) * D <= fl);
  T s = ((qa && jr < T(0)) || fl_mid) ? T(0.5) * D * jr * jr : T(0);
  if (is_fl && !fl_mid) s = fl * nabs(jr) - T(0.5) * fl * fl * R;
  return s;
}

// ---------------------------------------------------------------------------
// an elliptic contact: zones in the scaled coordinates u0 = jar_0,
// w_i = jar_i s_i, T = |w|
// ---------------------------------------------------------------------------

template <typename T>
struct Zone {
  T w[kMaxDim - 1];
  T inv_ts;  // 1 / max(T, 1e-12)
  T gap;     // mu T - u0
  bool bottom, mid;
};

template <typename T>
NEWTON_HD Zone<T> zone(const T* jc, int d, T mu, bool act, const T* s) {
  Zone<T> z;
  T ss = T(0);
  NEWTON_UNROLL
  for (int i = 0; i < kMaxDim - 1; ++i) {
    z.w[i] = T(0);
    if (i < d - 1) {
      z.w[i] = jc[i + 1] * s[i];
      ss += z.w[i] * z.w[i];
    }
  }
  const T t = nsqrt(ss);
  z.inv_ts = T(1) / clamp_min(t, tiny<T>());
  const T muT = mu * t;
  const T u0 = jc[0];
  z.bottom = act && (mu * (-u0) >= t);
  const bool top = !act || (u0 >= muT);
  z.mid = act && !z.bottom && !top;
  z.gap = muT - u0;
  return z;
}

// The contact's force on row a of its d rows.
template <typename T>
NEWTON_HD T cone_force(const Zone<T>& z, int a, T jca, T Da, T c2, T musa) {
  if (z.bottom) return (-Da) * jca;
  if (!z.mid) return T(0);
  const T f0 = c2 * z.gap;
  return a == 0 ? f0 : (-f0) * musa * z.w[a - 1] * z.inv_ts;
}

// ---------------------------------------------------------------------------
// the line search's phi'(alpha) and phi''(alpha) for K step lengths at once
// ---------------------------------------------------------------------------

template <int K, typename T, typename Team>
NEWTON_HD void phi(const Team& tm, const Env<T>& e, const T (&al)[K], T gMp,
                   T pMp, T (&d1)[K], T (&d2)[K]) {
  T dot[K], cv[K];
  NEWTON_UNROLL
  for (int k = 0; k < K; ++k) dot[k] = cv[k] = T(0);
  const int items = e.nplain + e.nc;
  for (int t = tm.rank(); t < items; t += tm.size()) {
    if (t < e.nplain) {
      const int r = e.plain[t];
      const T jar = e.jar[r], jp = e.Jp[r], D = e.D[r], fl = e.fl[r];
      const bool qa = e.quad[r] != T(0);
      NEWTON_UNROLL
      for (int k = 0; k < K; ++k) {
        T f, diag;
        row_force(jar + al[k] * jp, D, fl, qa, f, diag);
        dot[k] += jp * f;
        cv[k] += diag * jp * jp;
      }
    } else {
      const int c = t - e.nplain, st = e.cstart[c], d = e.cdim[c];
      const int m = e.cmus[c];
      const T mu = e.mu[c], c2 = e.c2[c];
      const bool act = e.act[c] != T(0);
      // per row of the contact; mus_a, s_a on its friction rows (a >= 1)
      T jar[kMaxDim], jp[kMaxDim], D[kMaxDim], mus[kMaxDim], s[kMaxDim];
      NEWTON_UNROLL
      for (int a = 0; a < kMaxDim; ++a) {
        jar[a] = jp[a] = D[a] = mus[a] = s[a] = T(0);
        if (a < d) {
          jar[a] = e.jar[st + a];
          jp[a] = e.Jp[st + a];
          D[a] = e.D[st + a];
          if (a > 0) {
            mus[a] = e.mus[m + a - 1];
            s[a] = e.s[m + a - 1];
          }
        }
      }
      NEWTON_UNROLL
      for (int k = 0; k < K; ++k) {
        T jc[kMaxDim];
        NEWTON_UNROLL
        for (int a = 0; a < kMaxDim; ++a) jc[a] = jar[a] + al[k] * jp[a];
        const Zone<T> z = zone(jc, d, mu, act, s + 1);
        T fdot = T(0);
        NEWTON_UNROLL
        for (int a = 0; a < kMaxDim; ++a)
          if (a < d) fdot += jp[a] * cone_force(z, a, jc[a], D[a], c2, mus[a]);
        dot[k] += fdot;
        if (z.bottom) {
          T b = T(0);
          NEWTON_UNROLL
          for (int a = 0; a < kMaxDim; ++a)
            if (a < d) b += D[a] * jp[a] * jp[a];
          cv[k] += b;
        } else if (z.mid) {
          // c2 (dg.h)^2 + c2 gap mu / T (|S h|^2 - (what . S h)^2)
          T dgh = -jp[0], shsh = T(0), wsh = T(0);
          NEWTON_UNROLL
          for (int i = 1; i < kMaxDim; ++i) {
            if (i < d) {
              const T what = z.w[i - 1] * z.inv_ts;
              dgh += mus[i] * what * jp[i];
              const T sh = s[i] * jp[i];
              shsh += sh * sh;
              wsh += what * sh;
            }
          }
          const T perp = shsh - wsh * wsh;
          cv[k] += c2 * (dgh * dgh) + c2 * z.gap * mu * z.inv_ts * perp;
        }
      }
    }
  }
  NEWTON_UNROLL
  for (int k = 0; k < K; ++k) {
    d1[k] = gMp + al[k] * pMp - tm.sum(dot[k]);
    d2[k] = pMp + tm.sum(cv[k]);
  }
}

// ---------------------------------------------------------------------------
// the pieces of a step
// ---------------------------------------------------------------------------

// e.jar = J xv - aref, rows over the team.
template <typename T, typename Team>
NEWTON_HD void residual(const Team& tm, const Env<T>& e, const T* xv) {
  for (int r = tm.rank(); r < e.nefc; r += tm.size()) {
    const T* Jr = e.J + r * e.nv;
    T acc = T(0);
    for (int v = 0; v < e.nv; ++v) acc += Jr[v] * xv[v];
    e.jar[r] = acc - e.aref[r];
  }
}

// Sum of the constraint costs at e.jar (the same value in every member).
template <typename T, typename Team>
NEWTON_HD T constraint_cost(const Team& tm, const Env<T>& e) {
  T acc = T(0);
  const int items = e.nplain + e.nc;
  for (int t = tm.rank(); t < items; t += tm.size()) {
    if (t < e.nplain) {
      const int r = e.plain[t];
      acc += row_cost(e.jar[r], e.D[r], e.R[r], e.fl[r], e.quad[r] != T(0));
    } else {
      const int c = t - e.nplain, st = e.cstart[c], d = e.cdim[c];
      T jc[kMaxDim];
      NEWTON_UNROLL
      for (int a = 0; a < kMaxDim; ++a) jc[a] = a < d ? e.jar[st + a] : T(0);
      const Zone<T> z = zone(jc, d, e.mu[c], e.act[c] != T(0),
                             e.s + e.cmus[c]);
      if (z.bottom) {
        T b = T(0);
        NEWTON_UNROLL
        for (int a = 0; a < kMaxDim; ++a)
          if (a < d) b += e.D[st + a] * jc[a] * jc[a];
        acc += T(0.5) * b;
      } else if (z.mid) {
        acc += T(0.5) * e.c2[c] * z.gap * z.gap;
      }
    }
  }
  return tm.sum(acc);
}

// 0.5 dx^T M dx with dx = xv - a0 (the same value in every member).
template <typename T, typename Team>
NEWTON_HD T quad_cost(const Team& tm, const Env<T>& e, const T* xv) {
  T acc = T(0);
  for (int i = tm.rank(); i < e.nv; i += tm.size()) {
    const T* Mi = e.M + i * e.nv;
    T mdx = T(0);
    for (int v = 0; v < e.nv; ++v) mdx += Mi[v] * (xv[v] - e.a0[v]);
    acc += (xv[i] - e.a0[i]) * mdx;
  }
  return T(0.5) * tm.sum(acc);
}

// Forces at e.jar into e.f, the rows' diagonal curvature into e.wgt and
// each contact's middle-zone terms into cu, cv and sw; items over the team.
template <typename T, typename Team>
NEWTON_HD void forces_and_curvature(const Team& tm, const Env<T>& e) {
  const int items = e.nplain + e.nc;
  for (int t = tm.rank(); t < items; t += tm.size()) {
    if (t < e.nplain) {
      const int r = e.plain[t];
      T f, diag;
      row_force(e.jar[r], e.D[r], e.fl[r], e.quad[r] != T(0), f, diag);
      e.f[r] = f;
      e.wgt[r] = diag;
      continue;
    }
    const int c = t - e.nplain, st = e.cstart[c], d = e.cdim[c];
    const int m = e.cmus[c];
    const T mu = e.mu[c], c2 = e.c2[c];
    T jc[kMaxDim];
    NEWTON_UNROLL
    for (int a = 0; a < kMaxDim; ++a) jc[a] = a < d ? e.jar[st + a] : T(0);
    const Zone<T> z = zone(jc, d, mu, e.act[c] != T(0), e.s + m);
    const T coef = z.mid ? c2 * z.gap * mu * z.inv_ts : T(0);
    for (int a = 0; a < d; ++a) {
      const T musa = a > 0 ? e.mus[m + a - 1] : T(0);
      const T sa = a > 0 ? e.s[m + a - 1] : T(0);
      e.f[st + a] = cone_force(z, a, jc[a], e.D[st + a], c2, musa);
      e.wgt[st + a] = z.bottom ? e.D[st + a]
                               : (z.mid && a > 0 ? coef * sa * sa : T(0));
      if (a > 0) e.sw[m + a - 1] = z.mid ? sa * z.w[a - 1] * z.inv_ts : T(0);
    }
    e.cu[c] = z.mid ? c2 : T(0);
    e.cv[c] = coef;
  }
}

// The next lower-triangle entry (i, j) of H that this member owns.
template <typename Team>
NEWTON_HD void next_entry(const Team& tm, int& i, int& j) {
  j += tm.size();
  while (j > i) {
    j -= i + 1;
    ++i;
  }
}

// Lower triangle of H = M + sum_r wgt_r J_r J_r^T + the middle-zone
// contacts' c2 u u^T - c2 gap mu/T v v^T, entries over the team.
template <typename T, typename Team>
NEWTON_HD void hessian(const Team& tm, const Env<T>& e) {
  const int nv = e.nv, ntri = nv * (nv + 1) / 2;
  {
    int i = 0, j = tm.rank() - tm.size();
    next_entry(tm, i, j);
    for (int t = tm.rank(); t < ntri; t += tm.size()) {
      e.H[i * nv + j] = e.M[i * nv + j] + col_dot2(e.J, nv, i, j, e.wgt, e.nefc);
      next_entry(tm, i, j);
    }
  }
  for (int c = 0; c < e.nc; ++c) {
    const T cu = e.cu[c], cv = e.cv[c];
    if (!(cu != T(0) || cv != T(0))) continue;   // not in the middle zone
    const int st = e.cstart[c], d = e.cdim[c], m = e.cmus[c];
    const T muc = e.muc[c];
    tm.sync();   // the previous contact's u and v are read
    for (int q = tm.rank(); q < nv; q += tm.size()) {
      T v = T(0);
      for (int a = 1; a < d; ++a) v += e.sw[m + a - 1] * e.J[(st + a) * nv + q];
      e.vb[q] = v;
      e.ub[q] = muc * v - e.J[st * nv + q];
    }
    tm.sync();
    int i = 0, j = tm.rank() - tm.size();
    next_entry(tm, i, j);
    for (int t = tm.rank(); t < ntri; t += tm.size()) {
      e.H[i * nv + j] += cu * e.ub[i] * e.ub[j] - cv * e.vb[i] * e.vb[j];
      next_entry(tm, i, j);
    }
  }
}

// Cholesky factor of H in place (lower, the diagonal in e.Ld), then
// e.vec = -H^-1 e.vec.  Where a pivot is not positive, every entry of the
// step is NaN.
template <typename T, typename Team>
NEWTON_HD void newton_step(const Team& tm, const Env<T>& e) {
  const int nv = e.nv;
  bool bad = false;
  for (int j = 0; j < nv; ++j) {
    const T d = e.H[j * nv + j];
    bad = bad || !(d > T(0));
    const T ljj = nsqrt(d);
    if (tm.rank() == 0) e.Ld[j] = ljj;
    for (int i = j + 1 + tm.rank(); i < nv; i += tm.size())
      e.H[i * nv + j] = e.H[i * nv + j] / ljj;
    tm.sync();
    for (int i = j + 1 + tm.rank(); i < nv; i += tm.size()) {
      const T lij = e.H[i * nv + j];
      for (int k = j + 1; k <= i; ++k) e.H[i * nv + k] -= lij * e.H[k * nv + j];
    }
    tm.sync();
  }
  // L y = grad (column by column: vec holds what is left of grad)
  for (int j = 0; j < nv; ++j) {
    const T yj = e.vec[j] / e.Ld[j];
    if (tm.rank() == 0) e.y[j] = yj;
    for (int i = j + 1 + tm.rank(); i < nv; i += tm.size())
      e.vec[i] -= e.H[i * nv + j] * yj;
    tm.sync();
  }
  // L^T z = y, p = -z
  for (int j = nv - 1; j >= 0; --j) {
    const T zj = e.y[j] / e.Ld[j];
    if (tm.rank() == 0) e.vec[j] = bad ? nan_of<T>() : -zj;
    for (int i = tm.rank(); i < j; i += tm.size())
      e.y[i] -= e.H[j * nv + i] * zj;
    tm.sync();
  }
}

// ---------------------------------------------------------------------------
// the whole solve of env n, the team sharing `work` (env_elems elements)
// ---------------------------------------------------------------------------

template <typename T, typename Team>
NEWTON_HD void solve_one(const Team& tm, const Args<T>& a, int n, T* work) {
  const Env<T> e(a, n, work);
  const int nefc = a.nefc, nv = a.nv, nc = a.nc;
  const long long en = n;
  {
    const T* J = a.J + en * nefc * nv;
    for (int q = tm.rank(); q < nefc * nv; q += tm.size()) e.J[q] = J[q];
    const T* M = a.M + en * nv * nv;
    for (int q = tm.rank(); q < nv * nv; q += tm.size()) e.M[q] = M[q];
    for (int r = tm.rank(); r < nefc; r += tm.size()) {
      const long long g = en * nefc + r;
      e.aref[r] = a.aref[g];
      e.R[r] = a.R[g];
      e.D[r] = T(1) / a.R[g];
      e.fl[r] = a.fl[g];
      e.quad[r] = a.quad[g] ? T(1) : T(0);
    }
    for (int i = tm.rank(); i < nv; i += tm.size()) {
      e.a0[i] = a.a0[en * nv + i];
      e.x[i] = a.x0 ? a.x0[en * nv + i] : e.a0[i];
    }
    tm.sync();
    for (int c = tm.rank(); c < nc; c += tm.size()) {
      const T mu = a.mu[en * nc + c];
      const T muc = clamp_min(mu, tiny<T>());
      e.mu[c] = mu;
      e.act[c] = a.act[en * nc + c] ? T(1) : T(0);
      e.muc[c] = muc;
      e.c2[c] = e.D[e.cstart[c]] / (T(1) + mu * mu);
      for (int q = e.cmus[c]; q < e.cmus[c] + e.cdim[c] - 1; ++q)
        e.s[q] = e.mus[q] / muc;
    }
    tm.sync();
  }

  // the warmstart: whichever of x0 and qacc_smooth costs less
  if (a.x0) {
    residual(tm, e, e.x);
    tm.sync();
    const T c_ws = quad_cost(tm, e, e.x) + constraint_cost(tm, e);
    tm.sync();
    residual(tm, e, e.a0);
    tm.sync();
    const T c_a0 = quad_cost(tm, e, e.a0) + constraint_cost(tm, e);
    tm.sync();
    if (!(c_ws < c_a0))
      for (int i = tm.rank(); i < nv; i += tm.size()) e.x[i] = e.a0[i];
    tm.sync();
  }

  const T fracs[7] = {T(1), T(0.5), T(0.25), T(0.125), T(1.0 / 16),
                      T(1.0 / 64), T(1.0 / 256)};
  const T mults[5] = {T(0.25), T(0.5), T(1), T(2), T(4)};
  for (int it = 0; it < a.iterations; ++it) {
    residual(tm, e, e.x);
    tm.sync();
    forces_and_curvature(tm, e);
    tm.sync();
    // Mdx = M (x - a0), grad = Mdx - J^T f
    for (int i = tm.rank(); i < nv; i += tm.size()) {
      T mdx = T(0);
      for (int v = 0; v < nv; ++v) mdx += e.M[i * nv + v] * (e.x[v] - e.a0[v]);
      e.Mdx[i] = mdx;
      e.vec[i] = mdx - col_dot(e.J, nv, i, e.f, nefc);
    }
    hessian(tm, e);
    tm.sync();
    newton_step(tm, e);   // e.vec = p

    // Jp, p^T M p, p^T M (x - a0)
    for (int r = tm.rank(); r < nefc; r += tm.size()) {
      T acc = T(0);
      for (int v = 0; v < nv; ++v) acc += e.J[r * nv + v] * e.vec[v];
      e.Jp[r] = acc;
    }
    T pmp = T(0), gmp = T(0);
    for (int i = tm.rank(); i < nv; i += tm.size()) {
      T mp = T(0);
      for (int v = 0; v < nv; ++v) mp += e.M[i * nv + v] * e.vec[v];
      pmp += e.vec[i] * mp;
      gmp += e.vec[i] * e.Mdx[i];
    }
    const T pMp = tm.sum(pmp), gMp = tm.sum(gmp);
    tm.sync();

    T d1_0[1], d2_0[1];
    const T zero[1] = {T(0)};
    phi<1>(tm, e, zero, gMp, pMp, d1_0, d2_0);
    // phi'(alpha) >= phi'(0) + alpha p^T M p, so the root lies in
    // [0, alpha_max]: a grid over the bracket and multiples of the
    // unguarded Newton estimate
    const T alpha_max = -d1_0[0] / clamp_min(pMp, tiny<T>());
    const T a1 = -d1_0[0] / clamp_min(d2_0[0], tiny<T>());
    T cand[kGrid], d1s[kGrid], d2s[kGrid];
    NEWTON_UNROLL
    for (int k = 0; k < kGrid; ++k) {
      const T c = k < 7 ? alpha_max * fracs[k < 7 ? k : 0]
                        : a1 * mults[k < 7 ? 0 : k - 7];
      cand[k] = tmin(clamp_min(c, T(0)), alpha_max);
    }
    phi<kGrid>(tm, e, cand, gMp, pMp, d1s, d2s);
    T lo = T(0), hi = T(0), best = T(0);
    int i_lo = 0;
    bool has_neg = false;
    NEWTON_UNROLL
    for (int k = 0; k < kGrid; ++k) {
      const bool neg = d1s[k] < T(0);
      const T l = neg ? cand[k] : T(0);
      const T h = neg ? alpha_max : cand[k];
      const T b = neg ? cand[k] : T(-1);
      lo = k == 0 ? l : tmax(lo, l);
      hi = k == 0 ? h : tmin(hi, h);
      // argmax: the first of the largest (NaN counts as the largest)
      if (k == 0 || (best == best && (b > best || b != b))) {
        best = b;
        i_lo = k;
      }
      has_neg = has_neg || neg;
    }
    T alpha = has_neg ? cand[i_lo] : T(0);
    T d1 = has_neg ? d1s[i_lo] : d1_0[0];
    T d2 = has_neg ? d2s[i_lo] : d2_0[0];
    for (int r = 0; r < a.ls_refine; ++r) {
      lo = d1 < T(0) ? tmax(lo, alpha) : lo;
      hi = d1 >= T(0) ? tmin(hi, alpha) : hi;
      const T a_newton = alpha - d1 / clamp_min(d2, tiny<T>());
      const bool inside = (a_newton > lo) && (a_newton < hi);
      alpha = inside ? a_newton : T(0.5) * (lo + hi);
      T al[1] = {alpha}, r1[1], r2[1];
      phi<1>(tm, e, al, gMp, pMp, r1, r2);
      d1 = r1[0];
      d2 = r2[0];
    }
    // the descent side of the bracket where phi'(final) > 0; a converged
    // iterate (phi'(0) >= 0) takes a null step
    alpha = d1 <= T(0) ? alpha : lo;
    alpha = d1_0[0] < T(0) ? alpha : T(0);
    for (int i = tm.rank(); i < nv; i += tm.size())
      e.x[i] = e.x[i] + alpha * e.vec[i];
    tm.sync();
  }

  // outputs: force in efc order, J^T f, qacc
  residual(tm, e, e.x);
  tm.sync();
  forces_and_curvature(tm, e);
  tm.sync();
  for (int r = tm.rank(); r < nefc; r += tm.size())
    a.force[en * nefc + r] = e.f[r];
  for (int i = tm.rank(); i < nv; i += tm.size()) {
    a.qfrc[en * nv + i] = col_dot(e.J, nv, i, e.f, nefc);
    a.qacc[en * nv + i] = e.x[i];
  }
}

}  // namespace newton_env
