// One env's Newton/elliptic constraint solve, written once for the CUDA
// kernel (csrc/newton.cu, one warp per env) and for the host driver
// (csrc/newton_host.cpp, a team of host threads), which the CPU tests hold
// against the JAX package.
//
// What it computes is nightmare_rl_tpu/physics/newton.py::solve (:214-340)
// for one env, rule for rule: the warmstart choice by total cost, then
// `iterations` Newton steps, each with the zone-aware Hessian, its
// Cholesky factor, p = -H^-1 grad and the bracketed line search (12 grid
// candidates, `ls_refine` guarded Newton/bisection refinements, the final
// choices), with no early exit.  The plain PyTorch version of the same
// function is nightmare_rl_tpu_torch/physics/newton.py::solve.
//
// The work is shared by a Team of size() members:
//   rank(), size()   member rank (0 <= rank < size) and the team's size; a
//                    member owns the items rank + k * size of a list, and
//                    row i of the factor belongs to member i % size, in its
//                    slot i / size (at most kRows slots, the loops over them
//                    unrolled, so a warp keeps them in registers);
//   sum(v)           the team's sum of v, the same value in every member;
//   sum_n(v[K])      K such sums at once (a warp interleaves them);
//   bcast(v, src)    member src's v, in every member;
//   prefix(p, total) the number of members before this one whose p is true,
//                    and in total the number of all whose p is true;
//   sync()           orders the members' workspace writes before the reads
//                    that follow;
//   stamp(k)         records timer stamp k (nothing outside a timeline
//                    build; a negative k is nothing).
// The kernel's team is a warp (shuffles, ballots, __syncwarp), kRows 1; the
// host driver's is a number of threads (a barrier, slots in memory), kRows
// kRegNv.  Every value that decides a branch (the lists' lengths, the line
// search's scalars) comes out of sum(), bcast() or prefix(), so all members
// take the same branches.
//
// The rows are read in efc order.  Work items are the rows outside the
// cones (a static list) and the contacts of the cones, each contact a
// static (first row, condim, offset of its mus); per env the contact's mu,
// activity and physical friction per direction mus_i, with
// s_i = mus_i / max(mu, 1e-12) formed once per solve.  An item whose force
// is 0 at every x (a one-sided row that is not active and no dof friction,
// an inactive contact) adds exactly 0 (or -0) to every sum below as long as
// its J is finite, so where all of J is finite the solve walks only the
// live items and their rows (lists built once per solve), and the Hessian
// only those with curvature (listed at every Newton step); where J is not
// finite every item is walked, so NaN and inf reach the same outputs as in
// the plain version.  The Hessian is
//     H = M + sum_r wgt_r J_r J_r^T + sum_{middle-zone contacts}
//             (c2 u u^T - c2 gap mu/T v v^T)
// with the diagonal curvature wgt (D on active one-sided and quadratic
// friction rows and on bottom-zone contact rows, c2 gap mu/T s_i^2 on a
// middle-zone contact's friction rows) and, per middle-zone contact,
//     v = sum_i s_i what_i J_{c,i},   u = Jc^T (-1, mus_i what_i)
//                                       = mu_c v - J_{c,0}:
// the JAX package's Jc^T B Jc with B = c2 dg dg^T + c2 gap mu/T
// S (I - what what^T) S written out.  Each member owns 3x3 tiles of H's
// lower triangle and forms them in one pass over the items with
// curvature, a contact's u and v on the tile's columns from the rows it
// has loaded.  The sums run
// in another order than the plain version's, and w_i = jar_i s_i and the
// divisions by T are products with s_i and 1/T: round-off only.
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
#define NEWTON_UNROLL6 _Pragma("unroll 6")   // loads of a loop over nv overlap
#else
#define NEWTON_HD inline
#define NEWTON_UNROLL
#define NEWTON_UNROLL6
#endif

namespace newton_env {

constexpr int kMaxDim = 6;   // largest condim of a cone contact
constexpr int kGrid = 12;    // line-search candidates: 7 fractions, 5 multiples
constexpr int kRegNv = 32;   // largest nv whose factor the members hold in
                             // their slots (above it: the workspace)
constexpr int kTile = 3;     // a member's tiles of H are kTile x kTile

// Timer stamps (Team::stamp; only a kernel built with -DNEWTON_TIMELINE
// records them): 0 the start, 1 the staging's end, 2 the warmstart's, then
// per Newton step (the first kStampSteps) the ends of its kStampsPerStep
// phases, and kStampEnd the outputs'.
constexpr int kStampSteps = 8, kStampsPerStep = 11, kStampStep0 = 3;
constexpr int kStampEnd = kStampStep0 + kStampSteps * kStampsPerStep;

NEWTON_HD float nsqrt(float x) { return sqrtf(x); }
NEWTON_HD double nsqrt(double x) { return sqrt(x); }
NEWTON_HD float nabs(float x) { return fabsf(x); }
NEWTON_HD double nabs(double x) { return fabs(x); }

template <typename T>
NEWTON_HD T nan_of() {
  return T(NAN);
}

template <typename T>
NEWTON_HD bool finite(T x) {
  return x - x == T(0);   // NaN - NaN and inf - inf are NaN
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
// consecutive envs start 16-byte aligned in either precision).  The int
// lists take one element of T per int (the live rows, the live items, those
// with curvature, and per contact its first row, condim and offset into
// mus).
NEWTON_HD int env_elems(int nefc, int nv, int nc, int nmus) {
  const int e = nefc * nv              // J
                + nv * nv              // H
                + 8 * nefc             // aref D fl quad jar Jp f wgt
                + 6 * nc               // mu act c2 muc cu cv
                + 3 * nmus             // mus, s, sw
                + 6 * nv               // x a0 Mdx vec y Ld
                + 3 * nefc + 3 * nc;   // rows items hitems | cst cdim cmus
  return (e + 3) & ~3;
}

// One env's workspace (shared memory in the kernel, the heap on the host),
// with M and R read where they lie (device memory, the caller's arrays).
template <typename T>
struct Env {
  int nefc, nv, nc, nplain;
  const T* Mg;                         // (nv, nv) of this env
  const T* Rg;                         // (nefc) of this env
  T *J, *H, *aref, *D, *fl, *quad, *jar, *Jp, *f, *wgt;
  T *mu, *act, *c2, *muc, *cu, *cv;    // per contact; cu = c2, cv = c2 gap
                                       // mu / T where middle-zone, else 0
  T *mus, *s, *sw;                     // per friction direction: mus_i, s_i,
                                       // and s_i what_i where middle-zone
  T *x, *a0, *Mdx, *vec, *y, *Ld;
  int *rows;    // the live rows, in efc order
  int *items;   // the live items: a row r < nefc outside the cones, or
                // nefc + c for contact c
  int *hitems;  // the live items with curvature (all live ones where J is
                // not finite), rebuilt at every Newton step
  int *cst, *cdim, *cmus;
  int nrows = 0, nitems = 0, nh = 0;
  bool skip = false;   // all of J is finite: rows of weight 0 may be skipped

  NEWTON_HD Env(const Args<T>& a, int n, T* w)
      : nefc(a.nefc), nv(a.nv), nc(a.nc), nplain(a.nplain),
        Mg(a.M + static_cast<long long>(n) * a.nv * a.nv),
        Rg(a.R + static_cast<long long>(n) * a.nefc) {
    J = w;         w += nefc * nv;
    H = w;         w += nv * nv;
    aref = w;      w += nefc;
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
    mus = w;       w += a.nmus;
    s = w;         w += a.nmus;
    sw = w;        w += a.nmus;
    x = w;         w += nv;
    a0 = w;        w += nv;
    Mdx = w;       w += nv;
    vec = w;       w += nv;
    y = w;         w += nv;
    Ld = w;        w += nv;
    rows = reinterpret_cast<int*>(w);
    items = rows + nefc;
    hitems = items + nefc;
    cst = hitems + nefc;
    cdim = cst + nc;
    cmus = cdim + nc;
  }
};

// ---------------------------------------------------------------------------
// sums over the live rows, in four interleaved partial sums (a sequential
// sum of nefc float32 terms loses ~nefc/4 times more than this)
// ---------------------------------------------------------------------------

// sum over the live rows r of J[r][i] w[r]
template <typename T>
NEWTON_HD T rows_dot(const Env<T>& e, int i, const T* w) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  const int n = e.nrows, nv = e.nv;
  int q = 0;
  for (; q + 3 < n; q += 4) {
    const int r0 = e.rows[q], r1 = e.rows[q + 1];
    const int r2 = e.rows[q + 2], r3 = e.rows[q + 3];
    s0 += e.J[r0 * nv + i] * w[r0];
    s1 += e.J[r1 * nv + i] * w[r1];
    s2 += e.J[r2 * nv + i] * w[r2];
    s3 += e.J[r3 * nv + i] * w[r3];
  }
  for (; q < n; ++q) {
    const int r = e.rows[q];
    s0 += e.J[r * nv + i] * w[r];
  }
  return (s0 + s1) + (s2 + s3);
}

// The indices t < n that satisfy pred, into out in order; returns their
// number (the same in every member).
template <typename Team, typename Pred>
NEWTON_HD int compact(const Team& tm, int n, const Pred& pred, int* out) {
  int base = 0;
  for (int t0 = 0; t0 < n; t0 += tm.size()) {
    const int t = t0 + tm.rank();
    const bool p = t < n && pred(t);
    int total = 0;
    const int before = tm.prefix(p, total);
    if (p) out[base + before] = t;
    base += total;
  }
  return base;
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

// The contact's force on row a of its d rows (both zones' values, then the
// zone picks: no branch per row).
template <typename T>
NEWTON_HD T cone_force(const Zone<T>& z, int a, T jca, T Da, T c2, T musa) {
  const T f0 = c2 * z.gap;
  const T fm = a == 0 ? f0 : (-f0) * musa * z.w[a - 1] * z.inv_ts;
  return z.bottom ? (-Da) * jca : (z.mid ? fm : T(0));
}

// ---------------------------------------------------------------------------
// the line search's phi'(alpha) and phi''(alpha) for K step lengths at once,
// over the live items
// ---------------------------------------------------------------------------


// One live item's data along the step (a member loads it once and may
// keep it for the refinements; D stays in the workspace): a row outside
// the cones has d = 0 and jar, jp, fl, one-sided activity in jar[0],
// jp[0], mus[0], s[0]; a contact its d rows from row st, mus_a and s_a on
// its friction rows (a >= 1).
template <typename T>
struct Item {
  T jar[kMaxDim], jp[kMaxDim], mus[kMaxDim], s[kMaxDim];
  T mu, c2;
  int st, d;
  bool act;
};

template <typename T>
NEWTON_HD Item<T> load_item(const Env<T>& e, int it) {
  Item<T> o;
  NEWTON_UNROLL
  for (int a = 0; a < kMaxDim; ++a)
    o.jar[a] = o.jp[a] = o.mus[a] = o.s[a] = T(0);
  o.mu = o.c2 = T(0);
  o.act = false;
  if (it < e.nefc) {
    o.st = it;
    o.d = 0;
    o.jar[0] = e.jar[it];
    o.jp[0] = e.Jp[it];
    o.mus[0] = e.fl[it];
    o.s[0] = e.quad[it];
    return o;
  }
  const int c = it - e.nefc, st = e.cst[c], d = e.cdim[c], m = e.cmus[c];
  o.st = st;
  o.d = d;
  o.mu = e.mu[c];
  o.c2 = e.c2[c];
  o.act = e.act[c] != T(0);
  NEWTON_UNROLL
  for (int a = 0; a < kMaxDim; ++a) {
    if (a < d) {
      o.jar[a] = e.jar[st + a];
      o.jp[a] = e.Jp[st + a];
      if (a > 0) {
        o.mus[a] = e.mus[m + a - 1];
        o.s[a] = e.s[m + a - 1];
      }
    }
  }
  return o;
}

// Its phi'(alpha) and phi''(alpha) terms at one step length:
// dot = Jp . f(jar + alpha Jp), cv = the curvature along Jp.
template <typename T>
NEWTON_HD void item_phi(const Env<T>& e, const Item<T>& o, T al, T& dot,
                        T& cv) {
  if (o.d == 0) {
    const T jp = o.jp[0];
    T f, diag;
    row_force(o.jar[0] + al * jp, e.D[o.st], o.mus[0], o.s[0] != T(0), f,
              diag);
    dot = jp * f;
    cv = diag * jp * jp;
    return;
  }
  const int d = o.d;
  const T mu = o.mu, c2 = o.c2;
  const T *jp = o.jp, *mus = o.mus, *s = o.s;
  T jc[kMaxDim], D[kMaxDim];
  NEWTON_UNROLL
  for (int a = 0; a < kMaxDim; ++a) {
    jc[a] = o.jar[a] + al * o.jp[a];
    D[a] = a < d ? e.D[o.st + a] : T(0);
  }
  const Zone<T> z = zone(jc, d, mu, o.act, s + 1);
  // both zones' curvature terms, then the contact's zone picks
  T fdot = T(0), cb = T(0);
  // c2 (dg.h)^2 + c2 gap mu / T (|S h|^2 - (what . S h)^2)
  T dgh = -jp[0], shsh = T(0), wsh = T(0);
  NEWTON_UNROLL
  for (int a = 0; a < kMaxDim; ++a) {
    if (a < d) {
      if (a > 0) {
        const T what = z.w[a - 1] * z.inv_ts;
        dgh += mus[a] * what * jp[a];
        const T sh = s[a] * jp[a];
        shsh += sh * sh;
        wsh += what * sh;
      }
      fdot += jp[a] * cone_force(z, a, jc[a], D[a], c2, mus[a]);
      cb += D[a] * jp[a] * jp[a];
    }
  }
  const T perp = shsh - wsh * wsh;
  const T cm = c2 * (dgh * dgh) + c2 * z.gap * mu * z.inv_ts * perp;
  dot = fdot;
  cv = z.bottom ? cb : (z.mid ? cm : T(0));
}

// The team's work is the (item, step length) pairs.  A team of K or more
// members gives each member one step length, r % K, and the items
// r / K + m (size / K) (the members past (size / K) K sit out), and where
// a step length's sums lie in fewer than 5 members they are gathered by
// bcast; a smaller team walks the pairs item-major.  With K = 1 a member may pass its first
// item, loaded already (`held`: item rank).
template <int K, typename T, typename Team>
NEWTON_HD void phi(const Team& tm, const Env<T>& e, const T (&al)[K], T gMp,
                   T pMp, T (&d1)[K], T (&d2)[K],
                   const Item<T>* held = nullptr) {
  T acc[2 * K];   // dot (K), then curvature (K)
  NEWTON_UNROLL
  for (int k = 0; k < 2 * K; ++k) acc[k] = T(0);
  const int sz = tm.size();
  if (sz >= K) {
    const int groups = sz / K, k = tm.rank() % K;
    T alk = al[0];
    NEWTON_UNROLL
    for (int kk = 1; kk < K; ++kk) alk = k == kk ? al[kk] : alk;
    T dot = T(0), cv = T(0);
    if (tm.rank() < groups * K) {
      int q = tm.rank() / K;
      if (held != nullptr && q < e.nitems) {   // K == 1: item q = rank
        item_phi(e, *held, alk, dot, cv);
        q += groups;
      }
      for (; q < e.nitems; q += groups) {
        T dq, cq;
        item_phi(e, load_item(e, e.items[q]), alk, dq, cq);
        dot += dq;
        cv += cq;
      }
    }
    if (groups < 5) {
      // a step length's sums lie in `groups` members: gather them by
      // bcast, the same order in every member, instead of 2K butterflies
      NEWTON_UNROLL
      for (int kk = 0; kk < K; ++kk) {
        T sd = T(0), sc = T(0);
        for (int g = 0; g < groups; ++g) {
          sd += tm.bcast(dot, kk + g * K);
          sc += tm.bcast(cv, kk + g * K);
        }
        d1[kk] = gMp + al[kk] * pMp - sd;
        d2[kk] = pMp + sc;
      }
      return;
    }
    NEWTON_UNROLL
    for (int kk = 0; kk < K; ++kk) {
      acc[kk] = k == kk ? dot : T(0);
      acc[K + kk] = k == kk ? cv : T(0);
    }
  } else {
    const int units = e.nitems * K;
    for (int u = tm.rank(); u < units; u += sz) {
      const int q = u / K, k = u - q * K;
      T alk = al[0];
      NEWTON_UNROLL
      for (int kk = 1; kk < K; ++kk) alk = k == kk ? al[kk] : alk;
      T dot, cv;
      item_phi(e, load_item(e, e.items[q]), alk, dot, cv);
      NEWTON_UNROLL
      for (int kk = 0; kk < K; ++kk) {
        if (k == kk) {
          acc[kk] += dot;
          acc[K + kk] += cv;
        }
      }
    }
  }
  tm.sum_n(acc);
  NEWTON_UNROLL
  for (int k = 0; k < K; ++k) {
    d1[k] = gMp + al[k] * pMp - acc[k];
    d2[k] = pMp + acc[K + k];
  }
}

// ---------------------------------------------------------------------------
// the pieces of a step
// ---------------------------------------------------------------------------

// e.jar = J xv - aref on the live rows, over the team.
template <typename T, typename Team>
NEWTON_HD void residual(const Team& tm, const Env<T>& e, const T* xv) {
  for (int q = tm.rank(); q < e.nrows; q += tm.size()) {
    const int r = e.rows[q];
    const T* Jr = e.J + r * e.nv;
    T acc = T(0);
    NEWTON_UNROLL6
    for (int v = 0; v < e.nv; ++v) acc += Jr[v] * xv[v];
    e.jar[r] = acc - e.aref[r];
  }
}

// Sum of the constraint costs at e.jar (the same value in every member).
template <typename T, typename Team>
NEWTON_HD T constraint_cost(const Team& tm, const Env<T>& e) {
  T acc = T(0);
  for (int q = tm.rank(); q < e.nitems; q += tm.size()) {
    const int it = e.items[q];
    if (it < e.nefc) {
      const int r = it;
      acc += row_cost(e.jar[r], e.D[r], e.Rg[r], e.fl[r], e.quad[r] != T(0));
    } else {
      const int c = it - e.nefc, st = e.cst[c], d = e.cdim[c];
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
    const T* Mi = e.Mg + i * e.nv;
    T mdx = T(0);
    NEWTON_UNROLL6
    for (int v = 0; v < e.nv; ++v) mdx += Mi[v] * (xv[v] - e.a0[v]);
    acc += (xv[i] - e.a0[i]) * mdx;
  }
  return T(0.5) * tm.sum(acc);
}

// Forces at e.jar into e.f, the rows' diagonal curvature into e.wgt and
// each contact's middle-zone terms into cu, cv and sw; live items over the
// team (the other rows keep f = wgt = 0 from the staging).  Returns the
// number of items with curvature, listed in e.hitems (the same in every
// member).
template <typename T, typename Team>
NEWTON_HD int forces_and_curvature(const Team& tm, const Env<T>& e) {
  int nh = 0;
  for (int t0 = 0; t0 < e.nitems; t0 += tm.size()) {
    const int q = t0 + tm.rank();
    bool curved = false;
    const int it = q < e.nitems ? e.items[q] : 0;
    if (q < e.nitems && it < e.nefc) {
      const int r = it;
      T f, diag;
      row_force(e.jar[r], e.D[r], e.fl[r], e.quad[r] != T(0), f, diag);
      e.f[r] = f;
      e.wgt[r] = diag;
      curved = diag != T(0);
    } else if (q < e.nitems) {
      const int c = it - e.nefc, st = e.cst[c], d = e.cdim[c];
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
      curved = z.bottom || z.mid;
    }
    const bool p = q < e.nitems && (curved || !e.skip);
    int total = 0;
    const int before = tm.prefix(p, total);
    if (p) e.hitems[nh + before] = it;
    nh += total;
  }
  return nh;
}

// The next entry (i, j), j <= i, of a lower triangle that this member owns.
template <typename Team>
NEWTON_HD void next_entry(const Team& tm, int& i, int& j) {
  j += tm.size();
  while (j > i) {
    j -= i + 1;
    ++i;
  }
}

// kTile entries of row r of J from column c0 (0 past nv).
template <typename T>
NEWTON_HD void tile_row(const Env<T>& e, int r, int c0, T (&out)[kTile]) {
  NEWTON_UNROLL
  for (int a = 0; a < kTile; ++a)
    out[a] = c0 + a < e.nv ? e.J[r * e.nv + c0 + a] : T(0);
}

// Lower triangle of H = M + sum_r wgt_r J_r J_r^T + the middle-zone
// contacts' c2 u u^T - c2 gap mu/T v v^T into e.H: each member forms its
// kTile x kTile tiles in registers in one pass over the items with
// curvature (e.hitems).
template <typename T, typename Team>
NEWTON_HD void hessian(const Team& tm, const Env<T>& e) {
  const int nv = e.nv, nb = (nv + kTile - 1) / kTile;
  const int ntiles = nb * (nb + 1) / 2;
  int bi = 0, bj = tm.rank() - tm.size();
  next_entry(tm, bi, bj);
  for (int t = tm.rank(); t < ntiles; t += tm.size()) {
    const int i0 = kTile * bi, j0 = kTile * bj;
    T acc[kTile][kTile];
    NEWTON_UNROLL
    for (int a = 0; a < kTile; ++a)
      NEWTON_UNROLL
      for (int b = 0; b < kTile; ++b)
        acc[a][b] = (i0 + a < nv && j0 + b < nv)
                        ? e.Mg[(i0 + a) * nv + j0 + b] : T(0);
    for (int q = 0; q < e.nh; ++q) {   // every member walks every item
      const int it = e.hitems[q];
      if (it < e.nefc) {
        const T w = e.wgt[it];
        T ri[kTile], rj[kTile];
        tile_row(e, it, i0, ri);
        tile_row(e, it, j0, rj);
        NEWTON_UNROLL
        for (int a = 0; a < kTile; ++a) {
          const T wa = w * ri[a];
          NEWTON_UNROLL
          for (int b = 0; b < kTile; ++b) acc[a][b] += wa * rj[b];
        }
        continue;
      }
      const int c = it - e.nefc, st = e.cst[c], d = e.cdim[c];
      const int m = e.cmus[c];
      const T cu = e.cu[c], cv = e.cv[c];
      const bool mid = cu != T(0) || cv != T(0);
      T vi[kTile], vj[kTile], ui[kTile], uj[kTile];
      NEWTON_UNROLL
      for (int a = 0; a < kTile; ++a) vi[a] = vj[a] = ui[a] = uj[a] = T(0);
      NEWTON_UNROLL
      for (int a = 0; a < kMaxDim; ++a) {
        if (a < d) {
          const int r = st + a;
          const T w = e.wgt[r];
          T ri[kTile], rj[kTile];
          tile_row(e, r, i0, ri);
          tile_row(e, r, j0, rj);
          if (!(e.skip && w == T(0))) {
            NEWTON_UNROLL
            for (int p = 0; p < kTile; ++p) {
              const T wp = w * ri[p];
              NEWTON_UNROLL
              for (int b = 0; b < kTile; ++b) acc[p][b] += wp * rj[b];
            }
          }
          if (mid) {
            const T sw = a > 0 ? e.sw[m + a - 1] : T(0);
            NEWTON_UNROLL
            for (int p = 0; p < kTile; ++p) {
              if (a == 0) {
                ui[p] = ri[p];
                uj[p] = rj[p];
              } else {
                vi[p] += sw * ri[p];
                vj[p] += sw * rj[p];
              }
            }
          }
        }
      }
      if (!mid) continue;
      const T muc = e.muc[c];
      NEWTON_UNROLL
      for (int p = 0; p < kTile; ++p) {
        ui[p] = muc * vi[p] - ui[p];
        uj[p] = muc * vj[p] - uj[p];
      }
      NEWTON_UNROLL
      for (int p = 0; p < kTile; ++p)
        NEWTON_UNROLL
        for (int b = 0; b < kTile; ++b)
          acc[p][b] += cu * ui[p] * uj[b] - cv * vi[p] * vj[b];
    }
    NEWTON_UNROLL
    for (int a = 0; a < kTile; ++a)
      NEWTON_UNROLL
      for (int b = 0; b < kTile; ++b) {
        const int i = i0 + a, j = j0 + b;
        if (i < nv && j <= i) e.H[i * nv + j] = acc[a][b];
      }
    next_entry(tm, bi, bj);
  }
}

// Cholesky factor of H (lower) and e.vec = -H^-1 e.vec with the factor in
// the members' slots: row i of H in member i % size's slot i / size, NVB
// (>= nv) entries a row.  Column j's pivot and entries reach the other
// members by bcast(); every slot takes the update of every column (its
// part above the diagonal gathers values that nothing reads, so no
// predicate sits between the column's bcasts, which overlap).  Each column
// takes one reciprocal of its pivot, and its owner keeps it for the
// solves.  The factor then goes through the workspace once, so that for
// the back solve slot i holds column i of L.  Where a pivot is not
// positive, every entry of the step is NaN.
template <int NVB, typename T, typename Team>
NEWTON_HD void newton_step_slots(const Team& tm, const Env<T>& e, int st0) {
  constexpr int R = Team::kRows;
  const int nv = e.nv, rk = tm.rank(), sz = tm.size();
  T h[R][NVB], rd[R];   // rows of H, then of L; L_ii, then 1 / L_ii
  NEWTON_UNROLL
  for (int k = 0; k < R; ++k) {
    const int i = rk + k * sz;
    rd[k] = T(1);
    NEWTON_UNROLL
    for (int j = 0; j < NVB; ++j)
      h[k][j] = (i < nv && j <= i) ? e.H[i * nv + j] : T(0);
  }
  bool bad = false;
  NEWTON_UNROLL
  for (int j = 0; j < NVB; ++j) {
    if (j < nv) {
      const T d = tm.bcast(h[j / sz][j], j % sz);
      bad = bad || !(d > T(0));
      const T ljj = nsqrt(d);
      NEWTON_UNROLL
      for (int k = 0; k < R; ++k) {
        const int i = rk + k * sz;
        // 0 / ljj is 0 (a bad pivot makes the step NaN whatever L holds):
        // the division's slow path, which a zero dividend takes, is left
        // to the entries that need it
        if (i > j && i < nv && h[k][j] != T(0)) h[k][j] = h[k][j] / ljj;
        if (i == j) {
          h[k][j] = ljj;
          rd[k] = ljj;
        }
      }
      NEWTON_UNROLL
      for (int c = j + 1; c < NVB; ++c) {
        const T lcj = tm.bcast(h[c / sz][j], c % sz);
        NEWTON_UNROLL
        for (int k = 0; k < R; ++k) h[k][c] -= h[k][j] * lcj;
      }
    }
  }
  tm.stamp(st0 + 4);
  NEWTON_UNROLL
  for (int k = 0; k < R; ++k) {
    const int i = rk + k * sz;
    NEWTON_UNROLL
    for (int j = 0; j < NVB; ++j)
      if (i < nv && j <= i) e.H[i * nv + j] = h[k][j];
    rd[k] = T(1) / rd[k];
  }
  // L y = grad: g holds what is left of grad, then y
  T g[R];
  NEWTON_UNROLL
  for (int k = 0; k < R; ++k) {
    const int i = rk + k * sz;
    g[k] = i < nv ? e.vec[i] : T(0);
  }
  NEWTON_UNROLL
  for (int j = 0; j < NVB; ++j) {
    if (j < nv) {
      const T yj = tm.bcast(g[j / sz] * rd[j / sz], j % sz);
      NEWTON_UNROLL
      for (int k = 0; k < R; ++k) {
        const int i = rk + k * sz;
        g[k] = i > j ? g[k] - h[k][j] * yj : (i == j ? yj : g[k]);
      }
    }
  }
  tm.sync();   // the factor's rows are in e.H
  NEWTON_UNROLL
  for (int k = 0; k < R; ++k) {
    const int i = rk + k * sz;
    NEWTON_UNROLL
    for (int j = 0; j < NVB; ++j)
      if (i < j && j < nv) h[k][j] = e.H[j * nv + i];   // L_ji
  }
  // L^T z = y, p = -z: g holds what is left of y, then z
  NEWTON_UNROLL
  for (int j = NVB - 1; j >= 0; --j) {
    if (j < nv) {
      const T zj = tm.bcast(g[j / sz] * rd[j / sz], j % sz);
      NEWTON_UNROLL
      for (int k = 0; k < R; ++k) {
        const int i = rk + k * sz;
        g[k] = i < j ? g[k] - h[k][j] * zj : (i == j ? zj : g[k]);
      }
    }
  }
  NEWTON_UNROLL
  for (int k = 0; k < R; ++k) {
    const int i = rk + k * sz;
    if (i < nv) e.vec[i] = bad ? nan_of<T>() : -g[k];
  }
  tm.stamp(st0 + 5);
}

// The same in the workspace, for nv above what the slots hold: H factored
// in place column by column (the diagonal in e.Ld), then the solves.
template <typename T, typename Team>
NEWTON_HD void newton_step_shared(const Team& tm, const Env<T>& e, int st0) {
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
  tm.stamp(st0 + 4);
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
  tm.stamp(st0 + 5);
}

// e.vec = -H^-1 e.vec: in the slots, sized to nv rounded up to a multiple
// of 4, where they hold nv rows; else in the workspace.  The kernel's
// float64 (no speed path) takes the largest slots for every nv, which
// keeps its build short; the host driver builds every size in either
// precision, so the CPU tests run the sizes the float32 kernel runs.
template <typename T, typename Team>
NEWTON_HD void newton_step(const Team& tm, const Env<T>& e, int st0) {
  const int nv = e.nv;
  if (nv > kRegNv || nv > Team::kRows * tm.size()) {
    newton_step_shared(tm, e, st0);
    return;
  }
#ifdef __CUDA_ARCH__
  constexpr bool every_size = sizeof(T) == 4;
#else
  constexpr bool every_size = true;
#endif
  if constexpr (!every_size) {
    newton_step_slots<kRegNv>(tm, e, st0);
  } else {
    switch ((nv + 3) / 4) {
      case 1: newton_step_slots<4>(tm, e, st0); break;
      case 2: newton_step_slots<8>(tm, e, st0); break;
      case 3: newton_step_slots<12>(tm, e, st0); break;
      case 4: newton_step_slots<16>(tm, e, st0); break;
      case 5: newton_step_slots<20>(tm, e, st0); break;
      case 6: newton_step_slots<24>(tm, e, st0); break;
      case 7: newton_step_slots<28>(tm, e, st0); break;
      default: newton_step_slots<32>(tm, e, st0); break;
    }
  }
}

// ---------------------------------------------------------------------------
// the whole solve of env n, the team sharing `work` (env_elems elements)
// ---------------------------------------------------------------------------

template <typename T, typename Team>
NEWTON_HD void stage(const Team& tm, const Args<T>& a, int n, Env<T>& e) {
  const int nefc = a.nefc, nv = a.nv, nc = a.nc;
  const long long en = n;
  T bad_j = T(0);   // entries of J that are not finite
  const T* J = a.J + en * nefc * nv;
  for (int q = tm.rank(); q < nefc * nv; q += tm.size()) {
    const T v = J[q];
    e.J[q] = v;
    bad_j += finite(v) ? T(0) : T(1);
  }
  for (int r = tm.rank(); r < nefc; r += tm.size()) {
    const long long g = en * nefc + r;
    e.aref[r] = a.aref[g];
    e.D[r] = T(1) / a.R[g];
    e.fl[r] = a.fl[g];
    e.quad[r] = a.quad[g] ? T(1) : T(0);
    e.f[r] = T(0);
    e.wgt[r] = T(0);
    e.jar[r] = T(0);   // here: whether the row is live
  }
  for (int i = tm.rank(); i < nv; i += tm.size()) {
    e.a0[i] = a.a0[en * nv + i];
    e.x[i] = a.x0 ? a.x0[en * nv + i] : e.a0[i];
  }
  const int* cst = a.desc + a.nplain;
  for (int c = tm.rank(); c < nc; c += tm.size()) {
    e.cst[c] = cst[c];
    e.cdim[c] = cst[nc + c];
    e.cmus[c] = cst[2 * nc + c];
  }
  e.skip = tm.sum(bad_j) == T(0);
  tm.sync();
  for (int c = tm.rank(); c < nc; c += tm.size()) {
    const T mu = a.mu[en * nc + c];
    const T muc = clamp_min(mu, tiny<T>());
    e.mu[c] = mu;
    e.act[c] = a.act[en * nc + c] ? T(1) : T(0);
    e.muc[c] = muc;
    e.c2[c] = e.D[e.cst[c]] / (T(1) + mu * mu);
    const int m = e.cmus[c];
    for (int q = m; q < m + e.cdim[c] - 1; ++q) {
      const T mq = a.mus[en * a.nmus + q];
      e.mus[q] = mq;
      e.s[q] = mq / muc;
    }
  }
  tm.sync();
  // the live items: those whose force can be nonzero (all where J is not
  // finite); then their rows, in efc order
  const int* plain = a.desc;
  const bool all = !e.skip;
  e.nitems = compact(
      tm, a.nplain + nc,
      [&](int t) {
        if (all) return true;
        if (t < a.nplain)
          return e.fl[plain[t]] > T(0) || e.quad[plain[t]] != T(0);
        return e.act[t - a.nplain] != T(0);
      },
      e.items);
  tm.sync();
  for (int q = tm.rank(); q < e.nitems; q += tm.size()) {
    int& it = e.items[q];
    if (it < a.nplain) {
      it = plain[it];
      e.jar[it] = T(1);
    } else {
      const int c = it - a.nplain;
      it = nefc + c;
      for (int k = 0; k < e.cdim[c]; ++k) e.jar[e.cst[c] + k] = T(1);
    }
  }
  tm.sync();
  e.nrows = compact(tm, nefc, [&](int r) { return e.jar[r] != T(0); },
                    e.rows);
  tm.sync();
}

template <typename T, typename Team>
NEWTON_HD void solve_one(const Team& tm, const Args<T>& a, int n, T* work) {
  tm.stamp(0);
  Env<T> e(a, n, work);
  const int nefc = a.nefc, nv = a.nv;
  const long long en = n;
  stage(tm, a, n, e);
  tm.stamp(1);

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
  tm.stamp(2);

  const T fracs[7] = {T(1), T(0.5), T(0.25), T(0.125), T(1.0 / 16),
                      T(1.0 / 64), T(1.0 / 256)};
  const T mults[5] = {T(0.25), T(0.5), T(1), T(2), T(4)};
  for (int it = 0; it < a.iterations; ++it) {
    const int st0 = it < kStampSteps ? kStampStep0 + it * kStampsPerStep
                                     : -kStampEnd;   // not recorded
    residual(tm, e, e.x);
    tm.sync();
    tm.stamp(st0 + 0);
    e.nh = forces_and_curvature(tm, e);
    tm.sync();
    tm.stamp(st0 + 1);
    // Mdx = M (x - a0), grad = Mdx - J^T f
    for (int i = tm.rank(); i < nv; i += tm.size()) {
      T mdx = T(0);
      NEWTON_UNROLL6
      for (int v = 0; v < nv; ++v) mdx += e.Mg[i * nv + v] * (e.x[v] - e.a0[v]);
      e.Mdx[i] = mdx;
      e.vec[i] = mdx - rows_dot(e, i, e.f);
    }
    tm.stamp(st0 + 2);
    hessian(tm, e);
    tm.sync();
    tm.stamp(st0 + 3);
    newton_step(tm, e, st0);   // e.vec = p
    tm.sync();

    // Jp, p^T M p, p^T M (x - a0)
    for (int q = tm.rank(); q < e.nrows; q += tm.size()) {
      const int r = e.rows[q];
      T acc = T(0);
      NEWTON_UNROLL6
      for (int v = 0; v < nv; ++v) acc += e.J[r * nv + v] * e.vec[v];
      e.Jp[r] = acc;
    }
    T pm[2] = {T(0), T(0)};   // p^T M p, p^T M (x - a0)
    for (int i = tm.rank(); i < nv; i += tm.size()) {
      T mp = T(0);
      NEWTON_UNROLL6
      for (int v = 0; v < nv; ++v) mp += e.Mg[i * nv + v] * e.vec[v];
      pm[0] += e.vec[i] * mp;
      pm[1] += e.vec[i] * e.Mdx[i];
    }
    tm.sum_n(pm);
    const T pMp = pm[0], gMp = pm[1];
    tm.sync();
    tm.stamp(st0 + 6);

    T d1_0[1], d2_0[1];
    const T zero[1] = {T(0)};
    phi<1>(tm, e, zero, gMp, pMp, d1_0, d2_0);
    tm.stamp(st0 + 7);
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
    T a_lo = T(0), d1_lo = T(0), d2_lo = T(0);   // at the argmax
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
        a_lo = cand[k];
        d1_lo = d1s[k];
        d2_lo = d2s[k];
      }
      has_neg = has_neg || neg;
    }
    tm.stamp(st0 + 8);
    T alpha = has_neg ? a_lo : T(0);
    T d1 = has_neg ? d1_lo : d1_0[0];
    T d2 = has_neg ? d2_lo : d2_0[0];
    const Item<T> held = load_item(
        e, tm.rank() < e.nitems ? e.items[tm.rank()] : 0);
    for (int r = 0; r < a.ls_refine; ++r) {
      lo = d1 < T(0) ? tmax(lo, alpha) : lo;
      hi = d1 >= T(0) ? tmin(hi, alpha) : hi;
      const T a_newton = alpha - d1 / clamp_min(d2, tiny<T>());
      const bool inside = (a_newton > lo) && (a_newton < hi);
      alpha = inside ? a_newton : T(0.5) * (lo + hi);
      T al[1] = {alpha}, r1[1], r2[1];
      phi<1>(tm, e, al, gMp, pMp, r1, r2, &held);
      d1 = r1[0];
      d2 = r2[0];
    }
    tm.stamp(st0 + 9);
    // the descent side of the bracket where phi'(final) > 0; a converged
    // iterate (phi'(0) >= 0) takes a null step
    alpha = d1 <= T(0) ? alpha : lo;
    alpha = d1_0[0] < T(0) ? alpha : T(0);
    for (int i = tm.rank(); i < nv; i += tm.size())
      e.x[i] = e.x[i] + alpha * e.vec[i];
    tm.sync();
    tm.stamp(st0 + 10);
  }

  // outputs: force in efc order, J^T f, qacc
  residual(tm, e, e.x);
  tm.sync();
  forces_and_curvature(tm, e);
  tm.sync();
  for (int r = tm.rank(); r < nefc; r += tm.size())
    a.force[en * nefc + r] = e.f[r];
  for (int i = tm.rank(); i < nv; i += tm.size()) {
    a.qfrc[en * nv + i] = rows_dot(e, i, e.f);
    a.qacc[en * nv + i] = e.x[i];
  }
  tm.stamp(kStampEnd);
}

}  // namespace newton_env
