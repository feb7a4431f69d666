// Batched leg-block-sparse box-PGS with the noslip post-pass, for Hopper
// (sm_90a).  One launch stages an env's inputs, builds the G panels from J
// and the block-arrow factor, and sweeps only the rows and pairs that can
// move f.
//
// The JAX package computes this form in XLA, not in a Pallas kernel:
// _scan_core_legs (nightmare_rl_tpu/ops/pgs.py:133-220) fed by _leg_panels
// (nightmare_rl_tpu/physics/solver.py:335-364).  The plain PyTorch versions
// are ops/pgs.py::pgs_legs_reference and physics/solver.py::leg_panels.
//
// Contract, per env.  Dofs are [base (6) | leg 0 (3) | ... | leg B-1 (3)], and
// the mass matrix is block-arrow with the no-fill factor
//   L = [[blkdiag(Ld_b), 0], [W_b^T ..., Ls]],  M = L L^T,
// given as Ld (B, 3, 3), W (B, 3, 6) and Ls (6, 6), lower triangular.  Row r
// of J touches leg slots leg1[r], leg2[r] (masked by has1, has2) and the base.
//   Prologue: the row panel of G = J L^-T in [leg1 | leg2 | base] slot layout,
//     g1 = Ld[leg1]^-1 (J[r, leg1's dofs] * has1)     (3x3 forward solve)
//     g2 = Ld[leg2]^-1 (J[r, leg2's dofs] * has2)
//     gb = Ls^-1 (J[r, base] - g1 W[leg1] - g2 W[leg2])  (6x6 forward solve),
//     diag[r] = |panel|^2 (12 values), A[i, i+1] = panel[i].panel[i+1] for
//     the noslip pairs, and the per-row records.
//   Sweeps: from f = 0 and slot state u = G^T f = 0 (per-leg ul (B, 3), base
//     ub (6)), `iterations` sweeps over rows in ascending order,
//       g = g1.ul[leg1] + g2.ul[leg2] + gb.ub + b[r] + R[r] f[r]
//       f[r] <- clip(f[r] - g / max(diag[r] + R[r], 1e-12), lo[r], hi[r])
//       ul[leg1] += g1 d;  ul[leg2] += g2 d;  ub += gb d   (d: change of f[r])
//     then `noslip` sweeps over the +/- facet pairs (i, i+1) from ns_offset,
//     both rows taken with row i's slots, the pair sum frozen, only where
//     hi[i] > 0.
//   Epilogue: dq = M^-1 J^T f = L^-T u (N, nv) in dof order,
//     from the final slot state, so that the caller's qacc update needs no
//     solve of its own:
//       xb = Ls^-T ub;  xl[b] = Ld[b]^-T (ul[b] - W[b] xb);  dq = [xb | xl].
// Slot ids outside [0, B) are clamped into it (the wrapper's CPU path
// refuses them).  A NaN passes through the clips as it does through
// jnp.clip; infinite bounds clip nothing.
//
// Which rows can move f.  An inactive contact row stays in the system with
// lo = hi = 0.  From f = 0 it gives clip(f - g inv, 0, 0) = +-0 for any
// finite g, so its change d is a zero and u += panel * d leaves u as it was
// (up to the sign of a zero).  A noslip pair with hi[i] <= 0 keeps f and
// adds panel * 0 to u.  So a row is visited only where it is not pinned
// (lo == 0 == hi) or where its diag, b or R is not finite (a finite diag
// means a finite panel); a pair only where hi[i] > 0 or either row's diag is
// not finite.  Both lists keep the rows' ascending order.  Skipping is then
// exact while u stays finite; a pinned row's g is NaN once u is not, and
// the reference's f is then NaN there.  u never becomes finite again once
// it is not, so after the sweeps each env checks its u: a warp in which any
// env's u is not finite sweeps again from f = 0, u = 0, those envs over
// every row and pair (the other envs repeat their own lists and get the
// same f).  What is not covered: a pinned row whose finite panel times a
// finite u overflows.
//
// What bounds it on an H100.  The bytes it needs (of J only the columns a
// row's masks select: the base's 6 and 3 per used slot, at most 12 of 24;
// the factor blocks, the slot ids and masks, b, R, lo, hi, f and dq) are at
// most ~19.7 MB per launch at N = 2048 in float32, 5.9 us at 3.35 TB/s; the
// arithmetic is small.  The time is set by a serial chain per env: each
// visited row is a dot product reduced over the env's lanes, a clip and an
// update that the next row reads, 3 sweeps of rows and 4 of pairs.  Tensor
// cores do not help a serial chain of 12-term dot products, each of which
// the next one waits on.  With one wave, a launch lasts as long as its
// slowest warp: the staging and prologue, then its longest lists.
//
// What the design does about it:
//   * Short chains.  The prologue classifies every row and pair and writes
//     the two lists (ballots over the env's lanes, 8 rows at a time, so the
//     lists come out ascending).  The 4 envs of a warp share its shuffles,
//     so the warp walks max(list length) steps; an env whose list is shorter
//     walks the rest on a row of zeros (row nefc, and rows nefc, nefc + 1
//     for pairs), whose step changes nothing.
//   * Staging in flight at once.  Every lane issues cp.async copies for its
//     rows' b, R, lo, hi, slot ids and J's base columns, and for the factor
//     blocks, with no register held; then, once the ids are in, the copies
//     of the leg columns they name.  Two rounds of memory latency, where a
//     row-by-row prologue waited on two dependent loads per row.  The slot
//     masks are bytes, too small for cp.async: plain loads, 8 rows a batch.
//     The panels are then built in place from shared memory, each lane's
//     rows 12 words apart (banks 0, 4, ..., 28) and the 4 envs one word
//     apart, so that a warp's panel accesses take all 32 banks once.  The
//     staging then runs at about the card's memory rate over the 32-byte
//     sectors it touches (J's needed values lie in 2 to 3 of a row's
//     sectors): building chunks of rows while later ones were in flight,
//     or staging J through a ring of whole rows, did not shorten it
//     (PERF.md section 6).
//   * One lane per leg and two for the base: 8 lanes per env, lane l < B
//     owning ul[l], lanes B and B+1 owning ub[0:3] and ub[3:6], the rest
//     idle.  A row's dot product is then the sum of at most four lanes' 3-term
//     products, reduced by a 3-level xor butterfly over the 8 lanes, and the
//     update lands in the owners' registers: the slot state lives in
//     registers and nothing is indexed dynamically but the panel's address.
//     Per row a lane takes its coefficients c = [l == leg1] g1 + [l == leg2]
//     g2 (a leg lane; both when leg1 == leg2, as the reference accumulates
//     both) or its half of gb (a base lane).
//   * One wave at N = 2048.  An env keeps its G panel (12 values a row), its
//     records, f, its factor blocks, the slot ids and masks and the two
//     lists in shared memory: ~11.1 KB in float32, so 4 envs share a
//     warp-sized block and 5 blocks an SM, 20 envs per SM.
//   * The chain: rows read ahead by loads the compiler may not sink, and one
//     row of lookahead, g[k] = c_k.u' + (c_k.c_{k-1}) d_{k-1}, where k-1 is
//     the previous row on the list, both sums reduced while that row is
//     solved.  List entries are read three steps ahead, the panel two steps
//     ahead, the record and f one step ahead.  A lane's panel addresses do
//     not depend on the slot ids (it reads g2 and its own first offset of
//     every row); the ids only select, after the loads.  Noslip pairs do the
//     same with the two rows of the previous pair.  The sweeps are a
//     function of their own (sweep_and_finish), so that their schedule
//     does not move with the prologue's code.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py slice-legs and
// tools/profile_pgs.py, PERF.md section 6): on the main path's inputs, where
// the slowest env keeps 72 of 112 rows active, 0.0485 ms a launch against
// 0.0672 for the design that swept every row; with every row active 0.991x
// that design; 66.8 ns a row step, 110.9 a pair step, 18 us of staging,
// prologue and epilogue, of which 8.2 us of copies at ~88 % of the memory
// rate.
// The launch geometry (envs per block, env stride, shared bytes) is computed
// by the Python wrapper (ops/pgs.py::legs_geometry) and passed in; launch()
// checks it against the shape.
//
// Rounding: triangular solves multiply by the reciprocal of the diagonal
// where the reference divides (but the epilogue's Ls^-T divides), a row's
// dot product is summed over the lanes in butterfly order and split in two
// by the lookahead, b + R f is formed apart, and nvcc contracts multiply-adds
// to FMAs.  The epilogue's u is the one the sweeps accumulated, not G^T f
// formed afresh: the two differ by the round-off of the row updates.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kLanes = 8;                      // lanes per env
constexpr int kS = 3;                          // dofs per leg
constexpr int kNb = 6;                         // base dofs
constexpr int kMaxB = kLanes - kNb / kS;       // legs a group holds
constexpr int kPw = 2 * kS + kNb;              // panel values per row
constexpr int kRec = 6;   // per row: b, R, 1/(diag+R), lo, hi, diag
constexpr int kPair = 3;  // per pair: b[i]-b[j], 1/max(h,1e-12), hi[i] > 0
constexpr int kHasBatch = 8;  // rows per lane whose mask loads fly together
constexpr int kMaxRows = 32000;  // list entries are 16-bit row numbers
constexpr int kWarpLanes = 32;
constexpr unsigned kFull = 0xffffffffu;

// Built with -DPGS_LEGS_TIMELINE (tools/profile_pgs.py --timeline), lane 0
// of each of the first kTimelineBlocks blocks stamps the card's global
// timer (ns) at the ends of the kernel's phases into g_timeline; otherwise
// STAMP is empty.
constexpr int kTimelineBlocks = 4096, kStamps = 8;
#ifdef PGS_LEGS_TIMELINE
__device__ long long g_timeline[kTimelineBlocks * kStamps];
#define STAMP(k)                                                         \
  if (threadIdx.x == 0 && blockIdx.x < kTimelineBlocks) {               \
    long long t;                                                          \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                 \
    g_timeline[blockIdx.x * kStamps + (k)] = t;                           \
  }
#else
#define STAMP(k)
#endif

// Sum over the 8 lanes of a group (xor butterfly: every lane ends with the
// bitwise same value, so all take the same clip branch).
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int m = kLanes >> 1; m > 0; m >>= 1)
    v += __shfl_xor_sync(kFull, v, m, kLanes);
  return v;
}

// jnp.clip(x, lo, hi) = min(max(x, lo), hi); a NaN x stays NaN
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

template <typename T>
__device__ __forceinline__ T at_least(T x, T floor) {
  return x < floor ? floor : x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory loads issued where they stand in the source (not sunk to
// their uses, which would put their latency back on the chain).
template <typename T>
__device__ __forceinline__ T lds(uint32_t a);

template <>
__device__ __forceinline__ float lds<float>(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

template <>
__device__ __forceinline__ double lds<double>(uint32_t a) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ int lds_int(uint32_t a) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ int lds_u16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a) : "memory");
  return v;
}

// An asynchronous copy of one 4- or 8-byte element from device to shared
// memory; cp_async_wait() waits for all of the thread's copies.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(Bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The raw panel values a lane may need from the row at shared address `row`:
// x from its first offset (g1, or a base lane's half of gb), y from g2.
template <typename T>
__device__ __forceinline__ void load_raw(T (&x)[kS], T (&y)[kS], uint32_t row,
                                         uint32_t off1) {
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    x[k] = lds<T>(row + off1 + k * sizeof(T));
    y[k] = lds<T>(row + (kS + k) * sizeof(T));
  }
}

// The lane's coefficients from its raw values and the slot ids (leg1 in the
// low byte, leg2 in the next) of the row that owns the slots.
template <typename T>
__device__ __forceinline__ void coef(T (&c)[kS], const T (&x)[kS],
                                     const T (&y)[kS], int ids, int l,
                                     bool leg_lane, bool base_lane) {
  const bool w1 = base_lane || (leg_lane && l == (ids & 0xff));
  const bool w2 = leg_lane && l == ((ids >> 8) & 0xff);
#pragma unroll
  for (int k = 0; k < kS; ++k)
    c[k] = (w1 ? x[k] : T(0)) + (w2 ? y[k] : T(0));
}

// g = Lblk^-1 (j * h) for one leg: Lblk row-major 3x3 with the diagonal held
// as its reciprocal.
template <typename T>
__device__ __forceinline__ void leg_solve(T (&g)[kS], const T* j, T h,
                                          const T* Lblk) {
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    T acc = j[i] * h;
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - Lblk[i * kS + k] * g[k];
    g[i] = acc * Lblk[i * kS + i];
  }
}

// The sweeps over the lists, the replay and the epilogue of one env's lane
// l (the kernel's state after its prologue), compiled apart from the
// prologue: inlined, ptxas scheduled the sweep loops anew with every change
// of the prologue, and some schedules put a read-ahead load's latency on
// the chain.
template <typename T>
__device__ __noinline__ void sweep_and_finish(
    T* P, T* rec, T* prec, T* f, const T* Lds, const T* Ws, const T* Lss,
    int* ids, uint16_t* rows, uint16_t* plist, T* __restrict__ f_out,
    T* __restrict__ dq, int l, int B, bool active, unsigned gmask, int nrow,
    int npr, int nefc, int npairs, int ns_offset, int iterations, int noslip,
    int env, size_t voff, int nv) {
  // the lane's role and its panel offset
  const bool leg_lane = l < B;
  const bool base_lane = !leg_lane && l < B + kNb / kS;
  const uint32_t off1 =
      static_cast<uint32_t>((base_lane ? 2 * kS + kS * (l - B) : 0) * sizeof(T));
  const uint32_t P0 = smem_addr(P), rec0 = smem_addr(rec);
  const uint32_t prec0 = smem_addr(prec), f0 = smem_addr(f);
  const uint32_t ids0 = smem_addr(ids), rows0 = smem_addr(rows);
  const uint32_t plist0 = smem_addr(plist);
  constexpr uint32_t rowb = kPw * sizeof(T), recb = kRec * sizeof(T);
  constexpr uint32_t pairb = kPair * sizeof(T), tb = sizeof(T);

  T x[kS];  // the lane's slot state: ul[l], a half of ub, or 0

  for (int pass = 0;; ++pass) {
    // the warp walks its longest lists; shorter ones end on the zero rows
    const int L = __reduce_max_sync(kFull, nrow);
    const int NP = __reduce_max_sync(kFull, npr);
    if (active) {
      for (int k = nrow + l; k < L; k += kLanes) rows[k] = nefc;
      for (int k = npr + l; k < NP; k += kLanes) plist[k] = nefc;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kS; ++k) x[k] = T(0);

    // Main sweeps over the row list, one row of lookahead: g[k] = s1 + s2 *
    // d', where d' is the change of the list's row k-1, s1 = c_k.u' with
    // u' = u - c_{k-1} d' lagging a row, and s2 = c_k.c_{k-1}.  s1 and s2 are
    // reduced while row k-1 is solved.
    for (int it = 0; it < iterations && L > 0; ++it) {
      T cr[kS], cn[kS], cp[kS], rx[kS], ry[kS];
      int rc = lds_u16(rows0);                               // row k
      int rn = lds_u16(rows0 + 2u * min(1, L - 1));          // row k+1
      int rn2 = lds_u16(rows0 + 2u * min(2, L - 1));         // row k+2
      load_raw(rx, ry, P0 + rc * rowb, off1);
      coef(cr, rx, ry, lds_int(ids0 + rc * 4u), l, leg_lane, base_lane);
      load_raw(rx, ry, P0 + rn * rowb, off1);
      coef(cn, rx, ry, lds_int(ids0 + rn * 4u), l, leg_lane, base_lane);
      // the first row's record and f, read before the shuffles below so
      // that every lane has them before the leader writes that f
      uint32_t q = rec0 + rc * recb;
      T bn = lds<T>(q), Rn = lds<T>(q + tb), invn = lds<T>(q + 2 * tb);
      T lon = lds<T>(q + 3 * tb), hin = lds<T>(q + 4 * tb);
      T fn = lds<T>(f0 + rc * tb);
      T part = T(0);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        part += cr[k] * x[k];
        cp[k] = T(0);
      }
      T s1 = group_sum(part), s2 = T(0), dp = T(0);
#pragma unroll 4
      for (int k = 0; k < L; ++k) {
        const T br = bn, Rr = Rn, inv = invn, lor = lon, hir = hin, fr = fn;
        const int r = rc;
        // read ahead: the list's entry k+3, row k+2's panel values and slot
        // ids, row k+1's record and f (last written a sweep ago, or a zero
        // row); past the list's end the reads repeat its last row, unused
        const int rn3 = lds_u16(rows0 + 2u * min(k + 3, L - 1));
        load_raw(rx, ry, P0 + rn2 * rowb, off1);
        const int id2 = lds_int(ids0 + rn2 * 4u);
        q = rec0 + rn * recb;
        bn = lds<T>(q);
        Rn = lds<T>(q + tb);
        invn = lds<T>(q + 2 * tb);
        lon = lds<T>(q + 3 * tb);
        hin = lds<T>(q + 4 * tb);
        fn = lds<T>(f0 + rn * tb);

        // the chain
        const T g = s1 + s2 * dp + (br + Rr * fr);
        const T nw = clip(fr - g * inv, lor, hir);
        const T d = nw - fr;
        if (active && l == 0) f[r] = nw;

        // off the chain: u <- u' + c_{k-1} d', then row k+1's two sums
        T p1 = T(0), p2 = T(0);
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          x[j] += cp[j] * dp;
          p1 += cn[j] * x[j];
          p2 += cn[j] * cr[j];
          cp[j] = cr[j];
          cr[j] = cn[j];
        }
        s1 = group_sum(p1);
        s2 = group_sum(p2);
        dp = d;
        coef(cn, rx, ry, id2, l, leg_lane, base_lane);
        rc = rn;
        rn = rn2;
        rn2 = rn3;
      }
#pragma unroll
      for (int k = 0; k < kS; ++k) x[k] += cp[k] * dp;  // the last row's change
      __syncwarp();
    }

    // Noslip sweeps over the pair list, both rows of a pair with row i's
    // slots and the same lookahead: the change of the previous pair enters
    // as s2 * di' + s3 * dj'.
    for (int sw = 0; sw < noslip && NP > 0; ++sw) {
      T ci[kS], cj[kS], cin[kS], cjn[kS], cpi[kS], cpj[kS];
      T rxi[kS], ryi[kS], rxj[kS], ryj[kS];
      int ic = lds_u16(plist0);                              // pair p's row i
      int in = lds_u16(plist0 + 2u * min(1, NP - 1));
      int in2 = lds_u16(plist0 + 2u * min(2, NP - 1));
      int id = lds_int(ids0 + ic * 4u);
      load_raw(rxi, ryi, P0 + ic * rowb, off1);
      load_raw(rxj, ryj, P0 + (ic + 1) * rowb, off1);
      coef(ci, rxi, ryi, id, l, leg_lane, base_lane);
      coef(cj, rxj, ryj, id, l, leg_lane, base_lane);
      id = lds_int(ids0 + in * 4u);
      load_raw(rxi, ryi, P0 + in * rowb, off1);
      load_raw(rxj, ryj, P0 + (in + 1) * rowb, off1);
      coef(cin, rxi, ryi, id, l, leg_lane, base_lane);
      coef(cjn, rxj, ryj, id, l, leg_lane, base_lane);
      // the first pair's record and f, read before the shuffles below so
      // that every lane has them before the leader writes them
      uint32_t q = prec0 + ((ic - ns_offset) >> 1) * pairb;
      T bdn = lds<T>(q), hinvn = lds<T>(q + tb), okn = lds<T>(q + 2 * tb);
      T fin = lds<T>(f0 + ic * tb), fjn = lds<T>(f0 + (ic + 1) * tb);
      T part = T(0);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        part += (ci[k] - cj[k]) * x[k];
        cpi[k] = T(0);
        cpj[k] = T(0);
      }
      T s1 = group_sum(part), s2 = T(0), s3 = T(0), dpi = T(0), dpj = T(0);
#pragma unroll 4
      for (int p = 0; p < NP; ++p) {
        const int i = ic;
        const T bd = bdn, hinv = hinvn, ok = okn, fi0 = fin, fj0 = fjn;
        // read ahead: the list's entry p+3, pair p+2's panel values and slot
        // ids (its row i's), pair p+1's record and f
        const int in3 = lds_u16(plist0 + 2u * min(p + 3, NP - 1));
        load_raw(rxi, ryi, P0 + in2 * rowb, off1);
        load_raw(rxj, ryj, P0 + (in2 + 1) * rowb, off1);
        const int id2 = lds_int(ids0 + in2 * 4u);
        q = prec0 + ((in - ns_offset) >> 1) * pairb;
        bdn = lds<T>(q);
        hinvn = lds<T>(q + tb);
        okn = lds<T>(q + 2 * tb);
        fin = lds<T>(f0 + in * tb);
        fjn = lds<T>(f0 + (in + 1) * tb);

        // the chain
        const T g = s1 + s2 * dpi + s3 * dpj + bd;
        const T tot = fi0 + fj0;
        T y = T(0.5) * (fi0 - fj0) - g * hinv;
        y = clip(y, T(-0.5) * tot, T(0.5) * tot);
        const bool act = ok != T(0);
        const T fi = act ? T(0.5) * tot + y : fi0;
        const T fj = act ? T(0.5) * tot - y : fj0;
        if (active && l == 0) {
          f[i] = fi;
          f[i + 1] = fj;
        }

        // off the chain: u <- u' + c_i' di' + c_j' dj', then pair p+1's sums
        T a1 = T(0), a2 = T(0), a3 = T(0);
#pragma unroll
        for (int k = 0; k < kS; ++k) {
          x[k] = x[k] + cpi[k] * dpi + cpj[k] * dpj;
          const T jd = cin[k] - cjn[k];
          a1 += jd * x[k];
          a2 += jd * ci[k];
          a3 += jd * cj[k];
          cpi[k] = ci[k];
          cpj[k] = cj[k];
          ci[k] = cin[k];
          cj[k] = cjn[k];
        }
        s1 = group_sum(a1);
        s2 = group_sum(a2);
        s3 = group_sum(a3);
        dpi = fi - fi0;
        dpj = fj - fj0;
        coef(cin, rxi, ryi, id2, l, leg_lane, base_lane);
        coef(cjn, rxj, ryj, id2, l, leg_lane, base_lane);
        ic = in;
        in = in2;
        in2 = in3;
      }
#pragma unroll
      for (int k = 0; k < kS; ++k) x[k] = x[k] + cpi[k] * dpi + cpj[k] * dpj;
      __syncwarp();
    }

    // An env whose u is not finite sweeps again over every row and pair;
    // the warp's other envs repeat theirs from f = 0.
    bool bad = false;
#pragma unroll
    for (int k = 0; k < kS; ++k) bad = bad || !isfinite(x[k]);
    const unsigned any = __ballot_sync(kFull, active && bad);
    if (any == 0u || pass > 0) break;
    if (any & gmask) {
      if (active) {
        for (int k = l; k < nefc; k += kLanes) rows[k] = k;
        for (int k = l; k < npairs; k += kLanes) plist[k] = ns_offset + 2 * k;
      }
      nrow = nefc;
      npr = npairs;
    }
    if (active)
      for (int r = l; r < nefc + 2; r += kLanes) f[r] = T(0);
    __syncwarp();
  }

  STAMP(6)
  // Epilogue: dq = L^-T u.  Every lane takes ub from the two base lanes and
  // back-substitutes Ls^T xb = ub; a leg lane then solves
  // Ld[l]^T xl = ul[l] - W[l] xb.
  {
    T xb[kNb];
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      xb[k] = __shfl_sync(kFull, x[k], B, kLanes);
      xb[kS + k] = __shfl_sync(kFull, x[k], B + 1, kLanes);
    }
#pragma unroll
    for (int i = kNb - 1; i >= 0; --i) {
      T acc = xb[i];
#pragma unroll
      for (int k = i + 1; k < kNb; ++k) acc = acc - Lss[k * kNb + i] * xb[k];
      xb[i] = acc / Lss[i * kNb + i];
    }
    T* const dqe = dq + static_cast<size_t>(env) * nv;
    if (active && leg_lane) {
      const T* const Lb = Lds + l * kS * kS;  // diagonal as its reciprocal
      const T* const Wb = Ws + l * kS * kNb;
      T xl[kS];
#pragma unroll
      for (int i = kS - 1; i >= 0; --i) {
        T acc = x[i];
#pragma unroll
        for (int j = 0; j < kNb; ++j) acc = acc - Wb[i * kNb + j] * xb[j];
#pragma unroll
        for (int k = i + 1; k < kS; ++k) acc = acc - Lb[k * kS + i] * xl[k];
        xl[i] = acc * Lb[i * kS + i];
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) dqe[kNb + kS * l + i] = xl[i];
    }
    if (active && base_lane) {  // constant indices keep xb in registers
      const bool hi_half = l > B;
#pragma unroll
      for (int k = 0; k < kS; ++k)
        dqe[(hi_half ? kS : 0) + k] = hi_half ? xb[kS + k] : xb[k];
    }
  }

  for (int r = l; r < nefc && active; r += kLanes) f_out[voff + r] = f[r];
  STAMP(7)
}

template <typename T>
__global__ void __launch_bounds__(kWarpLanes)
pgs_legs_kernel(const T* __restrict__ J, const T* __restrict__ Ld,
                const T* __restrict__ W, const T* __restrict__ Ls,
                const int* __restrict__ leg1, const int* __restrict__ leg2,
                const unsigned char* __restrict__ has1,
                const unsigned char* __restrict__ has2,
                const T* __restrict__ b, const T* __restrict__ R,
                const T* __restrict__ lo, const T* __restrict__ hi,
                T* __restrict__ f_out, T* __restrict__ dq, int N, int nefc,
                int nv, int B, int iterations, int noslip, int ns_offset,
                int envs_per_block, int env_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  STAMP(0)

  const int grp = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int env0 = blockIdx.x * envs_per_block;
  const int nenv = min(envs_per_block, N - env0);
  const int npairs = noslip > 0 ? (nefc - ns_offset) / 2 : 0;
  // A group without an env (past N, or past envs_per_block) runs along as a
  // ghost of slot 0, so that every shuffle and __syncwarp has the whole
  // warp; it writes nothing.
  const bool active = grp < nenv;
  const int slot = active ? grp : 0;
  const int env = env0 + slot;
  const unsigned gmask = 0xffu << (grp * kLanes);

  // this env's shared memory: panels (rows nefc, nefc + 1 zero) | records
  // (row nefc zero) | pair records (pair npairs zero) | f | Ld | W | Ls |
  // slot ids | row list | pair list | slot masks
  T* const P = smem + static_cast<size_t>(slot) * env_stride;
  T* const rec = P + kPw * (nefc + 2);
  T* const prec = rec + kRec * (nefc + 1);
  T* const f = prec + kPair * (npairs + 1);
  T* const Lds = f + nefc + 2;
  T* const Ws = Lds + B * kS * kS;
  T* const Lss = Ws + B * kS * kNb;
  int* const ids = reinterpret_cast<int*>(Lss + kNb * kNb);
  uint16_t* const rows = reinterpret_cast<uint16_t*>(ids + nefc + 2);
  uint16_t* const plist = rows + nefc;
  unsigned char* const hm = reinterpret_cast<unsigned char*>(plist + npairs);
  // leg2's ids wait in f's place until the prologue has read them
  int* const raw2 = reinterpret_cast<int*>(f);
  const size_t voff = static_cast<size_t>(env) * nefc;

  // Staging, round 1: every copy that needs no slot id, all in flight
  if (active) {
    for (int r = l; r < nefc; r += kLanes) {
      T* const q = rec + kRec * r;
      const T* const jr = J + (voff + r) * nv;
      cp_async<sizeof(T)>(q, b + voff + r);
      cp_async<sizeof(T)>(q + 1, R + voff + r);
      cp_async<sizeof(T)>(q + 3, lo + voff + r);
      cp_async<sizeof(T)>(q + 4, hi + voff + r);
      cp_async<4>(ids + r, leg1 + voff + r);
      cp_async<4>(raw2 + r, leg2 + voff + r);
#pragma unroll
      for (int k = 0; k < kNb; ++k)
        cp_async<sizeof(T)>(P + kPw * r + 2 * kS + k, jr + k);
    }
    const T* const Ldg = Ld + static_cast<size_t>(env) * B * kS * kS;
    const T* const Wg = W + static_cast<size_t>(env) * B * kS * kNb;
    const T* const Lsg = Ls + static_cast<size_t>(env) * kNb * kNb;
    for (int i = l; i < B * kS * kS; i += kLanes) cp_async<sizeof(T)>(Lds + i, Ldg + i);
    for (int i = l; i < B * kS * kNb; i += kLanes) cp_async<sizeof(T)>(Ws + i, Wg + i);
    for (int i = l; i < kNb * kNb; i += kLanes) cp_async<sizeof(T)>(Lss + i, Lsg + i);
    // the slot masks (bytes): plain loads, a batch of rows at once
    for (int r0 = l; r0 < nefc; r0 += kLanes * kHasBatch) {
      unsigned char h[kHasBatch];
#pragma unroll
      for (int k = 0; k < kHasBatch; ++k) {
        const int r = r0 + k * kLanes;
        h[k] = r < nefc ? static_cast<unsigned char>((has1[voff + r] ? 1 : 0) |
                                                     (has2[voff + r] ? 2 : 0))
                        : 0;
      }
#pragma unroll
      for (int k = 0; k < kHasBatch; ++k)
        if (r0 + k * kLanes < nefc) hm[r0 + k * kLanes] = h[k];
    }
  }
  cp_async_wait();
  STAMP(1)

  // Staging, round 2: the leg columns that the lane's rows name (the lane
  // copied those rows' ids itself)
  if (active) {
    for (int r = l; r < nefc; r += kLanes) {
      const int l1 = min(max(ids[r], 0), B - 1);
      const int l2 = min(max(raw2[r], 0), B - 1);
      ids[r] = l1 | (l2 << 8);
      const T* const jr = J + (voff + r) * nv + kNb;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        cp_async<sizeof(T)>(P + kPw * r + k, jr + kS * l1 + k);
        cp_async<sizeof(T)>(P + kPw * r + kS + k, jr + kS * l2 + k);
      }
    }
    // the rows of zeros that pad the lists
    for (int i = l; i < 2 * kPw; i += kLanes) P[kPw * nefc + i] = T(0);
    if (l < kRec) rec[kRec * nefc + l] = T(0);
    if (l < kPair) prec[kPair * npairs + l] = T(0);
    if (l < 2) ids[nefc + l] = 0;
  }
  cp_async_wait();
  __syncwarp();
  STAMP(2)

  // Ld's diagonal as its reciprocal; Ls's lower triangle in every lane's
  // registers, diagonal as reciprocal
  if (active)
    for (int i = l; i < B * kS * kS; i += kLanes)
      if ((i % (kS * kS)) % (kS + 1) == 0) Lds[i] = T(1) / Lds[i];
  T ls[kNb * (kNb + 1) / 2];
  {
    int k = 0;
#pragma unroll
    for (int i = 0; i < kNb; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j, ++k) {
        const T x = Lss[i * kNb + j];
        ls[k] = i == j ? T(1) / x : x;
      }
    }
  }
  __syncwarp();

  STAMP(3)
  // Prologue, 8 rows at a time (lane l builds row r0 + l in place from the
  // staged values), and the row list by ballot
  int nrow = 0;
  for (int r0 = 0; r0 < nefc; r0 += kLanes) {
    const int r = r0 + l;
    bool keep = false;
    if (active && r < nefc) {
      T* const pr = P + kPw * r;
      const int id = ids[r];
      const int l1 = id & 0xff, l2 = (id >> 8) & 0xff;
      const int hmask = hm[r];
      T g1[kS], g2[kS], gb[kNb];
      leg_solve(g1, pr, (hmask & 1) ? T(1) : T(0), Lds + l1 * kS * kS);
      leg_solve(g2, pr + kS, (hmask & 2) ? T(1) : T(0), Lds + l2 * kS * kS);
      const T* const w1 = Ws + l1 * kS * kNb;
      const T* const w2 = Ws + l2 * kS * kNb;
      int k = 0;
#pragma unroll
      for (int i = 0; i < kNb; ++i) {
        T a = T(0), c = T(0);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          a += g1[s] * w1[s * kNb + i];
          c += g2[s] * w2[s * kNb + i];
        }
        T acc = pr[2 * kS + i] - a - c;
#pragma unroll
        for (int j = 0; j < i; ++j) acc = acc - ls[k + j] * gb[j];
        gb[i] = acc * ls[k + i];
        k += i + 1;
      }
      T diag = T(0);
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        pr[s] = g1[s];
        pr[kS + s] = g2[s];
      }
#pragma unroll
      for (int i = 0; i < kNb; ++i) pr[2 * kS + i] = gb[i];
#pragma unroll
      for (int s = 0; s < kS; ++s) diag += g1[s] * g1[s];
#pragma unroll
      for (int s = 0; s < kS; ++s) diag += g2[s] * g2[s];
#pragma unroll
      for (int i = 0; i < kNb; ++i) diag += gb[i] * gb[i];
      T* const q = rec + kRec * r;
      const T br = q[0], Rr = q[1], lor = q[3], hir = q[4];
      q[2] = T(1) / at_least(diag + Rr, T(1e-12));
      q[5] = diag;
      keep = !(lor == T(0) && hir == T(0) && isfinite(diag) &&
               isfinite(br) && isfinite(Rr));
    }
    const unsigned m = __ballot_sync(kFull, keep) & gmask;
    if (keep) rows[nrow + __popc(m & ((1u << threadIdx.x) - 1u))] = r;
    nrow += __popc(m);
  }
  STAMP(4)
  // f = 0 (over leg2's staged ids, read above), the pair records and the
  // pair list
  __syncwarp();
  if (active)
    for (int r = l; r < nefc + 2; r += kLanes) f[r] = T(0);
  int npr = 0;
  for (int p0 = 0; p0 < npairs; p0 += kLanes) {
    const int p = p0 + l;
    bool keep = false;
    if (active && p < npairs) {
      const int i = ns_offset + 2 * p;
      const T* const pi = P + kPw * i;
      T a = T(0);
#pragma unroll
      for (int k = 0; k < kPw; ++k) a += pi[k] * pi[kPw + k];
      const T* const qi = rec + kRec * i;
      const T* const qj = qi + kRec;
      T* const q = prec + kPair * p;
      const T h = qi[5] + qj[5] - T(2) * a;
      q[0] = qi[0] - qj[0];
      q[1] = T(1) / at_least(h, T(1e-12));
      q[2] = qi[4] > T(0) ? T(1) : T(0);
      keep = qi[4] > T(0) || !isfinite(qi[5]) || !isfinite(qj[5]);
    }
    const unsigned m = __ballot_sync(kFull, keep) & gmask;
    if (keep) plist[npr + __popc(m & ((1u << threadIdx.x) - 1u))] = ns_offset + 2 * p;
    npr += __popc(m);
  }

  STAMP(5)
  sweep_and_finish<T>(P, rec, prec, f, Lds, Ws, Lss, ids, rows, plist, f_out, dq, l, B, active, gmask, nrow, npr, nefc, npairs, ns_offset, iterations, noslip, env, voff, nv);
}

// Elements of T that one env takes in shared memory (as ops/pgs.py's
// legs_geometry counts them).
template <typename T>
size_t env_elems(int nefc, int npairs, int B) {
  const size_t bytes = 4 * (static_cast<size_t>(nefc) + 2) +
                       2 * (static_cast<size_t>(nefc) + npairs) + nefc;
  return static_cast<size_t>(kPw) * (nefc + 2) +
         static_cast<size_t>(kRec) * (nefc + 1) +
         static_cast<size_t>(kPair) * (npairs + 1) + (nefc + 2) +
         static_cast<size_t>(B) * kS * (kS + kNb) + kNb * kNb +
         (bytes + sizeof(T) - 1) / sizeof(T);
}

// The dynamic shared memory a kernel may take above 48 KB is raised with
// cudaFuncSetAttribute at the first launch that needs more, once per kernel
// and device, and not again.  So a launch that a CUDA graph captures (after
// an eager warm-up) is the kernel launch alone, and every replay finds the
// attribute set on the function.
cudaError_t allow_smem(const void* kernel, int smem) {
  struct Allowed {
    const void* kernel;
    int device;
    int smem;
  };
  static std::mutex mu;
  static std::vector<Allowed> allowed;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  Allowed* hit = nullptr;
  for (Allowed& a : allowed)
    if (a.kernel == kernel && a.device == device) hit = &a;
  if (hit != nullptr && smem <= hit->smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  if (hit != nullptr)
    hit->smem = smem;
  else
    allowed.push_back({kernel, device, smem});
  return cudaSuccess;
}

template <typename T>
int launch(const T* J, const T* Ld, const T* W, const T* Ls, const int* leg1,
           const int* leg2, const unsigned char* has1,
           const unsigned char* has2, const T* b, const T* R, const T* lo,
           const T* hi, T* f, T* dq, int N, int nefc, int nv, int B,
           int iterations, int noslip, int ns_offset, int envs_per_block,
           int env_stride, int smem, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int npairs = noslip > 0 ? (nefc - ns_offset) / 2 : 0;
  const bool ok =
      dq != nullptr && nefc > 0 && nefc <= kMaxRows && B >= 1 && B <= kMaxB &&
      nv == kNb + kS * B &&
      iterations >= 0 && noslip >= 0 && ns_offset >= 0 && ns_offset <= nefc &&
      envs_per_block >= 1 && envs_per_block * kLanes <= kWarpLanes &&
      static_cast<size_t>(env_stride) >= env_elems<T>(nefc, npairs, B) &&
      static_cast<size_t>(smem) >=
          static_cast<size_t>(envs_per_block) * env_stride * sizeof(T);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(pgs_legs_kernel<T>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + envs_per_block - 1) / envs_per_block;
  pgs_legs_kernel<T><<<blocks, kWarpLanes, smem, stream>>>(
      J, Ld, W, Ls, leg1, leg2, has1, has2, b, R, lo, hi, f, dq, N, nefc, nv,
      B, iterations, noslip, ns_offset, envs_per_block, env_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int smem, int* blocks) {
  cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(pgs_legs_kernel<T>), smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, pgs_legs_kernel<T>, kWarpLanes, smem);
  return static_cast<int>(e);
}

}  // namespace

extern "C" int pgs_legs_f32(const float* J, const float* Ld, const float* W,
                            const float* Ls, const int* leg1, const int* leg2,
                            const unsigned char* has1,
                            const unsigned char* has2, const float* b,
                            const float* R, const float* lo, const float* hi,
                            float* f, float* dq, int N, int nefc, int nv,
                            int B, int iterations, int noslip, int ns_offset,
                            int envs_per_block, int env_stride, int smem,
                            void* stream) {
  return launch<float>(J, Ld, W, Ls, leg1, leg2, has1, has2, b, R, lo, hi, f,
                       dq, N, nefc, nv, B, iterations, noslip, ns_offset,
                       envs_per_block, env_stride, smem,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int pgs_legs_f64(const double* J, const double* Ld,
                            const double* W, const double* Ls, const int* leg1,
                            const int* leg2, const unsigned char* has1,
                            const unsigned char* has2, const double* b,
                            const double* R, const double* lo,
                            const double* hi, double* f, double* dq, int N,
                            int nefc, int nv, int B, int iterations, int noslip,
                            int ns_offset, int envs_per_block, int env_stride,
                            int smem, void* stream) {
  return launch<double>(J, Ld, W, Ls, leg1, leg2, has1, has2, b, R, lo, hi, f,
                        dq, N, nefc, nv, B, iterations, noslip, ns_offset,
                        envs_per_block, env_stride, smem,
                        static_cast<cudaStream_t>(stream));
}

// Blocks of the kernel that one SM holds at once for an element size with
// `smem` bytes of dynamic shared memory each, into *blocks.
extern "C" int pgs_legs_blocks_per_sm(int itemsize, int smem, int* blocks) {
  return itemsize == 4 ? blocks_per_sm<float>(smem, blocks)
                       : blocks_per_sm<double>(smem, blocks);
}

#ifdef PGS_LEGS_TIMELINE
// The stamps of the last launch: n values, block-major, kStamps a block.
extern "C" int pgs_legs_timeline(long long* out, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_timeline, sizeof(long long) * n));
}
#endif
