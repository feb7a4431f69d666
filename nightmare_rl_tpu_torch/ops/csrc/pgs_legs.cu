// Batched leg-block-sparse box-PGS with the noslip post-pass, for Hopper
// (sm_90a).  One launch builds the G panels from J and the block-arrow factor
// and runs every sweep.
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
// What bounds it on an H100.  As for csrc/pgs.cu, a chain of 3 * 112 + 4 * 56
// = 560 dependent row steps per env on the hexapod's main path (nefc = 112,
// B = 6), each a dot product reduced over the env's lanes, a clip and an
// update that the next row reads.  The bytes it needs (of J only the columns
// a row's masks select: the base's 6 and 3 per used slot, at most 12 of 24;
// the factor blocks, the slot ids and masks, b, R, lo, hi, f and dq) are at
// most ~19.7 MB per launch at N = 2048 in float32, 5.9 us at 3.35 TB/s; the
// arithmetic is small.  So the time is the chain's length times the time of
// one step, times the number of waves.
//
// What the design does about it:
//   * One lane per leg and two for the base: 8 lanes per env, lane l < B
//     owning ul[l], lanes B and B+1 owning ub[0:3] and ub[3:6], the rest
//     idle.  A row's dot product is then the sum of at most four lanes' 3-term
//     products, reduced by a 3-level xor butterfly over the 8 lanes, and the
//     update lands in the owners' registers: the slot state lives in
//     registers and nothing is indexed dynamically but the panel's address.
//     Per row a lane takes its coefficients c = [l == leg1] g1 + [l == leg2]
//     g2 (a leg lane; both when leg1 == leg2, as the reference accumulates
//     both) or its half of gb (a base lane).
//   * One wave at N = 2048.  An env keeps only its G panel (12 values a row
//     where csrc/pgs.cu keeps J and U, 48), its records, f, its legs' factor
//     blocks and the slot ids in shared memory: ~10.4 KB in float32, so 4
//     envs share a warp-sized block and 5 blocks an SM, 20 envs per SM.
//   * The chain as in csrc/pgs.cu: rows read a row ahead by loads the compiler
//     may not sink, and one row of lookahead, g[r] = c_r.u' + (c_r.c_{r-1})
//     d_{r-1}, both sums reduced while row r-1 is solved.  A lane's panel
//     addresses do not depend on the slot ids (it reads g2 and its own first
//     offset of every row); the ids only select, after the loads.  Noslip
//     pairs do the same with the two rows of the previous pair.
//   * The prologue works row-parallel: lane l builds rows l, l + 8, ...,
//     reading J's 12 needed values of its row from device memory and the
//     factor blocks from shared memory (Ls from registers), with the factor
//     diagonals held as their reciprocals.
// The launch geometry (envs per block, env stride, shared bytes) is computed
// by the Python wrapper (ops/pgs.py::legs_geometry) and passed in; launch()
// checks it against the shape.
//
// Rounding: triangular solves multiply by the reciprocal of the diagonal
// where the reference divides (but the epilogue's Ls^-T divides), a row's dot product is summed over the lanes
// in butterfly order and split in two by the lookahead, b + R f is formed
// apart, and nvcc contracts multiply-adds to FMAs.  The epilogue's u is the
// one the sweeps accumulated, not G^T f formed afresh: the two differ by the
// round-off of the row updates.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 8;                      // lanes per env
constexpr int kS = 3;                          // dofs per leg
constexpr int kNb = 6;                         // base dofs
constexpr int kMaxB = kLanes - kNb / kS;       // legs a group holds
constexpr int kPw = 2 * kS + kNb;              // panel values per row
constexpr int kRec = 6;   // per row: b, R, 1/(diag+R), lo, hi, diag
constexpr int kPair = 3;  // per pair: b[i]-b[j], 1/max(h,1e-12), hi[i] > 0
constexpr int kWarpLanes = 32;
constexpr unsigned kFull = 0xffffffffu;

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

// g = Lblk^-1 (j * h) for one leg: Lblk in shared memory, row-major 3x3 with
// the diagonal held as its reciprocal; j in device memory.
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
                int nv, int B, int iterations, int noslip, int ns_offset, int envs_per_block,
                int env_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);

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

  // this env's shared memory: panel | records | pair records | f | Ld | W |
  // slot ids
  T* const P = smem + static_cast<size_t>(slot) * env_stride;
  T* const rec = P + kPw * nefc;
  T* const prec = rec + kRec * nefc;
  T* const f = prec + kPair * npairs;
  T* const Lds = f + nefc;
  T* const Ws = Lds + B * kS * kS;
  int* const ids = reinterpret_cast<int*>(Ws + B * kS * kNb);
  const size_t voff = static_cast<size_t>(env) * nefc;

  // stage the legs' factor blocks, Ld's diagonal as its reciprocal
  if (active) {
    const T* const Ldg = Ld + static_cast<size_t>(env) * B * kS * kS;
    const T* const Wg = W + static_cast<size_t>(env) * B * kS * kNb;
    for (int i = l; i < B * kS * kS; i += kLanes) {
      const T x = Ldg[i];
      Lds[i] = (i % (kS * kS)) % (kS + 1) == 0 ? T(1) / x : x;
    }
    for (int i = l; i < B * kS * kNb; i += kLanes) Ws[i] = Wg[i];
  }
  // Ls's lower triangle in every lane's registers, diagonal as reciprocal
  T ls[kNb * (kNb + 1) / 2];
  {
    const T* const Lsg = Ls + static_cast<size_t>(env) * kNb * kNb;
    int k = 0;
#pragma unroll
    for (int i = 0; i < kNb; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j, ++k) {
        const T x = Lsg[i * kNb + j];
        ls[k] = i == j ? T(1) / x : x;
      }
    }
  }
  __syncwarp();

  // prologue, row-parallel: lane l builds rows l, l + 8, ...
#pragma unroll 2
  for (int r = l; r < nefc && active; r += kLanes) {
    const int l1 = min(max(leg1[voff + r], 0), B - 1);
    const int l2 = min(max(leg2[voff + r], 0), B - 1);
    const T h1 = has1[voff + r] ? T(1) : T(0);
    const T h2 = has2[voff + r] ? T(1) : T(0);
    const T* const jr = J + (voff + r) * nv;
    T g1[kS], g2[kS], gb[kNb];
    leg_solve(g1, jr + kNb + kS * l1, h1, Lds + l1 * kS * kS);
    leg_solve(g2, jr + kNb + kS * l2, h2, Lds + l2 * kS * kS);
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
      T acc = jr[i] - a - c;
#pragma unroll
      for (int j = 0; j < i; ++j) acc = acc - ls[k + j] * gb[j];
      gb[i] = acc * ls[k + i];
      k += i + 1;
    }
    T* const pr = P + kPw * r;
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
    q[0] = b[voff + r];
    q[1] = R[voff + r];
    q[3] = lo[voff + r];
    q[4] = hi[voff + r];
    q[5] = diag;
    f[r] = T(0);
    ids[r] = l1 | (l2 << 8);
  }
  __syncwarp();
  for (int p = l; p < npairs && active; p += kLanes) {
    const T* const pi = P + kPw * (ns_offset + 2 * p);
    T a = T(0);
#pragma unroll
    for (int k = 0; k < kPw; ++k) a += pi[k] * pi[kPw + k];
    prec[kPair * p + 1] = a;
  }
  __syncwarp();
  for (int r = l; r < nefc && active; r += kLanes) {
    T* const q = rec + kRec * r;
    q[2] = T(1) / at_least(q[5] + q[1], T(1e-12));
  }
  for (int p = l; p < npairs && active; p += kLanes) {
    const T* const qi = rec + kRec * (ns_offset + 2 * p);
    const T* const qj = qi + kRec;
    T* const q = prec + kPair * p;
    const T h = qi[5] + qj[5] - T(2) * q[1];
    q[0] = qi[0] - qj[0];
    q[1] = T(1) / at_least(h, T(1e-12));
    q[2] = qi[4] > T(0) ? T(1) : T(0);
  }
  __syncwarp();

  // the lane's role and its panel offset
  const bool leg_lane = l < B;
  const bool base_lane = !leg_lane && l < B + kNb / kS;
  const uint32_t off1 =
      static_cast<uint32_t>((base_lane ? 2 * kS + kS * (l - B) : 0) * sizeof(T));
  const uint32_t P0 = smem_addr(P), rec0 = smem_addr(rec);
  const uint32_t prec0 = smem_addr(prec), f0 = smem_addr(f);
  const uint32_t ids0 = smem_addr(ids);
  constexpr uint32_t rowb = kPw * sizeof(T), recb = kRec * sizeof(T);
  constexpr uint32_t pairb = kPair * sizeof(T), tb = sizeof(T);

  T x[kS];  // the lane's slot state: ul[l], a half of ub, or 0
#pragma unroll
  for (int k = 0; k < kS; ++k) x[k] = T(0);

  // Main sweeps, one row of lookahead: g[r] = s1 + s2 * d', where d' is row
  // r-1's change, s1 = c_r.u' with u' = u - c_{r-1} d' lagging a row, and
  // s2 = c_r.c_{r-1}.  s1 and s2 are reduced while row r-1 is solved.
  for (int it = 0; it < iterations; ++it) {
    T cr[kS], cn[kS], cp[kS], rx[kS], ry[kS];
    const int r1 = min(1, nefc - 1);
    load_raw(rx, ry, P0, off1);
    coef(cr, rx, ry, lds_int(ids0), l, leg_lane, base_lane);
    load_raw(rx, ry, P0 + r1 * rowb, off1);
    coef(cn, rx, ry, lds_int(ids0 + r1 * 4u), l, leg_lane, base_lane);
    // row 0's record and f, read before the shuffles below so that every
    // lane has them before the leader writes f[0]
    T bn = lds<T>(rec0), Rn = lds<T>(rec0 + tb), invn = lds<T>(rec0 + 2 * tb);
    T lon = lds<T>(rec0 + 3 * tb), hin = lds<T>(rec0 + 4 * tb);
    T fn = lds<T>(f0);
    T part = T(0);
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      part += cr[k] * x[k];
      cp[k] = T(0);
    }
    T s1 = group_sum(part), s2 = T(0), dp = T(0);
#pragma unroll 2
    for (int r = 0; r < nefc; ++r) {
      const T br = bn, Rr = Rn, inv = invn, lor = lon, hir = hin, fr = fn;
      // read ahead: row r+2's panel values and slot ids, row r+1's record
      // and f (last written a sweep ago); past the last row the reads
      // repeat it, unused
      const int r2 = min(r + 2, nefc - 1);
      load_raw(rx, ry, P0 + r2 * rowb, off1);
      const int id2 = lds_int(ids0 + r2 * 4u);
      const int rn = min(r + 1, nefc - 1);
      const uint32_t q = rec0 + rn * recb;
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

      // off the chain: u <- u' + c_{r-1} d', then row r+1's two sums
      T p1 = T(0), p2 = T(0);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        x[k] += cp[k] * dp;
        p1 += cn[k] * x[k];
        p2 += cn[k] * cr[k];
        cp[k] = cr[k];
        cr[k] = cn[k];
      }
      s1 = group_sum(p1);
      s2 = group_sum(p2);
      dp = d;
      coef(cn, rx, ry, id2, l, leg_lane, base_lane);
    }
#pragma unroll
    for (int k = 0; k < kS; ++k) x[k] += cp[k] * dp;  // the last row's change
    __syncwarp();
  }

  // Noslip sweeps over pairs (i, i+1), both rows with row i's slots and the
  // same lookahead: the change of the previous pair enters as
  // s2 * di' + s3 * dj'.
  for (int sw = 0; sw < noslip && npairs > 0; ++sw) {
    T ci[kS], cj[kS], cin[kS], cjn[kS], cpi[kS], cpj[kS];
    T rxi[kS], ryi[kS], rxj[kS], ryj[kS];
    const uint32_t a0 = P0 + ns_offset * rowb;
    const int q1 = ns_offset + 2 * min(1, npairs - 1);
    int id = lds_int(ids0 + ns_offset * 4u);
    load_raw(rxi, ryi, a0, off1);
    load_raw(rxj, ryj, a0 + rowb, off1);
    coef(ci, rxi, ryi, id, l, leg_lane, base_lane);
    coef(cj, rxj, ryj, id, l, leg_lane, base_lane);
    id = lds_int(ids0 + q1 * 4u);
    load_raw(rxi, ryi, P0 + q1 * rowb, off1);
    load_raw(rxj, ryj, P0 + (q1 + 1) * rowb, off1);
    coef(cin, rxi, ryi, id, l, leg_lane, base_lane);
    coef(cjn, rxj, ryj, id, l, leg_lane, base_lane);
    T bdn = lds<T>(prec0), hinvn = lds<T>(prec0 + tb);
    T okn = lds<T>(prec0 + 2 * tb);
    T fin = lds<T>(f0 + ns_offset * tb), fjn = lds<T>(f0 + (ns_offset + 1) * tb);
    T part = T(0);
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      part += (ci[k] - cj[k]) * x[k];
      cpi[k] = T(0);
      cpj[k] = T(0);
    }
    T s1 = group_sum(part), s2 = T(0), s3 = T(0), dpi = T(0), dpj = T(0);
#pragma unroll 2
    for (int p = 0; p < npairs; ++p) {
      const int i = ns_offset + 2 * p;
      const T bd = bdn, hinv = hinvn, ok = okn, fi0 = fin, fj0 = fjn;
      // read ahead: pair p+2's panel values and slot ids (its row i's),
      // pair p+1's record and f
      const int i2 = ns_offset + 2 * min(p + 2, npairs - 1);
      load_raw(rxi, ryi, P0 + i2 * rowb, off1);
      load_raw(rxj, ryj, P0 + (i2 + 1) * rowb, off1);
      const int id2 = lds_int(ids0 + i2 * 4u);
      const int pn = min(p + 1, npairs - 1);
      const int i1 = ns_offset + 2 * pn;
      const uint32_t q = prec0 + pn * pairb;
      bdn = lds<T>(q);
      hinvn = lds<T>(q + tb);
      okn = lds<T>(q + 2 * tb);
      fin = lds<T>(f0 + i1 * tb);
      fjn = lds<T>(f0 + (i1 + 1) * tb);

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
    }
#pragma unroll
    for (int k = 0; k < kS; ++k) x[k] = x[k] + cpi[k] * dpi + cpj[k] * dpj;
    __syncwarp();
  }

  // Epilogue: dq = L^-T u.  Every lane takes ub from the two base lanes and
  // back-substitutes Ls^T xb = ub (Ls from device memory: holding it in
  // registers through the sweeps would cost registers there); a leg lane
  // then solves Ld[l]^T xl = ul[l] - W[l] xb.
  {
    T xb[kNb];
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      xb[k] = __shfl_sync(kFull, x[k], B, kLanes);
      xb[kS + k] = __shfl_sync(kFull, x[k], B + 1, kLanes);
    }
    const T* const Lsg = Ls + static_cast<size_t>(env) * kNb * kNb;
#pragma unroll
    for (int i = kNb - 1; i >= 0; --i) {
      T acc = xb[i];
#pragma unroll
      for (int k = i + 1; k < kNb; ++k) acc = acc - Lsg[k * kNb + i] * xb[k];
      xb[i] = acc / Lsg[i * kNb + i];
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
}

template <typename T>
size_t env_elems(int nefc, int npairs, int B) {
  return static_cast<size_t>(nefc) * (kPw + kRec + 1) +
         static_cast<size_t>(kPair) * npairs +
         static_cast<size_t>(B) * kS * (kS + kNb) +
         (4 * static_cast<size_t>(nefc) + sizeof(T) - 1) / sizeof(T);
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
      dq != nullptr && nefc > 0 && B >= 1 && B <= kMaxB &&
      nv == kNb + kS * B &&
      iterations >= 0 && noslip >= 0 && ns_offset >= 0 && ns_offset <= nefc &&
      envs_per_block >= 1 && envs_per_block * kLanes <= kWarpLanes &&
      static_cast<size_t>(env_stride) >= env_elems<T>(nefc, npairs, B) &&
      static_cast<size_t>(smem) >=
          static_cast<size_t>(envs_per_block) * env_stride * sizeof(T);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      pgs_legs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + envs_per_block - 1) / envs_per_block;
  pgs_legs_kernel<T><<<blocks, kWarpLanes, smem, stream>>>(
      J, Ld, W, Ls, leg1, leg2, has1, has2, b, R, lo, hi, f, dq, N, nefc, nv,
      B, iterations, noslip, ns_offset, envs_per_block, env_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      pgs_legs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
