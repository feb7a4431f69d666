// Batched matrix-free box-PGS with the noslip post-pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nightmare_rl_tpu/ops/pgs.py::_kernel,
// launched by pgs_solve (nightmare_rl_tpu/ops/pgs.py:228-355, pl.pallas_call
// at :345).  Same contract as that kernel and as its plain reference
// _scan_core: for every env, starting from f = 0 and w = M^-1 J^T f = 0,
//   `iterations` sweeps over rows r = 0..nefc-1 in ascending order:
//       g = J[r].w + b[r] + R[r] f[r]
//       f[r] <- clip(f[r] - g / max(diag[r] + R[r], 1e-12), lo[r], hi[r])
//       w += U[r] * (change of f[r])
//   then `noslip` sweeps over the +/- facet pairs (i, i+1) from ns_offset,
//   each pair updated with its pair sum frozen, only where hi[i] > 0.
// diag = sum(J * U) and the pair off-diagonals A[i, i+1] = J[i].U[i+1] are
// computed in the prologue, so one launch does the whole solve.  A NaN passes
// through the clips as it does through jnp.clip.
//
// What bounds it on an H100.  Per env the solve is a chain of dependent row
// steps, 3 * 112 + 4 * 56 = 560 on the hexapod's main path (nefc = 112,
// nv = 24): each is a dot product reduced across the row, a clip, and a
// rank-1 update of w that the next row reads.  The bytes (J and U once, the
// row vectors, f) are 48.6 MB per launch at N = 2048 in float32, 14.5 us at
// 3.35 TB/s; the arithmetic is negligible.  So the time is the chain's
// length times the time of one step, times the number of waves of envs.
//
// What the design does about it:
//   * Env groups narrower than a warp: L lanes per env (L = 8 for nv <= 24,
//     else 32), lane l owning columns l, l + L, ...  The row dot ends in
//     log2(L) xor-shuffle levels (3 on the main path) and no lane idles.
//     The butterfly leaves the bitwise same sum in every lane of a group
//     (IEEE addition commutes), so all lanes take the same clip branch.
//     Every shuffle names the whole warp: groups without an env run as
//     ghosts of the block's first env and write nothing.  (A per-group mask
//     made the compiler put a convergence check, MATCH.ANY and REDUX, before
//     every shuffle of the chain.)
//   * Nothing global on the chain.  Each env's J and U panels (nefc * nv
//     contiguous elements each) are staged in shared memory in the prologue
//     by TMA bulk copies completed on an mbarrier, or by plain loads where a
//     panel is not a whole number of 16-byte chunks or not 16-byte aligned.
//     Per-row records (b, R, 1/(diag+R), lo, hi, diag), per-pair records
//     (b[i]-b[j], 1/max(h,1e-12), hi[i] > 0) and f sit beside them.  An env's
//     stride in shared memory is L words modulo 32 banks, so the groups of
//     a warp read J, U and the records without bank conflicts.
//   * No barrier and no memory access on the chain.  Row r+1's U, record
//     and f and row r+2's J are read while row r is solved (f[r+1] was
//     last written a sweep earlier), with loads that the compiler may not
//     sink to their uses, at one row address per panel plus constant
//     column offsets.  The group's leader writes the new f[r]; one
//     __syncwarp closes each sweep, and a sweep's first rows are read after
//     it.  Noslip pairs are disjoint, so the same holds for them.
//   * One row of lookahead.  J[r].w = J[r].w' + (J[r].U[r-1]) d', where d'
//     is row r-1's change of f and w' = w - U[r-1] d'.  Both sums are
//     reduced across the group while row r-1 is solved, so from one row's
//     change to the next the chain is one FMA, the projection and the clip;
//     the shuffles overlap the previous row.  Noslip pairs do the same with
//     the two rows of the previous pair.
//   * A parallel prologue: diag[r] and A[i, i+1] are reduced by the group L
//     rows at a time with no store in between, so the reductions overlap.
//   * One warp per block holding 32 / L envs (fewer where the panels are
//     large), so a block's shared memory is small enough that two blocks of
//     the main path share an SM: 8 envs resident per SM, two waves at
//     N = 2048.
// The launch geometry (lanes, envs per block, panel and env strides, shared
// bytes) is computed by the Python wrapper (ops/pgs.py::launch_geometry) and
// passed in; launch() checks it against the shape.
//
// Measured on an H100 (PERF.md section 6, tools/profile_pgs.py): a main-path
// row step takes ~59 ns and a noslip pair ~90 ns.  Their SASS loop bodies
// hold ~55 and ~90 instructions a step, issued in order by one warp per
// scheduler, so the loop is bound by that issue, not by the shuffles'
// latency.  Two variants that hide more latency at the cost of more
// instructions measured slower and were dropped: two rows of lookahead
// (three sums a row), and noslip pairs moved along U[i] - U[i+1] with the
// pair sum frozen (panels differenced in place, two sums a pair).
//
// Rounding: the butterfly sums a row's products in another order than the
// CPU's sequential sum, the lookahead splits J[r].w in two sums, b + R f is
// formed apart, and nvcc contracts multiply-adds to FMAs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

constexpr int kRec = 6;   // per row: b, R, 1/(diag+R), lo, hi, diag
constexpr int kPair = 3;  // per pair: b[i]-b[j], 1/max(h,1e-12), hi[i] > 0
constexpr int kMaxNv = 128;
constexpr int kWarpLanes = 32;
constexpr unsigned kFull = 0xffffffffu;

// Sum over the L lanes of a group (xor butterfly: every lane ends with the
// bitwise same value).  All 32 lanes of the warp take part: a constant full
// mask compiles to bare shuffles.
template <int L, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int m = L >> 1; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m, L);
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

// Shared-memory loads issued where they stand in the source: the reads a
// row ahead must not be sunk next to their uses (the compiler did so with
// plain loads), which would put their latency back on the chain.
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

// Lane l's columns l, l + L, ... of one staged row; a is the shared address
// of the row's element l.  Columns past nv read the next row (or the slack
// after the panels) and are zeroed, unless nv == L * K (Exact).
template <int L, int K, bool Exact, typename T>
__device__ __forceinline__ void load_row(T (&v)[K], uint32_t a, int l,
                                         int nv) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T x = lds<T>(a + k * L * sizeof(T));
    v[k] = Exact || l + k * L < nv ? x : T(0);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits for phase `parity` of the barrier; traps (an error, not a hang) if
// the copies have not landed after about a second.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}

// L lanes per env, K columns per lane at most (nv <= L * K; Exact: nv ==
// L * K).
template <typename T, int L, int K, bool Exact>
__global__ void __launch_bounds__(kWarpLanes)
pgs_kernel(const T* __restrict__ J, const T* __restrict__ U,
           const T* __restrict__ b, const T* __restrict__ R,
           const T* __restrict__ lo, const T* __restrict__ hi,
           T* __restrict__ f_out, int N, int nefc, int nv, int iterations,
           int noslip, int ns_offset, int envs_per_block, int panel,
           int env_stride, int bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int grp = threadIdx.x / L;
  const int l = threadIdx.x % L;
  const int env0 = blockIdx.x * envs_per_block;
  const int nenv = min(envs_per_block, N - env0);
  const size_t P = static_cast<size_t>(nefc) * nv;
  const int npairs = noslip > 0 ? (nefc - ns_offset) / 2 : 0;

  const uint32_t bar_s = smem_addr(&bar);
  if (bulk) {
    if (threadIdx.x == 0) mbar_init(bar_s, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(P * sizeof(T));
      mbar_expect_tx(bar_s, 2u * nenv * bytes);
      for (int e = 0; e < nenv; ++e) {
        T* dst = smem + static_cast<size_t>(e) * env_stride;
        const size_t src = static_cast<size_t>(env0 + e) * P;
        bulk_load(smem_addr(dst), J + src, bytes, bar_s);
        bulk_load(smem_addr(dst + panel), U + src, bytes, bar_s);
      }
    }
  }
  // A group without an env (past N, or past envs_per_block) runs along as a
  // ghost of slot 0, so that every shuffle and __syncwarp has the whole
  // warp; it writes nothing.
  const bool active = grp < nenv;
  const int slot = active ? grp : 0;
  const int env = env0 + slot;
  T* const Js = smem + static_cast<size_t>(slot) * env_stride;
  T* const Us = Js + panel;
  T* const rec = Us + panel;
  T* const prec = rec + kRec * nefc;
  T* const f = prec + kPair * npairs;

  if (!bulk && active) {
    const T* const Jg = J + static_cast<size_t>(env) * P;
    const T* const Ug = U + static_cast<size_t>(env) * P;
    for (size_t i = l; i < P; i += L) {
      Js[i] = Jg[i];
      Us[i] = Ug[i];
    }
  }
  const size_t voff = static_cast<size_t>(env) * nefc;
  for (int r = l; r < nefc && active; r += L) {
    T* q = rec + kRec * r;
    q[0] = b[voff + r];
    q[1] = R[voff + r];
    q[3] = lo[voff + r];
    q[4] = hi[voff + r];
    f[r] = T(0);
  }
  if (bulk) mbar_wait(bar_s, 0);
  __syncwarp();

  // shared addresses of this lane's element in row 0 of J and U, row stride
  const uint32_t J0 = smem_addr(Js + l), U0 = smem_addr(Us + l);
  const uint32_t rowb = static_cast<uint32_t>(nv * sizeof(T));
  const uint32_t rec0 = smem_addr(rec), prec0 = smem_addr(prec);
  const uint32_t f0 = smem_addr(f);
  constexpr uint32_t recb = kRec * sizeof(T), pairb = kPair * sizeof(T);
  constexpr uint32_t tb = sizeof(T);

  // prologue: diag[r] = J[r].U[r] and A[i, i+1] = J[i].U[i+1], L rows at a
  // time with no store in between (so the L reductions overlap); lane j
  // keeps row r0 + j's sum, then each lane finishes its own rows' records.
  for (int r0 = 0; r0 < nefc; r0 += L) {
    T mine = T(0);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t o = min(r0 + j, nefc - 1) * rowb;
      T jr[K], ur[K];
      load_row<L, K, Exact>(jr, J0 + o, l, nv);
      load_row<L, K, Exact>(ur, U0 + o, l, nv);
      T part = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) part += jr[k] * ur[k];
      const T d = group_sum<L>(part);
      mine = l == j ? d : mine;
    }
    if (active && r0 + l < nefc) rec[kRec * (r0 + l) + 5] = mine;
  }
  for (int p0 = 0; p0 < npairs; p0 += L) {
    T mine = T(0);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t o = (ns_offset + 2 * min(p0 + j, npairs - 1)) * rowb;
      T jr[K], ur[K];
      load_row<L, K, Exact>(jr, J0 + o, l, nv);
      load_row<L, K, Exact>(ur, U0 + o + rowb, l, nv);
      T part = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) part += jr[k] * ur[k];
      const T a = group_sum<L>(part);
      mine = l == j ? a : mine;
    }
    if (active && p0 + l < npairs) prec[kPair * (p0 + l) + 1] = mine;
  }
  __syncwarp();
  for (int r = l; r < nefc && active; r += L) {
    T* q = rec + kRec * r;
    q[2] = T(1) / at_least(q[5] + q[1], T(1e-12));
  }
  for (int p = l; p < npairs && active; p += L) {
    const T* qi = rec + kRec * (ns_offset + 2 * p);
    const T* qj = qi + kRec;
    T* q = prec + kPair * p;
    const T h = qi[5] + qj[5] - T(2) * q[1];
    q[0] = qi[0] - qj[0];
    q[1] = T(1) / at_least(h, T(1e-12));
    q[2] = qi[4] > T(0) ? T(1) : T(0);
  }
  __syncwarp();

  T w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = T(0);

  // Main sweeps, one row of lookahead: J[r].w = s1 + s2 * d', where d' is
  // row r-1's change, s1 = J[r].w' with w' = w - U[r-1] d' lagging a row,
  // and s2 = J[r].U[r-1].  s1 and s2 are reduced while row r-1 is solved.
  for (int it = 0; it < iterations; ++it) {
    T jn[K], un[K], up[K], jr[K];
    load_row<L, K, Exact>(jr, J0, l, nv);
    load_row<L, K, Exact>(un, U0, l, nv);
    load_row<L, K, Exact>(jn, J0 + min(1, nefc - 1) * rowb, l, nv);
    T part = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      part += jr[k] * w[k];
      up[k] = T(0);
    }
    // row 0's record and f, read before the shuffles below so that every
    // lane has them before the leader writes f[0]
    T bn = lds<T>(rec0), Rn = lds<T>(rec0 + tb), invn = lds<T>(rec0 + 2 * tb);
    T lon = lds<T>(rec0 + 3 * tb), hin = lds<T>(rec0 + 4 * tb);
    T fn = lds<T>(f0);
    T s1 = group_sum<L>(part), s2 = T(0), dp = T(0);
#pragma unroll 2
    for (int r = 0; r < nefc; ++r) {
      // this row's scalars and U, the next row's J (all read a row ago)
      const T br = bn, Rr = Rn, inv = invn, lor = lon, hir = hin, fr = fn;
      T ur[K], j1[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ur[k] = un[k];
        j1[k] = jn[k];
      }
      // read ahead: J[r+2], U[r+1], row r+1's record and f (last written a
      // sweep ago); past the last row the reads repeat it, unused
      const int r1 = min(r + 1, nefc - 1);
      load_row<L, K, Exact>(jn, J0 + min(r + 2, nefc - 1) * rowb, l, nv);
      load_row<L, K, Exact>(un, U0 + r1 * rowb, l, nv);
      const uint32_t q = rec0 + r1 * recb;
      bn = lds<T>(q);
      Rn = lds<T>(q + tb);
      invn = lds<T>(q + 2 * tb);
      lon = lds<T>(q + 3 * tb);
      hin = lds<T>(q + 4 * tb);
      fn = lds<T>(f0 + r1 * tb);

      // the chain
      const T g = s1 + s2 * dp + (br + Rr * fr);
      const T nw = clip(fr - g * inv, lor, hir);
      const T d = nw - fr;
      if (active && l == 0) f[r] = nw;

      // off the chain: w <- w' + U[r-1] d', then row r+1's two sums
      T p1 = T(0), p2 = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        w[k] += up[k] * dp;
        p1 += j1[k] * w[k];
        p2 += j1[k] * ur[k];
        up[k] = ur[k];
      }
      s1 = group_sum<L>(p1);
      s2 = group_sum<L>(p2);
      dp = d;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] += up[k] * dp;  // the last row's change
    __syncwarp();
  }

  // Noslip sweeps over pairs (i, i+1), with the same lookahead: the change
  // of the previous pair enters as s2 * di' + s3 * dj'.
  for (int s = 0; s < noslip && npairs > 0; ++s) {
    const uint32_t o0 = ns_offset * rowb;
    const uint32_t o1 = (ns_offset + 2 * min(1, npairs - 1)) * rowb;
    T jin[K], jjn[K], uin[K], ujn[K], upi[K], upj[K], ji[K], jj[K];
    load_row<L, K, Exact>(ji, J0 + o0, l, nv);
    load_row<L, K, Exact>(jj, J0 + o0 + rowb, l, nv);
    load_row<L, K, Exact>(uin, U0 + o0, l, nv);
    load_row<L, K, Exact>(ujn, U0 + o0 + rowb, l, nv);
    load_row<L, K, Exact>(jin, J0 + o1, l, nv);
    load_row<L, K, Exact>(jjn, J0 + o1 + rowb, l, nv);
    T part = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      part += (ji[k] - jj[k]) * w[k];
      upi[k] = T(0);
      upj[k] = T(0);
    }
    // the first pair's record and f, read before the shuffles below so that
    // every lane has them before the leader writes f[i], f[i+1]
    T bdn = lds<T>(prec0), hinvn = lds<T>(prec0 + tb);
    T okn = lds<T>(prec0 + 2 * tb);
    T fin = lds<T>(f0 + ns_offset * tb), fjn = lds<T>(f0 + (ns_offset + 1) * tb);
    T s1 = group_sum<L>(part), s2 = T(0), s3 = T(0), dpi = T(0), dpj = T(0);
#pragma unroll 2
    for (int p = 0; p < npairs; ++p) {
      const int i = ns_offset + 2 * p;
      const T bd = bdn, hinv = hinvn, ok = okn, fi0 = fin, fj0 = fjn;
      T ui[K], uj[K], jd[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ui[k] = uin[k];
        uj[k] = ujn[k];
        jd[k] = jin[k] - jjn[k];  // pair p+1's J[i] - J[i+1]
      }
      // read ahead: pair p+2's J, pair p+1's U, record and f
      const int p1 = min(p + 1, npairs - 1);
      const int i1 = ns_offset + 2 * p1;
      const uint32_t o2 = (ns_offset + 2 * min(p + 2, npairs - 1)) * rowb;
      load_row<L, K, Exact>(jin, J0 + o2, l, nv);
      load_row<L, K, Exact>(jjn, J0 + o2 + rowb, l, nv);
      load_row<L, K, Exact>(uin, U0 + i1 * rowb, l, nv);
      load_row<L, K, Exact>(ujn, U0 + (i1 + 1) * rowb, l, nv);
      const uint32_t q = prec0 + p1 * pairb;
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

      // off the chain: w <- w' + U[i'] di' + U[j'] dj', then pair p+1's sums
      T a1 = T(0), a2 = T(0), a3 = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        w[k] = w[k] + upi[k] * dpi + upj[k] * dpj;
        a1 += jd[k] * w[k];
        a2 += jd[k] * ui[k];
        a3 += jd[k] * uj[k];
        upi[k] = ui[k];
        upj[k] = uj[k];
      }
      s1 = group_sum<L>(a1);
      s2 = group_sum<L>(a2);
      s3 = group_sum<L>(a3);
      dpi = fi - fi0;
      dpj = fj - fj0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = w[k] + upi[k] * dpi + upj[k] * dpj;
    __syncwarp();
  }

  for (int r = l; r < nefc && active; r += L) f_out[voff + r] = f[r];
}

// Columns a lane owns at most, for the two group widths.
constexpr int cols(int lanes) { return lanes == 8 ? 3 : 4; }

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
using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                        const T*, T*, int, int, int, int, int, int, int, int,
                        int, int);

// The kernel for a group width: 8 lanes (without column masks when nv fills
// them, as the hexapod's nv = 24 does) or 32 lanes.
template <typename T>
Kernel<T> kernel_for(int lanes, int nv) {
  if (lanes == 8)
    return nv == 8 * cols(8) ? pgs_kernel<T, 8, cols(8), true>
                             : pgs_kernel<T, 8, cols(8), false>;
  return pgs_kernel<T, 32, cols(32), false>;
}

template <typename T>
int launch(const T* J, const T* U, const T* b, const T* R, const T* lo,
           const T* hi, T* f, int N, int nefc, int nv, int iterations,
           int noslip, int ns_offset, int lanes, int envs_per_block,
           int panel, int env_stride, int smem, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int npairs = noslip > 0 ? (nefc - ns_offset) / 2 : 0;
  const bool ok =
      nefc > 0 && nv > 0 && nv <= kMaxNv && iterations >= 0 && noslip >= 0 &&
      ns_offset >= 0 && ns_offset <= nefc && (lanes == 8 || lanes == 32) &&
      nv <= lanes * cols(lanes) && envs_per_block >= 1 &&
      envs_per_block * lanes <= kWarpLanes && panel >= nefc * nv &&
      panel % (16 / sizeof(T)) == 0 &&
      env_stride >= 2 * panel + (kRec + 1) * nefc + kPair * npairs +
                        (lanes * cols(lanes) - nv) &&
      env_stride % (16 / sizeof(T)) == 0 &&
      static_cast<size_t>(smem) >=
          static_cast<size_t>(envs_per_block) * env_stride * sizeof(T);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel<T> kernel = kernel_for<T>(lanes, nv);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t P = static_cast<size_t>(nefc) * nv;
  const int bulk = (P * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(J) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(U) % 16 == 0;
  const int blocks = (N + envs_per_block - 1) / envs_per_block;
  kernel<<<blocks, kWarpLanes, smem, stream>>>(
      J, U, b, R, lo, hi, f, N, nefc, nv, iterations, noslip, ns_offset,
      envs_per_block, panel, env_stride, bulk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int lanes, int nv, int smem, int* blocks) {
  const Kernel<T> kernel = kernel_for<T>(lanes, nv);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kWarpLanes, smem);
  return static_cast<int>(e);
}

}  // namespace

extern "C" int pgs_f32(const float* J, const float* U, const float* b,
                       const float* R, const float* lo, const float* hi,
                       float* f, int N, int nefc, int nv, int iterations,
                       int noslip, int ns_offset, int lanes,
                       int envs_per_block, int panel, int env_stride,
                       int smem, void* stream) {
  return launch<float>(J, U, b, R, lo, hi, f, N, nefc, nv, iterations, noslip,
                       ns_offset, lanes, envs_per_block, panel, env_stride,
                       smem, static_cast<cudaStream_t>(stream));
}

extern "C" int pgs_f64(const double* J, const double* U, const double* b,
                       const double* R, const double* lo, const double* hi,
                       double* f, int N, int nefc, int nv, int iterations,
                       int noslip, int ns_offset, int lanes,
                       int envs_per_block, int panel, int env_stride,
                       int smem, void* stream) {
  return launch<double>(J, U, b, R, lo, hi, f, N, nefc, nv, iterations,
                        noslip, ns_offset, lanes, envs_per_block, panel,
                        env_stride, smem, static_cast<cudaStream_t>(stream));
}

// Blocks of the kernel that one SM holds at once for (lanes, nv, element
// size) with `smem` bytes of dynamic shared memory each, into *blocks.
extern "C" int pgs_blocks_per_sm(int lanes, int nv, int itemsize, int smem,
                                 int* blocks) {
  return itemsize == 4 ? blocks_per_sm<float>(lanes, nv, smem, blocks)
                       : blocks_per_sm<double>(lanes, nv, smem, blocks);
}
