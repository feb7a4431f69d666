// Batched matrix-free box-PGS with the noslip post-pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nightmare_rl_tpu/ops/pgs.py::_kernel,
// launched by pgs_solve (pl.pallas_call).  Same contract as that kernel and
// as its plain reference _scan_core: for every env, starting from f = 0 and
// w = M^-1 J^T f = 0,
//   `iterations` sweeps over rows r = 0..nefc-1 in ascending order:
//       g = J[r].w + b[r] + R[r] f[r]
//       f[r] <- clip(f[r] - g / max(diag[r] + R[r], 1e-12), lo[r], hi[r])
//       w += U[r] * (change of f[r])
//   then `noslip` sweeps over the +/- facet pairs (i, i+1) from ns_offset,
//   each pair updated with its pair sum frozen, only where hi[i] > 0.
// diag = sum(J * U) and the pair off-diagonals A[i, i+1] = J[i].U[i+1] are
// computed in the prologue, so one launch does the whole solve.
//
// What bounds it on an H100.  Per env the solve is a serial chain of
// dependent row steps: 3 * 112 + 4 * 56 = 560 on the hexapod's main path,
// each a dot product reduced across the row, a clip, and a rank-1 update
// that the next row reads.  The bytes are J and U, 2 * 112 * 24 * 4 B per
// env in float32: about 44 MB per launch at N = 2048, 13 us at 3.35 TB/s.
// The arithmetic (about 2 * nefc * nv MACs per sweep) is negligible.  So the
// chain's latency bounds each env, and the card's width has to come from
// running many envs at once.
//
// What the design does about it:
//   * one warp per env, kWarpsPerBlock envs per block: all 2048 envs of the
//     main path are resident on the 132 SMs at once, and the scheduler
//     hides one warp's chain latency behind the others';
//   * lanes own the nv columns (strided when nv > 32), and w lives in
//     registers, so a row step is one coalesced load of J[r] and U[r]
//     (rows are contiguous in the (N, nefc, nv) layout), one butterfly
//     shuffle reduction and one fused update, with no shared-memory
//     traffic for w;
//   * f, b, R, lo, hi, 1/(diag+R), diag and the pair off-diagonals sit in
//     shared memory, read as broadcasts;
//   * U[r] is loaded before the reduction for J[r].w starts, so its load
//     overlaps the shuffle chain.
// J and U are read from global memory on every sweep (they stay in L1/L2
// after the first); staging them in shared memory is left for later work.
//
// Rounding: the butterfly reduction sums a row's products in another order
// than the CPU's sequential sum, and nvcc contracts multiply-adds to FMAs.
// Every lane ends the butterfly with the same value (IEEE addition is
// commutative), so all lanes take the same clip branch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxColsPerLane = 4;  // nv <= 128
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
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

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
pgs_kernel(const T* __restrict__ J, const T* __restrict__ U,
           const T* __restrict__ b, const T* __restrict__ R,
           const T* __restrict__ lo, const T* __restrict__ hi,
           T* __restrict__ f_out, int N, int nefc, int nv, int iterations,
           int noslip, int ns_offset) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kWarpsPerBlock + warp;
  if (env >= N) return;  // whole warp leaves together

  const int npairs = noslip > 0 ? (nefc - ns_offset) / 2 : 0;
  const int stride = 7 * nefc + (npairs > 0 ? npairs : 0);
  T* f = reinterpret_cast<T*>(smem_raw) + warp * stride;
  T* sb = f + nefc;
  T* sR = sb + nefc;
  T* slo = sR + nefc;
  T* shi = slo + nefc;
  T* sinv = shi + nefc;
  T* sdiag = sinv + nefc;
  T* sAij = sdiag + nefc;

  const T* Je = J + static_cast<size_t>(env) * nefc * nv;
  const T* Ue = U + static_cast<size_t>(env) * nefc * nv;
  const size_t voff = static_cast<size_t>(env) * nefc;
  for (int r = lane; r < nefc; r += 32) {
    f[r] = T(0);
    sb[r] = b[voff + r];
    sR[r] = R[voff + r];
    slo[r] = lo[voff + r];
    shi[r] = hi[voff + r];
  }

  // prologue: diag[r] = J[r].U[r], A[i, i+1] = J[i].U[i+1]
  for (int r = 0; r < nefc; ++r) {
    T acc = T(0);
    for (int c = lane; c < nv; c += 32) acc += Je[r * nv + c] * Ue[r * nv + c];
    acc = warp_sum(acc);
    if (lane == 0) sdiag[r] = acc;
  }
  for (int p = 0; p < npairs; ++p) {
    const int i = ns_offset + 2 * p;
    T acc = T(0);
    for (int c = lane; c < nv; c += 32)
      acc += Je[i * nv + c] * Ue[(i + 1) * nv + c];
    acc = warp_sum(acc);
    if (lane == 0) sAij[p] = acc;
  }
  __syncwarp();
  for (int r = lane; r < nefc; r += 32)
    sinv[r] = T(1) / at_least(sdiag[r] + sR[r], T(1e-12));
  __syncwarp();

  T w[kMaxColsPerLane];
#pragma unroll
  for (int k = 0; k < kMaxColsPerLane; ++k) w[k] = T(0);

  for (int it = 0; it < iterations; ++it) {
    for (int r = 0; r < nefc; ++r) {
      T u[kMaxColsPerLane];
      T jw = T(0);
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) {
        const int c = lane + 32 * k;
        u[k] = c < nv ? Ue[r * nv + c] : T(0);
        if (c < nv) jw += Je[r * nv + c] * w[k];
      }
      jw = warp_sum(jw);
      const T fr = f[r];
      const T g = jw + sb[r] + sR[r] * fr;
      const T nw = clip(fr - g * sinv[r], slo[r], shi[r]);
      const T d = nw - fr;
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) w[k] += u[k] * d;
      __syncwarp();  // every lane has read f[r]
      if (lane == 0) f[r] = nw;
      __syncwarp();
    }
  }

  for (int s = 0; s < noslip && npairs > 0; ++s) {
    for (int p = 0; p < npairs; ++p) {
      const int i = ns_offset + 2 * p;
      const int j = i + 1;
      T ui[kMaxColsPerLane], uj[kMaxColsPerLane];
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k) {
        const int c = lane + 32 * k;
        ui[k] = c < nv ? Ue[i * nv + c] : T(0);
        uj[k] = c < nv ? Ue[j * nv + c] : T(0);
        if (c < nv) acc += (Je[i * nv + c] - Je[j * nv + c]) * w[k];
      }
      acc = warp_sum(acc);
      const T fi0 = f[i];
      const T fj0 = f[j];
      const T g = acc + sb[i] - sb[j];
      const T h = sdiag[i] + sdiag[j] - T(2) * sAij[p];
      const T tot = fi0 + fj0;
      T y = T(0.5) * (fi0 - fj0) - g / at_least(h, T(1e-12));
      y = clip(y, T(-0.5) * tot, T(0.5) * tot);
      const bool ok = shi[i] > T(0);
      const T fi = ok ? T(0.5) * tot + y : fi0;
      const T fj = ok ? T(0.5) * tot - y : fj0;
#pragma unroll
      for (int k = 0; k < kMaxColsPerLane; ++k)
        w[k] = w[k] + ui[k] * (fi - fi0) + uj[k] * (fj - fj0);
      __syncwarp();
      if (lane == 0) {
        f[i] = fi;
        f[j] = fj;
      }
      __syncwarp();
    }
  }

  for (int r = lane; r < nefc; r += 32) f_out[voff + r] = f[r];
}

template <typename T>
int launch(const T* J, const T* U, const T* b, const T* R, const T* lo,
           const T* hi, T* f, int N, int nefc, int nv, int iterations,
           int noslip, int ns_offset, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (nv > 32 * kMaxColsPerLane || nefc <= 0 || ns_offset < 0 ||
      ns_offset > nefc)
    return static_cast<int>(cudaErrorInvalidValue);
  const int npairs = noslip > 0 ? (nefc - ns_offset) / 2 : 0;
  const size_t smem =
      static_cast<size_t>(kWarpsPerBlock) * (7 * nefc + npairs) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pgs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pgs_kernel<T><<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      J, U, b, R, lo, hi, f, N, nefc, nv, iterations, noslip, ns_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pgs_f32(const float* J, const float* U, const float* b,
                       const float* R, const float* lo, const float* hi,
                       float* f, int N, int nefc, int nv, int iterations,
                       int noslip, int ns_offset, void* stream) {
  return launch<float>(J, U, b, R, lo, hi, f, N, nefc, nv, iterations, noslip,
                       ns_offset, static_cast<cudaStream_t>(stream));
}

extern "C" int pgs_f64(const double* J, const double* U, const double* b,
                       const double* R, const double* lo, const double* hi,
                       double* f, int N, int nefc, int nv, int iterations,
                       int noslip, int ns_offset, void* stream) {
  return launch<double>(J, U, b, R, lo, hi, f, N, nefc, nv, iterations,
                        noslip, ns_offset, static_cast<cudaStream_t>(stream));
}
