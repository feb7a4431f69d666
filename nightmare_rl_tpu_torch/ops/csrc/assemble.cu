// Collision and constraint-row assembly of a physics substep, for Hopper
// (sm_90a): one launch per substep computes, for every env, the candidate
// points against the ground plane, the top-K deepest condim-3 points, the
// top-Kp deepest sphere pairs, every constraint row (J, aref, R, bounds),
// b = J qacc_smooth - aref, the rows' leg slots (PGS models with a
// block-arrow layout) and the Newton solve's row flags and cone
// coefficients (Newton models).
//
// The counterpart of the JAX package's compiled step between the smooth
// half and the solve (nightmare_rl_tpu/physics/pipeline.py:84-94,
// collision.py:57-131, solver.py:52-292 and 529-686), which XLA fuses into
// a few fusions of the vmapped step; the JAX package has no Pallas kernel
// for it.  Eagerly, the port's plain version (ops/assemble.py::plain) is
// ~300 small launches per nightmare_v3 substep and ~1,000 per anymal_c
// substep.  The arithmetic is assemble_env.cuh's, which the CPU tests also
// run through the host driver csrc/assemble_host.cpp.
//
// What bounds it on an H100.  The bytes: per nightmare_v3 env it reads the
// frames, subtree coms and motion axes of the smooth kernel (~340 values)
// and writes J (112 x 24) and ~10 values per row, ~4,100 values, ~35 MB at
// 2048 envs in float32, ~11 us at 3.35 TB/s (chip_smoke.py's
// assemble-kernel phase counts them exactly).  The operations, ~20 k per env (the 375 pair distances, the
// ranks, J's columns and the row products), are ~1 us at 67 TFLOP/s.
//
// The design: one warp per env, up to eight envs a block, as many as let
// the most envs reside on an SM (ops/assemble.py::geometry); the model's
// tables (point bodies, offsets, radii, friction, solref, solimp,
// invweight, the point->leg map, the body-dof mask, the pair index lists
// and the row owners) staged in shared memory once per block; the
// per-pair constants read from global memory for the Kp selected pairs
// only (anymal_c's 1,566 pairs would take ~63 KB of shared memory a
// block); the points' centers and distances in shared memory as four
// arrays (a lane's pair reads them without bank conflicts where the pair
// list runs over consecutive points); the selections on integer sort
// keys, the condim-3 points ranked four a lane at once, the pairs' lists
// merged two by two; J written straight to its output, a lane per (row
// owner, dof), each warp-wide store a run of one row, then read back a
// lane per row for J qvel and J qacc.  The first design staged J in shared
// memory (14 envs an SM, two waves at 2048) and ranked every listed pair
// against all the others: 93 us an env, 54 of them in that rank
// (tools/profile_assemble.py --timeline).  No fast math and no FMA
// contraction: the plain version's rounding, op for op, so that the
// selections agree with it wherever two distances are not within a
// rounding of each other.

#include <cuda_runtime.h>

#include <cstring>

#include "assemble_env.cuh"
#include "launch.cuh"

namespace {

using assemble_env::AssembleArgs;
using assemble_env::Layout;

// Bytes of shared memory that a block's copy of the tables takes: the
// constants, then the topology, each padded to 16 bytes
// (ops/assemble.py::table_bytes).
__host__ __device__ inline int table_bytes(const Layout& L, int itemsize) {
  return (L.ncst * itemsize + 15) / 16 * 16 + (L.ntopo * 4 + 15) / 16 * 16;
}
constexpr int kMaxEnvsPerBlock = 8;

// Built with -DASSEMBLE_TIMELINE (tools/profile_assemble.py --timeline),
// lane 0 of the warp of each of the first kTimelineEnvs envs stamps the
// card's global timer (ns) at the ends of assemble_one's phases into
// g_timeline; otherwise a stamp is nothing.
#ifdef ASSEMBLE_TIMELINE
constexpr int kTimelineEnvs = 8192, kStamps = assemble_env::kAssembleStamps;
__device__ long long g_timeline[2 * kTimelineEnvs * kStamps];
#endif

template <typename T>
__global__ void __launch_bounds__(common::kLanes * kMaxEnvsPerBlock)
    assemble_kernel(const __grid_constant__ AssembleArgs<T> a,
                    int envs_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cst = reinterpret_cast<T*>(smem_raw);
  int* topo = reinterpret_cast<int*>(smem_raw +
                                     (a.L.ncst * sizeof(T) + 15) / 16 * 16);
  for (int i = threadIdx.x; i < a.L.ncst; i += blockDim.x) cst[i] = a.cst[i];
  for (int i = threadIdx.x; i < a.L.ntopo; i += blockDim.x)
    topo[i] = a.topo[i];
  __syncthreads();
  const int warp = threadIdx.x / common::kLanes;
  const int n = blockIdx.x * envs_per_block + warp;
  if (n >= a.N) return;
  T* ws = reinterpret_cast<T*>(smem_raw + table_bytes(a.L, sizeof(T)));
  int* wi = reinterpret_cast<int*>(ws + static_cast<size_t>(envs_per_block) *
                                            a.L.w_elems);
  ws += static_cast<size_t>(warp) * a.L.w_elems;
  wi += static_cast<size_t>(warp) * a.L.i_elems;
#ifdef ASSEMBLE_TIMELINE
  const common::StampedWarpTeam<kStamps, kTimelineEnvs> tm{{}, g_timeline, n};
  assemble_env::assemble_one(tm, a, n, ws, wi, topo, cst);
#else
  assemble_env::assemble_one(common::WarpTeam{}, a, n, ws, wi, topo, cst);
#endif
}

template <typename T>
int launch(const int* layout, int nlayout, const int* topo, const T* cst,
           const T* pcst, const T* const* ins, int nins, void* const* outs,
           int nouts, int N, int envs_per_block, int smem,
           cudaStream_t stream) {
  if (nlayout != assemble_env::kLayoutInts || nins != 7 ||
      nouts != assemble_env::kNumOuts)
    return static_cast<int>(cudaErrorInvalidValue);
  AssembleArgs<T> a;
  std::memcpy(&a.L, layout, sizeof(Layout));
  a.topo = topo;
  a.cst = cst;
  a.pcst = pcst;
  a.xpos = ins[0];
  a.xquat = ins[1];
  a.subtree_com = ins[2];
  a.cdof = ins[3];
  a.qpos = ins[4];
  a.qvel = ins[5];
  a.qacc = ins[6];
  for (int k = 0; k < assemble_env::kNumOuts; ++k) a.out[k] = outs[k];
  a.N = N;
  if (N <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock ||
      a.L.w_elems <= 0 || a.L.i_elems <= 0 || a.L.Kp > assemble_env::kMaxPairs ||
      static_cast<size_t>(smem) <
          static_cast<size_t>(table_bytes(a.L, sizeof(T))) +
              static_cast<size_t>(envs_per_block) *
                  (a.L.w_elems * sizeof(T) + a.L.i_elems * sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(assemble_kernel<T>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + envs_per_block - 1) / envs_per_block;
  assemble_kernel<T><<<blocks, common::kLanes * envs_per_block, smem,
                       stream>>>(a, envs_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The Layout's field names, comma-separated, in order.
extern "C" const char* assemble_layout_names() {
  return assemble_env::kLayoutNames;
}

#define ASSEMBLE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const int* layout, int nlayout, const int* topo,       \
                      const T* cst, const T* pcst, const T* const* ins,      \
                      int nins, void* const* outs, int nouts, int N,         \
                      int envs_per_block, int smem, void* stream) {          \
    return launch<T>(layout, nlayout, topo, cst, pcst, ins, nins, outs,      \
                     nouts, N, envs_per_block, smem,                         \
                     static_cast<cudaStream_t>(stream));                     \
  }

ASSEMBLE_ENTRY(assemble_f32, float)
ASSEMBLE_ENTRY(assemble_f64, double)

#ifdef ASSEMBLE_TIMELINE
// The stamps of the last launch's first envs (kStamps per env) into out[n]
// on the host: the global timer's (ns) with cycles 0, the SM's cycle
// counter's with cycles 1.
extern "C" int assemble_timeline(long long* out, int n, int cycles) {
  if (n > kTimelineEnvs * kStamps) n = kTimelineEnvs * kStamps;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_timeline, static_cast<size_t>(n) * sizeof(long long),
      cycles ? sizeof(long long) * kTimelineEnvs * kStamps : 0));
}

// Stamps per env.
extern "C" int assemble_timeline_stamps() { return kStamps; }
#endif

// Blocks of the kernel one SM holds at once with `smem` bytes of dynamic
// shared memory and `envs_per_block` warps each, into *blocks.
extern "C" int assemble_blocks_per_sm(int itemsize, int envs_per_block,
                                      int smem, int* blocks) {
  const void* kernel =
      itemsize == 4 ? reinterpret_cast<const void*>(assemble_kernel<float>)
                    : reinterpret_cast<const void*>(assemble_kernel<double>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, common::kLanes * envs_per_block, smem);
  return static_cast<int>(e);
}
