// The learning half of a PPO iteration, for Hopper (sm_90a): `gae` once an
// iteration (GAE's recursion, the returns and the mean advantage), `grads`
// once a minibatch (the feed-forward actor-critic's forward pass over the
// minibatch's rows gathered from the trajectory, the PPO loss, its
// backward pass, every gradient and the KL into the flat buffer the ranks
// reduce, the losses) and `adam` once a minibatch (the mean over the ranks,
// the adaptive learning rate, the clip by global norm and Adam's step),
// each instantiated per dtype.
//
// The counterpart of the JAX package's compiled update (_gae's lax.scan,
// nightmare_rl_tpu/rl/ppo.py:187-203; minibatch_step's value_and_grad of
// loss_fn and the optax chain with _adapt_lr, :100-103, :244-255,
// :323-359), which XLA fuses inside lax.scan; the JAX package has no
// Pallas kernel for it.  Eagerly, the port's plain versions (ops/learn.py:
// GAE's loop over the steps, cuBLAS products, autograd's backward,
// torch's fused Adam and the clip's ops) are ~820 launches for GAE and
// ~360 a minibatch (tools/profile_learn.py).  The arithmetic is learn_env.cuh's, which the CPU
// tests also run through the host driver csrc/learn_host.cpp.
//
// What bounds it on an H100.  grads, per sample of nightmare_v3's net (66
// observations, [54, 42, 30] hidden units, 18 actions, the actor and the
// critic): ~14.8k multiply-adds forward, as many for the weight gradients
// and ~7.6k for the deltas, ~3.0 GFLOP a minibatch of 40,960 samples,
// ~45 us at 67 TFLOP/s in float32 outside the tensor cores (the port's
// nets run in full float32: no TF32); its bytes, the rows gathered and
// the gradients written, ~20.6 MB, ~6 us at 3.35 TB/s.  gae moves ~2.8 MB
// (~0.8 us).  adam moves ~32 bytes a parameter (the gradients, both moments
// and the parameters read and written): ~0.48 MB (~0.14 us) for
// nightmare_v3's 15,043 parameters, where two dependent launches and their
// DRAM round trips bound it, and ~78 MB (~23 us) for the recurrent net's
// 2,434,795, where the bytes do: a design in one block ran 40 us and
// 5.4 ms (one SM's loads in flight), so adam spreads over the card.
//
// The design.  grads: the grid's blocks split into the actor's and the
// critic's (the loss's gradient reaches each net through its own head), one
// block of each per SM, 256 threads each; a block stages its net's weights
// transposed (Wt[k][j], rows of n_out rounded up to 4) in shared memory once
// and walks its share of the minibatch in tiles of kTile = 64 samples.  The
// tile's rows lie feature-major ([feature][sample], 16-byte rows of 68
// words, 4 (mod 32): the rows of eight consecutive features start on
// distinct banks), so every product reads its operands as 16-byte vectors:
// the forward pass a 4 x 4 tile of (outputs, samples) per item (a vector of
// Wt's row k, a vector of x's), the weight gradients 4 outputs x 4 inputs
// summed over the samples four at a time (the inputs' rows kt, kt + nkt,
// ...: a quarter warp's on distinct banks), the deltas 4 inputs x 4
// samples; FP32 FMA, no tensor core (the port's nets run in full float32).
// The activation's derivative comes from its output (with z's sign, a bit
// a sample, where ELU's or LeakyReLU's parameter is below 0 and the output
// is above 0 on both sides), and a layer's deltas overwrite its outputs
// once its weight gradients have read them: only x, the hidden outputs and
// the head stay.  The loss stage is three phases: a member an (action,
// sample) for the log-probability's and KL's terms, a member a sample for
// their sums (in the actions' order), the ratio and the clipped surrogate,
// a member an (action, sample) for d/dmu and d/dstd.
// While a tile computes, the next one's indices, loss rows and
// observations are in flight (cp.async, 8-byte copies where a row allows;
// the observations as they lie into rows the last backward phase no
// longer reads, laid out into x after it).  A block adds each tile's
// gradients to its row of the scratch (L2), the last block of a
// group (an integer ticket) adds its group's rows in block order, the last
// group of each net adds the groups' rows in order into the flat buffer,
// and the later of the two nets writes the losses: no float atomics, so a
// replay equals the eager call bit for bit.  gae: a thread an env, its sum
// by lane and a fixed tree, the blocks' sums by the last block.  adam: each
// tensor cut into chunks of kAdamChunk = 1,024 elements, a block of 256
// threads a chunk, 4 consecutive elements a thread (16-byte loads where
// the address allows, 8-byte in float32 where it is 8-byte aligned: the
// recurrent net's big tensors sit at flat offsets of 2 mod 4), in two
// launches.  Phase A sums each chunk's squares by lane and a fixed tree
// and takes its tensors' bias corrections; the last block (an integer
// ticket) adds the chunks' sums in chunk order, the norm and the lr.
// Phase B, launched as A's programmatic dependent, loads its chunk's four
// operands while A runs (A writes none of them), waits for A's end, and
// writes the step.  Each element is read and written by one thread of
// each phase, and B stores only after A has ended: race-free; the sums'
// order depends on the tensors' sizes alone, so every grid and team gives
// the same bits.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "learn_env.cuh"

namespace {

using common::BlockTeam;
using learn_env::AdamArgs;
using learn_env::GaeArgs;
using learn_env::GradsArgs;

constexpr int kGradsThreads = 256;
// launch_grads' return code for tiles whose shared memory is above the
// card's opt-in limit (ops/learn.py SMEM_ABOVE_LIMIT: a ValueError)
constexpr int kSmemAboveLimit = -1;

// Whether this block is the last of `n` to arrive at `counter` (the
// block's stores made visible to the grid first); the last resets it.
__device__ bool last_to_arrive(int* counter, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == n - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <typename T>
__global__ void __launch_bounds__(learn_env::kGaeLanes)
    learn_gae_kernel(const __grid_constant__ GaeArgs<T> a) {
  __shared__ T lanes[learn_env::kGaeLanes];
  learn_env::gae_block(BlockTeam{}, a, blockIdx.x, lanes);
  if (last_to_arrive(a.counter, gridDim.x))
    learn_env::gae_final(BlockTeam{}, a);
}

// Built with -DLEARN_TIMELINE (tools/profile_learn.py --timeline), thread 0
// of each of the first kTimelineBlocks blocks of grads and adam stamps the
// card's global timer (ns) and its SM's cycle counter at learn_env's Stamp
// points into g_timeline (row: the block); otherwise a stamp is nothing.
#ifdef LEARN_TIMELINE
constexpr int kTimelineBlocks = 1024, kStamps = learn_env::kStamps;
__device__ long long g_timeline[2 * kTimelineBlocks * kStamps];
using Team = common::StampedBlockTeam<kStamps, kTimelineBlocks>;
__device__ Team team_of(int blk) { return Team{{}, g_timeline, blk}; }
#else
using Team = BlockTeam;
__device__ Team team_of(int) { return Team{}; }
#endif

template <typename T>
__global__ void __launch_bounds__(kGradsThreads, 2)
    learn_grads_kernel(const __grid_constant__ GradsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int blk = static_cast<int>(blockIdx.x);
  const Team tm = team_of(blk);
  learn_env::grads_block(tm, a, blk, reinterpret_cast<T*>(smem));
  const int k = blk < a.blocks[0] ? 0 : 1;
  const int b = k == 0 ? blk : blk - a.blocks[0];
  const int g = b / a.group;
  const int in_group = min(a.group, a.blocks[k] - g * a.group);
  if (!last_to_arrive(a.counters + k * a.groups[0] + g, in_group)) return;
  learn_env::grads_group(tm, a, k, g);
  tm.sync();
  tm.stamp(learn_env::kStampGroup);
  int* const net = a.counters + a.groups[0] + a.groups[1];
  if (!last_to_arrive(net + k, a.groups[k])) return;
  learn_env::grads_final(tm, a, k);
  if (!last_to_arrive(net + 2, 2)) return;
  learn_env::grads_losses(tm, a);
  tm.sync();
  tm.stamp(learn_env::kStampFinal);
}

// adam's phase A: the bias corrections and the chunks' sums of squares,
// then the last block's norm and lr; phase B, its programmatic dependent
// (launch_adam): the step.  Every block of phase A lets phase B's blocks
// launch as soon as it starts: they load their operands, which phase A does
// not write, and wait for its end before they read its results and store.
template <typename T>
__global__ void __launch_bounds__(learn_env::kAdamThreads)
    learn_adam_sums_kernel(const __grid_constant__ AdamArgs<T> a) {
  __shared__ T lanes[learn_env::kAdamThreads];
  asm volatile("griddepcontrol.launch_dependents;");
  const int blk = static_cast<int>(blockIdx.x);
  const Team tm = team_of(blk);
  learn_env::adam_sums(tm, a, blk, lanes);
  if (last_to_arrive(a.counter, gridDim.x))
    learn_env::adam_final(tm, a, lanes);
}

template <typename T>
__global__ void __launch_bounds__(learn_env::kAdamThreads)
    learn_adam_step_kernel(const __grid_constant__ AdamArgs<T> a) {
  const int blk = static_cast<int>(blockIdx.x);
  learn_env::adam_step(team_of(blk), a, blk);
}

template <typename T>
int launch_gae(const int* ints, int nints, const double* reals, int nreals,
               const void* const* ptrs, int nptrs, cudaStream_t stream) {
  GaeArgs<T> a;
  if (!learn_env::read_gae(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  learn_gae_kernel<T><<<a.blocks, learn_env::kGaeLanes, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grads(const int* ints, int nints, const double* reals, int nreals,
                 const void* const* ptrs, int nptrs, cudaStream_t stream) {
  GradsArgs<T> a;
  if (!learn_env::read_grads(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = learn_env::grads_smem_elems(a) * static_cast<int>(sizeof(T));
  const void* kernel = reinterpret_cast<const void*>(learn_grads_kernel<T>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e != cudaSuccess) {
    int device = 0, limit = 0;
    if (cudaGetDevice(&device) == cudaSuccess &&
        cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device) == cudaSuccess &&
        smem > limit) {
      cudaGetLastError();  // the refused attribute's error, not a launch's
      return kSmemAboveLimit;
    }
    return static_cast<int>(e);
  }
  learn_grads_kernel<T><<<a.blocks[0] + a.blocks[1], kGradsThreads, smem,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adam(const int* ints, int nints, const double* reals, int nreals,
                const void* const* ptrs, int nptrs, cudaStream_t stream) {
  AdamArgs<T> a;
  if (!learn_env::read_adam(ints, nints, reals, nreals, ptrs, nptrs, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  learn_adam_sums_kernel<T><<<a.blocks, learn_env::kAdamThreads, 0,
                              stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks);
  cfg.blockDim = dim3(learn_env::kAdamThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, learn_adam_step_kernel<T>, a));
}

}  // namespace

// The blocks' field names, comma-separated, in order.
#define LEARN_NAMES_ENTRY(NAME, S)                                            \
  extern "C" const char* NAME() { return learn_env::S; }
LEARN_NAMES_ENTRY(learn_gae_int_names, kGaeIntNames)
LEARN_NAMES_ENTRY(learn_gae_real_names, kGaeRealNames)
LEARN_NAMES_ENTRY(learn_gae_ptr_names, kGaePtrNames)
LEARN_NAMES_ENTRY(learn_grads_int_names, kGradsIntNames)
LEARN_NAMES_ENTRY(learn_grads_real_names, kGradsRealNames)
LEARN_NAMES_ENTRY(learn_grads_ptr_names, kGradsPtrNames)
LEARN_NAMES_ENTRY(learn_adam_int_names, kAdamIntNames)
LEARN_NAMES_ENTRY(learn_adam_real_names, kAdamRealNames)
LEARN_NAMES_ENTRY(learn_adam_ptr_names, kAdamPtrNames)

// grads' shared memory per block in bytes (0 for arguments it does not
// take).
#define LEARN_SMEM_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const int* ints, int nints, const double* reals,       \
                      int nreals, const void* const* ptrs, int nptrs) {      \
    GradsArgs<T> a;                                                           \
    if (!learn_env::read_grads(ints, nints, reals, nreals, ptrs, nptrs, &a))  \
      return 0;                                                               \
    return learn_env::grads_smem_elems(a) * static_cast<int>(sizeof(T));      \
  }

#define LEARN_ENTRY(NAME, FN, T)                                              \
  extern "C" int NAME(const int* ints, int nints, const double* reals,       \
                      int nreals, const void* const* ptrs, int nptrs,        \
                      void* stream) {                                         \
    return FN<T>(ints, nints, reals, nreals, ptrs, nptrs,                    \
                 static_cast<cudaStream_t>(stream));                          \
  }

LEARN_ENTRY(learn_gae_f32, launch_gae, float)
LEARN_ENTRY(learn_gae_f64, launch_gae, double)
LEARN_ENTRY(learn_grads_f32, launch_grads, float)
LEARN_ENTRY(learn_grads_f64, launch_grads, double)
LEARN_ENTRY(learn_adam_f32, launch_adam, float)
LEARN_ENTRY(learn_adam_f64, launch_adam, double)
LEARN_SMEM_ENTRY(learn_grads_smem_f32, float)
LEARN_SMEM_ENTRY(learn_grads_smem_f64, double)

// Blocks of grads one SM holds at once with `smem` bytes of dynamic shared
// memory each, into *blocks.
extern "C" int learn_grads_blocks_per_sm(int itemsize, int smem,
                                         int* blocks) {
  const void* kernel =
      itemsize == 4 ? reinterpret_cast<const void*>(learn_grads_kernel<float>)
                    : reinterpret_cast<const void*>(learn_grads_kernel<double>);
  cudaError_t e = common::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kGradsThreads, smem);
  return static_cast<int>(e);
}

#ifdef LEARN_TIMELINE
// The stamps of the last launch's first blocks (kStamps a block) into
// out[n] on the host: the global timer's (ns) with cycles 0, the SM's
// cycle counter's with cycles 1; learn_timeline_clear zeroes them first.
extern "C" int learn_timeline(long long* out, int n, int cycles) {
  if (n > kTimelineBlocks * kStamps) n = kTimelineBlocks * kStamps;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_timeline, static_cast<size_t>(n) * sizeof(long long),
      cycles ? sizeof(long long) * kTimelineBlocks * kStamps : 0));
}
extern "C" int learn_timeline_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_timeline);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_timeline));
  return static_cast<int>(e);
}
// Stamps a block, and their names, comma-separated.
extern "C" int learn_timeline_stamps() { return kStamps; }
extern "C" const char* learn_timeline_names() { return learn_env::kStampNames; }
#endif
