// The learning half of a PPO iteration, written once for the CUDA kernels
// (csrc/learn.cu, a block of threads as the team) and for the host driver
// (csrc/learn_host.cpp, a team of host threads), which the CPU tests hold
// against the plain versions (ops/learn.py) and the JAX package.
//
// gae_block walks GAE's recursion backwards in time, one env a lane, and
// writes the advantages and returns (T, N); gae_final sums the blocks'
// partial sums into the mean advantage.  They port the JAX package's _gae
// scan (nightmare_rl_tpu/rl/ppo.py:187-203).
//
// grads_block computes, for the samples of a minibatch that a block owns
// (rows idx of the (T·N, ·) trajectory, gathered a tile ahead), the
// feed-forward actor's or critic's forward pass, the per-sample gradients
// of the PPO loss (the clipped surrogate and the log-probability through
// the actor and the std, the clipped value loss through the critic), their
// backward pass, and sums the weight, bias and std gradients and the loss
// terms over its samples into its row of the scratch; grads_group,
// grads_final and grads_losses sum the blocks' rows over the grid and write
// every gradient and the KL into the flat buffer and (loss, surrogate,
// value loss) into the losses.  They port the JAX update's value_and_grad
// of loss_fn (nightmare_rl_tpu/rl/ppo.py:339-348, _loss_terms :222-242,
// models/actor_critic.py:133-159).
//
// adam divides the flat buffer (the gradients and, last, the KL, summed
// over the ranks) by the world, sets the adaptive learning rate from the
// KL, clips the gradients by their global norm (optax's rule) and takes
// Adam's step on every parameter tensor (torch's fused Adam's formula),
// counting each tensor's step, in fixed chunks of each tensor: adam_sums
// sums a block's chunks' squares (and takes its tensors' bias
// corrections), adam_final (the last block) the chunks' sums, the norm and
// the lr, and adam_step takes a block's chunks' step.  It ports the optax
// chain and _adapt_lr (nightmare_rl_tpu/rl/ppo.py:100-103, :244-255,
// :349-359).
//
// The team contract is rollout_env.cuh's: rank(), size(), sync(),
// copy(dst, src) and copy_wait(), and stamp(k) (a timer stamp, nothing but
// in a timeline build).  Work is split by index, and every sum runs in an
// order that does not depend on the team's size: a product's element sums
// its terms in ascending order; the gradients of a block's tile of samples
// are summed over the tile, then added to the block's sums tile by tile;
// the grid's partial sums are added group by group in block order, then
// the groups in order; the GAE sums and each of adam's chunks' and the
// chunks' sums (in chunk order) run over a fixed number of virtual lanes,
// then a fixed tree: the order depends on the tensors' sizes alone, never
// on the grid's or the team's.  No float atomics: a replay gives the eager
// call's bits.

#pragma once

#include <math.h>
#include <stdint.h>

#include "rollout_env.cuh"

#ifdef __CUDACC__
#define LEARN_HD __host__ __device__ __forceinline__
#else
#define LEARN_HD inline
#endif

namespace learn_env {

using rollout_env::activate;
using rollout_env::is_nan;
using rollout_env::kMaxLayers;
using rollout_env::Layer;
using rollout_env::mul_rn;
using rollout_env::odd_ld;

constexpr int kGaeLanes = 256;    // envs of a gae block, its lanes
constexpr int kGaeAhead = 8;      // steps of an env's loads issued at once
// grads' samples a tile (a multiple of 32), and a feature-major row's
// length in shared memory: 16-byte rows at 4 (mod 32) words, so that the
// rows of eight consecutive features start on distinct banks.
constexpr int kTile = 64;
constexpr int kLd = kTile + 4;
// grads' register tiles (members' items; the products' vector loads are 4
// elements, 16 bytes in float32): the forward pass kFwdJ outputs by kFwdS
// samples, the deltas kDxK inputs by kDxS samples, the weight gradients
// kDwJ outputs by kDwK inputs (kFwdJ, kFwdS and kDxS multiples of 4).
// Every shape gives the same bits (an element sums its terms in order).
constexpr int kFwdJ = 4, kFwdS = 4;
constexpr int kDxK = 4, kDxS = 4;
constexpr int kDwJ = 4, kDwK = 4;
// For ELU's and LeakyReLU's parameter below 0 (GradsArgs::neg), z > 0 of
// each hidden output: a byte for 4 samples (bit u: sample 4 q + u), kQuads
// bytes a feature.
constexpr int kQuads = kTile / 4;
// adam's chunks: a tensor's elements from its start in chunks of
// kAdamChunk, a block's kAdamThreads members (its lanes) 4 consecutive
// elements each.
constexpr int kAdamThreads = 256;
constexpr int kAdamChunk = 4 * kAdamThreads;
constexpr int kMaxTensors = 64;   // adam's parameter tensors at most
constexpr int kMaxTeam = 64;      // host team members at most

// The stamps of grads' and adam's timelines (csrc/learn.cu built with
// -DLEARN_TIMELINE, tools/profile_learn.py --timeline): the team's stamp(k)
// at the end of each phase of one tile of grads' walk (a block's second,
// where it has two), of the walk, and of the grid's sums in the block that
// adds them; and at the end of each of adam's phases.  A phase a design does
// not have is not stamped.
constexpr int kLossStamps = 3;
enum Stamp {
  kStampStart,                              // the block starts
  kStampStaged,                             // the weights staged
  kStampTile,                               // the recorded tile starts
  kStampGather,                             // its rows gathered
  kStampFwd,                                // + i: forward layer i
  kStampLoss = kStampFwd + kMaxLayers,      // + k: the loss stage's phases
  kStampBwd = kStampLoss + kLossStamps,     // + 2 i + part: backward layer i
  kStampWalk = kStampBwd + 2 * kMaxLayers,  // the block's walk ends
  kStampGroup,                              // its group's sum
  kStampFinal,                              // the grid's sum
  kStampAdamStart,                          // adam: a block starts
  kStampAdamSquares,                        // its sums of squares
  kStampAdamTree,                           // (last block) the norm, the lr
  kStampAdamPass,                           // the step (phase B) starts
  kStampAdamWait,                           // it has waited for phase A
  kStampAdamFirst,                          // its first chunk
  kStampAdamLast,                           // its last (of several)
  kStamps
};
static const char kStampNames[] =
    "start,staged,tile,gather,fwd0,fwd1,fwd2,fwd3,fwd4,fwd5,fwd6,fwd7,loss0,"
    "loss1,loss2,bwd0a,bwd0b,bwd1a,bwd1b,bwd2a,bwd2b,bwd3a,bwd3b,bwd4a,bwd4b,"
    "bwd5a,bwd5b,bwd6a,bwd6b,bwd7a,bwd7b,walk,group,final,adam_start,"
    "adam_squares,adam_tree,adam_pass,adam_wait,adam_first,adam_last";

// ---- the C interface's blocks -----------------------------------------

// gae: the steps and envs, the grid's blocks; gamma and lambda; reward,
// value (T, N), done (T, N) bool, last_value (N); outputs advantages and
// returns (T, N), the mean advantage (); the blocks' partial sums (blocks)
// and the grid's counter (one int, 0 between launches).
#define LEARN_GAE_INTS(X) X(T) X(N) X(blocks)
#define LEARN_GAE_REALS(X) X(gamma) X(lam)
#define LEARN_GAE_PTRS(X)                                                     \
  X(reward) X(value) X(done) X(last_value) X(o_adv) X(o_ret) X(o_mean)        \
  X(part) X(counter)

// grads: the minibatch's samples, the actions, the observation width, the
// layers of each net, the activation, the blocks of each net's part of the
// grid, the blocks a group of the grid's sum, the clipped value loss (0 or
// 1), the flat buffer's gradient count (its KL's index), the scratch's
// elements; then per layer (the actor's, then the critic's) n_in, n_out and
// the flat offsets of its weight's and its bias's gradients, and last the
// std's.
#define LEARN_GRADS_INTS(X)                                                   \
  X(B) X(A) X(nobs) X(n_actor) X(n_critic) X(act) X(blocks_a) X(blocks_c)     \
  X(group) X(clipped) X(P) X(scratch) X(std_off)
// the std floor (0: none), the activation's parameter, the clip parameter,
// the value loss's and the entropy's coefficients.
#define LEARN_GRADS_REALS(X)                                                  \
  X(std_floor) X(alpha) X(clip) X(value_coef) X(entropy_coef)
// the trajectory's obs (T·N, nobs), action, mu, sigma (T·N, A), logp and
// value (T·N), the returns and normalized advantages (T·N), the
// minibatch's rows idx (B) int64, std (A); outputs the flat buffer (P + 1)
// and the losses (3); the scratch and the grid's counters; then each
// layer's weight (n_out, n_in) and bias (n_out).
#define LEARN_GRADS_PTRS(X)                                                   \
  X(obs) X(action) X(mu) X(sigma) X(logp) X(value) X(returns) X(adv) X(idx)   \
  X(std) X(flat) X(losses) X(scratch) X(counters)

// adam: the gradients (the flat buffer's KL index), the parameter tensors,
// the adaptive schedule (0 or 1), the world, the chunks and the grid's
// blocks; then per tensor, in flat order, its elements and its gradient's
// flat offset.
#define LEARN_ADAM_INTS(X)                                                    \
  X(P) X(ntensors) X(adaptive) X(world) X(chunks) X(blocks)
// the KL target, the clip's norm, Adam's betas and eps, the lr's bounds and
// factor.
#define LEARN_ADAM_REALS(X)                                                   \
  X(desired_kl) X(max_grad_norm) X(beta1) X(beta2) X(eps) X(lr_min)           \
  X(lr_max) X(lr_factor)
// the flat buffer (P + 1), the lr (), the losses (3); output the
// statistics (4: the losses and the KL); the scratch
// (adam_scratch_elems) and the grid's counter (one int, 0 between
// launches); then per tensor its parameter, Adam's exp_avg and exp_avg_sq
// and its step (float32).
#define LEARN_ADAM_PTRS(X)                                                    \
  X(flat) X(lr) X(losses) X(stats) X(scratch) X(counter)

#define LEARN_ENUM(name) name,
#define LEARN_NAME(name) #name ","
namespace gae_int { enum { LEARN_GAE_INTS(LEARN_ENUM) kCount }; }
namespace gae_real { enum { LEARN_GAE_REALS(LEARN_ENUM) kCount }; }
namespace gae_ptr { enum { LEARN_GAE_PTRS(LEARN_ENUM) kCount }; }
namespace grads_int { enum { LEARN_GRADS_INTS(LEARN_ENUM) kCount }; }
namespace grads_real { enum { LEARN_GRADS_REALS(LEARN_ENUM) kCount }; }
namespace grads_ptr { enum { LEARN_GRADS_PTRS(LEARN_ENUM) kCount }; }
namespace adam_int { enum { LEARN_ADAM_INTS(LEARN_ENUM) kCount }; }
namespace adam_real { enum { LEARN_ADAM_REALS(LEARN_ENUM) kCount }; }
namespace adam_ptr { enum { LEARN_ADAM_PTRS(LEARN_ENUM) kCount }; }
static const char kGaeIntNames[] = LEARN_GAE_INTS(LEARN_NAME);
static const char kGaeRealNames[] = LEARN_GAE_REALS(LEARN_NAME);
static const char kGaePtrNames[] = LEARN_GAE_PTRS(LEARN_NAME);
static const char kGradsIntNames[] = LEARN_GRADS_INTS(LEARN_NAME);
static const char kGradsRealNames[] = LEARN_GRADS_REALS(LEARN_NAME);
static const char kGradsPtrNames[] = LEARN_GRADS_PTRS(LEARN_NAME);
static const char kAdamIntNames[] = LEARN_ADAM_INTS(LEARN_NAME);
static const char kAdamRealNames[] = LEARN_ADAM_REALS(LEARN_NAME);
static const char kAdamPtrNames[] = LEARN_ADAM_PTRS(LEARN_NAME);
#undef LEARN_ENUM
#undef LEARN_NAME

// ---- arithmetic -----------------------------------------------------------

// A load of what another block of the grid wrote (through L2 on the card).
template <typename T>
LEARN_HD T ld_shared(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

LEARN_HD float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
LEARN_HD double fma_t(double a, double b, double c) { return fma(a, b, c); }

// torch.maximum and torch.clamp: NaN in, NaN out.
template <typename T>
LEARN_HD T max_nan(T a, T b) {
  return is_nan(a) || is_nan(b) ? a + b : (a > b ? a : b);
}
template <typename T>
LEARN_HD T clamp_nan(T x, T lo, T hi) {
  return is_nan(x) ? x : (x < lo ? lo : (x > hi ? hi : x));
}
// torch.maximum's backward: the gradient's share of a (the larger; half
// each on a tie).
template <typename T>
LEARN_HD T max_share(T a, T b) {
  return a > b ? T(1) : (a == b ? T(0.5) : T(0));
}

// d activate(z) / dz from y = activate(z) and whether z > 0 (`pos`: y > 0
// but for ELU's and LeakyReLU's parameter below 0, where y > 0 on both
// sides and grads keeps z's sign apart); ELU and SELU below 0 from y (y +
// alpha is alpha * exp(z)).
template <typename T>
LEARN_HD T activate_grad(int kind, T alpha, T y, bool pos) {
  switch (kind) {
    case rollout_env::kElu:
      return pos ? T(1) : y + alpha;
    case rollout_env::kRelu:
      return pos ? T(1) : T(0);
    case rollout_env::kSelu: {
      const T scale = T(1.0507009873554804934193349852946);
      const T salpha = T(1.6732632423543772848170429916717);
      return pos ? scale : y + scale * salpha;
    }
    case rollout_env::kLeakyRelu:
      return pos ? T(1) : alpha;
    case rollout_env::kTanh:
      return T(1) - y * y;
    default:  // kSigmoid
      return y * (T(1) - y);
  }
}

// Four consecutive elements, 16-byte aligned (two 16-byte loads in
// float64): one vector load on the card.
template <typename T>
LEARN_HD void ld4(const T* p, T v[4]) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const double2 f = reinterpret_cast<const double2*>(p)[0];
    const double2 g = reinterpret_cast<const double2*>(p)[1];
    v[0] = f.x, v[1] = f.y, v[2] = g.x, v[3] = g.y;
  }
#else
  for (int u = 0; u < 4; ++u) v[u] = p[u];
#endif
}
template <typename T>
LEARN_HD void st4(T* p, const T v[4]) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
#else
  for (int u = 0; u < 4; ++u) p[u] = v[u];
#endif
}
// ld4 of what another block of the grid wrote (through L2 on the card).
template <typename T>
LEARN_HD void ld4_shared(const T* p, T v[4]) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const double2 f = __ldcg(reinterpret_cast<const double2*>(p));
    const double2 g = __ldcg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = f.x, v[1] = f.y, v[2] = g.x, v[3] = g.y;
  }
#else
  for (int u = 0; u < 4; ++u) v[u] = p[u];
#endif
}

// put(c, q) for every c < nc and q < w, a member taking the items p = c *
// w + q = rank, rank + size, ... (no division in the loop).
template <typename Team, typename Put>
LEARN_HD void for_rows(const Team& tm, int nc, int w, Put put) {
  if (w < 1) return;
  const int dc = tm.size() / w, dq = tm.size() - dc * w;
  int c = tm.rank() / w, q = tm.rank() - c * w;
  for (; c < nc; c += dc) {
    put(c, q);
    q += dq;
    if (q >= w) {
      q -= w;
      ++c;
    }
  }
}

LEARN_HD int min_i(int a, int b) { return a < b ? a : b; }
LEARN_HD int tiles_of(int n, int t) { return (n + t - 1) / t; }

// put(p, sum of src[q * stride + p] over the rows q < nrows, in row order)
// for every column p < W (stride a multiple of 4, src 16-byte aligned): a
// member takes 4 columns at a time and loads kRows rows of them at once
// before it adds them (the rows were written by other blocks of the grid:
// many loads in flight hide L2's latency; a grid of 132 blocks a net sums
// groups of 12 rows, then 11).
template <typename T, typename Team, typename Put>
LEARN_HD void col_sums(const Team& tm, const T* src, size_t stride,
                       int nrows, int W, Put put) {
  constexpr int kRows = 12;
  for (int p0 = tm.rank() * 4; p0 < W; p0 += tm.size() * 4) {
    T sum[4] = {T(0), T(0), T(0), T(0)};
    for (int q0 = 0; q0 < nrows; q0 += kRows) {
      T v[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (q0 + r < nrows) ld4_shared(src + (q0 + r) * stride + p0, v[r]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (q0 + r < nrows)
#pragma unroll
          for (int c = 0; c < 4; ++c) sum[c] += v[r][c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (p0 + c < W) put(p0 + c, sum[c]);
  }
}

// ---- gae ------------------------------------------------------------------

template <typename T>
struct GaeArgs {
  int T_, N, blocks;
  T gamma, gl;  // gl: Python's gamma * lam, then rounded to T
  const T *reward, *value, *last_value;
  const bool* done;
  T *o_adv, *o_ret, *o_mean, *part;
  int* counter;
};

template <typename T>
inline bool read_gae(const int* ints, int nints, const double* reals,
                     int nreals, const void* const* ptrs, int nptrs,
                     GaeArgs<T>* a) {
  if (nints != gae_int::kCount || nreals != gae_real::kCount ||
      nptrs != gae_ptr::kCount)
    return false;
  a->T_ = ints[gae_int::T];
  a->N = ints[gae_int::N];
  a->blocks = ints[gae_int::blocks];
  if (a->T_ < 1 || a->N < 1 ||
      a->blocks != (a->N + kGaeLanes - 1) / kGaeLanes)
    return false;
  a->gamma = static_cast<T>(reals[gae_real::gamma]);
  a->gl = static_cast<T>(reals[gae_real::gamma] * reals[gae_real::lam]);
  auto mp = [&](int k) { return const_cast<void*>(ptrs[k]); };
  a->reward = static_cast<const T*>(ptrs[gae_ptr::reward]);
  a->value = static_cast<const T*>(ptrs[gae_ptr::value]);
  a->done = static_cast<const bool*>(ptrs[gae_ptr::done]);
  a->last_value = static_cast<const T*>(ptrs[gae_ptr::last_value]);
  a->o_adv = static_cast<T*>(mp(gae_ptr::o_adv));
  a->o_ret = static_cast<T*>(mp(gae_ptr::o_ret));
  a->o_mean = static_cast<T*>(mp(gae_ptr::o_mean));
  a->part = static_cast<T*>(mp(gae_ptr::part));
  a->counter = static_cast<int*>(mp(gae_ptr::counter));
  for (int k = 0; k < gae_ptr::kCount; ++k)
    if (!ptrs[k]) return false;
  return true;
}

// Block `blk`'s envs [blk * kGaeLanes, ...) below N: each lane's env walks
// t = T-1 .. 0 as the plain version's ops round (each product and sum
// rounded once); the block's sum of its advantages (each lane's in time
// order, then a fixed tree over the lanes) into part[blk].  `s` holds
// kGaeLanes elements.
template <typename T, typename Team>
LEARN_HD void gae_block(const Team& tm, const GaeArgs<T>& a, int blk, T* s) {
  const int N = a.N;
  for (int v = tm.rank(); v < kGaeLanes; v += tm.size()) {
    const int n = blk * kGaeLanes + v;
    T sum = T(0);
    if (n < N) {
      T adv = T(0);
      T next = a.last_value[n];
      // kGaeAhead steps' loads issued before their arithmetic
      for (int t1 = a.T_; t1 > 0; t1 -= kGaeAhead) {
        const int t0 = t1 - kGaeAhead > 0 ? t1 - kGaeAhead : 0;
        T rw[kGaeAhead], vl[kGaeAhead];
        bool dn[kGaeAhead];
#pragma unroll
        for (int j = 0; j < kGaeAhead; ++j) {
          const int t = t1 - 1 - j;
          if (t >= t0) {
            const size_t i = static_cast<size_t>(t) * N + n;
            rw[j] = a.reward[i];
            vl[j] = a.value[i];
            dn[j] = a.done[i];
          }
        }
#pragma unroll
        for (int j = 0; j < kGaeAhead; ++j) {
          const int t = t1 - 1 - j;
          if (t < t0) break;
          const size_t i = static_cast<size_t>(t) * N + n;
          const T nonterminal = T(1) - (dn[j] ? T(1) : T(0));
          const T delta =
              (rw[j] + mul_rn(mul_rn(a.gamma, next), nonterminal)) - vl[j];
          adv = delta + mul_rn(mul_rn(a.gl, nonterminal), adv);
          a.o_adv[i] = adv;
          a.o_ret[i] = adv + vl[j];
          sum += adv;
          next = vl[j];
        }
      }
    }
    s[v] = sum;
  }
  for (int h = kGaeLanes / 2; h > 0; h /= 2) {
    tm.sync();
    for (int v = tm.rank(); v < h; v += tm.size()) s[v] += s[v + h];
  }
  tm.sync();
  if (tm.rank() == 0) a.part[blk] = s[0];
}

// The mean advantage from the blocks' sums, added in block order.
template <typename T, typename Team>
LEARN_HD void gae_final(const Team& tm, const GaeArgs<T>& a) {
  if (tm.rank() != 0) return;
  T sum = T(0);
  for (int b = 0; b < a.blocks; ++b) sum += ld_shared(a.part + b);
  *a.o_mean = sum / static_cast<T>(static_cast<double>(a.T_) * a.N);
}

// ---- grads ----------------------------------------------------------------

// One net of the grid (the actor, role 0, or the critic, role 1): its
// layers; their transposed weights' offsets and row lengths (n_out rounded
// up to kFwdJ, the pad zero) and their biases' offsets in shared memory;
// their outputs' rows in y (hidden layers); their gradients' columns in a
// block's sums (each layer's weight row-major, then its bias) and in the
// flat buffer; the std's and the loss terms' columns; the width of a
// block's sums and its row's stride in the scratch (16-byte rows).  Then
// the block's shared memory, in elements from its base (each part 16-byte
// aligned): the tile's indices, the weights, biases and the std's
// constants, the input tile x, the hidden outputs y, the head h, where the
// next tile's x arrives (the spare rows: y's from layer 1 on and h, which
// the last backward phase no longer reads, or rows of their own), the loss
// rows (the actor's: a sample's action, mu and sigma in a row of ldr, then
// logp and the advantage; the critic's value and return) and the loss
// stage's per-sample scratch (g, the surrogate or value loss, the KL).
template <typename T>
struct Role {
  int nl, width, stride, in0, head, ldr;
  Layer<T> layer[kMaxLayers];
  int ldt[kMaxLayers], wtoff[kMaxLayers], boff[kMaxLayers], hoff[kMaxLayers];
  int col_w[kMaxLayers], col_b[kMaxLayers];
  int flat_w[kMaxLayers], flat_b[kMaxLayers];
  int col_std, col_loss;  // the actor's std (A) and (surrogate, kl) sums;
                          // the critic's value loss sum (col_loss)
  int o_wt, o_b, o_c, o_x, o_y, o_h, o_spare, o_rows, o_aux, o_pos, elems;
};

template <typename T>
struct GradsArgs {
  int B, A, nobs, act, neg, blocks[2], group, groups[2], clipped, P, std_off;
  T std_floor, alpha, clip, value_coef, entropy_coef;
  const T *obs, *action, *mu, *sigma, *logp, *value, *returns, *adv, *std;
  const long long* idx;
  T *flat, *losses, *part[2], *gsum[2];
  int* counters;
  Role<T> role[2];
};

LEARN_HD int up4(int n) { return (n + 3) & ~3; }

// Role k's shared memory layout (Role's o_* fields and elems), from its
// layers; with z's signs where `neg`.
template <typename T>
LEARN_HD void role_layout(int A, int k, bool neg, Role<T>* r) {
  int at = up4(static_cast<int>(kTile * sizeof(long long) / sizeof(T)));
  r->o_wt = at;
  for (int i = 0; i < r->nl; ++i) {
    r->wtoff[i] = at - r->o_wt;
    at += r->layer[i].n_in * r->ldt[i];
  }
  at = up4(at);
  r->o_b = at;
  for (int i = 0; i < r->nl; ++i) {
    r->boff[i] = at - r->o_b;
    at += r->layer[i].n_out;
  }
  r->o_c = up4(at);
  at = up4(r->o_c + (k == 0 ? 2 * A : 0));
  r->o_x = at;
  r->o_y = at + kLd * r->in0;
  int hsize = 0;
  for (int i = 0; i + 1 < r->nl; ++i) {
    r->hoff[i] = hsize;
    hsize += r->layer[i].n_out;
  }
  r->o_h = r->o_y + kLd * hsize;
  const int end_h = r->o_h + kLd * r->head;
  // (the next tile's observations, kTile rows of in0)
  r->o_spare = r->nl > 1 ? r->o_y + kLd * r->layer[0].n_out : end_h;
  const int end_spare = r->o_spare + kLd * r->in0;
  at = end_h > end_spare ? end_h : end_spare;
  // a loss row: 8-byte aligned at 2 (mod 4) words for an even A (its
  // copies 8 bytes; a warp's rows on 16 distinct banks), odd otherwise
  r->ldr = A % 2 == 0 ? 3 * A + (3 * A % 4 == 2 ? 0 : 2) : odd_ld(3 * A);
  r->o_rows = at;
  at = up4(at + (k == 0 ? kTile * r->ldr + 2 * kTile : 2 * kTile));
  r->o_aux = at;
  r->o_pos = up4(at + 3 * kTile);
  const int pos_bytes = neg ? kQuads * hsize : 0;
  r->elems = r->o_pos + up4((pos_bytes + static_cast<int>(sizeof(T)) - 1) /
                            static_cast<int>(sizeof(T)));
}

template <typename T>
LEARN_HD int grads_smem_elems(const GradsArgs<T>& a) {
  const int x = a.role[0].elems, y = a.role[1].elems;
  return x > y ? x : y;
}

// The scratch's elements: each block's sums, then each group's.
template <typename T>
LEARN_HD long long grads_scratch_elems(const GradsArgs<T>& a) {
  long long n = 0;
  for (int k = 0; k < 2; ++k)
    n += static_cast<long long>(a.blocks[k] + a.groups[k]) * a.role[k].stride;
  return n;
}

// grads' arguments from the C interface's blocks; false for arguments the
// kernel does not take.
template <typename T>
inline bool read_grads(const int* ints, int nints, const double* reals,
                       int nreals, const void* const* ptrs, int nptrs,
                       GradsArgs<T>* a) {
  if (nints < grads_int::kCount || nreals != grads_real::kCount ||
      nptrs < grads_ptr::kCount)
    return false;
  const int* I = ints;
  a->B = I[grads_int::B];
  a->A = I[grads_int::A];
  a->nobs = I[grads_int::nobs];
  const int n_actor = I[grads_int::n_actor], n_critic = I[grads_int::n_critic];
  a->act = I[grads_int::act];
  a->blocks[0] = I[grads_int::blocks_a];
  a->blocks[1] = I[grads_int::blocks_c];
  a->group = I[grads_int::group];
  a->clipped = I[grads_int::clipped];
  a->P = I[grads_int::P];
  a->std_off = I[grads_int::std_off];
  const int nl = n_actor + n_critic;
  if (n_actor < 1 || n_critic < 1 || n_actor > kMaxLayers ||
      n_critic > kMaxLayers || nints != grads_int::kCount + 4 * nl ||
      nptrs != grads_ptr::kCount + 2 * nl || a->B < 1 || a->A < 1 ||
      a->nobs < 1 || a->group < 1 || a->P < 1 || a->act < rollout_env::kElu ||
      a->act > rollout_env::kSigmoid || a->std_off < 0 ||
      a->std_off + a->A > a->P)
    return false;
  const int ntiles = (a->B + kTile - 1) / kTile;
  for (int k = 0; k < 2; ++k) {
    if (a->blocks[k] < 1 || a->blocks[k] > ntiles) return false;
    a->groups[k] = (a->blocks[k] + a->group - 1) / a->group;
  }
  a->std_floor = static_cast<T>(reals[grads_real::std_floor]);
  a->alpha = static_cast<T>(reals[grads_real::alpha]);
  a->clip = static_cast<T>(reals[grads_real::clip]);
  a->value_coef = static_cast<T>(reals[grads_real::value_coef]);
  a->entropy_coef = static_cast<T>(reals[grads_real::entropy_coef]);
  a->neg = (a->act == rollout_env::kElu ||
            a->act == rollout_env::kLeakyRelu) &&
           reals[grads_real::alpha] < 0;
  const void* const* P = ptrs;
  auto mp = [&](int k) { return const_cast<void*>(P[k]); };
  a->obs = static_cast<const T*>(P[grads_ptr::obs]);
  a->action = static_cast<const T*>(P[grads_ptr::action]);
  a->mu = static_cast<const T*>(P[grads_ptr::mu]);
  a->sigma = static_cast<const T*>(P[grads_ptr::sigma]);
  a->logp = static_cast<const T*>(P[grads_ptr::logp]);
  a->value = static_cast<const T*>(P[grads_ptr::value]);
  a->returns = static_cast<const T*>(P[grads_ptr::returns]);
  a->adv = static_cast<const T*>(P[grads_ptr::adv]);
  a->idx = static_cast<const long long*>(P[grads_ptr::idx]);
  a->std = static_cast<const T*>(P[grads_ptr::std]);
  a->flat = static_cast<T*>(mp(grads_ptr::flat));
  a->losses = static_cast<T*>(mp(grads_ptr::losses));
  T* scratch = static_cast<T*>(mp(grads_ptr::scratch));
  a->counters = static_cast<int*>(mp(grads_ptr::counters));
  for (int k = 0; k < grads_ptr::kCount; ++k)
    if (!P[k]) return false;
  // the roles' layers: each reads the last one's width; the first the
  // observations, the heads A and 1 wide
  for (int k = 0; k < 2; ++k) {
    Role<T>& r = a->role[k];
    const int l0 = k == 0 ? 0 : n_actor;
    r.nl = k == 0 ? n_actor : n_critic;
    r.width = 0;
    for (int i = 0; i < r.nl; ++i) {
      const int l = l0 + i;
      const int* L = I + grads_int::kCount + 4 * l;
      const int n_in = L[0], n_out = L[1];
      const int want_in = i == 0 ? a->nobs : r.layer[i - 1].n_out;
      if (n_in != want_in || n_out < 1 ||
          (i == r.nl - 1 && n_out != (k == 0 ? a->A : 1)) || L[2] < 0 ||
          L[3] < 0 || L[2] + n_in * n_out > a->P || L[3] + n_out > a->P)
        return false;
      r.layer[i] = Layer<T>{static_cast<const T*>(P[grads_ptr::kCount + 2 * l]),
                            static_cast<const T*>(P[grads_ptr::kCount + 2 * l + 1]),
                            n_in, n_out};
      if (!r.layer[i].w || !r.layer[i].b) return false;
      r.ldt[i] = tiles_of(n_out, kFwdJ) * kFwdJ;
      r.col_w[i] = r.width;
      r.col_b[i] = r.width + n_in * n_out;
      r.width += n_in * n_out + n_out;
      r.flat_w[i] = L[2];
      r.flat_b[i] = L[3];
    }
    r.in0 = a->nobs;
    r.head = k == 0 ? a->A : 1;
    r.col_std = r.width;
    if (k == 0) r.width += a->A;
    r.col_loss = r.width;
    r.width += k == 0 ? 2 : 1;
    r.stride = up4(r.width);
    role_layout(a->A, k, a->neg != 0, &r);
  }
  if (static_cast<long long>(I[grads_int::scratch]) < grads_scratch_elems(*a))
    return false;
  T* s = scratch;
  for (int k = 0; k < 2; ++k) {
    a->part[k] = s;
    s += static_cast<size_t>(a->blocks[k]) * a->role[k].stride;
  }
  for (int k = 0; k < 2; ++k) {
    a->gsum[k] = s;
    s += static_cast<size_t>(a->groups[k]) * a->role[k].stride;
  }
  return true;
}

template <typename T>
struct GradsSmem {
  long long* idx;
  T *wt, *bias, *sd, *lsd, *x, *y, *h, *spare, *rows, *r1, *r2, *g, *sur, *kl;
  unsigned char* pos;
};

template <typename T>
LEARN_HD GradsSmem<T> grads_smem(const GradsArgs<T>& a, const Role<T>& r,
                                 int k, T* base) {
  GradsSmem<T> s;
  s.idx = reinterpret_cast<long long*>(base);
  s.wt = base + r.o_wt;
  s.bias = base + r.o_b;
  s.sd = base + r.o_c;
  s.lsd = s.sd + a.A;
  s.x = base + r.o_x;
  s.y = base + r.o_y;
  s.h = base + r.o_h;
  s.spare = base + r.o_spare;
  s.rows = base + r.o_rows;
  // the actor's logp and advantages, the critic's values and returns
  s.r1 = s.rows + (k == 0 ? kTile * r.ldr : 0);
  s.r2 = s.r1 + kTile;
  s.g = base + r.o_aux;
  s.sur = s.g + kTile;
  s.kl = s.sur + kTile;
  s.pos = reinterpret_cast<unsigned char*>(base + r.o_pos);
  return s;
}

// The sampling std of action i: std clamped by the floor where it is above 0.
template <typename T>
LEARN_HD T std_eff(const GradsArgs<T>& a, int i) {
  const T sd = a.std[i];
  return a.std_floor > T(0) && sd < a.std_floor ? a.std_floor : sd;
}

// The block's weights staged transposed (Wt[k][j] = W[j][k], the rows' pad
// zero), its biases, and the actor's std and its log per action.
template <typename T, typename Team>
LEARN_HD void stage(const Team& tm, const GradsArgs<T>& a, const Role<T>& r,
                    const GradsSmem<T>& s, bool actor) {
  for (int i = 0; i < r.nl; ++i) {
    const Layer<T>& L = r.layer[i];
    T* wt = s.wt + r.wtoff[i];
    const int ldt = r.ldt[i], pad = ldt - L.n_out;
    for_rows(tm, L.n_out, L.n_in, [&](int j, int k) {
      tm.copy(wt + k * ldt + j, L.w + j * L.n_in + k);
    });
    for_rows(tm, L.n_in, pad,
             [&](int k, int j) { wt[k * ldt + L.n_out + j] = T(0); });
    for (int j = tm.rank(); j < L.n_out; j += tm.size())
      tm.copy(s.bias + r.boff[i] + j, L.b + j);
  }
  if (actor)
    for (int i = tm.rank(); i < a.A; i += tm.size()) {
      const T sd = std_eff(a, i);
      s.sd[i] = sd;
      s.lsd[i] = T(log(sd));
    }
}

// The samples of tile t below B.
template <typename T>
LEARN_HD int tile_samples(const GradsArgs<T>& a, int t) {
  return min_i(kTile, a.B - t * kTile);
}

// Tile t's rows of the trajectory (its indices into s.idx).
template <typename T, typename Team>
LEARN_HD void fetch_idx(const Team& tm, const GradsArgs<T>& a,
                        const GradsSmem<T>& s, int t) {
  const int ns = tile_samples(a, t);
  for (int c = tm.rank(); c < ns; c += tm.size())
    tm.copy(s.idx + c, a.idx + t * kTile + c);
}

// Tile t's observations as they lie (a sample's row after another's, 8-byte
// copies where the width is even) into the spare rows; place_x lays them
// out feature-major in x.
template <typename T, typename Team>
LEARN_HD void fetch_x(const Team& tm, const GradsArgs<T>& a,
                      const GradsSmem<T>& s, int t) {
  const int ns = tile_samples(a, t), n = a.nobs;
  if (n % 2 == 0)
    for_rows(tm, ns, n / 2, [&](int c, int q) {
      tm.template copy_n<2>(s.spare + c * n + 2 * q,
                            a.obs + static_cast<size_t>(s.idx[c]) * n + 2 * q);
    });
  else
    for_rows(tm, ns, n, [&](int c, int q) {
      tm.copy(s.spare + c * n + q,
              a.obs + static_cast<size_t>(s.idx[c]) * n + q);
    });
}

// The observations that fetch_x brought, feature-major ([feature][sample],
// rows of kLd) in x, zero past the minibatch's end.
template <typename T, typename Team>
LEARN_HD void place_x(const Team& tm, const GradsArgs<T>& a,
                      const GradsSmem<T>& s, int t) {
  const int ns = tile_samples(a, t), n = a.nobs;
  for_rows(tm, n, kTile, [&](int q, int c) {
    s.x[q * kLd + c] = c < ns ? s.spare[c * n + q] : T(0);
  });
}

// Tile t's rows of the loss stage: the actor's action, mu and sigma (a
// sample's row of r.ldr; 8-byte copies where A is even), logp and
// normalized advantage; the critic's value and return.
template <typename T, typename Team>
LEARN_HD void fetch_rows(const Team& tm, const GradsArgs<T>& a,
                         const Role<T>& r, const GradsSmem<T>& s, int k,
                         int t) {
  const int ns = tile_samples(a, t), A = a.A;
  if (k == 1) {
    for_rows(tm, ns, 2, [&](int c, int q) {
      const size_t row = static_cast<size_t>(s.idx[c]);
      tm.copy((q ? s.r2 : s.r1) + c, (q ? a.returns : a.value) + row);
    });
    return;
  }
  const int v = A % 2 == 0 ? 2 : 1, h = A / v;  // a copy's elements
  for_rows(tm, ns, 3 * h + 2, [&](int c, int q) {
    const size_t row = static_cast<size_t>(s.idx[c]);
    if (q >= 3 * h) {
      tm.copy((q == 3 * h ? s.r1 : s.r2) + c,
              (q == 3 * h ? a.logp : a.adv) + row);
      return;
    }
    const int f = q >= 2 * h ? 2 : (q >= h ? 1 : 0);
    const T* src = (f == 0 ? a.action : (f == 1 ? a.mu : a.sigma)) +
                   row * A + (q - f * h) * v;
    T* dst = s.rows + c * r.ldr + q * v;
    if (v == 2)
      tm.template copy_n<2>(dst, src);
    else
      tm.copy(dst, src);
  });
}

// Layer i's forward pass over the tile: z = W x + b (each element's terms
// in ascending k, then the bias), and for a hidden layer y = activate(z)
// into y (z > 0 into pos where a.neg), the head's z into h.  A member's
// item is kFwdJ outputs (their weights vectors of Wt's row k) by kFwdS
// samples: kFwdS / 4 vectors of x's row k, kTile / (kFwdS / 4) samples
// apart, so that a quarter warp's vectors lie side by side.
template <typename T, typename Team>
LEARN_HD void forward_layer(const Team& tm, const GradsArgs<T>& a,
                            const Role<T>& r, const GradsSmem<T>& s, int i) {
  constexpr int kSpan = kTile / (kFwdS / 4);
  const Layer<T>& L = r.layer[i];
  const bool last = i == r.nl - 1;
  const T* in = i == 0 ? s.x : s.y + kLd * r.hoff[i - 1];
  T* out = last ? s.h : s.y + kLd * r.hoff[i];
  const T* wt = s.wt + r.wtoff[i];
  const T* bias = s.bias + r.boff[i];
  const int ldt = r.ldt[i], nj = ldt / kFwdJ, nst = kSpan / 4;
  for (int p = tm.rank(); p < nj * nst; p += tm.size()) {
    const int j0 = (p / nst) * kFwdJ, s0 = (p % nst) * 4;
    T acc[kFwdJ][kFwdS] = {};
    const T* wp = wt + j0;
    const T* xp = in + s0;
#pragma unroll 4
    for (int k = 0; k < L.n_in; ++k, wp += ldt, xp += kLd) {
      T w[kFwdJ], x[kFwdS];
#pragma unroll
      for (int q = 0; q < kFwdJ; q += 4) ld4(wp + q, w + q);
#pragma unroll
      for (int m = 0; m < kFwdS / 4; ++m) ld4(xp + m * kSpan, x + 4 * m);
#pragma unroll
      for (int q = 0; q < kFwdJ; ++q)
#pragma unroll
        for (int c = 0; c < kFwdS; ++c) acc[q][c] += w[q] * x[c];
    }
#pragma unroll
    for (int q = 0; q < kFwdJ; ++q) {
      const int j = j0 + q;
      if (j >= L.n_out) break;
      const T b = bias[j];
      T v[kFwdS];
      unsigned bits = 0;
#pragma unroll
      for (int c = 0; c < kFwdS; ++c) {
        const T z = acc[q][c] + b;
        v[c] = last ? z : activate(a.act, a.alpha, z);
        bits |= (z > T(0) ? 1u : 0u) << c;
      }
#pragma unroll
      for (int m = 0; m < kFwdS / 4; ++m)
        st4(out + j * kLd + s0 + m * kSpan, v + 4 * m);
      if (a.neg && !last) {
#pragma unroll
        for (int m = 0; m < kFwdS / 4; ++m)
          s.pos[(r.hoff[i] + j) * kQuads + (s0 + m * kSpan) / 4] =
              static_cast<unsigned char>((bits >> (4 * m)) & 15u);
      }
    }
  }
}

// The actor's loss stage over a tile of ns samples, in three phases.
// First a member an (action, sample): d = action - mu into the action's
// place, the log-probability's and the KL's terms into mu's and sigma's
// (their last reads); then a member a sample: the terms summed over the
// actions in ascending order, the ratio, the clipped surrogate and g = d
// loss / d log-probability (the mean's 1/B in it); then a member an
// (action, sample) again: the head's delta d loss / d mu into h and d loss
// / d std into the sigma's place.
template <typename T, typename Team>
LEARN_HD void actor_loss(const Team& tm, const GradsArgs<T>& a,
                         const Role<T>& r, const GradsSmem<T>& s, int ns,
                         bool rec) {
  const int A = a.A;
  const T c2pi = T(1.8378770664093453);  // Python's math.log(2.0 * math.pi)
  for (int p = tm.rank(); p < A * kTile; p += tm.size()) {
    const int i = p / kTile, c = p - i * kTile;
    if (c >= ns) continue;
    T* row = s.rows + c * r.ldr;
    const T mu = s.h[i * kLd + c], sd = s.sd[i];
    const T d = row[i] - mu, so = row[2 * A + i], dm = row[A + i] - mu;
    row[i] = d;
    row[A + i] = T(-0.5) * ((d * d) / (sd * sd) + T(2) * s.lsd[i] + c2pi);
    row[2 * A + i] =
        (T(log(sd / so)) + (so * so + dm * dm) / (T(2) * (sd * sd))) - T(0.5);
  }
  tm.sync();
  if (rec) tm.stamp(kStampLoss);
  const T lo = T(1) - a.clip, hi = T(1) + a.clip;
  const T inv_b = T(1) / static_cast<T>(a.B);
  for (int c = tm.rank(); c < kTile; c += tm.size()) {
    T g = T(0), sur = T(0), kl = T(0);
    if (c < ns) {
      const T* row = s.rows + c * r.ldr;
      T lp = T(0);
      for (int i = 0; i < A; ++i) {
        lp += row[A + i];
        kl += row[2 * A + i];
      }
      const T ratio = T(exp(lp - s.r1[c]));
      const T nadv = -s.r2[c];
      const T s1 = nadv * ratio, s2 = nadv * clamp_nan(ratio, lo, hi);
      sur = max_nan(s1, s2);
      const T band = ratio >= lo && ratio <= hi ? T(1) : T(0);
      g = inv_b * (max_share(s1, s2) * nadv +
                   max_share(s2, s1) * band * nadv) * ratio;
    }
    s.g[c] = g;
    s.sur[c] = sur;
    s.kl[c] = kl;
  }
  tm.sync();
  if (rec) tm.stamp(kStampLoss + 1);
  for (int p = tm.rank(); p < A * kTile; p += tm.size()) {
    const int i = p / kTile, c = p - i * kTile;
    T dmu = T(0), dsd = T(0);
    if (c < ns) {
      const T sd = s.sd[i], g = s.g[c], d = s.rows[c * r.ldr + i];
      dmu = g * (d / (sd * sd));
      dsd = g * ((d * d) / (sd * sd * sd) - T(1) / sd);
    }
    s.h[i * kLd + c] = dmu;
    s.rows[c * r.ldr + 2 * A + i] = dsd;
  }
}

// The critic's loss stage: a member a sample, its (clipped) value loss
// and the head's delta d loss / d v into h.
template <typename T, typename Team>
LEARN_HD void critic_loss(const Team& tm, const GradsArgs<T>& a,
                          const GradsSmem<T>& s, int ns) {
  const T scale = a.value_coef / static_cast<T>(a.B);
  for (int c = tm.rank(); c < kTile; c += tm.size()) {
    T g = T(0), vl = T(0);
    if (c < ns) {
      const T v = s.h[c], vo = s.r1[c], ret = s.r2[c];
      const T e = v - ret;
      if (a.clipped) {
        const T dv = v - vo;
        const T vc = vo + clamp_nan(dv, -a.clip, a.clip);
        const T ec = vc - ret;
        const T e1 = e * e, e2 = ec * ec;
        vl = max_nan(e1, e2);
        const T band = dv >= -a.clip && dv <= a.clip ? T(1) : T(0);
        g = scale * (max_share(e1, e2) * (T(2) * e) +
                     max_share(e2, e1) * band * (T(2) * ec));
      } else {
        vl = e * e;
        g = scale * (T(2) * e);
      }
    }
    s.h[c] = g;
    s.sur[c] = vl;
  }
}

// The items of layer i's sums phase (backward_sums): kDwJ x kDwK weight
// tiles, then a bias each, then for the head layer the actor's std's A and
// the loss terms' one.
struct SumItems {
  int njt, nkt, n_dw, n_db, n;
};
template <typename T>
LEARN_HD SumItems sum_items(const GradsArgs<T>& a, const Role<T>& r, int i,
                            int k) {
  const Layer<T>& L = r.layer[i];
  SumItems it;
  it.njt = tiles_of(L.n_out, kDwJ);
  it.nkt = tiles_of(L.n_in, kDwK);
  it.n_dw = it.njt * it.nkt;
  it.n_db = L.n_out;
  it.n = it.n_dw + it.n_db + (i == r.nl - 1 ? (k == 0 ? a.A + 1 : 1) : 0);
  return it;
}

// The block's sums of weight item p of layer i's sums phase (zero for the
// block's first tile), read from its row `acc` of the scratch.
template <typename T>
LEARN_HD void item_sums(const Role<T>& r, int i, const SumItems& it, int p,
                        const T* acc, bool first, T v[kDwJ][kDwK]) {
  const Layer<T>& L = r.layer[i];
  const int jt = p / it.nkt, kt = p - jt * it.nkt;
#pragma unroll
  for (int q = 0; q < kDwJ; ++q)
#pragma unroll
    for (int c = 0; c < kDwK; ++c) {
      const int j = jt * kDwJ + q, kk = kt + it.nkt * c;
      v[q][c] = first || j >= L.n_out || kk >= L.n_in
                    ? T(0)
                    : ld_shared(acc + r.col_w[i] + j * L.n_in + kk);
    }
}

// The first phase of layer i's backward pass, its output's deltas known
// (the head's in h, a hidden layer's in its rows of y): the tile's weight
// and bias gradients (each summed over the samples in ascending order)
// added to the block's sums; for the head layer also the std's gradients
// and the loss terms.  A weight item is kDwJ outputs (rows j0 ...) by kDwK
// inputs (rows kt, kt + nkt, ...: a quarter warp's rows on distinct banks),
// its samples read as vectors.
template <typename T, typename Team>
LEARN_HD void backward_sums(const Team& tm, const GradsArgs<T>& a,
                            const Role<T>& r, const GradsSmem<T>& s, int i,
                            int k, T* acc, bool first) {
  const Layer<T>& L = r.layer[i];
  const bool last = i == r.nl - 1;
  const T* dout = last ? s.h : s.y + kLd * r.hoff[i];
  const T* in = i == 0 ? s.x : s.y + kLd * r.hoff[i - 1];
  const SumItems it = sum_items(a, r, i, k);
  for (int p = tm.rank(); p < it.n; p += tm.size()) {
    if (p < it.n_dw) {
      const int jt = p / it.nkt, kt = p - jt * it.nkt;
      int jr[kDwJ], kr[kDwK];
#pragma unroll
      for (int q = 0; q < kDwJ; ++q)
        jr[q] = min_i(jt * kDwJ + q, L.n_out - 1) * kLd;
#pragma unroll
      for (int c = 0; c < kDwK; ++c)
        kr[c] = min_i(kt + it.nkt * c, L.n_in - 1) * kLd;
      T sum[kDwJ][kDwK] = {};
#pragma unroll 2
      for (int s4 = 0; s4 < kTile; s4 += 4) {
        T dv[kDwJ][4], iv[kDwK][4];
#pragma unroll
        for (int q = 0; q < kDwJ; ++q) ld4(dout + jr[q] + s4, dv[q]);
#pragma unroll
        for (int c = 0; c < kDwK; ++c) ld4(in + kr[c] + s4, iv[c]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < kDwJ; ++q)
#pragma unroll
            for (int c = 0; c < kDwK; ++c) sum[q][c] += dv[q][u] * iv[c][u];
      }
      T prev[kDwJ][kDwK];
      item_sums(r, i, it, p, acc, first, prev);
      T* gw = acc + r.col_w[i];
#pragma unroll
      for (int q = 0; q < kDwJ; ++q)
#pragma unroll
        for (int c = 0; c < kDwK; ++c) {
          const int j = jt * kDwJ + q, kk = kt + it.nkt * c;
          if (j < L.n_out && kk < L.n_in)
            gw[j * L.n_in + kk] = prev[q][c] + sum[q][c];
        }
    } else if (p < it.n_dw + it.n_db) {
      const int j = p - it.n_dw;
      const T prev = first ? T(0) : ld_shared(acc + r.col_b[i] + j);
      T sum = T(0);
      for (int s4 = 0; s4 < kTile; s4 += 4) {
        T v[4];
        ld4(dout + j * kLd + s4, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) sum += v[u];
      }
      acc[r.col_b[i] + j] = prev + sum;
    } else if (k == 0 && p - it.n_dw - it.n_db < a.A) {
      const int e = p - it.n_dw - it.n_db;
      const T prev = first ? T(0) : ld_shared(acc + r.col_std + e);
      T sum = T(0);
      for (int c = 0; c < kTile; ++c) sum += s.rows[c * r.ldr + 2 * a.A + e];
      acc[r.col_std + e] = prev + sum;
    } else {
      const T prev = first ? T(0) : ld_shared(acc + r.col_loss);
      const T prev_kl =
          first || k != 0 ? T(0) : ld_shared(acc + r.col_loss + 1);
      T sur = T(0), kl = T(0);
      for (int c = 0; c < kTile; ++c) {
        sur += s.sur[c];
        if (k == 0) kl += s.kl[c];
      }
      acc[r.col_loss] = prev + sur;
      if (k == 0) acc[r.col_loss + 1] = prev_kl + kl;
    }
  }
}

// The second phase of layer i's backward pass (i > 0): its input's deltas
// d_{i-1} = activate'(y_{i-1}) * W^T delta, over y_{i-1} in place (each
// element's terms in ascending j).  An item is kDxK inputs (rows kt, kt +
// nkt, ...) by kDxS samples (delta's rows as vectors, placed as the
// forward pass's).
template <typename T, typename Team>
LEARN_HD void backward_deltas(const Team& tm, const GradsArgs<T>& a,
                              const Role<T>& r, const GradsSmem<T>& s, int i) {
  constexpr int kSpan = kTile / (kDxS / 4);
  const Layer<T>& L = r.layer[i];
  const bool last = i == r.nl - 1;
  const T* dout = last ? s.h : s.y + kLd * r.hoff[i];
  T* din = s.y + kLd * r.hoff[i - 1];
  const T* wt = s.wt + r.wtoff[i];
  const int ldt = r.ldt[i];
  const int nkt = tiles_of(L.n_in, kDxK), nst = kSpan / 4;
  for (int p = tm.rank(); p < nkt * nst; p += tm.size()) {
    const int kt = p / nst, s0 = (p % nst) * 4;
    int kr[kDxK];
#pragma unroll
    for (int q = 0; q < kDxK; ++q)
      kr[q] = min_i(kt + nkt * q, L.n_in - 1) * ldt;
    T sum[kDxK][kDxS] = {};
    const T* dp = dout + s0;
#pragma unroll 4
    for (int j = 0; j < L.n_out; ++j, dp += kLd) {
      T w[kDxK], d[kDxS];
#pragma unroll
      for (int q = 0; q < kDxK; ++q) w[q] = wt[kr[q] + j];
#pragma unroll
      for (int m = 0; m < kDxS / 4; ++m) ld4(dp + m * kSpan, d + 4 * m);
#pragma unroll
      for (int q = 0; q < kDxK; ++q)
#pragma unroll
        for (int c = 0; c < kDxS; ++c) sum[q][c] += w[q] * d[c];
    }
#pragma unroll
    for (int q = 0; q < kDxK; ++q) {
      const int kk = kt + nkt * q;
      if (kk >= L.n_in) break;
      T* e = din + kk * kLd + s0;
      const unsigned char* sign = s.pos + (r.hoff[i - 1] + kk) * kQuads;
      T y[kDxS];
      unsigned bits = 0;
#pragma unroll
      for (int m = 0; m < kDxS / 4; ++m) {
        ld4(e + m * kSpan, y + 4 * m);
        if (a.neg)
          bits |= static_cast<unsigned>(sign[(s0 + m * kSpan) / 4]) << (4 * m);
      }
#pragma unroll
      for (int c = 0; c < kDxS; ++c) {
        const bool pos = a.neg ? ((bits >> c) & 1u) != 0 : y[c] > T(0);
        y[c] = activate_grad(a.act, a.alpha, y[c], pos) * sum[q][c];
      }
#pragma unroll
      for (int m = 0; m < kDxS / 4; ++m) st4(e + m * kSpan, y + 4 * m);
    }
  }
}

// The block `blk` of grads: blocks [0, blocks[0]) take the actor, the rest
// the critic; a role's block b owns the tiles [b * n / G, (b+1) * n / G)
// of the minibatch's n tiles, and sums their gradients into its row of the
// scratch (tile by tile).  `base` is its workspace (role elems).  While a
// tile computes, the next one's indices (from the forward pass on), loss
// rows (from the loss stage's last read on) and observations (during the
// last backward phase, into the spare rows) are in flight.
template <typename T, typename Team>
LEARN_HD void grads_block(const Team& tm, const GradsArgs<T>& a, int blk,
                          T* base) {
  const int k = blk < a.blocks[0] ? 0 : 1;
  const int b = k == 0 ? blk : blk - a.blocks[0];
  const Role<T>& r = a.role[k];
  const GradsSmem<T> s = grads_smem(a, r, k, base);
  T* acc = a.part[k] + static_cast<size_t>(b) * r.stride;
  tm.stamp(kStampStart);
  const int ntiles = (a.B + kTile - 1) / kTile;
  const int G = a.blocks[k];
  const int t0 = static_cast<int>(static_cast<long long>(b) * ntiles / G);
  const int t1 = static_cast<int>(static_cast<long long>(b + 1) * ntiles / G);
  const int t_rec = t0 + 1 < t1 ? t0 + 1 : t0;
  fetch_idx(tm, a, s, t0);
  tm.copy_wait();
  tm.sync();
  stage(tm, a, r, s, k == 0);
  fetch_x(tm, a, s, t0);
  fetch_rows(tm, a, r, s, k, t0);
  tm.copy_wait();
  tm.sync();
  place_x(tm, a, s, t0);
  tm.sync();
  tm.stamp(kStampStaged);
  for (int t = t0; t < t1; ++t) {
    const bool rec = t == t_rec, next = t + 1 < t1, first = t == t0;
    const int ns = tile_samples(a, t);
    if (rec) tm.stamp(kStampTile);
    if (next) fetch_idx(tm, a, s, t + 1);
    for (int i = 0; i < r.nl; ++i) {
      forward_layer(tm, a, r, s, i);
      tm.sync();
      if (rec) tm.stamp(kStampFwd + i);
    }
    if (k == 0)
      actor_loss(tm, a, r, s, ns, rec);
    else
      critic_loss(tm, a, s, ns);
    tm.sync();
    if (rec) tm.stamp(kStampLoss + 2);
    for (int i = r.nl - 1; i >= 0; --i) {
      const bool head = i == r.nl - 1;
      if (next && i == 0 && r.nl > 1) fetch_x(tm, a, s, t + 1);
      backward_sums(tm, a, r, s, i, k, acc, first);
      if (next && head) tm.copy_wait();  // the next tile's indices
      tm.sync();
      if (rec) tm.stamp(kStampBwd + 2 * i);
      if (next && head) {
        fetch_rows(tm, a, r, s, k, t + 1);
        if (r.nl == 1) fetch_x(tm, a, s, t + 1);
      }
      if (i > 0) {
        backward_deltas(tm, a, r, s, i);
        tm.sync();
        if (rec) tm.stamp(kStampBwd + 2 * i + 1);
      }
    }
    if (next) {
      tm.copy_wait();
      tm.sync();
      place_x(tm, a, s, t + 1);
      tm.sync();
      if (rec) tm.stamp(kStampGather);
    }
  }
  tm.stamp(kStampWalk);
}

// Group g of role k: the sums of its blocks [g * group, ...), added in
// block order, into the group's row.
template <typename T, typename Team>
LEARN_HD void grads_group(const Team& tm, const GradsArgs<T>& a, int k,
                          int g) {
  const Role<T>& r = a.role[k];
  const int b0 = g * a.group, nb = min_i(a.group, a.blocks[k] - b0);
  const T* src = a.part[k] + static_cast<size_t>(b0) * r.stride;
  T* dst = a.gsum[k] + static_cast<size_t>(g) * r.stride;
  col_sums(tm, src, r.stride, nb, r.width, [&](int p, T sum) { dst[p] = sum; });
}

// Role k's grid sums (each column's groups added in group order) into the
// flat buffer: its layers' gradients; the actor's std's with the entropy's
// term, zero where the floor clamps it.  The loss terms' sums go to the
// first group's row, for grads_losses.
template <typename T, typename Team>
LEARN_HD void grads_final(const Team& tm, const GradsArgs<T>& a, int k) {
  const Role<T>& r = a.role[k];
  T* row = a.gsum[k];
  col_sums(tm, row, r.stride, a.groups[k], r.width, [&](int p, T sum) {
    if (p >= r.col_loss) {
      row[p] = sum;
    } else if (p >= r.col_std) {
      const int i = p - r.col_std;
      const T sd = std_eff(a, i);
      const bool held = a.std_floor > T(0) && !(a.std[i] >= a.std_floor);
      a.flat[a.std_off + i] =
          held ? T(0) : sum - a.entropy_coef * (T(1) / sd);
    } else {
      int i = 0;
      while (p >= r.col_b[i] + r.layer[i].n_out) ++i;
      a.flat[p < r.col_b[i] ? r.flat_w[i] + p - r.col_w[i]
                            : r.flat_b[i] + p - r.col_b[i]] = sum;
    }
  });
}

// The losses (loss, surrogate, value loss) and the KL at P, from both
// roles' loss sums.
template <typename T, typename Team>
LEARN_HD void grads_losses(const Team& tm, const GradsArgs<T>& a) {
  if (tm.rank() != 0) return;
  const T half_log = T(1.4189385332046727);  // 0.5 * (1 + log(2 pi))
  const T nb = static_cast<T>(a.B);
  const T* sa = a.gsum[0] + a.role[0].col_loss;
  const T sur = ld_shared(sa) / nb;
  const T kl = ld_shared(sa + 1) / nb;
  const T vl = ld_shared(a.gsum[1] + a.role[1].col_loss) / nb;
  T ent = T(0);
  for (int i = 0; i < a.A; ++i) ent += half_log + T(log(std_eff(a, i)));
  a.losses[0] = (sur + a.value_coef * vl) - a.entropy_coef * ent;
  a.losses[1] = sur;
  a.losses[2] = vl;
  a.flat[a.P] = kl;
}

// ---- adam -----------------------------------------------------------------

template <typename T>
struct AdamArgs {
  int P, ntensors, adaptive, world, chunks, blocks;
  T desired_hi, desired_lo, max_norm, beta1, beta2, eps, lr_min, lr_max,
      factor;
  T *flat, *lr, *stats, *scratch;
  const T* losses;
  int* counter;
  // per tensor in flat order: its elements, its flat offset, its first
  // chunk (chunk0[ntensors]: the chunks)
  int numel[kMaxTensors], off[kMaxTensors], chunk0[kMaxTensors + 1];
  T *param[kMaxTensors], *m[kMaxTensors], *v[kMaxTensors];
  float* step[kMaxTensors];
};

// adam's scratch: the norm, the lr, each tensor's step size (lr over its
// first bias correction) and second bias correction, then the chunks' sums
// of squares.
LEARN_HD int adam_scratch_elems(int ntensors, int chunks) {
  return 2 + 2 * ntensors + chunks;
}

template <typename T>
inline bool read_adam(const int* ints, int nints, const double* reals,
                      int nreals, const void* const* ptrs, int nptrs,
                      AdamArgs<T>* a) {
  if (nints < adam_int::kCount || nreals != adam_real::kCount ||
      nptrs < adam_ptr::kCount)
    return false;
  a->P = ints[adam_int::P];
  a->ntensors = ints[adam_int::ntensors];
  a->adaptive = ints[adam_int::adaptive];
  a->world = ints[adam_int::world];
  a->chunks = ints[adam_int::chunks];
  a->blocks = ints[adam_int::blocks];
  const int nt = a->ntensors;
  if (a->P < 1 || nt < 1 || nt > kMaxTensors || a->world < 1 ||
      a->blocks < 1 || a->blocks > a->chunks ||
      nints != adam_int::kCount + 2 * nt || nptrs != adam_ptr::kCount + 4 * nt)
    return false;
  const double* R = reals;
  // as the plain version's comparisons and clamps round Python's numbers
  a->desired_hi = static_cast<T>(R[adam_real::desired_kl] * 2.0);
  a->desired_lo = static_cast<T>(R[adam_real::desired_kl] / 2.0);
  a->max_norm = static_cast<T>(R[adam_real::max_grad_norm]);
  a->beta1 = static_cast<T>(R[adam_real::beta1]);
  a->beta2 = static_cast<T>(R[adam_real::beta2]);
  a->eps = static_cast<T>(R[adam_real::eps]);
  a->lr_min = static_cast<T>(R[adam_real::lr_min]);
  a->lr_max = static_cast<T>(R[adam_real::lr_max]);
  a->factor = static_cast<T>(R[adam_real::lr_factor]);
  auto mp = [&](int k) { return const_cast<void*>(ptrs[k]); };
  a->flat = static_cast<T*>(mp(adam_ptr::flat));
  a->lr = static_cast<T*>(mp(adam_ptr::lr));
  a->losses = static_cast<const T*>(ptrs[adam_ptr::losses]);
  a->stats = static_cast<T*>(mp(adam_ptr::stats));
  a->scratch = static_cast<T*>(mp(adam_ptr::scratch));
  a->counter = static_cast<int*>(mp(adam_ptr::counter));
  for (int k = 0; k < nptrs; ++k)
    if (!ptrs[k]) return false;
  // the tensors tile [0, P) in order
  long long at = 0, chunks = 0;
  for (int t = 0; t < nt; ++t) {
    a->numel[t] = ints[adam_int::kCount + 2 * t];
    a->off[t] = ints[adam_int::kCount + 2 * t + 1];
    if (a->numel[t] < 1 || a->off[t] != at) return false;
    at += a->numel[t];
    a->chunk0[t] = static_cast<int>(chunks);
    chunks += (a->numel[t] + kAdamChunk - 1) / kAdamChunk;
    const int q = adam_ptr::kCount + 4 * t;
    a->param[t] = static_cast<T*>(mp(q));
    a->m[t] = static_cast<T*>(mp(q + 1));
    a->v[t] = static_cast<T*>(mp(q + 2));
    a->step[t] = static_cast<float*>(mp(q + 3));
  }
  a->chunk0[nt] = static_cast<int>(chunks);
  return at == a->P && chunks == a->chunks;
}

LEARN_HD float pow_t(float a, float b) { return powf(a, b); }
LEARN_HD double pow_t(double a, double b) { return pow(a, b); }

// The tensor of chunk k (the last whose first chunk is at most k).
template <typename T>
LEARN_HD int adam_tensor(const AdamArgs<T>& a, int k) {
  int lo = 0, hi = a.ntensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (a.chunk0[mid] <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Four consecutive elements at p: one 16-byte load on the card where p is
// 16-byte aligned (two in float64), two 8-byte loads where it is 8-byte
// aligned in float32, else four.  Within a chunk every member's 4 elements
// share one alignment, so the branch is uniform.
template <typename T>
LEARN_HD void ld4_any(const T* p, T v[4]) {
#ifdef __CUDA_ARCH__
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (at % 16 == 0) {
    ld4(p, v);
    return;
  }
  if constexpr (sizeof(T) == 4) {
    if (at % 8 == 0) {
      const float2 f = reinterpret_cast<const float2*>(p)[0];
      const float2 g = reinterpret_cast<const float2*>(p)[1];
      v[0] = f.x, v[1] = f.y, v[2] = g.x, v[3] = g.y;
      return;
    }
  }
#endif
  for (int u = 0; u < 4; ++u) v[u] = p[u];
}
template <typename T>
LEARN_HD void st4_any(T* p, const T v[4]) {
#ifdef __CUDA_ARCH__
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  if (at % 16 == 0) {
    st4(p, v);
    return;
  }
  if constexpr (sizeof(T) == 4) {
    if (at % 8 == 0) {
      reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
      reinterpret_cast<float2*>(p)[1] = make_float2(v[2], v[3]);
      return;
    }
  }
#endif
  for (int u = 0; u < 4; ++u) p[u] = v[u];
}

// Elements e .. e + 3 of a chunk of n elements at p (those at n and above:
// 0), and their store.
template <typename T>
LEARN_HD void ld_group(const T* p, int e, int n, T x[4]) {
  if (e + 4 <= n) {
    ld4_any(p + e, x);
    return;
  }
  for (int u = 0; u < 4; ++u) x[u] = e + u < n ? p[e + u] : T(0);
}
template <typename T>
LEARN_HD void st_group(T* p, int e, int n, const T x[4]) {
  if (e + 4 <= n) {
    st4_any(p + e, x);
    return;
  }
  for (int u = 0; u < 4; ++u)
    if (e + u < n) p[e + u] = x[u];
}

// The sum of lanes[0 .. kAdamThreads) by a fixed tree (lanes[v] +=
// lanes[v + h], h = kAdamThreads / 2, ..., 1), into lanes[0]; the team is
// synced before and after.  On the card (a block of kAdamThreads) the last
// five levels run in warp 0's registers by shuffles: the same sums.
template <typename T, typename Team>
LEARN_HD void lanes_tree(const Team& tm, T* lanes) {
  int h = kAdamThreads / 2;
#ifdef __CUDA_ARCH__
  for (; h >= 32; h /= 2) {
    tm.sync();
    if (tm.rank() < h) lanes[tm.rank()] += lanes[tm.rank() + h];
  }
  tm.sync();
  if (tm.rank() < 32) {
    T x = lanes[tm.rank()];
    for (; h > 0; h /= 2) x += __shfl_down_sync(0xffffffffu, x, h);
    if (tm.rank() == 0) lanes[0] = x;
  }
#else
  for (; h > 0; h /= 2) {
    tm.sync();
    for (int v = tm.rank(); v < h; v += tm.size()) lanes[v] += lanes[v + h];
  }
#endif
  tm.sync();
}

// x over the world (x itself for a world of one: the same bits, without a
// division).
template <typename T>
LEARN_HD T over_world(T x, int world) {
  return world == 1 ? x : x / static_cast<T>(world);
}

// The adaptive lr from the KL (over the world) and the lr before it.
template <typename T>
LEARN_HD T adam_lr(const AdamArgs<T>& a, T kl) {
  T lr = *a.lr;
  if (a.adaptive) {
    if (kl > a.desired_hi) {
      const T x = lr / a.factor;
      lr = x < a.lr_min ? a.lr_min : x;
    } else if (kl < a.desired_lo && kl > T(0)) {
      const T x = lr * a.factor;
      lr = x > a.lr_max ? a.lr_max : x;
    }
  }
  return lr;
}

// Waits, in a kernel launched as the programmatic dependent of the one
// before it in the stream, until that kernel has ended and its writes are
// visible; nothing on the host, whose phases run in order.
LEARN_HD void wait_prior_grid() {
#ifdef __CUDA_ARCH__
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// Chunk k's tensor t, its first element e0 in t and its elements n.
template <typename T>
LEARN_HD void adam_chunk(const AdamArgs<T>& a, int k, int* t, int* e0,
                         int* n) {
  *t = adam_tensor(a, k);
  *e0 = (k - a.chunk0[*t]) * kAdamChunk;
  *n = min_i(kAdamChunk, a.numel[*t] - *e0);
}

// Phase A, block blk of a.blocks: for its tensors t = blk, blk + blocks,
// ..., the step count, step size and second bias correction (torch's fused
// Adam: the step incremented first, its corrections in T) into the
// scratch; for its chunks k = blk, blk + blocks, ..., the sum of squares of
// the chunk's gradients over the world (lane v adds its 4 elements' in
// order, then the lanes' tree) into the scratch.  `lanes`: kAdamThreads
// elements of workspace.
template <typename T, typename Team>
LEARN_HD void adam_sums(const Team& tm, const AdamArgs<T>& a, int blk,
                        T* lanes) {
  tm.stamp(kStampAdamStart);
  const int nt = a.ntensors;
  for (int t = blk + tm.rank() * a.blocks; t < nt;
       t += a.blocks * tm.size()) {
    const T lr = adam_lr(a, over_world(a.flat[a.P], a.world));
    const float st = *a.step[t] + 1.0f;
    *a.step[t] = st;
    a.scratch[2 + t] = lr / (T(1) - pow_t(a.beta1, static_cast<T>(st)));
    a.scratch[2 + nt + t] =
        static_cast<T>(sqrt(T(1) - pow_t(a.beta2, static_cast<T>(st))));
  }
  T* const part = a.scratch + adam_scratch_elems(nt, 0);
  for (int k = blk; k < a.chunks; k += a.blocks) {
    int t, e0, n;
    adam_chunk(a, k, &t, &e0, &n);
    const T* const g = a.flat + a.off[t] + e0;
    for (int v = tm.rank(); v < kAdamThreads; v += tm.size()) {
      T x[4];
      ld_group(g, 4 * v, n, x);
      T s = T(0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T q = over_world(x[u], a.world);
        s = fma_t(q, q, s);
      }
      lanes[v] = s;
    }
    lanes_tree(tm, lanes);
    if (tm.rank() == 0) part[k] = lanes[0];
  }
  tm.sync();
  tm.stamp(kStampAdamSquares);
}

// Phase A's end, by the last block to arrive: the chunks' sums in chunk
// order (lane v adds chunks v, v + kAdamThreads, ..., then the lanes'
// tree), the norm; the KL over the world, the adaptive lr and the
// statistics.
template <typename T, typename Team>
LEARN_HD void adam_final(const Team& tm, const AdamArgs<T>& a, T* lanes) {
  const T* const part = a.scratch + adam_scratch_elems(a.ntensors, 0);
  // member 0's loads first, in flight while the lanes add the sums
  T kl = T(0), lr = T(0), losses[3];
  if (tm.rank() == 0) {
    kl = over_world(a.flat[a.P], a.world);
    lr = adam_lr(a, kl);
    for (int k = 0; k < 3; ++k) losses[k] = a.losses[k];
  }
  for (int v = tm.rank(); v < kAdamThreads; v += tm.size()) {
    T s = T(0);
    for (int k = v; k < a.chunks; k += kAdamThreads) s += ld_shared(part + k);
    lanes[v] = s;
  }
  lanes_tree(tm, lanes);
  if (tm.rank() == 0) {
    a.flat[a.P] = kl;
    *a.lr = lr;
    a.scratch[0] = static_cast<T>(sqrt(lanes[0]));
    a.scratch[1] = lr;
    for (int k = 0; k < 3; ++k) a.stats[k] = losses[k];
    a.stats[3] = kl;
  }
  tm.stamp(kStampAdamTree);
}

// Phase B, block blk of a.blocks: Adam's step on its chunks k = blk, blk +
// blocks, ...: every operand of a member's elements loaded at once, the
// gradient over the world and clipped, the moments and the parameter by
// torch's fused Adam's formula, each written back where it was read (the
// clipped gradient into the flat buffer).  Phase A writes none of the
// operands, so a kernel launched as phase A's programmatic dependent loads
// its first chunk's while phase A runs, and waits for it
// (wait_prior_grid) before it reads the scratch and stores.
template <typename T, typename Team>
LEARN_HD void adam_step(const Team& tm, const AdamArgs<T>& a, int blk) {
  tm.stamp(kStampAdamPass);
  const T* const sc = a.scratch;
  for (int k = blk; k < a.chunks; k += a.blocks) {
    int t, e0, n;
    adam_chunk(a, k, &t, &e0, &n);
    T* const g = a.flat + a.off[t] + e0;
    T* const m = a.m[t] + e0;
    T* const v = a.v[t] + e0;
    T* const p = a.param[t] + e0;
    for (int r = tm.rank(); r < kAdamThreads; r += tm.size()) {
      const int e = 4 * r;
      T xg[4], xm[4], xv[4], xp[4];
      ld_group(g, e, n, xg);
      ld_group(m, e, n, xm);
      ld_group(v, e, n, xv);
      ld_group(p, e, n, xp);
      wait_prior_grid();
      if (k == blk) tm.stamp(kStampAdamWait);
      const T norm = sc[0], size = sc[2 + t], bc2 = sc[2 + a.ntensors + t];
      const bool keep = norm < a.max_norm;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        T gj = over_world(xg[u], a.world);
        if (!keep) gj = (gj / norm) * a.max_norm;
        const T mj = fma_t(a.beta1, xm[u], fma_t(-a.beta1, gj, gj));
        const T gg = gj * gj;
        const T vj = fma_t(a.beta2, xv[u], fma_t(-a.beta2, gg, gg));
        const T denom = static_cast<T>(sqrt(vj)) / bc2 + a.eps;
        xp[u] = xp[u] - size * mj / denom;
        xg[u] = gj;
        xm[u] = mj;
        xv[u] = vj;
      }
      st_group(g, e, n, xg);
      st_group(m, e, n, xm);
      st_group(v, e, n, xv);
      st_group(p, e, n, xp);
    }
    if (k == blk) tm.stamp(kStampAdamFirst);
  }
  if (blk + a.blocks < a.chunks) tm.stamp(kStampAdamLast);
}

}  // namespace learn_env
