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
// (rows idx of the (T·N, ·) trajectory, gathered as they are read), the
// feed-forward actor's or critic's forward pass, the per-sample gradients
// of the PPO loss (the clipped surrogate and the log-probability through
// the actor and the std, the clipped value loss through the critic), their
// backward pass, and sums the weight, bias and std gradients and the loss
// terms over its samples; grads_group and grads_final sum the blocks'
// partials over the grid and write every gradient and the KL into the flat
// buffer and (loss, surrogate, value loss) into the losses.  They port the
// JAX update's value_and_grad of loss_fn (nightmare_rl_tpu/rl/ppo.py:
// 339-348, _loss_terms :222-242, models/actor_critic.py:133-159).
//
// adam_block divides the flat buffer (the gradients and, last, the KL,
// summed over the ranks) by the world, sets the adaptive learning rate from
// the KL, clips the gradients by their global norm (optax's rule) and takes
// Adam's step on every parameter tensor (torch's fused Adam's formula),
// counting each tensor's step.  It ports the optax chain and _adapt_lr
// (nightmare_rl_tpu/rl/ppo.py:100-103, :244-255, :349-359).
//
// The team contract is rollout_env.cuh's: rank(), size(), sync(),
// copy(dst, src) and copy_wait().  Work is split by index, and every sum
// runs in an order that does not depend on the team's size: a product's
// element sums its terms in ascending order; the gradients of a block's
// tile of samples are summed over the tile, then added to the block's sums
// tile by tile; the grid's partial sums are added group by group in block
// order, then the groups in order; the GAE and Adam sums run over a fixed
// number of virtual lanes, then a fixed tree.  No float atomics: a replay
// gives the eager call's bits.

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
constexpr int kTile = 32;         // samples of a grads tile
#ifndef LEARN_TILE_R
#define LEARN_TILE_R 4
#endif
#ifndef LEARN_TILE_C
#define LEARN_TILE_C 2
#endif
// A product's register tile: rows and columns (kTile a multiple of them).
// Every shape gives the same bits (an element sums its terms in order).
// On the card a minibatch took 518-520 us at 4 x 2, 568-573 at 4 x 4,
// 529-532 at 2 x 4, 550-552 at 2 x 2, 638-639 at 1 x 4 with the k loop
// unrolled twice; 491-493 at 4 x 2 unrolled 4 or 8 times, or with 512
// threads a block (PERF.md §6).
constexpr int kTR = LEARN_TILE_R;
constexpr int kTC = LEARN_TILE_C;
constexpr int kLd = kTile + 1;    // a feature-major row's length (odd)
constexpr int kAdamLanes = 1024;  // adam's virtual lanes for the norm
constexpr int kMaxTensors = 64;   // adam's parameter tensors at most
constexpr int kAhead = 4;         // adam's elements a member loads at once
constexpr int kMaxTeam = 64;      // host team members at most

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
// the adaptive schedule (0 or 1), the world; then per tensor its elements
// and its gradient's flat offset.
#define LEARN_ADAM_INTS(X) X(P) X(ntensors) X(adaptive) X(world)
// the KL target, the clip's norm, Adam's betas and eps, the lr's bounds and
// factor.
#define LEARN_ADAM_REALS(X)                                                   \
  X(desired_kl) X(max_grad_norm) X(beta1) X(beta2) X(eps) X(lr_min)           \
  X(lr_max) X(lr_factor)
// the flat buffer (P + 1), the lr (), the losses (3); output the
// statistics (4: the losses and the KL); then per tensor its parameter,
// Adam's exp_avg and exp_avg_sq and its step (float32).
#define LEARN_ADAM_PTRS(X) X(flat) X(lr) X(losses) X(stats)

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

// d activate(z) / dz from z and y = activate(z): ELU and SELU from y below
// 0 (y + alpha is alpha * exp(z)).
template <typename T>
LEARN_HD T activate_grad(int kind, T alpha, T z, T y) {
  switch (kind) {
    case rollout_env::kElu:
      return z > T(0) ? T(1) : y + alpha;
    case rollout_env::kRelu:
      return z > T(0) ? T(1) : T(0);
    case rollout_env::kSelu: {
      const T scale = T(1.0507009873554804934193349852946);
      const T salpha = T(1.6732632423543772848170429916717);
      return z > T(0) ? scale : y + scale * salpha;
    }
    case rollout_env::kLeakyRelu:
      return z > T(0) ? T(1) : alpha;
    case rollout_env::kTanh:
      return T(1) - y * y;
    default:  // kSigmoid
      return y * (T(1) - y);
  }
}

// acc[r][c] += sum over k < K of a[ao[r] + k * ak] * b[bo[c] + k * bk], k
// ascending: a kTR x kTC tile of a product, its rows and columns at the
// given offsets (a tail's offsets repeat a valid row; its results are
// dropped).
template <typename T>
LEARN_HD void tile_dot(int K, const T* a, const int ao[kTR], int ak,
                       const T* b, const int bo[kTC], int bk,
                       T acc[kTR][kTC]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    T av[kTR], bv[kTC];
#pragma unroll
    for (int r = 0; r < kTR; ++r) av[r] = a[ao[r] + k * ak];
#pragma unroll
    for (int c = 0; c < kTC; ++c) bv[c] = b[bo[c] + k * bk];
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) acc[r][c] += av[r] * bv[c];
  }
}

LEARN_HD int min_i(int a, int b) { return a < b ? a : b; }
LEARN_HD int tiles_of(int n, int t) { return (n + t - 1) / t; }

// put(p, sum of src[q * stride + p] over the rows q < nrows, in row order)
// for every column p < W: a member takes kCols columns at a time and loads
// kRows rows of them before it adds them (the rows were written by other
// blocks of the grid: many loads in flight hide L2's latency).
template <typename T, typename Team, typename Put>
LEARN_HD void col_sums(const Team& tm, const T* src, size_t stride,
                       int nrows, int W, Put put) {
  constexpr int kCols = 4, kRows = 8;
  for (int p0 = tm.rank() * kCols; p0 < W; p0 += tm.size() * kCols) {
    T sum[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) sum[c] = T(0);
    for (int q0 = 0; q0 < nrows; q0 += kRows) {
      T v[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          v[r][c] = q0 + r < nrows && p0 + c < W
                        ? ld_shared(src + (q0 + r) * stride + p0 + c)
                        : T(0);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (q0 + r < nrows) sum[c] += v[r][c];
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
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
// layers, their staged weights' offsets and row lengths, their activations'
// offsets (hidden layers; elements of the y and d buffers, kLd a unit),
// their gradients' columns in a block's sums (weights row-major, then the
// biases) and in the flat buffer; the std's and the loss terms' columns.
template <typename T>
struct Role {
  int nl, width, in0, wsize, hsize, head;
  Layer<T> layer[kMaxLayers];
  int ld[kMaxLayers], woff[kMaxLayers], hoff[kMaxLayers];
  int col_w[kMaxLayers], col_b[kMaxLayers];
  int flat_w[kMaxLayers], flat_b[kMaxLayers];
  int col_std, col_loss;  // the actor's std (A) and (surrogate, kl) sums;
                          // the critic's value loss sum (col_loss)
};

template <typename T>
struct GradsArgs {
  int B, A, nobs, act, blocks[2], group, groups[2], clipped, P, std_off;
  T std_floor, alpha, clip, value_coef, entropy_coef;
  const T *obs, *action, *mu, *sigma, *logp, *value, *returns, *adv, *std;
  const long long* idx;
  T *flat, *losses, *part[2], *gsum[2];
  int* counters;
  Role<T> role[2];
};

// The shared memory of a role's block (elements): the staged weights, the
// block's sums, the input tile (in0 x kLd), the hidden outputs y and their
// derivatives d (then deltas), the head (outputs, then deltas), and the
// loss stage's scratch (three A x kLd, three kLd).
template <typename T>
LEARN_HD int role_smem_elems(const GradsArgs<T>& a, const Role<T>& r) {
  return r.wsize + r.width + kLd * (r.in0 + 2 * r.hsize + r.head) +
         kLd * (3 * a.A + 3);
}

template <typename T>
LEARN_HD int grads_smem_elems(const GradsArgs<T>& a) {
  const int x = role_smem_elems(a, a.role[0]), y = role_smem_elems(a, a.role[1]);
  return x > y ? x : y;
}

// The scratch's elements: each block's sums, then each group's.
template <typename T>
LEARN_HD long long grads_scratch_elems(const GradsArgs<T>& a) {
  long long n = 0;
  for (int k = 0; k < 2; ++k)
    n += static_cast<long long>(a.blocks[k] + a.groups[k]) * a.role[k].width;
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
    r.width = r.wsize = r.hsize = 0;
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
      r.ld[i] = odd_ld(n_in);
      r.woff[i] = r.wsize;
      r.wsize += n_out * r.ld[i];
      r.hoff[i] = r.hsize;
      if (i < r.nl - 1) r.hsize += n_out;
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
  }
  if (static_cast<long long>(I[grads_int::scratch]) < grads_scratch_elems(*a))
    return false;
  T* s = scratch;
  for (int k = 0; k < 2; ++k) {
    a->part[k] = s;
    s += static_cast<size_t>(a->blocks[k]) * a->role[k].width;
  }
  for (int k = 0; k < 2; ++k) {
    a->gsum[k] = s;
    s += static_cast<size_t>(a->groups[k]) * a->role[k].width;
  }
  return true;
}

template <typename T>
struct GradsSmem {
  T *w, *acc, *x, *y, *d, *h, *l1, *l2, *dd, *g, *sur, *kl;
};

template <typename T>
LEARN_HD GradsSmem<T> grads_smem(const GradsArgs<T>& a, const Role<T>& r,
                                 T* base) {
  GradsSmem<T> s;
  s.w = base;
  s.acc = s.w + r.wsize;
  s.x = s.acc + r.width;
  s.y = s.x + kLd * r.in0;
  s.d = s.y + kLd * r.hsize;
  s.h = s.d + kLd * r.hsize;
  s.l1 = s.h + kLd * r.head;
  s.l2 = s.l1 + kLd * a.A;
  s.dd = s.l2 + kLd * a.A;
  s.g = s.dd + kLd * a.A;
  s.sur = s.g + kLd;
  s.kl = s.sur + kLd;
  return s;
}

// The sampling std of action i: std clamped by the floor where it is above 0.
template <typename T>
LEARN_HD T std_eff(const GradsArgs<T>& a, int i) {
  const T sd = a.std[i];
  return a.std_floor > T(0) && sd < a.std_floor ? a.std_floor : sd;
}

// Layer i's forward pass over the tile: z = W x + b, and for a hidden layer
// y = activate(z) and d = activate'(z) (the head's z into h).
template <typename T, typename Team>
LEARN_HD void forward_layer(const Team& tm, const GradsArgs<T>& a,
                            const Role<T>& r, const GradsSmem<T>& s, int i) {
  const Layer<T>& L = r.layer[i];
  const bool last = i == r.nl - 1;
  const T* x = i == 0 ? s.x : s.y + kLd * r.hoff[i - 1];
  T* y = last ? s.h : s.y + kLd * r.hoff[i];
  T* d = s.d + kLd * r.hoff[i];
  const T* w = s.w + r.woff[i];
  const int ld = r.ld[i], mt = tiles_of(L.n_out, kTR), nt = kTile / kTC;
  for (int p = tm.rank(); p < mt * nt; p += tm.size()) {
    const int j0 = (p / nt) * kTR, s0 = (p % nt) * kTC;
    int ao[kTR], bo[kTC];
#pragma unroll
    for (int q = 0; q < kTR; ++q) ao[q] = min_i(j0 + q, L.n_out - 1) * ld;
#pragma unroll
    for (int c = 0; c < kTC; ++c) bo[c] = s0 + c;
    T acc[kTR][kTC] = {};
    tile_dot(L.n_in, w, ao, 1, x, bo, kLd, acc);
#pragma unroll
    for (int q = 0; q < kTR; ++q) {
      const int j = j0 + q;
      if (j >= L.n_out) break;
      const T b = L.b[j];
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const T z = acc[q][c] + b;
        if (last) {
          y[j * kLd + s0 + c] = z;
        } else {
          const T v = activate(a.act, a.alpha, z);
          y[j * kLd + s0 + c] = v;
          d[j * kLd + s0 + c] = activate_grad(a.act, a.alpha, z, v);
        }
      }
    }
  }
}

// Layer i's backward pass over the tile, its output's deltas known (the
// head's in h, a hidden layer's in d): the weight and bias gradients of
// the tile added to the block's sums, and (i > 0) the input's deltas
// d_{i-1} *= W^T delta, in place.
template <typename T, typename Team>
LEARN_HD void backward_layer(const Team& tm, const Role<T>& r,
                             const GradsSmem<T>& s, int i) {
  const Layer<T>& L = r.layer[i];
  const bool last = i == r.nl - 1;
  const T* dout = last ? s.h : s.d + kLd * r.hoff[i];
  const T* in = i == 0 ? s.x : s.y + kLd * r.hoff[i - 1];
  T* din = i == 0 ? nullptr : s.d + kLd * r.hoff[i - 1];
  const T* w = s.w + r.woff[i];
  const int ld = r.ld[i];
  const int mw = tiles_of(L.n_out, kTR), nw = tiles_of(L.n_in, kTC);
  const int n_dw = mw * nw, n_db = L.n_out;
  const int n_dx = i == 0 ? 0 : tiles_of(L.n_in, kTR) * (kTile / kTC);
  T* gw = s.acc + r.col_w[i];
  T* gb = s.acc + r.col_b[i];
  for (int p = tm.rank(); p < n_dw + n_db + n_dx; p += tm.size()) {
    int ao[kTR], bo[kTC];
    T acc[kTR][kTC] = {};
    if (p < n_dw) {
      // dW[j][k] += sum_s delta[j][s] x[k][s]
      const int j0 = (p / nw) * kTR, k0 = (p % nw) * kTC;
#pragma unroll
      for (int q = 0; q < kTR; ++q) ao[q] = min_i(j0 + q, L.n_out - 1) * kLd;
#pragma unroll
      for (int c = 0; c < kTC; ++c) bo[c] = min_i(k0 + c, L.n_in - 1) * kLd;
      tile_dot(kTile, dout, ao, 1, in, bo, 1, acc);
#pragma unroll
      for (int q = 0; q < kTR; ++q)
#pragma unroll
        for (int c = 0; c < kTC; ++c)
          if (j0 + q < L.n_out && k0 + c < L.n_in)
            gw[(j0 + q) * L.n_in + k0 + c] += acc[q][c];
    } else if (p < n_dw + n_db) {
      const int j = p - n_dw;
      T sum = T(0);
      for (int c = 0; c < kTile; ++c) sum += dout[j * kLd + c];
      gb[j] += sum;
    } else {
      // d_{i-1}[k][s] *= sum_j W[j][k] delta[j][s]
      const int q0 = p - n_dw - n_db;
      const int k0 = (q0 / (kTile / kTC)) * kTR;
      const int s0 = (q0 % (kTile / kTC)) * kTC;
#pragma unroll
      for (int q = 0; q < kTR; ++q) ao[q] = min_i(k0 + q, L.n_in - 1);
#pragma unroll
      for (int c = 0; c < kTC; ++c) bo[c] = s0 + c;
      tile_dot(L.n_out, w, ao, ld, dout, bo, kLd, acc);
#pragma unroll
      for (int q = 0; q < kTR; ++q) {
        if (k0 + q >= L.n_in) break;
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
          T& e = din[(k0 + q) * kLd + s0 + c];
          e = e * acc[q][c];
        }
      }
    }
  }
}

// The actor's loss stage over a tile of ns samples from row r0 of the
// minibatch: each sample's log-probability, ratio, clipped surrogate and
// KL; the head's deltas d loss / d mu (the mean's 1/B in them) into h,
// the tile's std gradients and surrogate and KL sums added to the block's.
template <typename T, typename Team>
LEARN_HD void actor_loss(const Team& tm, const GradsArgs<T>& a,
                         const Role<T>& r, const GradsSmem<T>& s, int r0,
                         int ns) {
  const int A = a.A;
  const T c2pi = T(1.8378770664093453);  // Python's math.log(2.0 * math.pi)
  for (int p = tm.rank(); p < A * kTile; p += tm.size()) {
    const int i = p / kTile, c = p - i * kTile;
    if (c >= ns) continue;
    const size_t at = static_cast<size_t>(a.idx[r0 + c]) * A + i;
    const T mu = s.h[i * kLd + c], sd = std_eff(a, i);
    const T d = a.action[at] - mu, so = a.sigma[at], dm = a.mu[at] - mu;
    s.dd[i * kLd + c] = d;
    s.l1[i * kLd + c] = T(-0.5) * ((d * d) / (sd * sd) + T(2) * T(log(sd)) +
                                   c2pi);
    s.l2[i * kLd + c] = (T(log(sd / so)) +
                         (so * so + dm * dm) / (T(2) * (sd * sd))) - T(0.5);
  }
  tm.sync();
  const T lo = T(1) - a.clip, hi = T(1) + a.clip;
  const T inv_b = T(1) / static_cast<T>(a.B);
  for (int c = tm.rank(); c < kTile; c += tm.size()) {
    T g = T(0), sur = T(0), kl = T(0);
    if (c < ns) {
      const size_t row = static_cast<size_t>(a.idx[r0 + c]);
      T lp = T(0);
      for (int i = 0; i < A; ++i) {
        lp += s.l1[i * kLd + c];
        kl += s.l2[i * kLd + c];
      }
      const T ratio = T(exp(lp - a.logp[row]));
      const T nadv = -a.adv[row];
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
  for (int p = tm.rank(); p < A * kTile; p += tm.size()) {
    const int i = p / kTile, c = p - i * kTile;
    T dmu = T(0), dsd = T(0);
    if (c < ns) {
      const T sd = std_eff(a, i), g = s.g[c], d = s.dd[i * kLd + c];
      dmu = g * (d / (sd * sd));
      dsd = g * ((d * d) / (sd * sd * sd) - T(1) / sd);
    }
    s.h[i * kLd + c] = dmu;
    s.l1[i * kLd + c] = dsd;
  }
  tm.sync();
  for (int i = tm.rank(); i < A + 1; i += tm.size()) {
    if (i < A) {
      T sum = T(0);
      for (int c = 0; c < kTile; ++c) sum += s.l1[i * kLd + c];
      s.acc[r.col_std + i] += sum;
    } else {
      T sur = T(0), kl = T(0);
      for (int c = 0; c < kTile; ++c) {
        sur += s.sur[c];
        kl += s.kl[c];
      }
      s.acc[r.col_loss] += sur;
      s.acc[r.col_loss + 1] += kl;
    }
  }
}

// The critic's loss stage: each sample's (clipped) value loss; the head's
// delta d loss / d v into h; the tile's value loss sum added to the
// block's.
template <typename T, typename Team>
LEARN_HD void critic_loss(const Team& tm, const GradsArgs<T>& a,
                          const Role<T>& r, const GradsSmem<T>& s, int r0,
                          int ns) {
  const T scale = a.value_coef / static_cast<T>(a.B);
  for (int c = tm.rank(); c < kTile; c += tm.size()) {
    T g = T(0), vl = T(0);
    if (c < ns) {
      const size_t row = static_cast<size_t>(a.idx[r0 + c]);
      const T v = s.h[c], vo = a.value[row], ret = a.returns[row];
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
  tm.sync();
  if (tm.rank() == 0) {
    T sum = T(0);
    for (int c = 0; c < kTile; ++c) sum += s.sur[c];
    s.acc[r.col_loss] += sum;
  }
}

// The block `blk` of grads: blocks [0, blocks[0]) take the actor, the rest
// the critic; a role's block b owns the tiles [b * n / G, (b+1) * n / G)
// of the minibatch's n tiles.  Its sums go to its row of the scratch.
// `base` is its workspace (role_smem_elems elements).
template <typename T, typename Team>
LEARN_HD void grads_block(const Team& tm, const GradsArgs<T>& a, int blk,
                          T* base) {
  const int k = blk < a.blocks[0] ? 0 : 1;
  const int b = k == 0 ? blk : blk - a.blocks[0];
  const Role<T>& r = a.role[k];
  const GradsSmem<T> s = grads_smem(a, r, base);
  for (int i = 0; i < r.nl; ++i) {
    const Layer<T>& L = r.layer[i];
    T* w = s.w + r.woff[i];
    for (int p = tm.rank(); p < L.n_out * L.n_in; p += tm.size()) {
      const int j = p / L.n_in;
      tm.copy(w + j * r.ld[i] + (p - j * L.n_in), L.w + p);
    }
  }
  for (int p = tm.rank(); p < r.width; p += tm.size()) s.acc[p] = T(0);
  tm.copy_wait();
  const int ntiles = (a.B + kTile - 1) / kTile;
  const int G = a.blocks[k];
  const int t0 = static_cast<int>(static_cast<long long>(b) * ntiles / G);
  const int t1 = static_cast<int>(static_cast<long long>(b + 1) * ntiles / G);
  for (int t = t0; t < t1; ++t) {
    const int r0 = t * kTile;
    const int ns = min_i(kTile, a.B - r0);
    tm.sync();  // the last tile's reads of x are done
    for (int p = tm.rank(); p < r.in0 * kTile; p += tm.size()) {
      const int c = p / r.in0, q = p - c * r.in0;
      s.x[q * kLd + c] =
          c < ns ? a.obs[static_cast<size_t>(a.idx[r0 + c]) * a.nobs + q]
                 : T(0);
    }
    tm.sync();
    for (int i = 0; i < r.nl; ++i) {
      forward_layer(tm, a, r, s, i);
      tm.sync();
    }
    if (k == 0)
      actor_loss(tm, a, r, s, r0, ns);
    else
      critic_loss(tm, a, r, s, r0, ns);
    tm.sync();
    for (int i = r.nl - 1; i >= 0; --i) {
      backward_layer(tm, r, s, i);
      tm.sync();
    }
  }
  tm.sync();
  T* out = a.part[k] + static_cast<size_t>(b) * r.width;
  for (int p = tm.rank(); p < r.width; p += tm.size()) out[p] = s.acc[p];
}

// Group g of role k: the sums of its blocks [g * group, ...), added in
// block order, into the group's row.
template <typename T, typename Team>
LEARN_HD void grads_group(const Team& tm, const GradsArgs<T>& a, int k,
                          int g) {
  const int W = a.role[k].width;
  const int b0 = g * a.group, nb = min_i(a.group, a.blocks[k] - b0);
  const T* src = a.part[k] + static_cast<size_t>(b0) * W;
  T* dst = a.gsum[k] + static_cast<size_t>(g) * W;
  col_sums(tm, src, W, nb, W, [&](int p, T sum) { dst[p] = sum; });
}

// The grid's sums (each column's groups added in group order, into the
// first group's row) into the flat buffer (every layer's gradients; the
// std's with the entropy's term, zero where the floor clamps it; the KL at
// P) and the losses (loss, surrogate, value loss).
template <typename T, typename Team>
LEARN_HD void grads_final(const Team& tm, const GradsArgs<T>& a) {
  const T half_log = T(1.4189385332046727);  // 0.5 * (1 + log(2 pi))
  for (int k = 0; k < 2; ++k) {
    T* row = a.gsum[k];
    col_sums(tm, row, a.role[k].width, a.groups[k], a.role[k].width,
             [&](int p, T sum) { row[p] = sum; });
  }
  tm.sync();
  for (int k = 0; k < 2; ++k) {
    const Role<T>& r = a.role[k];
    const T* sums = a.gsum[k];
    for (int i = 0; i < r.nl; ++i) {
      const Layer<T>& L = r.layer[i];
      const int nw = L.n_in * L.n_out;
      for (int p = tm.rank(); p < nw + L.n_out; p += tm.size()) {
        if (p < nw)
          a.flat[r.flat_w[i] + p] = ld_shared(sums + r.col_w[i] + p);
        else
          a.flat[r.flat_b[i] + p - nw] = ld_shared(sums + r.col_b[i] + p - nw);
      }
    }
  }
  const Role<T>& ra = a.role[0];
  const T* sa = a.gsum[0];
  for (int i = tm.rank(); i < a.A; i += tm.size()) {
    const T sd = std_eff(a, i);
    const T g = ld_shared(sa + ra.col_std + i) - a.entropy_coef * (T(1) / sd);
    const bool held = a.std_floor > T(0) && !(a.std[i] >= a.std_floor);
    a.flat[a.std_off + i] = held ? T(0) : g;
  }
  if (tm.rank() == 0) {
    const T nb = static_cast<T>(a.B);
    const T sur = ld_shared(sa + ra.col_loss) / nb;
    const T kl = ld_shared(sa + ra.col_loss + 1) / nb;
    const T vl = ld_shared(a.gsum[1] + a.role[1].col_loss) / nb;
    T ent = T(0);
    for (int i = 0; i < a.A; ++i) ent += half_log + T(log(std_eff(a, i)));
    a.losses[0] = (sur + a.value_coef * vl) - a.entropy_coef * ent;
    a.losses[1] = sur;
    a.losses[2] = vl;
    a.flat[a.P] = kl;
  }
}

// ---- adam -----------------------------------------------------------------

template <typename T>
struct AdamArgs {
  int P, ntensors, adaptive, world;
  T desired_hi, desired_lo, max_norm, beta1, beta2, eps, lr_min, lr_max,
      factor;
  T *flat, *lr, *stats;
  const T* losses;
  int numel[kMaxTensors], off[kMaxTensors];
  T *param[kMaxTensors], *m[kMaxTensors], *v[kMaxTensors];
  float* step[kMaxTensors];
};

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
  const int nt = a->ntensors;
  if (a->P < 1 || nt < 1 || nt > kMaxTensors || a->world < 1 ||
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
  for (int k = 0; k < nptrs; ++k)
    if (!ptrs[k]) return false;
  long long covered = 0;
  for (int t = 0; t < nt; ++t) {
    a->numel[t] = ints[adam_int::kCount + 2 * t];
    a->off[t] = ints[adam_int::kCount + 2 * t + 1];
    if (a->numel[t] < 1 || a->off[t] < 0 || a->off[t] + a->numel[t] > a->P)
      return false;
    covered += a->numel[t];
    const int q = adam_ptr::kCount + 4 * t;
    a->param[t] = static_cast<T*>(mp(q));
    a->m[t] = static_cast<T*>(mp(q + 1));
    a->v[t] = static_cast<T*>(mp(q + 2));
    a->step[t] = static_cast<float*>(mp(q + 3));
  }
  return covered == a->P;
}

// adam's workspace (bytes): the lanes' sums, then per tensor its new step
// and bias corrections, then the norm and the lr.
template <typename T>
LEARN_HD int adam_smem_bytes() {
  return static_cast<int>(sizeof(T)) * (kAdamLanes + 2 * kMaxTensors + 2) +
         static_cast<int>(sizeof(float)) * kMaxTensors;
}

LEARN_HD float pow_t(float a, float b) { return powf(a, b); }
LEARN_HD double pow_t(double a, double b) { return pow(a, b); }

// The whole of adam, by one team: `base` is its workspace.
template <typename T, typename Team>
LEARN_HD void adam_block(const Team& tm, const AdamArgs<T>& a, void* base) {
  T* sq = static_cast<T*>(base);
  T* bc1 = sq + kAdamLanes;
  T* bc2 = bc1 + kMaxTensors;
  T* scal = bc2 + kMaxTensors;  // the norm, the lr
  float* steps = reinterpret_cast<float*>(scal + 2);
  const T world = static_cast<T>(a.world);
  // the mean over the ranks, in place, and each lane's sum of squares of
  // the gradients (elements v, v + kAdamLanes, ...)
  for (int v = tm.rank(); v < kAdamLanes; v += tm.size()) {
    T s = T(0);
    for (int i0 = v; i0 <= a.P; i0 += kAhead * kAdamLanes) {
      T g[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int i = i0 + j * kAdamLanes;
        g[j] = i <= a.P ? a.flat[i] / world : T(0);
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int i = i0 + j * kAdamLanes;
        if (i <= a.P) a.flat[i] = g[j];
        if (i < a.P) s += g[j] * g[j];
      }
    }
    sq[v] = s;
  }
  // each tensor's step count and bias corrections (torch's fused Adam:
  // the step incremented first, its corrections in T)
  for (int t = tm.rank(); t < a.ntensors; t += tm.size()) {
    const float st = *a.step[t] + 1.0f;
    steps[t] = st;
    bc1[t] = T(1) - pow_t(a.beta1, static_cast<T>(st));
    bc2[t] = static_cast<T>(sqrt(T(1) - pow_t(a.beta2, static_cast<T>(st))));
  }
  for (int h = kAdamLanes / 2; h > 0; h /= 2) {
    tm.sync();
    for (int v = tm.rank(); v < h; v += tm.size()) sq[v] += sq[v + h];
  }
  tm.sync();
  if (tm.rank() == 0) {
    const T kl = a.flat[a.P];
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
    *a.lr = lr;
    scal[0] = static_cast<T>(sqrt(sq[0]));
    scal[1] = lr;
    for (int k = 0; k < 3; ++k) a.stats[k] = a.losses[k];
    a.stats[3] = kl;
  }
  tm.sync();
  const T norm = scal[0], lr = scal[1];
  const bool keep = norm < a.max_norm;
  // the elements of every tensor in flat order, kAhead a member at once
  for (int i0 = tm.rank(); i0 < a.P; i0 += kAhead * tm.size()) {
    int ts[kAhead], es[kAhead];
    T g[kAhead], m[kAhead], v[kAhead], p[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int i = i0 + j * tm.size();
      ts[j] = -1;
      if (i >= a.P) continue;
      for (int t = 0; t < a.ntensors; ++t)
        if (i >= a.off[t] && i < a.off[t] + a.numel[t]) ts[j] = t;
      const int t = ts[j];
      if (t < 0) continue;
      es[j] = i - a.off[t];
      g[j] = a.flat[i];
      m[j] = a.m[t][es[j]];
      v[j] = a.v[t][es[j]];
      p[j] = a.param[t][es[j]];
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int t = ts[j], e = es[j];
      if (t < 0) continue;
      T gj = g[j];
      if (!keep) gj = (gj / norm) * a.max_norm;
      a.flat[i0 + j * tm.size()] = gj;
      const T mj = fma_t(a.beta1, m[j], fma_t(-a.beta1, gj, gj));
      const T gg = gj * gj;
      const T vj = fma_t(a.beta2, v[j], fma_t(-a.beta2, gg, gg));
      const T denom = static_cast<T>(sqrt(vj)) / bc2[t] + a.eps;
      a.param[t][e] = p[j] - (lr / bc1[t]) * mj / denom;
      a.m[t][e] = mj;
      a.v[t][e] = vj;
    }
  }
  for (int t = tm.rank(); t < a.ntensors; t += tm.size()) *a.step[t] = steps[t];
}

}  // namespace learn_env
