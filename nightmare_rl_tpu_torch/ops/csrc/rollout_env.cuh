// The rollout step's policy half and its trajectory stores, written once for
// the CUDA kernels (csrc/rollout.cu, a block of threads as the team) and for
// the host driver (csrc/rollout_host.cpp, a team of host threads), which the
// CPU tests hold against the plain versions (ops/rollout.py) and the JAX
// package.
//
// act_block computes, for a tile of E envs, the actor's and the critic's
// MLPs (Linear, activation, ..., Linear), the sampling std (std clamped by
// std_floor where it is above 0), action = mu + std * eps and the diagonal
// Gaussian log-probability, and writes row t of the trajectory's obs,
// action, value, logp, mu and sigma buffers.  store_block computes the
// timeout bootstrap reward + gamma * value * time_out into row t of the
// reward buffer, copies done into its row, writes env 0's record row, and
// adds the finished episodes' count and term sums to the running sums.
// They are the counterparts of the JAX package's compiled rollout step
// around env.step (nightmare_rl_tpu/rl/ppo.py:153-185, with
// models/actor_critic.py's sample_action and log_prob :133-143).
//
// The team contract is smooth_env.cuh's: rank(), size(), sync() (every
// member reaches every sync), with copy(dst, src), an element copied from
// global to shared memory that may complete later (cp.async on the card),
// and copy_wait(), which waits for the member's copies (a sync follows it).
// Work is split by index (member r takes items r, r + size(), ...), and
// every sum runs in an order that does not depend on the team's size:
//
// - a unit's pre-activation sums its inputs in ascending order, chunk by
//   chunk, then adds the bias (the plain version's cuBLAS and CPU products
//   take other orders: the card holds them to a float32 tolerance);
// - logp sums an env's actions in ascending order;
// - the finished sums run over kStoreLanes virtual lanes (lane v takes the
//   envs v, v + kStoreLanes, ...), then a fixed tree over the lanes.  No
//   atomics: a replay gives the eager call's bits.
//
// The weights are read at launch by pointer (Adam updates them in place, so
// a captured graph reads the new values).  A block stages them in shared
// memory as they lie, a unit's row after another's, each row padded to an
// odd length (consecutive units fall on distinct banks), as many layers at
// a time as its budget holds, all the copies in flight at once; a layer
// wider than the budget is staged in chunks of input rows (the plan,
// plan_chunks).  The activations lie feature-major ([unit][env]), so a
// member that computes one unit for kEnvTile envs reads their inputs as
// consecutive words, and its kEnvTile sums are independent chains.  The
// elementwise products of the sample and the bootstrap round as the plain
// version's separate ops do (mul_rn: no contraction into an FMA).

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define ROLLOUT_HD __host__ __device__ __forceinline__
#else
#define ROLLOUT_HD inline
#endif

namespace rollout_env {

constexpr int kMaxLayers = 8;     // Linear layers per net at most
constexpr int kMaxChunks = 48;    // staged weight chunks of both nets at most
constexpr int kMaxTeam = 64;      // host team members at most
constexpr int kStoreLanes = 512;  // the finished sums' virtual lanes
constexpr int kMaxTerms = 16;     // reward terms at most
constexpr int kEnvTile = 4;       // envs of a member's (unit, envs) tile

// The activations of models/actor_critic.py's _ACTIVATIONS.
enum Activation { kElu, kRelu, kSelu, kLeakyRelu, kTanh, kSigmoid };

// act's integers: the envs, the envs a block, the actions, the observation
// width, the MLP inputs' widths, the layers of each net, the activation,
// the weight budget (elements of shared memory), the trajectory's rows;
// then n_in, n_out of each layer (the actor's, then the critic's).
#define ROLLOUT_ACT_INTS(X)                                                   \
  X(N) X(E) X(A) X(nobs) X(in_a) X(in_c) X(n_actor) X(n_critic) X(act)        \
  X(budget) X(rows)
// act's numbers: the std floor (0: none), the activation's parameter (ELU's
// alpha, LeakyReLU's negative slope).
#define ROLLOUT_ACT_REALS(X) X(std_floor) X(alpha)
// act's tensors: obs (N, nobs), the actor's and critic's MLP inputs (N,
// in_a), (N, in_c), eps (N, A), std (A), t (1,) int64 or null (row 0);
// outputs, each optional (null: not written): row t of obs (rows, N,
// nobs), action, mu, sigma (rows, N, A), value and logp (rows, N), and the
// action (N, A) and value (N) once more for the caller (env.step and the
// bootstrap); then the Linear layers' weight (n_out, n_in) and bias
// (n_out), the actor's first.
#define ROLLOUT_ACT_PTRS(X)                                                   \
  X(obs) X(xa) X(xc) X(eps) X(std) X(t) X(o_obs) X(o_action) X(o_value)       \
  X(o_logp) X(o_mu) X(o_sigma) X(r_action) X(r_value)

// store's integers: the envs, the reward terms, the trajectory's rows, and
// the record row's parts (nq, nv, A, ncmd; record 0: no record row).
#define ROLLOUT_STORE_INTS(X)                                                 \
  X(N) X(nterms) X(rows) X(record) X(nq) X(nv) X(A) X(ncmd)
#define ROLLOUT_STORE_REALS(X) X(gamma)
// store's tensors: reward (N), time_out and done (N) bool, value (N),
// finished (N, nterms), t (1,) int64, n_done (), term_sums (nterms); env 0's
// record sources (row 0 of record_qpos, record_qvel, action, done,
// commands); outputs: row t of the reward (rows, N) and done (rows, N)
// buffers and of the record (rows, nq + nv + A + 1 + ncmd), t + 1, the new
// n_done and term_sums.
#define ROLLOUT_STORE_PTRS(X)                                                 \
  X(reward) X(time_out) X(done) X(value) X(finished) X(t) X(n_done)           \
  X(term_sums) X(rec_qpos) X(rec_qvel) X(rec_action) X(rec_done) X(rec_cmd)   \
  X(o_reward) X(o_done) X(o_rec) X(o_t) X(o_n_done) X(o_term_sums)

#define ROLLOUT_ENUM(name) name,
#define ROLLOUT_NAME(name) #name ","
namespace act_int { enum { ROLLOUT_ACT_INTS(ROLLOUT_ENUM) kCount }; }
namespace act_real { enum { ROLLOUT_ACT_REALS(ROLLOUT_ENUM) kCount }; }
namespace act_ptr { enum { ROLLOUT_ACT_PTRS(ROLLOUT_ENUM) kCount }; }
namespace store_int { enum { ROLLOUT_STORE_INTS(ROLLOUT_ENUM) kCount }; }
namespace store_real { enum { ROLLOUT_STORE_REALS(ROLLOUT_ENUM) kCount }; }
namespace store_ptr { enum { ROLLOUT_STORE_PTRS(ROLLOUT_ENUM) kCount }; }
static const char kActIntNames[] = ROLLOUT_ACT_INTS(ROLLOUT_NAME);
static const char kActRealNames[] = ROLLOUT_ACT_REALS(ROLLOUT_NAME);
static const char kActPtrNames[] = ROLLOUT_ACT_PTRS(ROLLOUT_NAME);
static const char kStoreIntNames[] = ROLLOUT_STORE_INTS(ROLLOUT_NAME);
static const char kStoreRealNames[] = ROLLOUT_STORE_REALS(ROLLOUT_NAME);
static const char kStorePtrNames[] = ROLLOUT_STORE_PTRS(ROLLOUT_NAME);
#undef ROLLOUT_ENUM
#undef ROLLOUT_NAME

template <typename T>
struct Layer {
  const T* w;  // (n_out, n_in), row-major
  const T* b;  // (n_out)
  int n_in, n_out;
};

// A staged piece of a layer: its input rows [k0, k1), unit j's at `off` +
// j * ld elements into the weight buffer (ld = k1 - k0, or one more to be
// odd); `stage_end` closes a stage (the chunks staged together between two
// syncs).
struct Chunk {
  int layer, k0, k1, ld, off, stage_end;
};

// The odd row length at or above `rows`.
ROLLOUT_HD int odd_ld(int rows) { return rows | 1; }

template <typename T>
struct ActArgs {
  int N, E, A, nobs, in_a, in_c, n_actor, n_critic, act, budget, rows;
  int nchunks, hmax;
  bool shared_input;  // the critic reads the actor's input buffer
  T std_floor, alpha;
  const T *obs, *xa, *xc, *eps, *std;
  const long long* t;
  T *o_obs, *o_action, *o_value, *o_logp, *o_mu, *o_sigma, *r_action,
      *r_value;
  Layer<T> layer[2 * kMaxLayers];
  Chunk chunk[kMaxChunks];
};

template <typename T>
struct StoreArgs {
  int N, nterms, rows, record, nq, nv, A, ncmd;
  T gamma;
  const T *reward, *value, *finished, *n_done, *term_sums;
  const bool *time_out, *done;
  const long long* t;
  const T *rec_qpos, *rec_qvel, *rec_action, *rec_cmd;
  const bool* rec_done;
  T *o_reward, *o_rec, *o_n_done, *o_term_sums;
  bool* o_done;
  long long* o_t;
};

// ---- the plan ----------------------------------------------------------

// The layers cut into chunks of input rows whose padded rows fit `budget`
// elements (the most rows r with n_out * odd_ld(r) <= budget), and packed
// in order into stages of at most `budget` elements.  Returns the number of
// chunks, or -1 where a layer's single input row does not fit or the
// chunks are more than max_chunks.  ops/rollout.py::_chunks mirrors it.
inline int plan_chunks(const int* n_in, const int* n_out, int nlayers,
                       int budget, Chunk* out, int max_chunks) {
  int n = 0, used = 0;
  for (int l = 0; l < nlayers; ++l) {
    if (n_in[l] < 1 || n_out[l] < 1 || n_out[l] > budget) return -1;
    int rows = n_in[l] < budget / n_out[l] ? n_in[l] : budget / n_out[l];
    while (rows > 1 && n_out[l] * odd_ld(rows) > budget) --rows;
    for (int k0 = 0; k0 < n_in[l]; k0 += rows) {
      const int k1 = k0 + rows < n_in[l] ? k0 + rows : n_in[l];
      const int ld = odd_ld(k1 - k0);
      const int size = ld * n_out[l];
      if (n > 0 && used + size > budget) {
        out[n - 1].stage_end = 1;
        used = 0;
      }
      if (n == max_chunks) return -1;
      out[n] = Chunk{l, k0, k1, ld, used, 0};
      used += size;
      ++n;
    }
  }
  if (n > 0) out[n - 1].stage_end = 1;
  return n;
}

// act's arguments from the C interface's blocks (the names' order above,
// then n_in, n_out of each layer in `ints` and its weight and bias in
// `ptrs`), the chunks planned.  Returns false for arguments the kernel does
// not take.
template <typename T>
inline bool read_act(const int* ints, int nints, const double* reals,
                     int nreals, const void* const* ptrs, int nptrs,
                     ActArgs<T>* a) {
  if (nints < act_int::kCount || nreals != act_real::kCount ||
      nptrs < act_ptr::kCount)
    return false;
  const int* I = ints;
  a->N = I[act_int::N];
  a->E = I[act_int::E];
  a->A = I[act_int::A];
  a->nobs = I[act_int::nobs];
  a->in_a = I[act_int::in_a];
  a->in_c = I[act_int::in_c];
  a->n_actor = I[act_int::n_actor];
  a->n_critic = I[act_int::n_critic];
  a->act = I[act_int::act];
  a->budget = I[act_int::budget];
  a->rows = I[act_int::rows];
  const int nl = a->n_actor + a->n_critic;
  if (a->n_actor < 1 || a->n_critic < 1 || a->n_actor > kMaxLayers ||
      a->n_critic > kMaxLayers || nints != act_int::kCount + 2 * nl ||
      nptrs != act_ptr::kCount + 2 * nl || a->N < 0 || a->E < kEnvTile ||
      a->E % kEnvTile != 0 ||
      a->A < 1 || a->nobs < 0 || a->budget < 1 || a->rows < 1 ||
      a->act < kElu || a->act > kSigmoid)
    return false;
  a->std_floor = static_cast<T>(reals[act_real::std_floor]);
  a->alpha = static_cast<T>(reals[act_real::alpha]);
  const void* const* P = ptrs;
  a->obs = static_cast<const T*>(P[act_ptr::obs]);
  a->xa = static_cast<const T*>(P[act_ptr::xa]);
  a->xc = static_cast<const T*>(P[act_ptr::xc]);
  a->eps = static_cast<const T*>(P[act_ptr::eps]);
  a->std = static_cast<const T*>(P[act_ptr::std]);
  a->t = static_cast<const long long*>(P[act_ptr::t]);
  a->o_obs = static_cast<T*>(const_cast<void*>(P[act_ptr::o_obs]));
  a->o_action = static_cast<T*>(const_cast<void*>(P[act_ptr::o_action]));
  a->o_value = static_cast<T*>(const_cast<void*>(P[act_ptr::o_value]));
  a->o_logp = static_cast<T*>(const_cast<void*>(P[act_ptr::o_logp]));
  a->o_mu = static_cast<T*>(const_cast<void*>(P[act_ptr::o_mu]));
  a->o_sigma = static_cast<T*>(const_cast<void*>(P[act_ptr::o_sigma]));
  a->r_action = static_cast<T*>(const_cast<void*>(P[act_ptr::r_action]));
  a->r_value = static_cast<T*>(const_cast<void*>(P[act_ptr::r_value]));
  if (!a->xa || !a->xc || !a->eps || !a->std || (a->o_obs && !a->obs))
    return false;
  a->shared_input = a->xa == a->xc && a->in_a == a->in_c;
  int n_in[2 * kMaxLayers], n_out[2 * kMaxLayers];
  a->hmax = 1;
  for (int l = 0; l < nl; ++l) {
    const bool actor = l < a->n_actor;
    const int i = actor ? l : l - a->n_actor;
    const int depth = actor ? a->n_actor : a->n_critic;
    n_in[l] = I[act_int::kCount + 2 * l];
    n_out[l] = I[act_int::kCount + 2 * l + 1];
    // each layer reads the last one's width; the heads are A and 1 wide
    const int want_in = i == 0 ? (actor ? a->in_a : a->in_c) : n_out[l - 1];
    if (n_in[l] != want_in ||
        (i == depth - 1 && n_out[l] != (actor ? a->A : 1)))
      return false;
    if (i < depth - 1 && n_out[l] > a->hmax) a->hmax = n_out[l];
    a->layer[l] = Layer<T>{static_cast<const T*>(P[act_ptr::kCount + 2 * l]),
                           static_cast<const T*>(P[act_ptr::kCount + 2 * l + 1]),
                           n_in[l], n_out[l]};
    if (!a->layer[l].w || !a->layer[l].b) return false;
  }
  a->nchunks = plan_chunks(n_in, n_out, nl, a->budget, a->chunk, kMaxChunks);
  return a->nchunks > 0;
}

// store's arguments from the C interface's blocks; false for arguments the
// kernel does not take.
template <typename T>
inline bool read_store(const int* ints, int nints, const double* reals,
                       int nreals, const void* const* ptrs, int nptrs,
                       StoreArgs<T>* a) {
  if (nints != store_int::kCount || nreals != store_real::kCount ||
      nptrs != store_ptr::kCount)
    return false;
  a->N = ints[store_int::N];
  a->nterms = ints[store_int::nterms];
  a->rows = ints[store_int::rows];
  a->record = ints[store_int::record];
  a->nq = ints[store_int::nq];
  a->nv = ints[store_int::nv];
  a->A = ints[store_int::A];
  a->ncmd = ints[store_int::ncmd];
  a->gamma = static_cast<T>(reals[store_real::gamma]);
  if (a->N < 0 || a->nterms < 1 || a->nterms > kMaxTerms || a->rows < 1)
    return false;
  auto cp = [&](int k) { return ptrs[k]; };
  auto mp = [&](int k) { return const_cast<void*>(ptrs[k]); };
  a->reward = static_cast<const T*>(cp(store_ptr::reward));
  a->time_out = static_cast<const bool*>(cp(store_ptr::time_out));
  a->done = static_cast<const bool*>(cp(store_ptr::done));
  a->value = static_cast<const T*>(cp(store_ptr::value));
  a->finished = static_cast<const T*>(cp(store_ptr::finished));
  a->t = static_cast<const long long*>(cp(store_ptr::t));
  a->n_done = static_cast<const T*>(cp(store_ptr::n_done));
  a->term_sums = static_cast<const T*>(cp(store_ptr::term_sums));
  a->rec_qpos = static_cast<const T*>(cp(store_ptr::rec_qpos));
  a->rec_qvel = static_cast<const T*>(cp(store_ptr::rec_qvel));
  a->rec_action = static_cast<const T*>(cp(store_ptr::rec_action));
  a->rec_done = static_cast<const bool*>(cp(store_ptr::rec_done));
  a->rec_cmd = static_cast<const T*>(cp(store_ptr::rec_cmd));
  a->o_reward = static_cast<T*>(mp(store_ptr::o_reward));
  a->o_done = static_cast<bool*>(mp(store_ptr::o_done));
  a->o_rec = static_cast<T*>(mp(store_ptr::o_rec));
  a->o_t = static_cast<long long*>(mp(store_ptr::o_t));
  a->o_n_done = static_cast<T*>(mp(store_ptr::o_n_done));
  a->o_term_sums = static_cast<T*>(mp(store_ptr::o_term_sums));
  // every tensor is given, the record's where a record row is written
  for (int k = 0; k < store_ptr::kCount; ++k) {
    const bool rec = (k >= store_ptr::rec_qpos && k <= store_ptr::rec_cmd) ||
                     k == store_ptr::o_rec;
    if (!ptrs[k] && (!rec || a->record)) return false;
  }
  return true;
}

// The activations' and heads' buffers of a block, after the weight buffer
// (elements), each feature-major ([feature][env], E envs): the actor's
// input (in_a x E), the critic's where it is another tensor (in_c x E), two
// hidden buffers (hmax x E each), mu and the log-probability terms (A x E
// each), the value (E).
template <typename T>
struct ActSmem {
  T *w, *xa, *xc, *h0, *h1, *mu, *lp, *v;
};

template <typename T>
ROLLOUT_HD int act_smem_elems(const ActArgs<T>& a) {
  return a.budget + a.E * (a.in_a + (a.shared_input ? 0 : a.in_c) +
                           2 * a.hmax + 2 * a.A + 1);
}

template <typename T>
ROLLOUT_HD ActSmem<T> act_smem(const ActArgs<T>& a, T* base) {
  ActSmem<T> s;
  s.w = base;
  s.xa = s.w + a.budget;
  s.xc = a.shared_input ? s.xa : s.xa + a.E * a.in_a;
  s.h0 = s.xc + (a.shared_input ? a.E * a.in_a : a.E * a.in_c);
  s.h1 = s.h0 + a.E * a.hmax;
  s.mu = s.h1 + a.E * a.hmax;
  s.lp = s.mu + a.E * a.A;
  s.v = s.lp + a.E * a.A;
  return s;
}

// ---- arithmetic ----------------------------------------------------------

// a * b rounded once and never contracted into an FMA with a later add (the
// plain version's products are separate ops).
ROLLOUT_HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
ROLLOUT_HD double mul_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

template <typename T>
ROLLOUT_HD bool is_nan(T x) {
  return x != x;
}

// torch's activation modules (NaN passes through each).
template <typename T>
ROLLOUT_HD T activate(int kind, T alpha, T x) {
  switch (kind) {
    case kElu:
      return x > T(0) ? x : alpha * expm1(x);
    case kRelu:
      return x < T(0) ? T(0) : x;
    case kSelu: {
      const T scale = T(1.0507009873554804934193349852946);
      const T salpha = T(1.6732632423543772848170429916717);
      return x > T(0) ? scale * x : scale * (salpha * expm1(x));
    }
    case kLeakyRelu:
      return x > T(0) ? x : x * alpha;
    case kTanh:
      return tanh(x);
    default:  // kSigmoid
      return T(1) / (T(1) + exp(-x));
  }
}

// ---- act ----------------------------------------------------------------

// Where layer l (0 .. n_actor + n_critic - 1) reads its input and writes
// its output ([feature][env] buffers), and whether it is its net's last.
template <typename T>
ROLLOUT_HD void layer_io(const ActArgs<T>& a, const ActSmem<T>& s, int l,
                         const T** x, T** y, bool* last) {
  const bool actor = l < a.n_actor;
  const int i = actor ? l : l - a.n_actor;
  const int depth = actor ? a.n_actor : a.n_critic;
  if (i == 0)
    *x = actor ? s.xa : s.xc;
  else
    *x = (i - 1) % 2 == 0 ? s.h0 : s.h1;
  *last = i == depth - 1;
  if (*last)
    *y = actor ? s.mu : s.v;
  else
    *y = i % 2 == 0 ? s.h0 : s.h1;
}

// Stage a chunk's weights: w[off + j * ld + kk] = W[j, k0 + kk], the copies
// left in flight.
template <typename T, typename Team>
ROLLOUT_HD void stage_chunk(const Team& tm, const ActArgs<T>& a,
                            const Chunk& c, T* w) {
  const Layer<T>& L = a.layer[c.layer];
  const int rows = c.k1 - c.k0;
  T* dst = w + c.off;
  // member r copies elements r, r + size, ... of the chunk, (j, kk) kept
  // by increments rather than a division per element
  int j = tm.rank() / rows, kk = tm.rank() - j * rows;
  const int dj = tm.size() / rows, dk = tm.size() - dj * rows;
  for (; j < L.n_out; j += dj, kk += dk) {
    if (kk >= rows) {
      kk -= rows;
      ++j;
      if (j >= L.n_out) break;
    }
    tm.copy(dst + j * c.ld + kk,
            L.w + static_cast<size_t>(j) * L.n_in + c.k0 + kk);
  }
}

// A chunk's part of its layer's pre-activations for the block's envs; the
// last chunk adds the bias and applies the activation (not to the net's
// last layer).  A member takes a unit j for kEnvTile envs at a time; each
// (unit, env) belongs to one member, so the partial sums wait in the output
// buffer between chunks.
template <typename T, typename Team>
ROLLOUT_HD void compute_chunk(const Team& tm, const ActArgs<T>& a,
                              const ActSmem<T>& s, const Chunk& c) {
  const Layer<T>& L = a.layer[c.layer];
  const T* x;
  T* y;
  bool last;
  layer_io(a, s, c.layer, &x, &y, &last);
  const int n_out = L.n_out, E = a.E;
  const bool first = c.k0 == 0, done = c.k1 == L.n_in;
  const int tiles = n_out * (E / kEnvTile);
  for (int p = tm.rank(); p < tiles; p += tm.size()) {
    const int g = p / n_out;
    const int j = p - g * n_out;
    const int e0 = g * kEnvTile;
    T acc[kEnvTile];
#pragma unroll
    for (int i = 0; i < kEnvTile; ++i)
      acc[i] = first ? T(0) : y[j * E + e0 + i];
    const T* wj = s.w + c.off + j * c.ld;
    const T* xk = x + c.k0 * E + e0;
#pragma unroll 4
    for (int kk = 0; kk < c.k1 - c.k0; ++kk) {
      const T wk = wj[kk];
#pragma unroll
      for (int i = 0; i < kEnvTile; ++i) acc[i] += wk * xk[kk * E + i];
    }
#pragma unroll
    for (int i = 0; i < kEnvTile; ++i) {
      T v = acc[i];
      if (done) {
        v += L.b[j];
        if (!last) v = activate(a.act, a.alpha, v);
      }
      y[j * E + e0 + i] = v;
    }
  }
}

// The block `blk` of act: envs [blk * E, blk * E + E) below N.  `base` is
// the block's workspace (act_smem_elems elements).
template <typename T, typename Team>
ROLLOUT_HD void act_block(const Team& tm, const ActArgs<T>& a, int blk,
                          T* base) {
  const ActSmem<T> s = act_smem(a, base);
  const int E = a.E;
  const int n0 = blk * E;
  const int ne = a.N - n0 < E ? a.N - n0 : E;
  const long long t = a.t ? *a.t : 0;
  const bool row_ok = t >= 0 && t < a.rows;
  const size_t N = static_cast<size_t>(a.N);

  // the MLP inputs, feature-major (the envs past N zero), and the first
  // stage's weights, all in flight at once; the observation's row of the
  // trajectory meanwhile
  for (int p = tm.rank(); p < E * a.in_a; p += tm.size()) {
    const int e = p / a.in_a;
    const int k = p - e * a.in_a;
    if (e < ne)
      tm.copy(s.xa + k * E + e, a.xa + static_cast<size_t>(n0) * a.in_a + p);
    else
      s.xa[k * E + e] = T(0);
  }
  if (!a.shared_input)
    for (int p = tm.rank(); p < E * a.in_c; p += tm.size()) {
      const int e = p / a.in_c;
      const int k = p - e * a.in_c;
      if (e < ne)
        tm.copy(s.xc + k * E + e,
                a.xc + static_cast<size_t>(n0) * a.in_c + p);
      else
        s.xc[k * E + e] = T(0);
    }
  if (a.o_obs && row_ok) {
    T* o = a.o_obs + (t * N + n0) * a.nobs;
    for (int p = tm.rank(); p < ne * a.nobs; p += tm.size())
      o[p] = a.obs[static_cast<size_t>(n0) * a.nobs + p];
  }

  // the nets, stage by stage; a layer's outputs are read by the next layer
  // after a sync
  for (int c0 = 0; c0 < a.nchunks;) {
    int c1 = c0;
    while (!a.chunk[c1].stage_end) ++c1;
    if (c0 > 0) tm.sync();  // the last stage's weights are read
    for (int c = c0; c <= c1; ++c) stage_chunk(tm, a, a.chunk[c], s.w);
    tm.copy_wait();
    tm.sync();
    for (int c = c0; c <= c1; ++c) {
      compute_chunk(tm, a, s, a.chunk[c]);
      if (a.chunk[c].k1 == a.layer[a.chunk[c].layer].n_in) tm.sync();
    }
    c0 = c1 + 1;
  }

  // the heads: sigma, the action and each action's log-density term
  const T c2pi = T(1.8378770664093453);  // Python's math.log(2.0 * math.pi)
  for (int p = tm.rank(); p < ne * a.A; p += tm.size()) {
    const int e = p / a.A;
    const int j = p - e * a.A;
    const size_t i = (static_cast<size_t>(n0) + e) * a.A + j;
    const T mu = s.mu[j * E + e];
    T sd = a.std[j];
    if (a.std_floor > T(0)) sd = sd < a.std_floor ? a.std_floor : sd;
    const T act = mu + mul_rn(sd, a.eps[i]);
    const T d = act - mu;
    s.lp[j * E + e] = T(-0.5) * (mul_rn(d, d) / mul_rn(sd, sd) +
                                 mul_rn(T(2), T(log(sd))) + c2pi);
    if (row_ok) {
      const size_t at = t * N * a.A + i;
      if (a.o_action) a.o_action[at] = act;
      if (a.o_mu) a.o_mu[at] = mu;
      if (a.o_sigma) a.o_sigma[at] = sd;
    }
    if (a.r_action) a.r_action[i] = act;
  }
  tm.sync();
  for (int e = tm.rank(); e < ne; e += tm.size()) {
    T lp = T(0);
    for (int j = 0; j < a.A; ++j) lp += s.lp[j * E + e];
    if (row_ok) {
      const size_t at = t * N + n0 + e;
      if (a.o_logp) a.o_logp[at] = lp;
      if (a.o_value) a.o_value[at] = s.v[e];
    }
    if (a.r_value) a.r_value[n0 + e] = s.v[e];
  }
}

// ---- store --------------------------------------------------------------

// One env's operands of store.
template <typename T>
struct EnvRow {
  T reward, value, f[kMaxTerms];
  bool time_out, done;
};

template <typename T>
ROLLOUT_HD void load_row(const StoreArgs<T>& a, int n, EnvRow<T>* x) {
  x->reward = a.reward[n];
  x->value = a.value[n];
  x->time_out = a.time_out[n];
  x->done = a.done[n];
  const T* f = a.finished + static_cast<size_t>(n) * a.nterms;
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k)
    if (k < a.nterms) x->f[k] = f[k];
}

// An env's row t of the rewards and done flags, and its finished sums
// added to a lane's.
template <typename T>
ROLLOUT_HD void store_row(const StoreArgs<T>& a, int n, long long t,
                          bool row_ok, T g, const EnvRow<T>& x, int* cnt,
                          T* acc) {
  if (row_ok) {
    const size_t at = t * static_cast<size_t>(a.N) + n;
    a.o_reward[at] = x.reward + mul_rn(mul_rn(g, x.value),
                                       x.time_out ? T(1) : T(0));
    a.o_done[at] = x.done;
  }
  *cnt += is_nan(x.f[0]) ? 0 : 1;
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k)
    if (k < a.nterms && !is_nan(x.f[k])) acc[k] += x.f[k];
}

template <typename T>
ROLLOUT_HD int store_smem_bytes(const StoreArgs<T>& a) {
  return kStoreLanes * (a.nterms * static_cast<int>(sizeof(T)) +
                        static_cast<int>(sizeof(int)));
}

// The whole of store, by one team: `base` is its workspace
// (store_smem_bytes).
template <typename T, typename Team>
ROLLOUT_HD void store_block(const Team& tm, const StoreArgs<T>& a,
                            void* base) {
  T* sums = static_cast<T*>(base);                        // lanes x nterms
  int* counts = reinterpret_cast<int*>(sums + kStoreLanes * a.nterms);
  const long long t = *a.t;
  const bool row_ok = t >= 0 && t < a.rows;

  // env 0's record row: qpos | qvel | action | done | commands
  if (a.record && row_ok) {
    const int width = a.nq + a.nv + a.A + 1 + a.ncmd;
    T* o = a.o_rec + t * width;
    for (int i = tm.rank(); i < width; i += tm.size()) {
      int k = i;
      T x;
      if (k < a.nq) {
        x = a.rec_qpos[k];
      } else if ((k -= a.nq) < a.nv) {
        x = a.rec_qvel[k];
      } else if ((k -= a.nv) < a.A) {
        x = a.rec_action[k];
      } else if ((k -= a.A) == 0) {
        x = *a.rec_done ? T(1) : T(0);
      } else {
        x = a.rec_cmd[k - 1];
      }
      o[i] = x;
    }
  }
  // per env, the bootstrapped reward and done into row t; the finished
  // episodes' count (term 0 not NaN) and NaN-skipping term sums by lane:
  // lane v over envs v, v + kStoreLanes, ..., two at a time, every load of
  // the two issued before a store, the sums in registers
  const T g = a.gamma;
  for (int v = tm.rank(); v < kStoreLanes; v += tm.size()) {
    int cnt = 0;
    T acc[kMaxTerms];
#pragma unroll
    for (int k = 0; k < kMaxTerms; ++k) acc[k] = T(0);
    for (int n = v; n < a.N; n += 2 * kStoreLanes) {
      const int m = n + kStoreLanes;
      const bool two = m < a.N;
      EnvRow<T> x0, x1;
      load_row(a, n, &x0);
      if (two) load_row(a, m, &x1);
      store_row(a, n, t, row_ok, g, x0, &cnt, acc);
      if (two) store_row(a, m, t, row_ok, g, x1, &cnt, acc);
    }
#pragma unroll
    for (int k = 0; k < kMaxTerms; ++k)
      if (k < a.nterms) sums[v * a.nterms + k] = acc[k];
    counts[v] = cnt;
  }
  for (int h = kStoreLanes / 2; h > 0; h /= 2) {
    tm.sync();
    for (int v = tm.rank(); v < h; v += tm.size()) {
      counts[v] += counts[v + h];
      for (int k = 0; k < a.nterms; ++k)
        sums[v * a.nterms + k] += sums[(v + h) * a.nterms + k];
    }
  }
  tm.sync();
  for (int k = tm.rank(); k < a.nterms; k += tm.size())
    a.o_term_sums[k] = a.term_sums[k] + sums[k];
  if (tm.rank() == 0) {
    *a.o_n_done = *a.n_done + static_cast<T>(counts[0]);
    *a.o_t = t + 1;
  }
}

}  // namespace rollout_env
