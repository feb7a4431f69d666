// One env's task half of an env step, written once for the CUDA kernels
// (csrc/task.cu, a team of lanes per env) and for the host driver
// (csrc/task_host.cpp, a team of host threads), which the CPU tests hold
// against the plain version and the JAX package.
//
// pre_one computes an env's actions and controls from the policy's raw
// actions, before the physics; post_one everything of the env step after
// the physics: the readings, command resampling, terminations, the reset
// bookkeeping, the reward terms and the observation.  They are the
// counterparts of the JAX package's compiled env step around
// pipeline.step (nightmare_rl_tpu/envs/nightmare_v3.py:182-361,
// nightmare_rl_tpu/envs/anymal_c.py:183-293), per robot (Robot).  The
// plain PyTorch versions are ops/task.py's plain_*_pre and plain_*_post;
// the arithmetic below follows them op for op, so that every decision (the
// reset, time-out and contact flags, the resample step, first_contact, the
// command cuts) agrees with them exactly on either device:
//
// - every op of the plain version rounds once, as an eager torch op does
//   (the kernels are built with -fmad=false);
// - torch's CUDA cross product contracts its first product,
//   fma(a1, b2, -(a2 * b1)) (cross_diff), and its CUDA vector norm sums
//   (x0² + x2²) + x1² for three elements, x0² + x1² for two (norm3,
//   norm2): what they give on an H100 bit for bit (PERF.md §6 PR 17);
// - a tensor divided by a Python scalar s is x * fl(1 / s) on the card
//   (the reciprocal taken in double, by the wrapper) and x / fl(s) on the
//   CPU (div_scalar);
//   a product, sum or comparison with a Python scalar casts it to T first;
// - arccos and exp are the C library's (acosf / expf on the card, as
//   torch's CUDA ops call them).
//
// Sums over an env's arrays (the reward terms' sums, the reward) run in
// index order; torch's reductions take another order, so those values
// differ from the plain version's by round-off.
//
// The work is shared by a Team of size() members (smooth_env.cuh's
// contract: rank(), size()): every member computes the env's scalars (the
// readings, the decisions, the commands, the reward terms) in the same
// order, and the members split the stores of the env's arrays (member r
// stores elements r, r + size(), ...), so no value depends on the team's
// size and no member waits for another.
//
// NaN semantics follow torch's: comparisons with NaN are false, clamp and
// amax propagate NaN, masks multiply (NaN * 0 is NaN).

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TASK_HD __host__ __device__ __forceinline__
#else
#define TASK_HD inline
#endif

namespace task_env {

enum Robot { kNightmareV3 = 0, kAnymalC = 1 };
constexpr int kMaxTerms = 16;   // reward terms at most
constexpr int kMaxTeam = 64;    // host team members at most

// Reward terms, in each robot's REWARD_NAMES order (envs/nightmare_v3.py,
// envs/anymal_c.py); the kernel takes the active ones as a list of ids.
enum NightmareTerm {
  kNTermination, kNTrackingLinVel, kNTrackingAngVel, kNDofAcc, kNActionRate,
  kNBodyContactForces, kNDefaultPosition, kNOrientation, kNLinVelZ,
  kNAngVelXy, kNFeetAirTime, kNTorques, kNBaseHeight, kNFeetContactForces,
  kNDofVel, kNStandStill
};
enum AnymalTerm {
  kATermination, kATrackingLinVel, kATrackingAngVel, kALinVelZ, kAAngVelXy,
  kAOrientation, kATorques, kADofAcc, kAActionRate, kAFeetAirTime,
  kAFeetContactForces, kAStandStill
};

// Each robot's sizes: the joints that the task reads (actions, joint
// angles and velocities) and the feet; the plan refuses a model of other
// sizes.  Known at compile time, so that the loops over them unroll and
// their loads issue together.
template <int Rb>
struct Sizes {
  static constexpr int kAct = Rb == kNightmareV3 ? 18 : 12;
  static constexpr int kFeet = Rb == kNightmareV3 ? 6 : 4;
};

// The integer parameters, in order: the robot and its sizes, the config's
// integers, the offsets of the constants in the cst table (c_*) and the
// active reward terms' ids.  The wrapper (ops/task.py) reads the names
// from the library (task_int_names) and fills the fields by name.
#define TASK_INTS(X)                                                          \
  X(robot) X(nq) X(nv) X(nbody) X(nsensor) X(nact) X(nobs) X(nfeet)           \
  X(nterms) X(max_len) X(resample_every) X(tibia_mode) X(body_mode)           \
  X(add_noise) X(fat_active) X(ncst)                                          \
  X(c_qpos0) X(c_default) X(c_scales) X(c_noise) X(c_cmd_scale) X(c_gravity)  \
  X(term0) X(term1) X(term2) X(term3) X(term4) X(term5) X(term6) X(term7)     \
  X(term8) X(term9) X(term10) X(term11) X(term12) X(term13) X(term14)         \
  X(term15)

// The config's numbers, as the Python doubles that the plain version
// hands to torch; each is cast to T (or its reciprocal taken) where torch
// does so.
#define TASK_REALS(X)                                                         \
  X(action_scale) X(clip_actions) X(p_gain) X(dt) X(term_force)               \
  X(tibia_max) X(body_max) X(tilt_limit) X(tilt_div) X(height_target)         \
  X(sigma) X(max_contact_force) X(contact_thr) X(s_lin) X(s_ang)              \
  X(grav_div) X(s_dof_pos) X(s_dof_vel) X(clip_obs) X(span_x) X(lo_x)         \
  X(span_y) X(lo_y) X(span_w) X(lo_w) X(cmd_cut) X(still_cut) X(air_cut)      \
  X(air_lo) X(air_hi) X(cos_eps) X(inv_dt) X(inv_sigma) X(inv_tilt_div)      \
  X(inv_grav_div)

struct Ints {
#define TASK_FIELD(name) int name;
  TASK_INTS(TASK_FIELD)
#undef TASK_FIELD
};

struct Reals {
#define TASK_FIELD(name) double name;
  TASK_REALS(TASK_FIELD)
#undef TASK_FIELD
};

#define TASK_NAME(name) #name ","
static const char kIntNames[] = TASK_INTS(TASK_NAME);
static const char kRealNames[] = TASK_REALS(TASK_NAME);
#undef TASK_NAME

constexpr int kNumInts = sizeof(Ints) / sizeof(int);
constexpr int kNumReals = sizeof(Reals) / sizeof(double);

// pre's operands and outputs.  kPrevDofPos: the last reading of the joint
// angles (nightmare_v3's control law; unused by anymal_c).
enum PreIn { kRaw, kPrevDofPos, kNumPreIns };
enum PreOut { kActions, kCtrl, kNumPreOuts };

// post's operands, each (N, per-env size), contiguous: the physics state
// after pipeline.step (qpos, qvel, cvel and xipos whole, qfrc_actuator and
// sensordata), the previous EnvState's fields, this step's actions, and the
// uniform draws (the commands' draws in the plain version's order: two per
// command for nightmare_v3, three for anymal_c, the resample's first; then
// the observation noise's, (N, nobs), where add_noise).
enum PostIn {
  kQpos, kQvel, kCvel, kXipos, kQfrcActuator, kSensordata, kEpisodeLength,
  kCommands, kPrevActions, kActionsIn, kPrevDofVel, kFeetAirTime,
  kLastContacts, kLastContactsFilt, kEpisodeSums, kDraw0, kDraw1, kDraw2,
  kDraw3, kDraw4, kDraw5, kNoise, kNumPostIns
};
// post's outputs, each (N, per-env size), contiguous.  kLastContactsFiltOut
// is nightmare_v3's only.
enum PostOut {
  kQposOut, kQvelOut, kEpisodeLengthOut, kCommandsOut, kDofPosOut,
  kDofVelOut, kFeetAirTimeOut, kLastContactsOut, kLastContactsFiltOut,
  kEpisodeSumsOut, kObs, kReward, kRewardTerms, kFinished, kReset, kTimeOut,
  kNumPostOuts
};

template <typename T>
struct PreArgs {
  Ints I;
  Reals R;
  const T* cst;
  const T* in[kNumPreIns];
  T* out[kNumPreOuts];
  int N;
};

template <typename T>
struct PostArgs {
  Ints I;
  Reals R;
  const T* cst;
  const void* in[kNumPostIns];
  void* out[kNumPostOuts];
  int N;
};

// ---- torch's rounding, op for op ----------------------------------------

// a * b - c * d as torch's cross product computes it on each device: on
// the card its kernel contracts the first product into an FMA.
template <typename T>
TASK_HD T cross_diff(T a, T b, T c, T d) {
#ifdef __CUDA_ARCH__
  return fma(a, b, -(c * d));
#else
  return a * b - c * d;
#endif
}

template <typename T>
TASK_HD void cross(const T* a, const T* b, T* o) {
  const T x = cross_diff(a[1], b[2], a[2], b[1]);
  const T y = cross_diff(a[2], b[0], a[0], b[2]);
  const T z = cross_diff(a[0], b[1], a[1], b[0]);
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

// core/quat.py::rotate: v + 2 (w (u x v) + u x (u x v)), each op rounded.
template <typename T>
TASK_HD void rotate(const T* v, const T* q, T* o) {
  T uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) {
    const T wuv = q[0] * uv[k];
    const T s = wuv + uuv[k];
    const T t = T(2) * s;
    o[k] = v[k] + t;
  }
}

// torch.linalg.vector_norm over three and over two elements.
template <typename T>
TASK_HD T norm3(const T* x) {
  const T a = x[0] * x[0];
  const T b = x[1] * x[1];
  const T c = x[2] * x[2];
  const T s = a + c;
  return sqrt(s + b);
}

template <typename T>
TASK_HD T norm2(T x, T y) {
  const T a = x * x;
  const T b = y * y;
  return sqrt(a + b);
}

// x / s for a Python float s: x * fl(1 / s) on the card (inv: 1 / s,
// the reciprocal in double, which the wrapper takes), x / fl(s) on the
// CPU.
template <typename T>
TASK_HD T div_scalar(T x, double s, double inv) {
#ifdef __CUDA_ARCH__
  (void)s;
  return x * T(inv);
#else
  (void)inv;
  return x / T(s);
#endif
}

template <typename T>
TASK_HD T clamp(T x, T lo, T hi) {
  const T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

template <typename T>
TASK_HD T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// torch.amax: NaN wins.
template <typename T>
TASK_HD T amax(const T* x, int n) {
  T m = x[0];
  for (int k = 1; k < n; ++k)
    if (x[k] != x[k] || x[k] > m) m = x[k];
  return m;
}

template <typename T>
TASK_HD T mask(bool b) {
  return b ? T(1) : T(0);
}

template <typename T>
TASK_HD T nan_value() {
  return T(NAN);
}

// Python's % for a positive or negative divisor (the sign of the divisor).
TASK_HD int py_mod(int a, int m) {
  int r = a % m;
  if (r != 0 && ((r < 0) != (m < 0))) r += m;
  return r;
}

// lo + span * u, the plain version's affine map of a uniform draw.
template <typename T>
TASK_HD T affine(T u, double span, double lo) {
  const T t = u * T(span);
  return t + T(lo);
}

// ---- pre: actions and controls --------------------------------------------

template <typename T, int Rb, typename Team>
TASK_HD void pre_one(const Team& tm, const PreArgs<T>& a, int n) {
  const Ints& I = a.I;
  const Reals& R = a.R;
  constexpr int na = Sizes<Rb>::kAct;
  const T* raw = a.in[kRaw] + static_cast<size_t>(n) * na;
  const T* def = a.cst + I.c_default;
  T* act = a.out[kActions] + static_cast<size_t>(n) * na;
  T* ctrl = a.out[kCtrl] + static_cast<size_t>(n) * na;
  const T clip = T(R.clip_actions);
  for (int j = tm.rank(); j < na; j += tm.size()) {
    if (Rb == kNightmareV3) {
      // clamp(raw * action_scale, ±clip); (actions - default - dof_pos) * p_gain
      const T x = clamp(raw[j] * T(R.action_scale), -clip, clip);
      const T d = x - def[j];
      const T e = d - a.in[kPrevDofPos][static_cast<size_t>(n) * na + j];
      act[j] = x;
      ctrl[j] = e * T(R.p_gain);
    } else {
      // clamp(raw, ±clip); default + actions * action_scale
      const T x = clamp(raw[j], -clip, clip);
      const T t = x * T(R.action_scale);
      act[j] = x;
      ctrl[j] = def[j] + t;
    }
  }
}

// ---- post: everything after the physics -------------------------------------

// The commands drawn from three uniforms (vy's unused by nightmare_v3,
// whose vy is 0), the xy part zeroed where its norm is at most cmd_cut.
template <typename T, int Rb>
TASK_HD void draw_commands(const Reals& R, T ux, T uy, T uw, T* c) {
  const T vx = affine(ux, R.span_x, R.lo_x);
  const T vy = Rb == kNightmareV3 ? T(0) : affine(uy, R.span_y, R.lo_y);
  const T wz = affine(uw, R.span_w, R.lo_w);
  const T m = mask<T>(norm2(vx, vy) > T(R.cmd_cut));
  c[0] = vx * m;
  c[1] = vy * m;
  c[2] = wz;
}

template <typename T>
TASK_HD T at(const void* p, size_t i) {
  return static_cast<const T*>(p)[i];
}

template <typename T>
TASK_HD bool flag(const void* p, size_t i) {
  return static_cast<const uint8_t*>(p)[i] != 0;
}

// Whether the parameter blocks are ones the kernels take: a known robot of
// its own sizes, at most kMaxTerms terms, a resample period.
inline bool params_ok(const Ints& I) {
  if (I.robot == kNightmareV3) {
    if (I.nact != Sizes<kNightmareV3>::kAct ||
        I.nfeet != Sizes<kNightmareV3>::kFeet || I.nsensor < 13)
      return false;
  } else if (I.robot == kAnymalC) {
    if (I.nact != Sizes<kAnymalC>::kAct || I.nfeet != Sizes<kAnymalC>::kFeet ||
        I.nsensor < I.nfeet)
      return false;
  } else {
    return false;
  }
  return I.nterms >= 0 && I.nterms <= kMaxTerms && I.resample_every != 0 &&
         I.nq == I.nact + 7 && I.nv == I.nact + 6 && I.nbody >= 2;
}

template <typename T, int Rb, typename Team>
TASK_HD void post_one(const Team& tm, const PostArgs<T>& a, int n) {
  const Ints& I = a.I;
  const Reals& R = a.R;
  const size_t nn = static_cast<size_t>(n);
  constexpr int na = Sizes<Rb>::kAct, nf = Sizes<Rb>::kFeet;
  const int nq = I.nq, nv = I.nv;
  const T* qpos = static_cast<const T*>(a.in[kQpos]) + nn * nq;
  const T* qvel = static_cast<const T*>(a.in[kQvel]) + nn * nv;
  const T* cv = static_cast<const T*>(a.in[kCvel]) + (nn * I.nbody + 1) * 6;
  const T* sd = static_cast<const T*>(a.in[kSensordata]) + nn * I.nsensor;
  const T* prev_act = static_cast<const T*>(a.in[kPrevActions]) + nn * na;
  const T* act = static_cast<const T*>(a.in[kActionsIn]) + nn * na;
  const T* prev_dv = static_cast<const T*>(a.in[kPrevDofVel]) + nn * na;
  const T* fat_in = static_cast<const T*>(a.in[kFeetAirTime]) + nn * nf;
  const T* sums = static_cast<const T*>(a.in[kEpisodeSums]) + nn * I.nterms;
  const T* prev_cmd = static_cast<const T*>(a.in[kCommands]) + nn * 3;
  const T* def = a.cst + I.c_default;
  const T* dof_pos = qpos + 7;
  const T* dof_vel = qvel + 6;

  // readings: the base's velocities and gravity in its frame
  const int len = static_cast<const int*>(a.in[kEpisodeLength])[n] + 1;
  const T q[4] = {qpos[3], -qpos[4], -qpos[5], -qpos[6]};
  T lin[3], ang[3], grav[3];
  rotate(cv + 3, q, lin);
  rotate(cv, q, ang);
  rotate(a.cst + I.c_gravity, q, grav);
  const T* feet = Rb == kNightmareV3 ? sd + 6 : sd;

  // commands resampled every resample_every steps
  T cmd[3];
  const bool resample = py_mod(len, I.resample_every) == 0;
  {
    const int k = Rb == kNightmareV3 ? 2 : 3;  // draws per command
    T c[3];
    draw_commands<T, Rb>(R, at<T>(a.in[kDraw0], nn),
                         at<T>(a.in[kDraw0 + (k == 3 ? 1 : 0)], nn),
                         at<T>(a.in[kDraw0 + k - 1], nn), c);
    for (int i = 0; i < 3; ++i) cmd[i] = resample ? c[i] : prev_cmd[i];
  }

  // terminations
  const bool time_out = len > I.max_len;
  bool reset = time_out;
  T tibia[nf];
  if (Rb == kNightmareV3) {
    reset = reset || amax(feet, nf) > T(R.term_force);
#pragma unroll
    for (int k = 0; k < nf; ++k) tibia[k] = sd[k] * mask<T>(feet[k] == T(0));
    if (I.tibia_mode == 2) reset = reset || amax(tibia, nf) > T(R.tibia_max);
    if (I.body_mode == 2) reset = reset || sd[12] > T(R.body_max);
    const T cosang = -grav[2] / clamp_min(norm3(grav), T(R.cos_eps));
    reset = reset || acos(clamp(cosang, T(-1), T(1))) > T(R.tilt_limit);
  } else {
    const T tilt = acos(clamp(div_scalar(-grav[2], R.tilt_div, R.inv_tilt_div), T(-1), T(1)));
    reset = reset || tilt > T(R.tilt_limit);
    reset = reset || amax(feet, nf) > T(R.term_force);
  }

  // the reset: fresh commands, the episode's count and sums
  {
    const int k = Rb == kNightmareV3 ? 2 : 3;
    T c[3];
    draw_commands<T, Rb>(R, at<T>(a.in[kDraw0 + k], nn),
                         at<T>(a.in[kDraw0 + k + (k == 3 ? 1 : 0)], nn),
                         at<T>(a.in[kDraw0 + 2 * k - 1], nn), c);
    for (int i = 0; i < 3; ++i) cmd[i] = reset ? c[i] : cmd[i];
  }

  // the commands' norm (anymal_c's "moving"), taken before the sums below:
  // a square root (as the division and arccos above) may call a slow path,
  // and none is left to call while the sums' values are live
  const T moving = norm2(cmd[0], cmd[1]);

  // feet air time, and the sums over the feet that the terms take
  bool contact[nf], filt[nf];
  T fat[nf];
  T rew_air = T(0), air = T(0), over = T(0), tib = T(0);
#pragma unroll
  for (int k = 0; k < nf; ++k) {
    contact[k] = feet[k] > T(R.contact_thr);
    filt[k] = contact[k] || flag<T>(a.in[kLastContacts], nn * nf + k);
    const T x = (feet[k] - T(R.max_contact_force)) *
                mask<T>(feet[k] > T(R.max_contact_force));
    over += x * x;
  }
  if (Rb == kNightmareV3) {
#pragma unroll
    for (int k = 0; k < nf; ++k) {
      const T t = fat_in[k] + T(R.dt);
      fat[k] = t * mask<T>(filt[k] ==
                           flag<T>(a.in[kLastContactsFilt], nn * nf + k));
      const T hi = mask<T>(fat[k] > T(R.air_hi)) * (fat[k] - T(R.air_hi));
      const T lo = mask<T>(fat[k] < T(R.air_lo)) * (T(R.air_lo) - fat[k]);
      const T x = hi + lo;
      air += x * x;
      tib += tibia[k];
    }
  } else {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < nf; ++k) {
      const T f0 = reset ? T(0) : fat_in[k];
      const bool first = f0 > T(0) && filt[k];
      fat[k] = f0 + T(R.dt);
      s += (fat[k] - T(R.air_lo)) * mask<T>(first);
    }
    rew_air = s * mask<T>(moving > T(R.air_cut));
  }

  // the sums over the joints that the terms take, each in index order (six
  // joints an iteration: unrolled whole, the loop's loads stay live across
  // the square roots' slow-path calls above and float32 spills)
  T acc2 = T(0), rate2 = T(0), def2 = T(0), def1 = T(0), vel2 = T(0),
    tq2 = T(0);
#pragma unroll 6
  for (int j = 0; j < na; ++j) {
    const T x = div_scalar(dof_vel[j] - prev_dv[j], R.dt, R.inv_dt);
    acc2 += x * x;
    const T r = Rb == kNightmareV3 ? prev_act[j] - act[j] : act[j] - prev_act[j];
    rate2 += r * r;
    const T d = dof_pos[j] - def[j];
    def2 += d * d;
    def1 += fabs(d);
    vel2 += dof_vel[j] * dof_vel[j];
    if (Rb == kAnymalC) {
      const T tq = static_cast<const T*>(a.in[kQfrcActuator])[nn * nv + 6 + j];
      tq2 += tq * tq;
    }
  }

  // every term's value, in the robot's REWARD_NAMES order
  T vals[kMaxTerms];
  {
    const T d0 = cmd[0] - lin[0], d1 = cmd[1] - lin[1];
    const T e = d0 * d0 + d1 * d1;
    const T d2 = cmd[2] - ang[2];
    const T track_lin = exp(div_scalar(-e, R.sigma, R.inv_sigma));
    const T track_ang = exp(div_scalar(-(d2 * d2), R.sigma, R.inv_sigma));
    const T term = mask<T>(reset && !time_out);
    const T lin_z = lin[2] * lin[2];
    const T ang_xy = ang[0] * ang[0] + ang[1] * ang[1];
    for (int t = 0; t < kMaxTerms; ++t) vals[t] = T(0);
    if (Rb == kNightmareV3) {
      T body;
      if (I.tibia_mode == 1 && I.body_mode == 1)
        body = tib + sd[12];
      else if (I.tibia_mode == 1)
        body = tib + T(0);
      else
        body = sd[12] + T(0);
      T height = T(0);
      if (a.in[kXipos] != nullptr) {
        const T h = static_cast<const T*>(a.in[kXipos])[(nn * I.nbody + 1) * 3 + 2];
        const T x = h - T(R.height_target);
        height = x * x;
      }
      vals[kNTermination] = term;
      vals[kNTrackingLinVel] = track_lin;
      vals[kNTrackingAngVel] = track_ang;
      vals[kNDofAcc] = acc2;
      vals[kNActionRate] = rate2;
      vals[kNBodyContactForces] = body;
      vals[kNDefaultPosition] = def2;
      vals[kNOrientation] = grav[0] * grav[0] + grav[1] * grav[1];
      vals[kNLinVelZ] = lin_z;
      vals[kNAngVelXy] = ang_xy;
      vals[kNFeetAirTime] = air;
      vals[kNTorques] = T(0);
      vals[kNBaseHeight] = height;
      vals[kNFeetContactForces] = over;
      vals[kNDofVel] = vel2;
      vals[kNStandStill] = def1 * mask<T>(moving < T(R.still_cut));
    } else {
      const T g0 = div_scalar(grav[0], R.grav_div, R.inv_grav_div);
      const T g1 = div_scalar(grav[1], R.grav_div, R.inv_grav_div);
      vals[kATermination] = term;
      vals[kATrackingLinVel] = track_lin;
      vals[kATrackingAngVel] = track_ang;
      vals[kALinVelZ] = lin_z;
      vals[kAAngVelXy] = ang_xy;
      vals[kAOrientation] = g0 * g0 + g1 * g1;
      vals[kATorques] = tq2;
      vals[kADofAcc] = acc2;
      vals[kAActionRate] = rate2;
      vals[kAFeetAirTime] = rew_air;
      vals[kAFeetContactForces] = over;
      vals[kAStandStill] = def1 * mask<T>(moving < T(R.still_cut));
    }
  }

  // the active terms, scaled, and their sum
  T rt[kMaxTerms];
  T reward = T(0);
  const int* ids = &I.term0;
  const T* scales = a.cst + I.c_scales;
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    rt[t] = T(0);
    if (t < I.nterms) {
      T v = T(0);
#pragma unroll
      for (int k = 0; k < kMaxTerms; ++k) v = ids[t] == k ? vals[k] : v;
      rt[t] = v * scales[t];
      reward += rt[t];
    }
  }

  // stores: the members split every array
  const int r0 = tm.rank(), step = tm.size();
  const T* qpos0 = a.cst + I.c_qpos0;
  T* qpos_out = static_cast<T*>(a.out[kQposOut]) + nn * nq;
  T* qvel_out = static_cast<T*>(a.out[kQvelOut]) + nn * nv;
  for (int k = r0; k < nq; k += step) qpos_out[k] = reset ? qpos0[k] : qpos[k];
  for (int k = r0; k < nv; k += step) qvel_out[k] = reset ? T(0) : qvel[k];
  T* dp_out = static_cast<T*>(a.out[kDofPosOut]) + nn * na;
  T* dv_out = static_cast<T*>(a.out[kDofVelOut]) + nn * na;
  for (int j = r0; j < na; j += step) {
    dp_out[j] = dof_pos[j];
    dv_out[j] = dof_vel[j];
  }
  T* fat_out = static_cast<T*>(a.out[kFeetAirTimeOut]) + nn * nf;
  uint8_t* lc_out = static_cast<uint8_t*>(a.out[kLastContactsOut]) + nn * nf;
#pragma unroll
  for (int k = 0; k < nf; ++k) {
    if (k % step != r0) continue;
    if (Rb == kNightmareV3) {
      uint8_t* lcf_out =
          static_cast<uint8_t*>(a.out[kLastContactsFiltOut]) + nn * nf;
      if (I.fat_active) {
        fat_out[k] = fat[k];
        lc_out[k] = contact[k];
        lcf_out[k] = filt[k];
      } else {
        fat_out[k] = reset ? T(0) : fat_in[k];
        lc_out[k] = flag<T>(a.in[kLastContacts], nn * nf + k);
        lcf_out[k] = flag<T>(a.in[kLastContactsFilt], nn * nf + k);
      }
    } else {
      fat_out[k] = fat[k] * mask<T>(!filt[k]);
      lc_out[k] = contact[k];
    }
  }
  const int nt = I.nterms;
  T* terms_out = static_cast<T*>(a.out[kRewardTerms]) + nn * nt;
  T* fin_out = static_cast<T*>(a.out[kFinished]) + nn * nt;
  T* sums_out = static_cast<T*>(a.out[kEpisodeSumsOut]) + nn * nt;
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t >= nt || t % step != r0) continue;
    terms_out[t] = rt[t];
    fin_out[t] = reset ? sums[t] : nan_value<T>();
    const T base = reset ? T(0) : sums[t];
    sums_out[t] = base + rt[t];
  }

  // the observation (a reset env returns its terminal one): its first 12
  // elements from the env's scalars (the loop unrolled, so that they stay
  // in registers), the joints' from memory
  const T* cmd_scale = a.cst + I.c_cmd_scale;
  const T* noise_vec = a.cst + I.c_noise;
  T* obs = static_cast<T*>(a.out[kObs]) + nn * I.nobs;
  const T clip = T(R.clip_obs);
  auto finish = [&](T o, int k) {
    if (Rb == kNightmareV3 && I.add_noise) {
      const T u = static_cast<const T*>(a.in[kNoise])[nn * I.nobs + k];
      const T t = T(2) * u;
      const T noise = t - T(1);
      o = o + noise * noise_vec[k];
    }
    obs[k] = clamp(o, -clip, clip);
  };
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    if (k % step != r0) continue;
    T o;
    if (k < 3)
      o = lin[k] * T(R.s_lin);
    else if (k < 6)
      o = ang[k - 3] * T(R.s_ang);
    else if (k < 9)
      o = Rb == kNightmareV3 ? grav[k - 6]
                             : div_scalar(grav[k - 6], R.grav_div, R.inv_grav_div);
    else
      o = cmd[k - 9] * cmd_scale[k - 9];
    finish(o, k);
  }
  for (int k = r0; k < I.nobs; k += step) {
    if (k < 12) continue;
    T o;
    if (k < 12 + na) {
      const T d = dof_pos[k - 12] - def[k - 12];
      o = Rb == kNightmareV3 ? d * T(R.s_dof_pos) : d;
    } else if (k < 12 + 2 * na) {
      o = dof_vel[k - 12 - na] * T(R.s_dof_vel);
    } else {
      o = act[k - 12 - 2 * na];
    }
    finish(o, k);
  }

  if (r0 == 0) {
    static_cast<int*>(a.out[kEpisodeLengthOut])[n] = reset ? 0 : len;
    T* c_out = static_cast<T*>(a.out[kCommandsOut]) + nn * 3;
    for (int i = 0; i < 3; ++i) c_out[i] = cmd[i];
    static_cast<T*>(a.out[kReward])[n] = reward;
    static_cast<uint8_t*>(a.out[kReset])[n] = reset;
    static_cast<uint8_t*>(a.out[kTimeOut])[n] = time_out;
  }
}

}  // namespace task_env
