"""How ``correct`` is decided for a training cell.

Set-up drives the program through its first iterations with the window's
own call, ``PPO.learn_step()``, and keeps what the plain reference needs to
follow them: the train state at the start; the state before and after a
sample of rollout steps (drawn from the seed) with the two generators'
states (``Recorder``); per iteration the weights before it, its trajectory,
last observations and permutation; and the first three optimizer steps'
statistics and lrs, Adam's first moments after the first and the weights
after each (``StepRecorder``).  After the window,
``reference_outputs`` recomputes each of these with
``reference/ppo.py`` and ``numbers`` compares:

- ``start_gap``: the train state of the seed (weights, env reset state and
  observations, episode lengths), worst field, relative to its scale;
- ``step_gap``: a rollout step (act, the physics substeps, the task half,
  store) followed from the program's own state before it, the next state,
  observations, trajectory row and env 0's record row: the 90th percentile
  over the sampled steps' envs of an env's worst field gap (a contact or
  reset decision that rounding flips parts a few envs);
- ``loss_gap``, ``grad_gap``, ``change_gap``: the first three optimizer
  steps (the first iteration's first three minibatches: GAE, the losses and
  gradients, the clip, Adam), the reference following its own weights on
  the program's trajectory and permutation: each step's loss; the first
  gradient as Adam got it (its first moments after one step), worst leaf
  by the gap of norms over the larger of the leaf's and the median leaf's
  norm; the weights' change after the three steps, the median over the
  leaves of the gap of a leaf's change norms over the reference's, among
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the median: at the second and third steps a few elements,
  such as the action std's, whose gradients are near 0 part by Adam's
  normalization, and samples near the clipped objectives' edges switch
  sides, so the worst leaf swings by 1e-3 on a few seeds);
- ``lr_gap``: the lr each of those steps took against the adaptive rule
  applied by the reference to its own KL.  The reference steps with the
  program's lr: at the first step the policy has not moved, its KL is 0 to
  rounding and the rule's ``0 < kl`` decides on the round-off floor, so two
  sound programs may take lr or 1.5 lr there; a decision on a floor (a KL
  under ``KL_FLOOR``, or within ``THRESHOLD_BAND`` of a threshold) is
  not compared.
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics
from typing import Dict, List

import torch

NUMBERS = ("start_gap", "step_gap", "loss_gap", "grad_gap", "change_gap",
           "lr_gap")
STEP_QUANTILE = 0.9
SMALL_GRAD = 1e-3
LEARN_STEPS = 3          # the optimizer steps the reference follows
KL_FLOOR = 1e-6          # a KL this small is an unmoved policy's rounding
THRESHOLD_BAND = 1e-3    # relative distance to a threshold of the lr rule


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dataclasses, NamedTuples, tuples and lists
    in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kids = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        kids = tree
    else:
        return []
    return [x for k in kids for x in leaves(k)]


def host(tree) -> List[torch.Tensor]:
    return [x.detach().to("cpu", copy=True) for x in leaves(tree)]


def sample_steps(seed: int, iterations: int, T: int, k: int) -> List[set]:
    """The rollout steps of each warm-up iteration that the reference
    follows: ``k`` of the ``T``, drawn from the seed."""
    rng = random.Random(seed)
    return [set(rng.sample(range(T), k)) for _ in range(iterations)]


class Recorder:
    """Wraps the program's rollout stepper (its captured step) during the
    warm-up iterations: before and after each sampled step it copies the
    carry, and before it the generators' states, to the host.  The step
    itself runs unchanged."""

    def __init__(self, step, ppo, env, samples: List[set]):
        self.step, self.ppo, self.env = step, ppo, env
        self.samples = samples
        self.k, self.t = 0, 0
        self.kept = []

    def __call__(self, carry):
        keep = self.t in self.samples[self.k]
        if keep:
            before = host(carry[:2])
            gens = (self.ppo.generator.get_state(),
                    self.env.generator.get_state())
        out = self.step(carry)
        if keep:
            self.kept.append(dict(k=self.k, t=self.t, before=before,
                                  gens=gens, after=host(out[:2])))
        self.t += 1
        if self.t == self.ppo.cfg.runner.num_steps_per_env:
            self.k, self.t = self.k + 1, 0
        return out

    def release(self) -> None:
        """Lets the program go: what was kept stays."""
        self.step = self.ppo = self.env = None


class StepRecorder:
    """Wraps the learning half's minibatch step (``rl/ppo.py::Parts.step``,
    a captured part) in the first iteration: after each of its first
    ``LEARN_STEPS`` replays it copies to the host the step's statistics
    (loss, surrogate, value loss, kl), the lr it took, Adam's first moments
    after the first and the weights after each.  The step itself runs
    unchanged."""

    def __init__(self, step, ppo):
        self.step, self.ppo = step, ppo
        self.rows, self.lrs, self.params = [], [], []
        self.exp_avg1 = None

    def __call__(self, losses):
        out = self.step(losses)
        j = len(self.rows)
        if j < LEARN_STEPS:
            self.rows.append(out.tolist())
            self.lrs.append(float(self.ppo.lr))
            if j == 0:
                self.exp_avg1 = host([self.ppo.optimizer.state[p]["exp_avg"]
                                      for p in self.ppo.params])
            self.params.append(host(self.ppo.params))
        return out

    def release(self) -> None:
        """Lets the program go: what was kept stays."""
        self.step = self.ppo = None


def program_iteration(ppo, stats: dict) -> dict:
    """What the reference needs of an iteration that has just run: its
    trajectory, last observations and permutation, and env 0's record."""
    return dict(traj=host(ppo._traj), obs=host(ppo.obs)[0],
                perm=ppo.last_perm.detach().cpu().clone(),
                record=None if "record" not in stats else
                [torch.tensor(x) for x in stats["record"]])


def _to(xs, device):
    return [x.to(device) for x in xs]


def reference_outputs(config: dict, N: int, seed: int, recorder: Recorder,
                      iters: List[dict], params: List[List[torch.Tensor]],
                      lrs: List[float], device, control: bool = False,
                      half: bool = False) -> Dict[str, object]:
    """The reference's outputs beside the program's: its start, each
    sampled step from the program's state before it, and its own first
    optimizer steps over the program's first trajectory with the lrs
    ``lrs`` that the program's steps took.  ``control``: computed with TF32
    (the low-precision control, in the program's place).  ``half``: a
    planted fault, half of the batch left out (a step leaves the second
    half of the envs as they were, a minibatch's loss is the mean over the
    first half of its samples)."""
    import contextlib

    from benchmark.reference import ppo as RP
    from benchmark.reference.plain.utils import device as D

    ctx = D.tf32() if control else contextlib.nullcontext()
    with ctx:
        ref = RP.Reference(config, N, device)
        start = ref.start(seed)
        out = dict(start=dict(params=host(start["params"]),
                              state=host(start["state"]),
                              obs=host(start["obs"])[0]))
        template = start["state"]
        steps = []
        for s in recorder.kept:
            st = _rebuild(template, _to(s["before"][:-1], device))
            r = ref.rollout_step(_to(params[s["k"]], device), st,
                                 s["before"][-1].to(device), *s["gens"],
                                 record=iters[s["k"]]["record"] is not None)
            if half:
                r = _left_out(r, st, s["before"][-1].to(device), N)
            steps.append(dict(state=host(r["state"]), obs=host(r["obs"])[0],
                              row=host(r["row"]),
                              record=None if r["record"] is None
                              else r["record"].cpu()))
        out["steps"] = steps
        ref.load(start["params"])
        it = iters[0]
        learn = RP.Learner(ref, half=half).first_steps(
            RP.Transition(*_to(it["traj"], device)), it["obs"].to(device),
            it["perm"].to(device), lrs)
        out["learn"] = dict(rows=learn["rows"], lrs=list(lrs),
                            rule_lr=learn["rule_lr"],
                            exp_avg1=host(learn["exp_avg1"]),
                            params=[host(p) for p in learn["params"]])
    return out


def _left_out(r: dict, state, obs, N: int) -> dict:
    """A step's outputs with the second half of the envs left as they
    were before it (their rows zero)."""
    h = N // 2
    keep = [x.clone() for x in leaves(r["state"])]
    for x, y in zip(keep, leaves(state)):
        x[h:] = y[h:]
    nobs = r["obs"].clone()
    nobs[h:] = obs[h:]
    row = [x.clone() for x in r["row"]]
    for x in row:
        x[h:] = 0
    return dict(r, state=_rebuild(r["state"], keep), obs=nobs, row=row)


def _rebuild(template, new):
    """``template``'s tree with its leaves replaced by ``new``."""
    it = iter(new)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{f.name: go(getattr(t, f.name))
                                             for f in dataclasses.fields(t)})
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[go(c) for c in t])
        if isinstance(t, (tuple, list)):
            return type(t)(go(c) for c in t)
        return t

    return go(template)


def env_gaps(pairs, N: int) -> torch.Tensor:
    """Per env, the worst gap over the fields ``pairs`` (program, reference;
    env axis first): a float field's largest difference over its scale (its
    largest magnitude over the envs), 1 for a flag or a count that differs,
    inf where one side is NaN and the other not."""
    gaps = torch.zeros(N, dtype=torch.float64)
    for p, r in pairs:
        p, r = p.reshape(N, -1), r.reshape(N, -1)
        if not p.is_floating_point():
            d = (p != r).any(dim=1).double()
        else:
            p, r = p.double(), r.double()
            nan_p, nan_r = torch.isnan(p), torch.isnan(r)
            diff = torch.where(nan_p | nan_r, 0.0, (p - r).abs())
            scale = torch.nan_to_num(r.abs(), posinf=0.0).max()
            d = diff.amax(dim=1) / max(float(scale), 1e-6)
            d = torch.where((nan_p != nan_r).any(dim=1), math.inf, d)
        gaps = torch.maximum(gaps, d)
    return gaps


def _leaf_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The worst leaf's gap of norms, over the larger of its reference
    norm and the median leaf's."""
    n_p = [float(x.double().norm()) for x in prog]
    n_r = [float(x.double().norm()) for x in ref]
    med = statistics.median(n_r)
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(n_p, n_r))


def _lr_gap(lrs: List[float], rows: List[list], rule: List[float],
            algo: dict) -> float:
    """The largest relative gap of an lr that a step took from the rule's,
    over the steps whose KL (the reference's) is off the rule's floors."""
    thresholds = (algo["desired_kl"] * 2.0, algo["desired_kl"] / 2.0)
    worst = 0.0
    for lr, row, want in zip(lrs, rows, rule):
        kl = row[3]
        if kl <= KL_FLOOR or any(abs(kl / t - 1) <= THRESHOLD_BAND
                                 for t in thresholds):
            continue
        worst = max(worst, abs(lr - want) / want)
    return worst


def _median_leaf_gap(prog: List[torch.Tensor], ref: List[torch.Tensor],
                     keep: List[bool]) -> float:
    """The median over the kept leaves of the gap of norms over the
    reference's norm."""
    return statistics.median(
        abs(float(a.double().norm()) - float(b.double().norm()))
        / max(float(b.double().norm()), 1e-30)
        for a, b, k in zip(prog, ref, keep) if k)


def numbers(prog: Dict[str, object], ref: Dict[str, object], N: int,
            algo: dict) -> Dict[str, float]:
    """The compared numbers (``NUMBERS``) of the program's outputs against
    the reference's; ``algo``: the configuration's PPO algorithm."""
    ps, rs = prog["start"], ref["start"]
    start = env_gaps(list(zip(ps["state"], rs["state"]))
                     + [(ps["obs"], rs["obs"])], N).max()
    start = max(float(start), _leaf_gap(ps["params"], rs["params"]),
                max(float((a - b).abs().max()) for a, b in
                    zip(ps["params"], rs["params"])))
    gaps = []
    for p, r in zip(prog["steps"], ref["steps"]):
        pairs = list(zip(p["state"], r["state"])) + [(p["obs"], r["obs"])]
        pairs += list(zip(p["row"], r["row"]))
        g = env_gaps(pairs, N)
        if p["record"] is not None:
            g[0] = max(g[0], env_gaps([(p["record"][None], r["record"][None])],
                                      1)[0])
        gaps.append(g)
    step = (float(torch.quantile(torch.cat(gaps), STEP_QUANTILE))
            if gaps else 0.0)
    pl, rl = prog["learn"], ref["learn"]
    loss = max(abs(a[0] - b[0]) / max(abs(b[0]), 1e-30)
               for a, b in zip(pl["rows"], rl["rows"]))
    grad = _leaf_gap(pl["exp_avg1"], rl["exp_avg1"])
    med = statistics.median(float(x.norm()) for x in rl["exp_avg1"])
    keep = [float(x.norm()) >= SMALL_GRAD * med for x in rl["exp_avg1"]]
    change = _median_leaf_gap(
        [a - b for a, b in zip(pl["params"][-1], ps["params"])],
        [a - b for a, b in zip(rl["params"][-1], rs["params"])], keep)
    return dict(start_gap=start, step_gap=step, loss_gap=loss,
                grad_gap=grad, change_gap=change,
                lr_gap=_lr_gap(pl["lrs"], rl["rows"], rl["rule_lr"], algo))


def program_outputs(start: dict, recorder: Recorder, iters: List[dict],
                    learn: "StepRecorder") -> Dict[str, object]:
    """The program's side of ``numbers``, from what set-up kept."""
    steps = []
    for s in recorder.kept:
        it = iters[s["k"]]
        row = [x[s["t"]] for x in it["traj"]]
        rec = None
        if it["record"] is not None:
            rec = torch.cat([x[s["t"]].reshape(-1).float()
                             for x in it["record"]])
        steps.append(dict(state=s["after"][:-1], obs=s["after"][-1], row=row,
                          record=rec))
    return dict(start=start, steps=steps,
                learn=dict(rows=learn.rows, lrs=learn.lrs,
                           exp_avg1=learn.exp_avg1, params=learn.params))


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or below its limit (NaN fails)."""
    return all(values[k] <= limits[k] for k in NUMBERS)
