"""Data-parallel training of the port (parallel/mesh.py, parallel/shard.py)
on the CPU with gloo, mirroring tests/test_sharded.py and
tests/test_multihost.py.

The port's random draws are made at the global shape and cut per rank, so
the rollout does not depend on the world size; with a 1×1 update (one
minibatch, one epoch) the averaged shard gradients equal the global-batch
gradient, so world 1 and world 2 take the same step up to float32
round-off (the CLI trains in float32), held to the JAX test's tolerances.
With the default 5×4 update the minibatches are shard-local (PARITY.md §4)
and only the rollout statistics must agree.

The CLI runs under ``python -m torch.distributed.run`` in two subprocess
runs shared by the module, as the ranks that chip_smoke.py's sharded phase
runs on the card (``chip_smoke.mesh_worker``), here with ``--device cpu``
at 16 global envs, rnn 32 and 4 steps in the learn and recurrent jobs:
world 2, then world 1, which also resumes world 2's recurrent checkpoint.

The ranks' learning half is ``rl/ppo.py::CapturedLearn``, its parts split
at the reductions over the ranks (on the CPU each part runs eagerly on its
buffers); the ``learn`` job holds it against the plain ``PPO._learn`` on
each rank from one state (``chip_smoke._hold_learner``).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.core.config import EnvCfg, NightmareV3Cfg
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.parallel import mesh as M
from nightmare_rl_tpu_torch.parallel.shard import Shard, local_envs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

WORKER_ARGS = ("--device", "cpu", "--envs", "16", "--rnn", "32",
               "--steps", "4", "--seed", "3",
               "single", "default", "learn", "recurrent")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    w2, w1 = str(root / "w2"), str(root / "w1")
    smoke._torchrun(2, w2, *WORKER_ARGS, timeout=300)
    smoke._torchrun(1, w1, *WORKER_ARGS, "--resume",
                    os.path.join(w2, "recurrent"), timeout=300)
    return dict(w1=w1, w2=w2, load=smoke._load_rank)


_equal = smoke._same


# ---------------------------------------------------------------------------
# the draw helper and the shard-aware env, in this process


def test_shard_draws_are_slices_of_the_global_draw():
    n, world = 5, 3
    g = torch.Generator().manual_seed(4)
    full = torch.rand(n * world, 2, generator=g)
    ints = torch.randint(0, 7, (n * world,), generator=g)
    perm = torch.randperm(4 * n * world, generator=g)
    states = set()
    seen = []
    for r in range(world):
        sh = Shard(r, world)
        g.manual_seed(4)
        assert torch.equal(sh.draw(torch.rand, (n, 2), generator=g),
                           full[r * n:(r + 1) * n])
        assert torch.equal(sh.randint(7, n, generator=g),
                           ints[r * n:(r + 1) * n])
        p = sh.perm(4, n, g, "cpu")
        # a permutation of this rank's 4·n samples, in the global order
        assert torch.equal(torch.sort(p).values, torch.arange(4 * n))
        t, e = p // n, p % n + r * n
        seen.append(t * n * world + e)
        states.add(bytes(g.get_state().numpy()))
    assert len(states) == 1  # every rank's generator ends in one state
    glob = torch.cat(seen)
    assert torch.equal(torch.sort(glob).values, torch.arange(4 * n * world))
    # each rank keeps the global permutation's order of its samples
    for r, s in enumerate(seen):
        mine = perm[(perm % (n * world)) // n == r]
        assert torch.equal(s, mine)
    # world 1 is exactly the unsharded draw
    g.manual_seed(4)
    torch.rand(n * world, 2, generator=g)
    torch.randint(0, 7, (n * world,), generator=g)
    assert torch.equal(Shard().perm(4, n * world, g, "cpu"), perm)
    with pytest.raises(ValueError, match="divide"):
        local_envs(10, Shard(0, 3))


def test_sharded_env_draws_the_rows_of_the_global_env():
    cfg = NightmareV3Cfg().replace(env=EnvCfg(num_envs=8))
    whole = NightmareV3Env(cfg, device="cpu")
    state, obs = whole.reset(5)
    for r in range(2):
        part = NightmareV3Env(cfg, device="cpu", shard=Shard(r, 2))
        assert part.num_envs == 4
        st, ob = part.reset(5)
        rows = slice(4 * r, 4 * r + 4)
        assert torch.equal(st.commands, state.commands[rows])
        np.testing.assert_allclose(ob.numpy(), obs[rows].numpy(), rtol=0,
                                   atol=1e-6)
        assert torch.equal(part.generator.get_state(),
                           whole.generator.get_state())


def test_mesh_backend_and_device_choice(monkeypatch):
    """The backend is an explicit choice: gloo on the CPU; nccl is refused
    there and, where ranks outnumber the cards, on the card; no card
    without --device cpu raises."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="gloo"):
        M.make_mesh("cpu", "nccl")
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        M.make_mesh("cpu", require_launcher=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh("cuda")
    mesh = M.make_mesh("cpu")
    try:
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        assert mesh.shard == Shard(0, 1)
        env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=2)),
                             device="cpu", shard=Shard(1, 2))
        from nightmare_rl_tpu_torch.core.config import PPOCfg
        from nightmare_rl_tpu_torch.rl.ppo import PPO

        with pytest.raises(ValueError, match="shard"):
            M.ShardedPPO(env, PPOCfg(), mesh)
        with pytest.raises(ValueError, match="ShardedPPO"):
            PPO(env, PPOCfg())
    finally:
        M.close()


# ---------------------------------------------------------------------------
# the CLI at world 1 and world 2


def test_single_minibatch_world1_equals_world2(runs):
    """1×1 update: rollout stats, loss, KL and parameters agree to the JAX
    test's float32 tolerances (tests/test_sharded.py:54-91)."""
    a, b = runs["load"](runs["w1"], "single"), runs["load"](runs["w2"], "single")
    sa, sb = a["stats"], b["stats"]
    np.testing.assert_allclose(sa["mean_reward"], sb["mean_reward"], rtol=1e-6)
    assert sa["dones"] == sb["dones"]
    np.testing.assert_allclose(sa["loss"], sb["loss"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sa["kl"], sb["kl"], rtol=1e-5, atol=1e-8)
    params = [k for k in a["items"] if k.startswith("net.")]
    assert len(params) == 17
    for k in params:
        np.testing.assert_allclose(a["items"][k].numpy(), b["items"][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the rollout is the same: the gathered global observations agree
    np.testing.assert_allclose(a["items"]["obs"].numpy(),
                               b["items"]["obs"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [1, 2])
def test_segmented_learner_equals_learn(runs, world):
    """On every rank, from one state (restored in place): the learning half
    as ``learn_step`` runs it under a mesh (``CapturedLearn``: its parts,
    the reductions between them in place on the parts' buffers) against
    ``PPO._learn`` called with the plain functions: statistics,
    parameters, gradients, Adam's state, the lr, the permutation and the
    generator's state equal bit for bit (``torch.equal``), for the
    feed-forward ``learn`` job and, at world 2, the recurrent one.  Every
    job's rank trained through the segmented learner."""
    assert M.ShardedPPO.graph_update is True
    jobs = ("learn", "recurrent") if world == 2 else ("learn",)
    for rank, job in ((r, j) for r in range(world) for j in jobs):
        held = runs["load"](runs[f"w{world}"], job, rank)["held"]
        ref, got = held["eager"], held["graph"]
        for k in ("params", "grads", "adam", "lr"):
            assert len(ref[k]) == len(got[k]) > 0
            for a, b in zip(ref[k], got[k]):
                assert torch.equal(a, b), (world, rank, job, k)
        for k in ("stats", "perm", "generator"):
            assert torch.equal(ref[k], got[k]), (world, rank, job, k)
        assert np.isfinite(ref["stats"].numpy()).all()
        for job in ("single", "default", "learn", "recurrent"):
            assert runs["load"](runs[f"w{world}"], job, rank)["learner"], job
    # the ranks took the same step from replicated parameters
    if world == 2:
        h0, h1 = (runs["load"](runs["w2"], "learn", r)["held"]["graph"]
                  for r in (0, 1))
        for k in ("params", "grads", "adam", "lr"):
            assert all(torch.equal(a, b) for a, b in zip(h0[k], h1[k])), k


def test_default_minibatching_rollout_stats_equal(runs):
    a, b = runs["load"](runs["w1"], "default"), runs["load"](runs["w2"], "default")
    sa, sb = a["stats"], b["stats"]
    np.testing.assert_allclose(sa["mean_reward"], sb["mean_reward"], rtol=1e-6)
    assert sa["dones"] == sb["dones"]
    np.testing.assert_allclose(sa["episode_reward_means"],
                               sb["episode_reward_means"], rtol=1e-6, atol=1e-7)
    assert np.isfinite(sb["loss"])


def test_ranks_hold_replicas_and_their_shards(runs):
    """Parameters, optimizer, lr and generators are equal on both ranks;
    each rank holds its 8 of the 16 envs and of the recurrent state, and
    the gathered state is the ranks' rows in rank order."""
    for job in ("single", "default", "learn", "recurrent"):
        r0, r1 = (runs["load"](runs["w2"], job, r) for r in (0, 1))
        assert r0["world"] == 2 and r0["num_envs"] == r1["num_envs"] == 8
        assert r0["items"].keys() == r1["items"].keys()
        for k in r0["items"]:
            assert _equal(r0["items"][k], r1["items"][k]), (job, k)
        assert torch.equal(torch.cat([r0["obs"], r1["obs"]]), r0["items"]["obs"])
    r0, r1 = (runs["load"](runs["w2"], "recurrent", r) for r in (0, 1))
    for i, name in enumerate(("actor", "critic")):
        for j, part in enumerate(("h", "c")):
            h0, h1 = r0["hidden"][2 * i + j], r1["hidden"][2 * i + j]
            assert h0.shape == h1.shape == (8, 32)
            assert float(h0.abs().max()) > 0 and float(h1.abs().max()) > 0
            assert torch.equal(torch.cat([h0, h1]),
                               r0["items"][f"hidden.{name}.{part}"])


def test_world2_checkpoint_resumes_at_world1(runs):
    saved = runs["load"](runs["w2"], "recurrent")["items"]
    loaded = runs["load"](runs["w1"], "loaded")["items"]
    assert saved.keys() == loaded.keys()
    assert any(k.startswith("env.phys.") for k in saved)
    assert "hidden.actor.h" in saved and "generator" in saved
    differ = [k for k in saved if not _equal(saved[k], loaded[k])]
    assert not differ, differ
    cont = runs["load"](runs["w1"], "continued")
    assert cont["items"]["iteration"] == 2 and np.isfinite(cont["stats"]["loss"])


def test_runner_writes_checkpoints_under_a_mesh(runs):
    for job in ("single", "default", "recurrent"):
        files = [f for _, _, fs in os.walk(os.path.join(runs["w2"], job))
                 for f in fs]
        assert "model_1.pt" in files and "metrics.jsonl" in files, files
    blob = torch.load(next(os.path.join(d, "model_1.pt") for d, _, fs in
                           os.walk(os.path.join(runs["w2"], "recurrent"))
                           if "model_1.pt" in fs), weights_only=True)
    assert blob["train_state"]["obs"].shape == (16, 66)
    assert blob["train_state"]["hidden"]["actor"]["h"].shape == (16, 32)
    assert "memory_a.rnn.weight_ih_l0" in blob["model_state_dict"]
