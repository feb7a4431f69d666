"""The port's tracing (``nightmare_rl_tpu_torch/utils/trace.py``): off, a
span is one shared null context and nothing is recorded; on, spans nest
with their parents and PPO iteration, ``learn_step``'s ``ppo.iteration``
holds ``ppo.rollout`` (with ``ppo.record``), ``ppo.learn`` and
``ppo.stats``, whose stamps are the statistics' ``rollout_s`` and
``update_s``; the counters count the host's blocking reads, the captures
and the compiles; a capture, an env's constructor and a recording's
alignment to a profiler trace.  The tests marked ``cuda`` (a capture holds
the same launches with tracing on and off; a span's stamps against its
annotation in an exported profiler trace; the capture's spans and a
``learn_step``'s syncs on the card) skip where there is no card.  The file
imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_trace.py
"""

import json
import subprocess
from unittest import mock

import pytest
import torch

from nightmare_rl_tpu_torch.core.config import (
    EnvCfg, NightmareV3Cfg, PPOCfg, RunnerCfg,
)
from nightmare_rl_tpu_torch.envs.nightmare_v3 import NightmareV3Env
from nightmare_rl_tpu_torch.ops import build
from nightmare_rl_tpu_torch.rl.ppo import PPO
from nightmare_rl_tpu_torch.utils import trace
from nightmare_rl_tpu_torch.utils.graph import CapturedStep

ITERATION_PARTS = ["ppo.rollout", "ppo.learn", "ppo.stats"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def tracing_off():
    assert trace.stop() is None, "a test left a recording on"
    yield
    trace.stop()


def _ppo(record=True, device="cpu", n=4):
    env = NightmareV3Env(NightmareV3Cfg().replace(
        env=EnvCfg(num_envs=n, episode_length_s=0.2)), device=device)
    ppo = PPO(env, PPOCfg().replace(runner=RunnerCfg(num_steps_per_env=2)),
              record_states=record)
    ppo.init(0)
    return ppo


def _children(rec, index):
    return [s for s in rec.spans if s.parent == index]


def test_off_is_one_null_context_and_records_nothing():
    assert trace.span("a") is trace.span("b", fn="x")
    with trace.span("a") as s:
        assert s is None
    assert trace.count("host.syncs") is None
    with trace.timed("ppo.rollout") as t:
        pass
    assert t.seconds >= 0 and not hasattr(t, "index")
    ppo = _ppo()
    with mock.patch.object(trace, "_On", side_effect=AssertionError), \
            mock.patch.object(trace, "Recording", side_effect=AssertionError):
        stats = ppo.learn_step()
    assert stats["rollout_s"] > 0 and stats["update_s"] > 0
    assert trace.stop() is None


def test_spans_nest_with_their_parents_and_iteration():
    with trace.recording() as rec:
        with trace.span("outer", k=1):
            with trace.span("inner"):
                trace.count("c")
        for _ in range(2):
            with trace.span(trace.ITERATION):
                with trace.span("part"):
                    with trace.span("leaf"):
                        trace.count("c", 2)
    assert trace.span("x") is trace.span("y")  # off again after the block
    got = [(s.name, s.parent, s.iteration, s.attrs) for s in rec.spans]
    assert got == [("outer", None, None, {"k": 1}), ("inner", 0, None, {}),
                   (trace.ITERATION, None, 0, {}), ("part", 2, 0, {}),
                   ("leaf", 3, 0, {}), (trace.ITERATION, None, 1, {}),
                   ("part", 5, 1, {}), ("leaf", 6, 1, {})]
    assert rec.counters == {"c": 5}
    for s in rec.spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end


def test_learn_step_spans_cover_the_iteration():
    """Two iterations: each ``ppo.iteration`` holds its three parts in
    order, the rollout's one read below the rollout; the statistics'
    seconds are the rollout's and learning half's spans."""
    ppo = _ppo()
    ppo.learn_step()
    with trace.recording() as rec:
        stats = [ppo.learn_step() for _ in range(2)]
    iters = [i for i, s in enumerate(rec.spans) if s.name == trace.ITERATION]
    assert len(iters) == 2
    for k, i in enumerate(iters):
        it = rec.spans[i]
        parts = _children(rec, i)
        assert [s.name for s in parts] == ITERATION_PARTS
        assert all(s.iteration == k for s in parts)
        edges = [it.start] + [t for s in parts for t in (s.start, s.end)] + [
            it.end]
        assert edges == sorted(edges)
        # learn_step's head and the gaps between the parts are all the
        # iteration holds besides them
        covered = sum(s.end - s.start for s in parts)
        assert covered >= 0.95 * (it.end - it.start)
        rollout, learn, _ = parts
        record = _children(rec, rec.spans.index(rollout))
        assert [s.name for s in record] == ["ppo.record"]
        assert stats[k]["rollout_s"] == (rollout.end - rollout.start) * 1e-9
        assert stats[k]["update_s"] == (learn.end - learn.start) * 1e-9
        assert stats[k]["graph_captures"] == 0


@pytest.mark.parametrize("record,syncs", [(True, 4), (False, 3)])
def test_host_syncs_a_learn_step(record, syncs):
    """The iteration's blocking calls: the two syncs after the rollout and
    the learning half, env 0's record copy (with ``record_states``) and
    the statistics' readback."""
    ppo = _ppo(record)
    with trace.recording() as rec:
        ppo.learn_step()
        ppo.learn_step()
    assert rec.counters["host.syncs"] == 2 * syncs


def test_first_iteration_counts_its_captures():
    """The rollout step and the learning half's five parts are made in the
    first iteration, each inside a ``graph.capture`` span named by the
    captured function; later iterations make none."""
    ppo = _ppo()
    with trace.recording() as rec:
        first = ppo.learn_step()
    assert first["graph_captures"] == 6
    assert rec.counters["graph.captures"] == 6
    caps = [s for s in rec.spans if s.name == "graph.capture"]
    where = {s.attrs["fn"]: rec.spans[s.parent].name for s in caps}
    assert where == {"PPO._rollout_step": "ppo.rollout",
                     "PPO._head": "ppo.learn", "PPO._spread": "ppo.learn",
                     "PPO._tail": "ppo.learn", "PPO._grads": "ppo.learn",
                     "PPO._step": "ppo.learn"}
    with trace.recording() as rec:
        assert ppo.learn_step()["graph_captures"] == 0
    assert "graph.captures" not in rec.counters


def test_captured_step_on_the_cpu_records_its_capture():
    """On the CPU a ``CapturedStep`` captures nothing and warms nothing up:
    its construction is one ``graph.capture`` span with no children (on
    the card it holds ``graph.warmup`` and ``graph.record``:
    ``test_capture_spans_on_the_card``)."""
    def step(state, x):
        return state + x

    state, x = torch.zeros(3), torch.ones(3)
    with trace.recording() as rec:
        cap = CapturedStep(step, state, x)
    assert [(s.name, s.parent, s.attrs) for s in rec.spans] == [
        ("graph.capture", None,
         {"fn": "test_captured_step_on_the_cpu_records_its_capture."
                "<locals>.step"})]
    assert rec.counters == {"graph.captures": 1}
    assert cap.graph is None and cap.warmup_s == cap.capture_s == 0.0
    assert torch.equal(cap(state, x), x)


def test_env_constructor_is_a_setup_span():
    with trace.recording() as rec:
        env = NightmareV3Env(NightmareV3Cfg().replace(
            env=EnvCfg(num_envs=2)), device="cpu")
    assert env.num_envs == 2
    spans = [(s.name, s.attrs) for s in rec.spans]
    assert spans == [("setup.env", {"fn": "NightmareV3Env.__init__"})]


def test_build_counts_its_compiles(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// k\n")
    (tmp_path / "k.cpp").write_text("// k\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.shutil, "which", lambda name: name)

    def compiler(cmd, **_):
        with open(cmd[cmd.index("-o") + 1], "w") as fh:
            fh.write("lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build.subprocess, "run", compiler)
    with trace.recording() as rec:
        build.build("k")
        build.build_host("k")
        build.build("k")       # found: no compile
        build.build_host("k")
    assert rec.counters == {"build.compiles": 2}


def test_align_and_write(tmp_path):
    """A recording's offset against a hand-made exported trace: the median
    of the annotations' starts less the spans' (names of which the two
    hold as many); the written file holds the spans, counters and
    offset."""
    with trace.recording() as rec:
        for _ in range(3):
            with trace.span("a"):
                trace.count("n")
        with trace.span("b"):
            pass
    base = rec.spans[0].start // 10**9 * 10**9  # whole seconds, as torch's
    events = [{"ph": "X", "cat": "user_annotation", "name": "a",
               "ts": (s.start - base + d) * 1e-3, "dur": 1.0}
              for s, d in zip(rec.spans[:3], (1000, 2000, 9000))]
    events.append({"ph": "X", "cat": "gpu_user_annotation", "name": "b",
                   "ts": 0.0, "dur": 1.0})
    assert rec.align({"traceEvents": events, "baseTimeNanoseconds": base}) \
        == 2000
    assert trace.Recording().align({"traceEvents": events}) is None
    rec.write(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as fh:
        back = json.load(fh)
    assert back["offset_ns"] == 2000 and back["counters"] == {"n": 3}
    assert [s["name"] for s in back["spans"]] == ["a", "a", "a", "b"]
    assert back["spans"][0]["end"] >= back["spans"][0]["start"]


# --------------------------------------------------------------- the card


def _env_step(device, n=64):
    env = NightmareV3Env(NightmareV3Cfg().replace(env=EnvCfg(num_envs=n)),
                         device=device)
    state, _ = env.reset(0)
    return env, state, torch.zeros(n, env.num_actions, device=device)


@pytest.mark.cuda
def test_capture_holds_the_same_launches_with_tracing_on(cuda):
    """The env step captured with tracing off and on: the same kernel
    launches a replay and the same graph nodes by type."""
    env, state, acts = _env_step(cuda)

    def capture():
        return CapturedStep(env.step, state, acts, generators=[env.generator],
                            state_field="state", debug=True)

    off = capture()
    with trace.recording() as rec:
        on = capture()
    assert rec.counters["graph.captures"] == 1
    assert on.launches == off.launches and sum(on.launches.values()) > 0
    assert on.node_counts() == off.node_counts()


@pytest.mark.cuda
def test_capture_spans_on_the_card(cuda):
    """On the card a capture's span holds its warm-up and its recording,
    whose seconds are the object's ``warmup_s`` and ``capture_s``."""
    env, state, acts = _env_step(cuda)
    with trace.recording() as rec:
        cap = CapturedStep(env.step, state, acts, generators=[env.generator],
                           state_field="state")
    top = [i for i, s in enumerate(rec.spans) if s.name == "graph.capture"]
    assert len(top) == 1 and rec.spans[top[0]].parent is None
    assert rec.spans[top[0]].attrs == {"fn": "NightmareV3Env.step"}
    warm, record = _children(rec, top[0])
    assert (warm.name, record.name) == ("graph.warmup", "graph.record")
    assert cap.warmup_s == (warm.end - warm.start) * 1e-9
    assert cap.capture_s == (record.end - record.start) * 1e-9
    assert 0 < cap.record_s <= cap.capture_s


@pytest.mark.cuda
def test_span_stamps_agree_with_the_profiler_trace(cuda, tmp_path):
    """A span's in-memory stamps and its annotation in the exported
    profiler trace agree within 50 us, with no offset applied."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(512, 512, device=cuda)
    with record_function("warm"):
        (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("warm"):  # the first annotation's set-up
            torch.cuda.synchronize()
        with trace.recording() as rec:
            for _ in range(5):
                with trace.span("probe"):
                    y = x @ x
                    torch.cuda.synchronize()
        torch.cuda.synchronize()
    del y
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        chrome = json.load(fh)
    base = chrome.get("baseTimeNanoseconds", 0)
    marks = sorted((e for e in chrome["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and e.get("name") == "probe"), key=lambda e: e["ts"])
    assert len(marks) == len(rec.spans) == 5
    for s, e in zip(rec.spans, marks):
        start = base + e["ts"] * 1e3
        assert abs(s.start - start) < 50e3, (s.start, start)
        assert abs(s.end - (start + e["dur"] * 1e3)) < 50e3
    assert abs(rec.align(chrome)) < 50e3


@pytest.mark.cuda
def test_learn_step_syncs_on_the_card(cuda):
    """On the card a learn_step blocks the host four times, as the counter
    says: ``host.syncs`` against the profiler's synchronize calls inside
    the iteration's annotation (the profiler's own start and stop
    synchronize too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ppo = _ppo(device=cuda, n=64)
    ppo.learn_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec:
            ppo.learn_step()
    events = prof.events()
    it, = [e.time_range for e in events if e.name == trace.ITERATION
           and e.device_type == DeviceType.CPU]
    syncs = [e for e in events if "Synchronize" in e.name
             and it.start <= e.time_range.start < it.end]
    assert rec.counters["host.syncs"] == len(syncs) == 4
