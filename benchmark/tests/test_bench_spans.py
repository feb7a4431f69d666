"""``spans.py``'s reduction of a profiled stretch by the program's spans,
on a hand-made chrome trace and recording: the idle time while each span
was open (a nested span counted once, in its parent's part), in the rest
of an iteration and outside every iteration, their sum against the
stretch's own idle time, the counters, the clock's offset, and the command
that reads a profile directory."""

import json

import pytest

from benchmark import spans

BASE = 10**18


def _rec(spans_us, counters=None, offset_ns=0, unit=1000):
    """A recording's dict from (name, start, end, parent) in microseconds
    after BASE (seconds with ``unit`` 1e9), its stamps ``offset_ns`` behind
    the trace's clock."""
    out, iteration, n = [], None, 0
    for name, a, b, parent in spans_us:
        if name == "ppo.iteration":
            iteration, n = n, n + 1
        out.append({"name": name, "start": BASE + round(a * unit) - offset_ns,
                    "end": BASE + round(b * unit) - offset_ns,
                    "parent": parent, "iteration": iteration, "attrs": {}})
    return {"clock": "time.time_ns", "offset_ns": offset_ns, "spans": out,
            "counters": counters or {}}


SPANS = [("ppo.iteration", 0, 1000, None), ("ppo.rollout", 100, 600, 0),
         ("ppo.record", 550, 600, 1), ("ppo.learn", 600, 900, 0),
         ("ppo.stats", 900, 1000, 0),
         ("ppo.iteration", 1200, 2200, None), ("ppo.rollout", 1300, 1800, 5),
         ("ppo.learn", 1800, 2100, 5), ("ppo.stats", 2100, 2200, 5)]


def _events():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    return [x("kernel", "step", 120, 380), x("kernel", "grads", 620, 260),
            x("gpu_memset", "set", 1150, 100),    # half outside, half head
            x("kernel", "step", 1320, 380), x("gpu_memcpy", "copy", 1820, 180),
            x("kernel", "after", 2300, 50),       # past the stretch
            x("cpu_op", "aten::mm", 0, 2200),     # not the card's
            x("gpu_user_annotation", "ppo.rollout", 100, 500),
            x("cuda_runtime", "cudaDeviceSynchronize", 590, 10),
            x("cuda_runtime", "cudaStreamSynchronize", 990, 10),
            x("cuda_runtime", "cudaLaunchKernel", 110, 5)]


@pytest.mark.parametrize("offset_ns", [0, 7000])
def test_idle_by_span(offset_ns):
    st = spans.reduce(_events(), BASE, _rec(
        SPANS, {"host.syncs": 8, "graph.captures": 0}, offset_ns))
    assert st["iterations"] == 2 and st["window_ms"] == pytest.approx(2.2)
    # rollout: 120 + 120 us; learn: 40 + 120; the rest of the iterations:
    # heads 100 + 50, statistics 100 + 100; outside: 150 of 200
    assert st["rollout_idle_ms"] == pytest.approx(0.120)
    assert st["learn_idle_ms"] == pytest.approx(0.080)
    assert st["stats_idle_ms"] == pytest.approx(0.175)
    assert st["outside_idle_ms"] == pytest.approx(0.075)
    # the card busy 1,300 of 2,200 us
    assert st["idle_ms"] == pytest.approx(0.900)
    assert st["sum_ms"] == pytest.approx(st["idle_ms"])
    assert (st["host_syncs"], st["captures"], st["trace_syncs"]) == (8, 0, 2)
    assert st["offset_ns"] == offset_ns


def test_no_recording_or_iteration_reads_nothing():
    assert spans.reduce(_events(), BASE, None) is None
    assert spans.reduce(_events(), BASE, _rec(
        [("ppo.rollout", 0, 10, None)])) is None


def test_intervals():
    a = [(0.0, 10.0), (20.0, 30.0)]
    assert spans._minus(a, [(2.0, 3.0), (5.0, 25.0)]) == [
        (0.0, 2.0), (3.0, 5.0), (25.0, 30.0)]
    assert spans._minus(a, []) == a
    assert spans._overlap(a, [(5.0, 22.0), (29.0, 40.0)]) == 5 + 2 + 1
    assert spans._idle(a, [(5.0, 22.0)]) == 20 - 7


def _profile_dir(path, rec):
    (path / "trace.json").write_text(json.dumps(
        {"baseTimeNanoseconds": BASE, "traceEvents": _events()}))
    (path / "spans.json").write_text(json.dumps(rec))
    return str(path)


def test_reads_a_profile_directory(tmp_path, capsys):
    rec = _rec(SPANS, {"host.syncs": 8, "graph.captures": 0}, 7000)
    d = _profile_dir(tmp_path, rec)
    assert spans.read(d) == spans.reduce(_events(), BASE, rec)
    assert spans.main([d]) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[0])["stats_idle_ms"] == pytest.approx(0.175)
    assert "holds within 2 %" in out[1]
    assert "host syncs 4 an iteration" in out[2]
    assert "captures in the stretch 0" in out[2]
    assert "offset 7.000 us" in out[2]


def test_a_profile_without_iterations(tmp_path):
    d = _profile_dir(tmp_path, _rec([("ppo.rollout", 0, 10, None)]))
    assert spans.main([d]) == 1
    assert spans.main([]) == 2
