"""BENCHMARK.json and the benchmark's data files against the format they
follow: names and units of the allowed characters, the keys each
entry may have, one file a configuration, cell and metric, found by name,
and every per-layer metric's end-to-end metric reported where it is."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


def test_keys_and_counts(spec):
    assert set(spec) == KEYS["top"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    for kind, lo, hi in (("configs", 1, 24), ("workloads", 1, 24),
                         ("end_to_end", 1, 16), ("per_layer", 1, 128)):
        assert lo <= len(spec[kind]) <= hi
    for c in spec["configs"]:
        assert set(c) == KEYS["config"]
    for w in spec["workloads"]:
        assert set(w) == KEYS["workload"]
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(spec):
    names = []
    for c in spec["configs"]:
        names += [c["name"], *c["reduced"]]
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
    for w in spec["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
        assert LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"] + spec["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert LINE.match(m["layer"])
    for w in spec["command"]:
        assert LINE.match(w)
    bad = [n for n in names if not NAME.match(n)]
    assert not bad
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in spec[kind]}) == len(spec[kind])
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_file_is_found_by_name(spec):
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = _load("configs", c["name"] + ".json")
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
    for w in spec["workloads"]:
        assert w["config"] in configs
        data = _load("workloads", w["name"] + ".json")
        assert data["config"] == w["config"] and data["why"] == w["why"]
        assert set(data["limits"]) == {"start_gap", "step_gap", "loss_gap",
                                       "grad_gap", "change_gap", "lr_gap"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    used = {w["config"] for w in spec["workloads"]}
    assert used == configs


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(os.path.join(dirpath, "x"), ROOT)[:-2]
        for f in files:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel + f), rel + f


def test_bounds_and_sources(spec):
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_each_moved_metric_is_reported_where_its_layer_metric_is(spec):
    cells = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in v for k, v in e2e.items() if k != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in spec["per_layer"])


def test_layers_are_named_alike(spec):
    by_layer = {}
    for m in spec["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_configuration_files_hold_the_program_defaults():
    """A configuration holds every field of the program's config classes
    as they are run; the reference builds from the same dicts."""
    import dataclasses

    from benchmark.reference.plain.core import config as C
    from benchmark.reference.plain.envs.anymal_c import AnymalCCfg

    for name, env_default in (("nightmare_v3", C.NightmareV3Cfg()),
                              ("anymal_c", AnymalCCfg())):
        data = _load("configs", name + ".json")
        env = dataclasses.asdict(env_default)
        (env["env"] if "env" in env else env).pop("num_envs")
        assert json.loads(json.dumps(env)) == data["env"]
        ppo = dataclasses.asdict(C.PPOCfg())
        ppo.pop("seed")
        assert json.loads(json.dumps(ppo)) == data["ppo"]
        assert data["dtype"] == "float32" and data["tf32"] is False
