"""The port's anymal_c evaluation (``nightmare_rl_tpu_torch/tools/
eval_anymal.py``, the counterpart of ``scripts/eval_anymal.py``):

- the committed weights ``nightmare_rl_tpu_torch/assets/anymal_model_122.pt``
  equal, tensor for tensor, a fresh export of ``artifacts/anymal_model_122``
  by the JAX package's own exporter (the card's machine has no JAX, so the
  file is committed);
- ``eval_stats`` equals the JAX script's formulas, written out here, to
  1e-12: on the committed JAX trajectory ``artifacts/anymal122_vx05.npz``
  (its qpos gives the displacement and the base height) and on seeded
  random sensordata, ``done`` and ``time_out``;
- the CLI runs 3 steps on the CPU and prints the script's two lines;
- a JAX (orbax) checkpoint directory is refused.

A whole rollout is not held to round-off against the JAX package: anymal_c
agrees one decimated step at a time (tests/test_torch_anymal.py); the card
holds the 300-step rollout to the JAX script's outcome (chip_smoke.py
eval-anymal).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nightmare_rl_tpu_torch.tools import eval_anymal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "nightmare_rl_tpu_torch", "assets",
                       "anymal_model_122.pt")
DT = 0.00800000037997961  # anymal_c's control step (float32 timestep × 4)


def test_committed_weights_equal_a_fresh_jax_export(tmp_path):
    out = str(tmp_path / "fresh.pt")
    subprocess.run(
        [sys.executable, "-m", "nightmare_rl_tpu.tools.export_torch",
         "--robot", "anymal_c", "--ckpt",
         os.path.join(REPO, "artifacts", "anymal_model_122"), "--out", out],
        cwd=REPO, check=True, capture_output=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    fresh = torch.load(out, weights_only=True)
    committed = torch.load(WEIGHTS, weights_only=True)
    assert committed.keys() == fresh.keys() and committed["iter"] == 122
    a, b = committed["model_state_dict"], fresh["model_state_dict"]
    assert a.keys() == b.keys() and len(a) == 17
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _script_stats(pos, feet, done, time_out, dt):
    """scripts/eval_anymal.py:66-84, as written there (the loop's counts
    included)."""
    falls = timeouts = 0
    for d, to in zip(done, time_out):
        if bool(d):
            falls += 0 if bool(to) else 1
            timeouts += 1 if bool(to) else 0
    settle = min(int(1.0 / dt), len(pos) // 2)
    v_avg = (pos[-1] - pos[settle]) / ((len(pos) - settle) * dt)
    contact = np.stack(feet) > 1e-6
    duty = contact.mean(axis=0)
    return dict(settle=settle, v_avg=v_avg, duty=duty,
                feet_down=contact.sum(axis=1).mean(),
                base_z_mean=pos[settle:, 2].mean(),
                base_z_min=pos[settle:, 2].min(), falls=falls,
                timeouts=timeouts)


@pytest.mark.parametrize("steps", [300, 7])
def test_eval_stats_match_the_script(steps):
    jax_traj = np.load(os.path.join(REPO, "artifacts", "anymal122_vx05.npz"))
    pos = jax_traj["qpos"][:steps, :3].astype(np.float64)
    rng = np.random.default_rng(steps)
    feet = np.where(rng.random((steps, 4)) < 0.3, 0.0,
                    rng.random((steps, 4)) * 40.0)
    done = rng.random(steps) < 0.1
    time_out = done & (rng.random(steps) < 0.5)
    done[[1, 2]], time_out[[1, 2]] = True, [False, True]  # a fall, a timeout
    want = _script_stats(pos, list(feet), done, time_out, DT)
    got = eval_anymal.eval_stats(pos, feet, done, time_out, DT)
    assert got.keys() == want.keys()
    assert got["settle"] == want["settle"] == (124 if steps == 300 else 3)
    assert (got["falls"], got["timeouts"]) == (want["falls"], want["timeouts"])
    assert want["falls"] > 0 and want["timeouts"] > 0
    for k in ("v_avg", "duty", "feet_down", "base_z_mean", "base_z_min"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    # the committed JAX rollout stood: base_z 0.604 (artifacts/README.md)
    if steps == 300:
        assert round(float(got["base_z_mean"]), 3) == 0.604


def test_cli_runs_three_steps_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "t.npz")
    res = eval_anymal.main(["--ckpt", WEIGHTS, "--steps", "3", "--device",
                            "cpu", "--out", out])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"loaded {WEIGHTS} (iteration 122)"
    assert printed[1:3] == list(res["lines"])
    assert printed[1].startswith("eval: cmd (+0.50,+0.00,+0.00) | "
                                 "displacement v (")
    assert printed[2].startswith("gait: duty=") and "base_z mean=" in printed[2]
    assert res["record"]["qpos"].shape == (3, 1, 19)
    assert res["record"]["sensordata"].shape == (3, 1, 4)
    saved = np.load(out)
    assert saved["qpos"].shape == (3, 19) and saved["qvel"].shape == (3, 18)
    np.testing.assert_array_equal(saved["qpos"], res["record"]["qpos"][:, 0])


def test_orbax_directory_is_refused():
    with pytest.raises(SystemExit, match="export"):
        eval_anymal.main(["--ckpt", os.path.join(REPO, "artifacts",
                                                 "anymal_model_122"),
                          "--steps", "3", "--device", "cpu"])
