"""The port's ``utils/debug_plot.py`` under Agg: ``save()`` writes a PNG for
the calls the JAX package's ``DebugPlot`` takes (a curve with markers, a
top-down scatter of leg poses), and the two classes draw the same artists
from the same data.  Leg poses come from the port's gait engine as tensors.
Both classes import matplotlib only when built."""

import numpy as np
import pytest

from nightmare_rl_tpu.utils.debug_plot import DebugPlot as JDebugPlot
from nightmare_rl_tpu_torch.engine import gait as G
from nightmare_rl_tpu_torch.utils.debug_plot import DebugPlot

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(autouse=True)
def agg(monkeypatch):
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.delenv("DISPLAY", raising=False)


def _draw(plot, poses):
    x = np.linspace(0.0, 1.0, 11)
    plot.plot(x, x ** 2, markers=[(0.5, 0.25), (0.9, 0.81)], xlabel="factor",
              ylabel="cost", title="keep-out line search")
    curve = [(a.get_xdata().tolist(), a.get_ydata().tolist())
             for a in plot._artists]
    plot.plot_poses_2d(poses)
    scatter = [(a.get_xdata().tolist(), a.get_ydata().tolist(), a.get_color())
               for a in plot._artists]
    return curve, scatter


def test_debug_plot_saves_png(tmp_path):
    cfg = G.make_cfg()
    es = G.init_state(cfg, 2)
    poses = [es.pose[0], es.pose[1] + 0.01]          # (6, 3) tensors
    plot = DebugPlot()
    assert plot._interactive is False
    curve, scatter = _draw(plot, poses)
    assert len(curve) == 3 and len(scatter) == 12
    out = tmp_path / "plot.png"
    plot.save(str(out))
    assert out.read_bytes()[:8] == PNG

    jplot = JDebugPlot()
    jcurve, jscatter = _draw(jplot, [p.numpy() for p in poses])
    assert (curve, scatter) == (jcurve, jscatter)
    jplot.save(str(tmp_path / "jax.png"))
    assert (tmp_path / "jax.png").read_bytes()[:8] == PNG
