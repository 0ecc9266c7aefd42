"""The start of the intrinsics from the target's homographies
(vicalib_tpu_torch/solver/intr_start.py) and where the engine uses it.

Data: the port's simulator (io/sim.py) on the benchmark rigs' geometry (an
orbit 0.35 m above the medium grid), 10 frames two seconds apart, projected
dots with 0.2 px of noise: a EuRoC-like stereo poly2 752x480 rig (f = 458,
k1 = -0.28, k2 = 0.07) and the vi_sim linear 800x600 rig (f = 335.64).
The engine cases run camera-only on the checked-in fixture
``tests/data/vi_smoke`` and stop at the problem build.
"""
import os

import numpy as np
import pytest

from vicalib_tpu_torch import obs
from vicalib_tpu_torch.cameras.models import default_params_np
from vicalib_tpu_torch.config import VicalibConfig
from vicalib_tpu_torch.engine import VicalibEngine
from vicalib_tpu_torch.io import outputs as t_out
from vicalib_tpu_torch.io import sim
from vicalib_tpu_torch.solver import intr_start

EUROC = [([458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907],
          (0.0, 0.0, 0.0)),
         ([457.587, 456.134, 379.999, 255.238, -0.28368365, 0.07451284],
          (-0.11, 0.0, 0.0))]
VI_SIM = [([335.639853151, 335.639853151, 400.0, 300.0], (0.0, 0.0, 0.0)),
          ([338.2, 337.1, 398.5, 302.5], (0.0, -0.12, 0.0))]


def _rig(model, cams, width, height, n_frames=10):
    """(SimData, widths, heights) of a stereo rig seen from the benchmark
    rigs' orbit, a frame every two seconds."""
    q_rdf = sim.quat_np.from_matrix(sim.RDF_ROBOTICS_T_CK)
    cfg = sim.SimConfig(
        cameras=[sim.SimRigCamera(model=model, params=np.asarray(p, float),
                                  T_ck=(q_rdf, np.asarray(t, float)),
                                  width=width, height=height)
                 for p, t in cams],
        target=sim.make_target(), n_frames=n_frames, frame_rate=0.5,
        imu_rate=10.0, pixel_noise=0.2, seed=3, distance=0.35,
        orbit_radius=0.12, wobble=0.25)
    data = sim.simulate(cfg, device="cpu")
    return data, [width] * len(cams), [height] * len(cams)


@pytest.mark.parametrize("rig", ["euroc_poly2", "vi_sim_linear"])
def test_start_recovers_the_intrinsics(rig):
    if rig == "euroc_poly2":
        model, cams, w, h, f_tol = "poly2", EUROC, 752, 480, 0.03
    else:
        model, cams, w, h, f_tol = "linear", VI_SIM, 800, 600, 0.01
    data, widths, heights = _rig(model, cams, w, h)
    assert data.visible.sum(-1).min() >= 20     # the dots fill the frames
    with obs.recording() as rec:
        start = intr_start.start_intrinsics(
            [model] * 2, data.pixels, data.visible, data.points_3d, widths,
            heights)
    for (truth, _), p in zip(cams, start):
        assert p.shape == (len(truth),)
        np.testing.assert_allclose(p[:2], truth[:2], rtol=f_tol)
        np.testing.assert_array_equal(p[2:4], [w / 2, h / 2])
        if model == "poly2":
            assert abs(p[4] - truth[4]) < 0.05
    # the span and the counter of the frames that voted, both cameras
    assert rec.n("vicalib.engine.intr_start") == 1
    assert rec.seconds("vicalib.engine.intr_start") > 0
    assert rec.count("vicalib.engine.intr_start_frames") == 20


def test_no_usable_frame_keeps_the_default():
    data, widths, heights = _rig("poly2", EUROC[:1], 752, 480, n_frames=4)
    default = default_params_np("poly2", 752, 480)
    pix, vis = data.pixels[0], data.visible[0].copy()
    # fewer than 4 dots a frame: no frame votes
    few = np.zeros_like(vis)
    few[:, np.flatnonzero(vis[0])[:3]] = True
    # every dot of one grid row: each frame's points lie on a line
    row = np.zeros_like(vis)
    row[:, :sim.make_target().cols] = True
    for mask in (few, row):
        with obs.recording() as rec:
            (p,) = intr_start.start_intrinsics(
                ["poly2"], pix[None], mask[None], data.points_3d, widths,
                heights)
        np.testing.assert_array_equal(p, default)
        assert rec.count("vicalib.engine.intr_start_frames") == 0
    params, n = intr_start.camera_start("poly2", pix, vis, data.points_3d,
                                        752, 480)
    assert n == 4 and not np.array_equal(params, default)


ROOT = os.path.join(os.path.dirname(__file__), "data", "vi_smoke")


class _Built(Exception):
    """Raised where the engine hands its start on, to stop the run there."""


@pytest.mark.parametrize("mode", ["batch", "stream"])
@pytest.mark.parametrize("preload", [False, True])
def test_engine_starts_from_the_preload_else_the_homographies(
        mode, preload, tmp_path, monkeypatch):
    """Batch: ``build_problem``'s ``intr0``; stream: the
    ``StreamingCalibrator``'s (its first chunk's build).  A ``-model_files``
    preload wins; without one the start comes from the homographies of the
    frames the solve first sees (the first chunk's in live mode)."""
    from vicalib_tpu_torch import streaming
    from vicalib_tpu_torch.solver import build

    seen = {}
    real_start = intr_start.start_intrinsics

    def spy_start(names, pixels, *a, **k):
        seen["start_frames"] = pixels.shape[1]
        seen["start"] = real_start(names, pixels, *a, **k)
        return seen["start"]

    def stop(*a, intr0=None, **k):
        seen["intr0"] = intr0
        raise _Built

    monkeypatch.setattr(intr_start, "start_intrinsics", spy_start)
    monkeypatch.setattr(build, "build_problem", stop)
    monkeypatch.setattr(streaming, "StreamingCalibrator", stop)
    kw = {}
    fixed = np.array([250.0, 251.0, 199.0, 151.0])
    if preload:
        kw["model_files"] = str(tmp_path / "start.xml")
        t_out.write_cameras_xml(kw["model_files"], ["linear"], [fixed],
                                [(np.array([0.0, 0.0, 0.0, 1.0]),
                                  np.zeros(3))], [400], [300],
                                calibrate_imu=False)
    if mode == "stream":
        kw["stream_chunk"] = 4
    cfg = VicalibConfig(cam="file://%s/images/*.pgm" % ROOT,
                        models="linear", use_only_when_static=False,
                        calibrate_imu=False, output=str(tmp_path / "c.xml"),
                        **kw)
    with pytest.raises(_Built):
        VicalibEngine(cfg, device="cpu").run()
    (intr0,) = seen["intr0"]
    if preload:
        assert "start" not in seen
        np.testing.assert_array_equal(intr0, fixed)
    else:
        np.testing.assert_array_equal(intr0, seen["start"][0])
        assert seen["start_frames"] == (4 if mode == "stream" else 12)
        # the fixture's camera: f = 240 (gt.json), far from the default 300
        np.testing.assert_allclose(intr0[:2], 240.0, rtol=0.02)
