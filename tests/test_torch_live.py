"""The live-mode auxiliaries of the port against the JAX package's: the
tracker, the SVG views, the HTML report and the status server.

Data: the checked-in fixture ``tests/data/vi_smoke`` (12 rendered mono
400x300 frames) for the tracker, and a 6-frame mono VI sequence from the JAX
simulator (50 Hz IMU, 0.1 s window slack), built into a problem by the JAX
package and carried to the port through ``convert``, for the views and the
report.

Tolerances: tracker poses within 1e-5 (the poses file's %f resolution is
1e-6; detections agree to float32 ulps); SVG text equal (the same numbers
formatted alike); integration strips within 1e-9 relative to their largest
entry (a prefix-product form of the same RK4 chain against JAX's step-by-step
scan); report numbers equal as printed.
"""
import dataclasses
import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from vicalib_tpu import report as j_report
from vicalib_tpu import viz as j_viz
from vicalib_tpu.io import sim as jsim
from vicalib_tpu.solver.build import problem_from_sim as j_from_sim
from vicalib_tpu.targets.grid import load_preset as j_preset
from vicalib_tpu.utils import CalibrationStats as JStats
from vicalib_tpu.utils import CalibrationStatus as JStatus
from vicalib_tpu_torch import convert
from vicalib_tpu_torch import report as t_report
from vicalib_tpu_torch import viz as t_viz
from vicalib_tpu_torch.targets.grid import load_preset as t_preset
from vicalib_tpu_torch.utils import CalibrationStats as TStats
from vicalib_tpu_torch.utils import CalibrationStatus as TStatus

CAM = "file://%s/*.pgm" % os.path.join(os.path.dirname(__file__), "data",
                                       "vi_smoke", "images")


def test_tracker_matches_jax(tmp_path, capsys):
    """The same frames tracked with the same dot counts, T_gw printed and
    poses written within 1e-5."""
    from vicalib_tpu.tracker import main as j_main
    from vicalib_tpu_torch.tracker import main as t_main

    outs = []
    for name, run in (("jax", lambda a: j_main(a)),
                      ("torch", lambda a: t_main(a, device="cpu"))):
        poses = str(tmp_path / ("%s.txt" % name))
        assert run(["-cam", CAM, "-models", "linear",
                    "-output_poses", poses]) == 0
        text = capsys.readouterr().out
        heads = re.findall(r"^frame .*$", text, re.M)
        mats = np.array([float(x) for ln in re.findall(
            r"^[+-].*$", text, re.M) for x in ln.split()]).reshape(-1, 4, 4)
        outs.append((heads, mats, np.loadtxt(poses)))
    (hj, mj, pj), (ht, mt, pt) = outs
    assert ht == hj and len(ht) >= 10
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    # camera heights sane (the fixture's target distance is ~0.4 m)
    assert np.all(np.abs(pt[:, :3]) < 2.0)


@pytest.fixture(scope="module")
def vi():
    cfg = jsim.default_mono_config(n_frames=6, model="linear", imu=True,
                                   imu_rate=50.0,
                                   gyro_bias=np.array([0.01, -0.02, 0.015]))
    data_j, state_j = j_from_sim(jsim.simulate(cfg), use_imu=True,
                                 window_slack=0.1)
    imu = data_j.imu
    pd = {"model_names": ["linear"], "n_frames": data_j.n_frames,
          "obs": [{"frame_idx": np.asarray(o.frame_idx),
                   "p_w": np.asarray(o.p_w), "p_c": np.asarray(o.p_c),
                   "valid": np.asarray(o.valid),
                   "points_per_frame": o.points_per_frame}
                  for o in data_j.obs],
          "imu": {f.name: (np.asarray(getattr(imu, f.name))
                           if f.name not in ("consecutive", "slack")
                           else getattr(imu, f.name))
                  for f in dataclasses.fields(imu)}}
    # a state with velocities, biases and a time offset, so the strips bend
    rng = np.random.default_rng(5)
    sj = state_j._replace(v_w=state_j.v_w + rng.normal(size=(6, 3)) * 0.1,
                          biases=state_j.biases + rng.normal(size=6) * 0.01,
                          time_offset=state_j.time_offset + 0.003)
    return (cfg, data_j, sj, convert.problem_from_numpy(pd, "cpu"),
            convert.state_from_numpy(
                {k: np.asarray(v) for k, v in sj._asdict().items()}, "cpu"))


def test_scene_and_detection_svgs_match_jax(vi, tmp_path):
    cfg, data_j, sj, data_t, st = vi
    strips_j = j_viz.integration_strips(sj, data_j)
    strips_t = t_viz.integration_strips(st, data_t)
    assert len(strips_t) == len(strips_j) == 5
    for a, b in zip(strips_j, strips_t):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-9 * np.abs(a).max())
    q, t = np.asarray(sj.q_wk), np.asarray(sj.t_wk)
    svg_j = j_viz.scene_svg(None, j_preset("small"), q, t,
                            imu_strips=strips_j)
    svg_t = t_viz.scene_svg(None, t_preset("small"), q, t,
                            imu_strips=strips_t)
    assert svg_t == svg_j and svg_t.count("polyline") == 6
    px = np.asarray(data_j.obs[0].p_c)[:40]
    valid = np.arange(40) % 3 > 0
    coords = np.stack([np.arange(40) % 7 - 1, np.arange(40) % 5], axis=1)
    for mod, name in ((j_viz, "j.svg"), (t_viz, "t.svg")):
        mod.detection_svg(str(tmp_path / name), (300, 400), px, valid,
                          grid_coords=coords, true_pixels=px[:5] + 0.5)
    assert (tmp_path / "t.svg").read_text() == \
        (tmp_path / "j.svg").read_text()


def test_html_report_matches_jax(vi, tmp_path):
    """Every per-camera number, the inertial table and the covariance
    sigmas as printed in both reports."""
    cfg, data_j, sj, data_t, st = vi
    S = data_j.layout.size
    cov = np.diag(np.linspace(1e-6, 1e-2, S))

    @dataclasses.dataclass
    class Result:
        stages_run: list
        total_iterations: int
        mse: float
        cam_rmse: np.ndarray
        covariance: np.ndarray

    res = Result([("visual", 5, 1.25, 0.5), ("inertial-full", 7, 1.0, 0.7)],
                 12, 0.0123, np.array([0.0456]), cov)
    cells = []
    for mod, data, state, stats, name in (
            (j_report, data_j, sj, JStats(1, status=JStatus.SUCCESS), "j"),
            (t_report, data_t, st, TStats(1, status=TStatus.SUCCESS), "t")):
        path = mod.write_html_report(str(tmp_path / (name + ".html")),
                                     ["linear"], state, data, res, stats,
                                     [800], [600])
        text = open(path).read()
        cells.append(re.findall(r"<(h1|h3|td|p)[^>]*>(.*?)</\1>", text,
                                re.S))
        for needle in ("Inertial parameters", "gyro bias", "time offset",
                       "gravity", "standard deviations", "Solver stages"):
            assert needle in text, needle
    assert cells[1] == cells[0]


def test_status_server_endpoints(tmp_path):
    """The JAX status test's checks (stats JSON, live page, scene, report
    with a refresh), plus exact routes: ``/scene.svg.bak`` and other
    unknown paths answer 404 (the JAX package matches prefixes and serves
    the report for any other path)."""
    from vicalib_tpu_torch.status import StatusServer

    def get(path):
        return urllib.request.urlopen(base + path, timeout=10).read()

    report = tmp_path / "report.html"
    srv = StatusServer(0, report_path=str(report)).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert json.loads(get("/stats.json"))["status"] == "starting"
        stats = TStats(2, status=TStatus.OPTIMIZING)
        stats.reprojection_error = [0.05, 0.07]
        stats.num_iterations = 12
        stats.total_mse = 1e-4
        stats.cam_intrinsics = [np.arange(4.0), np.ones(4)]
        srv.publish(stats)
        d = json.loads(get("/stats.json?x=1"))
        assert d["status"] == "optimizing"
        assert d["reprojection_error"] == [0.05, 0.07]
        assert d["num_iterations"] == 12
        assert d["cam_intrinsics"] == [[0.0, 1.0, 2.0, 3.0], [1.0] * 4]
        assert b"calibration running" in get("/")
        for path in ("/scene.svg", "/scene.svg.bak", "/stats.jsonx",
                     "/index.html"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(path)
            assert e.value.code == 404, path
        svg = t_viz.scene_svg(None, t_preset("small"),
                              np.tile([0.0, 0.0, 0.0, 1.0], (3, 1)),
                              np.array([[0, 0, -0.4], [0.05, 0, -0.4],
                                        [0.1, 0, -0.4]]))
        srv.publish_scene(svg)
        assert get("/scene.svg").decode() == svg
        assert b"/scene.svg" in get("/")
        with pytest.raises(urllib.error.HTTPError):
            get("/scene.svg.bak")
        report.write_text("<html><head></head><body>REPORT</body></html>")
        page = get("/")
        assert b"REPORT" in page and b"refresh" in page
    finally:
        srv.stop()
