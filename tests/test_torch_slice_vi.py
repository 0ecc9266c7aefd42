"""The port's visual-inertial path end to end against the JAX engine.

The checked-in fixture ``tests/data/vi_smoke`` (12 mono 400x300 frames, P5
and P2 PGMs, a device clock with an epoch, a two-column IMU timestamp.txt)
goes through the JAX ``VicalibEngine`` and the port's (``device="cpu"``)
with the JAX fixture test's configuration: images and IMU CSV in,
cameras.xml out, the whole staged schedule (visual, inertial-rotation,
inertial-full, inertial-full+scale).

Tolerance between the two results: the same stages and iteration counts;
intrinsics within 5e-3 px; T_ck within 1e-4 (rad and m); gyro biases
within 1e-4 rad/s, accel biases within 2e-3 m/s^2; ts within 1e-5 s.
Detection agrees to float32 ulps (test_torch_slice.py), so the visual
stages stop at slightly different points; the inertial-full stage then
runs into its 200-iteration cap in both packages (the whitening refresh
keeps the cost churning at the 1e-6 function tolerance), and the poorly
observed accel bias (12 frames) is left free to ~1e-3 (measured 5.5e-4;
T_ck 2e-5, ts 2e-6).  Both results must also pass the JAX fixture test's
own ground-truth checks (test_smoke_fixture.py).
"""
import json
import os

import numpy as np
import pytest

from vicalib_tpu.config import VicalibConfig as JConfig
from vicalib_tpu.engine import VicalibEngine as JEngine
from vicalib_tpu_torch.config import VicalibConfig as TConfig
from vicalib_tpu_torch.engine import VicalibEngine as TEngine
from vicalib_tpu_torch.geometry import quat_np
from vicalib_tpu_torch.io import outputs as t_out

ROOT = os.path.join(os.path.dirname(__file__), "data", "vi_smoke")
CAM = f"file://{ROOT}/images/*.pgm"
IMU = f"csv://{ROOT}/imu"


def _run(engine_cls, config_cls, out_dir, **kw):
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        cfg = config_cls(cam=CAM, imu=IMU, models="linear",
                         use_only_when_static=False, calibrate_imu=True,
                         use_system_time=False,
                         output=str(out_dir / "cameras.xml"),
                         output_log_file=str(out_dir / "v.log"))
        return engine_cls(cfg, **kw).run()
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dj = tmp_path_factory.mktemp("jax_vi")
    dt = tmp_path_factory.mktemp("torch_vi")
    return (_run(JEngine, JConfig, dj), dj,
            _run(TEngine, TConfig, dt, device="cpu"), dt)


def _gt_checks(res, gt):
    """test_smoke_fixture.py's ground-truth checks."""
    assert res.success, res.stats
    q_est, t_est = res.stats.t_ck_vec[0]
    dq = quat_np.quat_mul(quat_np.inverse(np.asarray(gt["q_ck"])), q_est)
    assert np.linalg.norm(quat_np.log(dq)) < 5e-3
    assert np.linalg.norm(t_est - np.asarray(gt["t_ck"])) < 2e-2
    np.testing.assert_allclose(res.stats.cam_intrinsics[0][:4],
                               gt["intrinsics"], atol=5.0)
    assert res.stats.reprojection_error[0] < 0.1
    assert abs(res.stats.ts - gt["time_offset"]) < 2e-3


def test_port_vi_engine_matches_jax_engine(runs):
    res_j, dj, res_t, dt = runs
    gt = json.load(open(os.path.join(ROOT, "gt.json")))
    _gt_checks(res_j, gt)
    _gt_checks(res_t, gt)
    assert [r[0] for r in res_t.result.stages_run] == [
        "visual", "inertial-rotation", "inertial-full",
        "inertial-full+scale"]
    assert [r[:2] for r in res_t.result.stages_run] == \
        [r[:2] for r in res_j.result.stages_run]
    assert res_t.timings.keys() >= {"read", "detect", "build", "solve"}
    cj = t_out.read_cameras_xml(str(dj / "cameras.xml"))
    ct = t_out.read_cameras_xml(str(dt / "cameras.xml"))
    assert len(cj) == len(ct) == 1
    np.testing.assert_allclose(ct[0]["params"], cj[0]["params"], rtol=0,
                               atol=5e-3)
    # with an IMU the written pose carries the RDF: both wrote it so
    np.testing.assert_allclose(ct[0]["T_wc"], cj[0]["T_wc"], rtol=0,
                               atol=1e-4)
    (qj, tj), (qt, tt) = res_j.stats.t_ck_vec[0], res_t.stats.t_ck_vec[0]
    dq = quat_np.quat_mul(quat_np.inverse(np.asarray(qj)), qt)
    assert np.linalg.norm(quat_np.log(dq)) < 1e-4
    np.testing.assert_allclose(tt, np.asarray(tj), rtol=0, atol=1e-4)
    bj = np.asarray(res_j.state.biases)
    bt = res_t.state.biases.numpy()
    np.testing.assert_allclose(bt[:3], bj[:3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(bt[3:], bj[3:], rtol=0, atol=2e-3)
    assert abs(res_t.stats.ts - res_j.stats.ts) < 1e-5
    log = (dt / "v.log").read_text()
    for key in ("bw_ba= ", "sfw_sfa= ", "G= ", "ts= ",
                "stage inertial-full+scale: iters="):
        assert key in log


def test_cli_main_imu_writes_the_same_calibration(tmp_path):
    """cli.main with -imu against the engine with the same flags.  Both cap
    each stage at 10 LM iterations (-max_iters) to keep the CPU time down
    and ask for the covariance log (-compute_covariance)."""
    from vicalib_tpu_torch import cli

    (tmp_path / "c").mkdir()
    (tmp_path / "e").mkdir()
    xml_cli = str(tmp_path / "c" / "cameras.xml")
    log_cli = str(tmp_path / "c" / "v.log")
    rc = cli.main(["-models", "linear", "-cam", CAM, "-imu", IMU,
                   "-nouse_only_when_static", "-nouse_system_time",
                   "-max_iters", "10", "-compute_covariance",
                   "-output", xml_cli, "-output_log_file", log_cli],
                  device="cpu")
    assert rc == 0
    cwd = os.getcwd()
    os.chdir(tmp_path / "e")
    try:
        cfg = TConfig(cam=CAM, imu=IMU, models="linear",
                      use_only_when_static=False, use_system_time=False,
                      max_iters=10, compute_covariance=True,
                      output=str(tmp_path / "e" / "cameras.xml"),
                      output_log_file=str(tmp_path / "e" / "v.log"))
        res = TEngine(cfg, device="cpu").run()
    finally:
        os.chdir(cwd)
    assert res.result.covariance is not None
    a = t_out.read_cameras_xml(xml_cli)
    b = t_out.read_cameras_xml(str(tmp_path / "e" / "cameras.xml"))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["params"], y["params"])
        np.testing.assert_array_equal(x["T_wc"], y["T_wc"])
    log = open(log_cli).read()
    assert "shared-parameter covariance blocks:" in log
    assert "time_offset: sigma=" in log and "cam0.R_ck: sigma=" in log
    strip = lambda s: [ln for ln in s.splitlines() if "wall=" not in ln]
    assert strip(log) == strip((tmp_path / "e" / "v.log").read_text())


def test_cli_imu_without_a_cuda_device_raises(monkeypatch):
    """The command line runs on the CUDA device and never falls back."""
    import torch

    from vicalib_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-models", "linear", "-cam", CAM, "-imu", IMU,
                  "-nouse_only_when_static"])
