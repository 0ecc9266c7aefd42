"""The port's main path end to end against the JAX engine.

A rendered stereo 400x300, 12-frame, index-aligned PGM dataset goes through
the JAX ``VicalibEngine`` and the port's (``device="cpu"``, and once through
``cli.main``).  Images in, cameras.xml out.

Tolerance between the two results: intrinsics within 5e-3 px, the cam-1
extrinsic within 1e-5 (rad and m).  Detection agrees to float32 ulps and
RANSAC's draws differ (jax.random vs torch.Generator) but select the same
inlier sets on these clean detections, so both solves start from the same
poses to rounding; both then stop at the same function tolerance (1e-6
relative cost change), where the flat directions of the problem leave
~1e-3 px of slack in the intrinsics (measured 3e-4 px) and ~1e-6 in the
extrinsic.  Both results must also pass the ground-truth checks of the JAX
package's own visual-only engine test: success and rmse < 0.1 px per camera.

The port starts the intrinsics from the target's homographies where the
JAX package keeps upstream's fixed start, so both engines here are handed
that fixed start as a ``-model_files`` preload: the comparison is of
everything after the start.
"""
import os
import re

import numpy as np
import pytest

from vicalib_tpu.config import VicalibConfig as JConfig
from vicalib_tpu.engine import VicalibEngine as JEngine
from vicalib_tpu.io import sim as jsim
from vicalib_tpu.io import sources as jsources
from vicalib_tpu_torch.config import VicalibConfig as TConfig
from vicalib_tpu_torch.cameras.models import default_params_np
from vicalib_tpu_torch.engine import VicalibEngine as TEngine
from vicalib_tpu_torch.io import outputs as t_out


@pytest.fixture(scope="module")
def stereo(tmp_path_factory):
    root = tmp_path_factory.mktemp("stereo_pgm")
    cfg = jsim.default_stereo_vi_config(n_frames=12, model="linear",
                                        distance=0.40, orbit_radius=0.2)
    for cam in cfg.cameras:
        cam.params[:4] = [240.0, 240.0, 200.0, 150.0]
        cam.width, cam.height = 400, 300
    cfg.cameras[0].T_ck = (np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))
    cfg.cameras[1].T_ck = (np.array([0.0, 0.0, 0.0, 1.0]),
                           np.array([0.0, -0.06, 0.0]))
    data = jsim.simulate(cfg)
    dirs = []
    for c in range(2):
        d = root / f"cam{c}"
        d.mkdir()
        for k, img in enumerate(jsim.render_frames(data, cam=c)):
            jsources.write_pgm(str(d / f"f{k:03d}.pgm"), img)
        dirs.append(str(d))
    uri = "file://[%s/*.pgm,%s/*.pgm]" % tuple(dirs)
    return root, cfg, uri


def _run(engine_cls, config_cls, uri, out, model_files="", **kw):
    cwd = os.getcwd()
    os.chdir(os.path.dirname(out))
    try:
        cfg = config_cls(cam=uri, models="linear,linear",
                         use_only_when_static=False, output=out,
                         model_files=model_files)
        return engine_cls(cfg, **kw).run()
    finally:
        os.chdir(cwd)


def _fixed_start(path):
    """A cameras.xml holding upstream's fixed start of both cameras (the
    default intrinsics, identity extrinsics)."""
    t_out.write_cameras_xml(
        path, ["linear"] * 2, [default_params_np("linear", 400, 300)] * 2,
        [(np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))] * 2, [400] * 2,
        [300] * 2, calibrate_imu=False)
    return path


def _xml(path):
    cams = t_out.read_cameras_xml(path)
    return [c["params"] for c in cams], [c["T_wc"] for c in cams]


def test_port_engine_matches_jax_engine(stereo, tmp_path):
    root, cfg, uri = stereo
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    xml_j = str(tmp_path / "j" / "cameras.xml")
    xml_t = str(tmp_path / "t" / "cameras.xml")
    start = _fixed_start(str(tmp_path / "start.xml"))
    res_j = _run(JEngine, JConfig, uri, xml_j, model_files=start)
    res_t = _run(TEngine, TConfig, uri, xml_t, model_files=start,
                 device="cpu")
    for res in (res_j, res_t):
        assert res.success
        assert max(res.stats.reprojection_error) < 0.1
    assert res_t.timings.keys() >= {"detect", "build", "solve"}
    params_j, T_j = _xml(xml_j)
    params_t, T_t = _xml(xml_t)
    for c in range(2):
        np.testing.assert_allclose(params_t[c], params_j[c], rtol=0,
                                   atol=5e-3)
        np.testing.assert_allclose(params_t[c], cfg.cameras[c].params[:4],
                                   atol=5.0)
        np.testing.assert_allclose(T_t[c], T_j[c], rtol=0, atol=1e-5)
    # cam 1 sits 6 cm from cam 0 along y
    np.testing.assert_allclose(T_t[1][:, 3], [0.0, 0.06, 0.0], atol=2e-3)


def test_cli_main_writes_the_same_calibration(stereo, tmp_path):
    from vicalib_tpu_torch import cli

    _, _, uri = stereo
    xml_cli = str(tmp_path / "cli.xml")
    rc = cli.main(["-models", "linear,linear", "-cam", uri,
                   "-nouse_only_when_static", "-output", xml_cli,
                   "-output_log_file", str(tmp_path / "v.log")],
                  device="cpu")
    assert rc == 0
    (tmp_path / "e").mkdir()
    xml_e = str(tmp_path / "e" / "cameras.xml")
    _run(TEngine, TConfig, uri, xml_e, device="cpu")
    for a, b in zip(_xml(xml_cli), _xml(xml_e)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # no preload: the intrinsics started from the homographies of both
    # cameras' 12 frames
    log = (tmp_path / "v.log").read_text()
    assert re.search(r"^span vicalib\.engine\.intr_start: n=1 s=", log, re.M)
    assert re.search(r"^count vicalib\.engine\.intr_start_frames: 24$", log,
                     re.M)


@pytest.mark.parametrize("layout", ["mono", "aligned", "async"])
def test_associate_channels_matches_jax(tmp_path, layout):
    """Superframe association (host code) on index-aligned and on async
    channels: one frame dropped and one stamp repeated in channel 1, stamps
    jittered ~2 ms.  Frame selection must pick the same files as JAX."""
    from vicalib_tpu_torch.io import sources as tsources

    rng = np.random.default_rng(3)
    n_ch = 1 if layout == "mono" else 2
    t0 = np.arange(10) / 10.0
    stamps = [t0, t0.copy()]
    if layout == "async":
        t1 = np.delete(t0 + rng.normal(0, 2e-3, 10), 4)
        stamps[1] = np.insert(t1, 6, t1[5])
    dirs = []
    for c in range(n_ch):
        d = tmp_path / f"cam{c}"
        d.mkdir()
        for k in range(len(stamps[c])):
            (d / f"f{k:03d}.pgm").write_bytes(b"")
        if layout == "async":
            np.savetxt(str(d / "timestamps.txt"), stamps[c])
        dirs.append(str(d))
    uri = "file://[%s]" % ",".join(f"{d}/*.pgm" for d in dirs)
    for system in (False, True):
        tj, sj = jsources.associate_channels(
            jsources.parse_camera_uri(uri), system=system)
        tt, st = tsources.associate_channels(
            tsources.parse_camera_uri(uri), system=system)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(st, sj)
        assert len(tt) == (9 if layout == "async" else 10)
