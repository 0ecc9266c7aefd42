"""The port's engine in live mode: -stream_chunk against the JAX engine,
-stream_chunk with the IMU, -report_file and -status_port, -checkpoint_file
then -resume_file, and -profile_dir.

Data: the checked-in fixture ``tests/data/vi_smoke`` (12 mono 400x300
frames, a 100 Hz IMU CSV with a device clock), images (and IMU CSV) in,
cameras.xml out.  Streaming feeds 6 frames per chunk: two chunks, both at
capacity 16.  The comparison with the JAX engine is camera-only, so the JAX
side compiles a visual solve only (a VI solve compile costs ~45 s of XLA on
the CPU test machine, and the streaming calibrator's VI chunks are held to
the JAX package's in tests/test_torch_streaming.py); the port's VI runs cap
every stage at 3 LM iterations (-max_iters) to stay cheap.

Tolerance of the streamed camera-only calibration between the engines: the
same chunk and stats count and the same per-chunk iterations; intrinsics
within 5e-3 px and T_ck within 1e-4 — the batch engines' bound on this
fixture (tests/test_torch_slice_vi.py): the two packages' PnP RANSAC draws
differ, so the solves start from slightly different poses.
"""
import json
import logging
import os
import re
import socket
import urllib.request

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


def _cfg(config_cls, out_dir, **kw):
    base = dict(cam=CAM, imu=IMU, models="linear",
                use_only_when_static=False, calibrate_imu=True,
                use_system_time=False, max_iters=3,
                output=str(out_dir / "cameras.xml"),
                output_log_file=str(out_dir / "v.log"))
    base.update(kw)
    return config_cls(**base)


def _run(engine_cls, cfg, out_dir, **kw):
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        return engine_cls(cfg, **kw).run()
    finally:
        os.chdir(cwd)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _watcher(seen, out_dir, port=None):
    """A stats callback recording the status, whether the report exists
    and, with ``port``, what the status server serves at that moment."""
    def cb(stats):
        row = {"status": stats.status.name,
               "report": os.path.exists(out_dir / "report.html")}
        if port is not None:
            row["live"] = json.loads(urllib.request.urlopen(
                "http://127.0.0.1:%d/stats.json" % port, timeout=10).read())
        seen.append(row)
    return cb


def test_engine_stream_matches_jax(tmp_path):
    """Camera-only -stream_chunk 6 -report_file through both engines."""
    seen = {"jax": [], "torch": []}
    runs = {}
    for name, engine_cls, config_cls, kw in (
            ("jax", JEngine, JConfig, {}),
            ("torch", TEngine, TConfig, {"device": "cpu"})):
        out = tmp_path / name
        out.mkdir()
        runs[name] = _run(engine_cls, _cfg(
            config_cls, out, imu="", calibrate_imu=False, max_iters=200,
            stream_chunk=6, report_file=str(out / "report.html")), out,
            update_stats_callback=_watcher(seen[name], out), **kw)
    rj, rt = runs["jax"], runs["torch"]
    assert rt.success and rj.success
    # OPTIMIZING before the solve, one per chunk, then the final status;
    # the report is rewritten after every chunk's stats (as in JAX), so
    # the second chunk's callback, mid-run, finds the first chunk's report
    assert [r["status"] for r in seen["torch"]] == \
        [r["status"] for r in seen["jax"]] == \
        ["OPTIMIZING"] * 3 + ["SUCCESS"]
    assert [r["report"] for r in seen["torch"]] == \
        [r["report"] for r in seen["jax"]] == [False, False, True, True]
    assert [r[:2] for r in rt.result.stages_run] == \
        [r[:2] for r in rj.result.stages_run]
    assert rt.state.q_wk.shape[0] == np.asarray(rj.state.q_wk).shape[0]
    cj = t_out.read_cameras_xml(str(tmp_path / "jax" / "cameras.xml"))
    ct = t_out.read_cameras_xml(str(tmp_path / "torch" / "cameras.xml"))
    np.testing.assert_allclose(ct[0]["params"], cj[0]["params"], rtol=0,
                               atol=5e-3)
    (qj, tj), (qt, tt) = rj.stats.t_ck_vec[0], rt.stats.t_ck_vec[0]
    dq = quat_np.quat_mul(quat_np.inverse(np.asarray(qj)), qt)
    assert np.linalg.norm(quat_np.log(dq)) < 1e-4
    np.testing.assert_allclose(tt, np.asarray(tj), rtol=0, atol=1e-4)


def test_engine_stream_with_imu_report_and_status(tmp_path, caplog):
    """-stream_chunk 6 with the IMU, -report_file, -status_port and
    -compute_covariance: the server serves the snapshot the engine has just
    published, the report is an HTML document with the inertial table and
    the covariance sigmas, the covariance is finite, and the state is
    trimmed to the selected frames (11 of the fixture's 12; the first
    precedes the IMU).  The result log's live spans count the chunks
    published."""
    caplog.set_level(logging.INFO, logger="vicalib_tpu_torch.streaming")
    seen = []
    port = _free_port()
    res = _run(TEngine, _cfg(TConfig, tmp_path, stream_chunk=6,
                             report_file=str(tmp_path / "report.html"),
                             status_port=port, compute_covariance=True),
               tmp_path, update_stats_callback=_watcher(seen, tmp_path, port),
               device="cpu")
    assert [r["status"] for r in seen][:3] == ["OPTIMIZING"] * 3
    for row in seen:
        assert row["live"]["status"] == row["status"].lower()
    assert seen[2]["live"]["num_iterations"] == \
        res.result.total_iterations
    assert [r[0] for r in res.result.stages_run] == ["inertial-full+scale"]
    assert res.state.q_wk.shape[0] == 11
    cov = res.result.covariance
    assert cov.shape == (25, 25) and np.all(np.isfinite(cov))
    text = (tmp_path / "report.html").read_text()
    assert text.startswith("<!doctype html>") and text.endswith("</html>")
    assert "Inertial parameters" in text and "standard deviations" in text
    # the server stopped with the run
    with pytest.raises(OSError):
        urllib.request.urlopen("http://127.0.0.1:%d/" % port, timeout=2)
    chunks = [r.chunk for r in caplog.records if hasattr(r, "chunk")]
    log = (tmp_path / "v.log").read_text()
    for name in ("build", "solve", "publish"):
        n = re.search(r"^span vicalib\.live\.%s: n=(\d+) s=" % name, log,
                      re.M)
        assert n and int(n.group(1)) == len(chunks) == 2, name


def test_engine_checkpoint_then_resume(tmp_path, monkeypatch):
    """-checkpoint_file writes the last stage's state, flags and meta;
    -resume_file hands run_staged exactly that state and those flags with
    ``resume`` set, so only the saved stage re-solves and the one-time
    initializers do not run.  With 3 iterations per stage the first run
    has not converged, so the resumed run moves on and is not held to the
    first run's answer."""
    import vicalib_tpu_torch.solver as tsolver
    from vicalib_tpu_torch.checkpoint import load_checkpoint

    ckpt = str(tmp_path / "state.npz")
    r1 = _run(TEngine, _cfg(TConfig, tmp_path, checkpoint_file=ckpt),
              tmp_path, device="cpu")
    state, flags, meta = load_checkpoint(ckpt, device="cpu")
    assert meta["stage"] == "inertial-full+scale" and flags.scale_active
    assert (meta["iterations"], meta["cost"]) == \
        tuple(r1.result.stages_run[-1][1:3])
    for a, b in zip(r1.state, state):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    calls = []
    real = tsolver.run_staged

    def spy(st, data, fl, *a, **kw):
        calls.append((st, fl, kw.get("resume"), kw.get("checkpoint_path")))
        return real(st, data, fl, *a, **kw)

    monkeypatch.setattr(tsolver, "run_staged", spy)
    r2 = _run(TEngine, _cfg(TConfig, tmp_path, resume_file=ckpt,
                            output=str(tmp_path / "cameras2.xml")),
              tmp_path, device="cpu")
    (st, fl, resume, path), = calls
    assert resume is True and path is None and fl == flags
    for a, b in zip(state, st):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    assert [r[0] for r in r2.result.stages_run] == ["inertial-full+scale"]
    assert 0 < r2.result.total_iterations <= 3
    assert np.all(np.isfinite(r2.stats.cam_intrinsics[0]))


def test_profile_dir_writes_a_trace(tmp_path):
    """-profile_dir: a torch.profiler Chrome trace of the whole run (CPU
    activity here; CUDA activity too on a card), with the port's spans
    from the frame read to the LM iterations as host ranges of the
    operator kind, which the profiler does not mirror on the device's
    timeline as it does an annotation."""
    prof = tmp_path / "prof"
    res = _run(TEngine, _cfg(TConfig, tmp_path, imu="", calibrate_imu=False,
                             profile_dir=str(prof)), tmp_path, device="cpu")
    assert np.all(np.isfinite(res.stats.cam_intrinsics[0]))
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    trace = json.load(open(prof / traces[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert {"vicalib.engine.read", "vicalib.lm.iter"} <= names
    assert {e.get("cat") for e in trace["traceEvents"]
            if e.get("name", "").startswith("vicalib.")} == {"cpu_op"}
