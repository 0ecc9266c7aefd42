"""Checkpoints: the port's files against the JAX package's, and resume.

The format (npz of the CalibState fields + a json sidecar with the stage
flags and meta, FORMAT_VERSION 1) is shared: a checkpoint written by either
package loads in the other with equal arrays, flags and meta.  Resume
parity: the JAX package solves an 8-frame mono camera-only sequence (0.1 px
pixel noise) with the outlier pass, checkpointing after every stage; its
first stage's checkpoint is resumed by both packages on the same problem.
Camera-only keeps the JAX side to one cheap solver compile; the VI resume
(the initializers skipped) is held to the JAX package chunk by chunk in
tests/test_torch_streaming.py, whose warm chunks resume at the final stage.

Tolerance of the resumed states: 1e-8 absolute on every field (intrinsics
1e-6 px) — the same float64 arithmetic in other summation orders (the
streaming parity test measures 5e-10 px and 5e-11 elsewhere).
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from vicalib_tpu import checkpoint as jck
from vicalib_tpu.io import sim as jsim
from vicalib_tpu.solver import StageFlags as JFlags
from vicalib_tpu.solver import run_staged as j_run_staged
from vicalib_tpu.solver.build import problem_from_sim as j_from_sim
from vicalib_tpu.solver.problem import CalibState as JState
from vicalib_tpu.solver.problem import init_state as j_init_state
from vicalib_tpu_torch import checkpoint as tck
from vicalib_tpu_torch import convert
from vicalib_tpu_torch.solver import StageFlags as TFlags
from vicalib_tpu_torch.solver import run_staged as t_run_staged
from vicalib_tpu_torch.solver.lm import LMOptions as TOptions
from vicalib_tpu_torch.solver.problem import CalibState as TState
from vicalib_tpu_torch.solver.problem import init_state as t_init_state


def _problem_dict(data):
    return {"model_names": list(data.layout.model_names),
            "n_frames": data.n_frames,
            "obs": [{"frame_idx": np.asarray(o.frame_idx),
                     "p_w": np.asarray(o.p_w), "p_c": np.asarray(o.p_c),
                     "valid": np.asarray(o.valid),
                     "points_per_frame": o.points_per_frame}
                    for o in data.obs]}


def _assert_states_equal(st, sj):
    for name in JState._fields:
        a, b = np.asarray(getattr(sj, name)), getattr(st, name).numpy()
        assert b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_field_lists_and_format_match():
    assert TState._fields == JState._fields
    assert [f.name for f in dataclasses.fields(TFlags)] == \
        [f.name for f in dataclasses.fields(JFlags)]
    assert tck.FORMAT_VERSION == jck.FORMAT_VERSION == 1


def test_checkpoint_roundtrip(tmp_path):
    """Port save then load: equal arrays, flags and meta; ``dtype=None``
    keeps the saved dtype (float32 here), a dtype argument casts."""
    state = t_init_state(5, ["poly3"], [640], [480], torch.float32, "cpu")
    state = state._replace(biases=torch.arange(6, dtype=torch.float32))
    flags = TFlags(calibrate_imu=True, inertial_active=True)
    path = str(tmp_path / "ckpt.npz")
    tck.save_checkpoint(path, state, flags, meta={"stage": "test"})
    state2, flags2, meta = tck.load_checkpoint(path, device="cpu")
    for a, b in zip(state, state2):
        assert b.dtype == torch.float32
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert flags2 == flags and meta == {"stage": "test"}
    state3, _, _ = tck.load_checkpoint(path, dtype=torch.float64,
                                       device="cpu")
    assert all(x.dtype == torch.float64 for x in state3)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_are_interchangeable(tmp_path, writer):
    """A checkpoint written by either package loads in the other with equal
    arrays (and dtypes), flags and meta."""
    rng = np.random.default_rng(3)
    sj = j_init_state(4, ["linear", "poly3"], [800, 640], [600, 480])
    sj = JState(*[np.asarray(x) + rng.normal(size=np.shape(x))
                  for x in sj])
    st = convert.state_from_numpy(sj._asdict(), "cpu")
    kw = dict(calibrate_imu=True, inertial_active=True, rotation_only=False,
              bias_active=True)
    meta = {"stage": "inertial-full", "cost": 1.5, "iterations": 7}
    path = str(tmp_path / "state.npz")
    if writer == "jax":
        jck.save_checkpoint(path, sj, JFlags(**kw), meta=meta)
        st2, flags, meta2 = tck.load_checkpoint(path, device="cpu")
        _assert_states_equal(st2, sj)
        assert flags == TFlags(**kw)
    else:
        tck.save_checkpoint(path, st, TFlags(**kw), meta=meta)
        sj2, flags, meta2 = jck.load_checkpoint(path)
        _assert_states_equal(st, sj2)
        assert flags == JFlags(**kw)
    assert meta2 == meta
    side = json.load(open(path + ".json"))
    assert side["fields"] == list(JState._fields)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's camera-only solve with the outlier pass and a
    checkpoint after every stage; the first stage's checkpoint is kept
    aside (the callback of a stage runs before that stage's checkpoint is
    written)."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = jsim.default_mono_config(n_frames=8, model="linear",
                                   pixel_noise=0.1)
    data_j, state_j = j_from_sim(jsim.simulate(cfg))
    path = str(d / "state.npz")
    kept = str(d / "first.npz")
    seen = []

    def keep(stats):
        if seen:
            shutil.copy(path, kept)
            shutil.copy(path + ".json", kept + ".json")
        seen.append(stats["stage"])

    j_run_staged(state_j, data_j, JFlags(calibrate_imu=False),
                 do_remove_outliers=True, stats_callback=keep,
                 checkpoint_path=path)
    assert len(seen) == 2
    return data_j, kept


def test_run_staged_checkpoints_every_stage(tmp_path, monkeypatch, caplog):
    """The port's run_staged writes the checkpoint after every stage, with
    the stage's flags and meta (stage, cost, iterations), calls the stats
    callback once per stage with the JAX keys, and logs each stage as it
    ends (with DEBUG, the IMU factors' Mahalanobis distances too)."""
    import logging

    from vicalib_tpu_torch.solver.build import build_problem

    caplog.set_level(logging.DEBUG, logger="vicalib_tpu_torch.solver")

    cfg = jsim.default_mono_config(n_frames=6, model="linear", imu=True,
                                   imu_rate=50.0)
    sd = jsim.simulate(cfg)
    data, state = build_problem(
        ["linear"], sd.frame_times, sd.pixels, sd.visible, sd.points_3d,
        imu_times=sd.imu_times, gyro=sd.gyro, accel=sd.accel,
        window_slack=0.1, device="cpu")
    saved, stats = [], []
    real_save = tck.save_checkpoint

    def spy(path, st, flags=None, meta=None):
        saved.append((flags, meta))
        real_save(path, st, flags, meta)

    monkeypatch.setattr(tck, "save_checkpoint", spy)
    path = str(tmp_path / "run.npz")
    res = t_run_staged(state, data, TFlags(calibrate_imu=True),
                       TOptions(max_iters=2), stats_callback=stats.append,
                       checkpoint_path=path)
    names = [r[0] for r in res.stages_run]
    assert names == ["visual", "inertial-rotation", "inertial-full",
                     "inertial-full+scale"]
    assert [m["stage"] for _, m in saved] == names
    assert [s["stage"] for s in stats] == names
    assert set(stats[0]) == {"stage", "cost", "iterations", "cam_rmse",
                             "wall_s", "state"}
    for (flags, meta), row in zip(saved, res.stages_run):
        assert (meta["iterations"], meta["cost"]) == (row[1], row[2])
    assert saved[1][0].rotation_only and not saved[2][0].rotation_only
    for name in names:
        assert "stage %s done: cost" % name in caplog.text
    assert caplog.text.count("IMU Mahalanobis: median") == 2
    st2, flags2, meta2 = tck.load_checkpoint(path, device="cpu")
    assert meta2["stage"] == "inertial-full+scale" and flags2.scale_active
    for a, b in zip(res.state, st2):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_resume_from_jax_checkpoint_matches_jax(jax_run):
    data_j, kept = jax_run
    sj, fj, meta = jck.load_checkpoint(kept)
    assert meta["stage"] == "visual"
    rj = j_run_staged(sj, data_j, fj, do_remove_outliers=True, resume=True)
    data_t = convert.problem_from_numpy(_problem_dict(data_j), "cpu")
    st, ft, _ = tck.load_checkpoint(kept, device="cpu")
    rt = t_run_staged(st, data_t, ft, do_remove_outliers=True, resume=True)
    # the saved stage re-solves first (from its converged state: few
    # iterations), then the outlier pass and its re-solve
    assert [r[0] for r in rt.stages_run] == ["visual", "visual"]
    assert [r[:2] for r in rt.stages_run] == [r[:2] for r in rj.stages_run]
    np.testing.assert_allclose(rt.info.cost, rj.info.cost, rtol=1e-6)
    for name in JState._fields:
        atol = 1e-6 if name == "intr" else 1e-8
        np.testing.assert_allclose(getattr(rt.state, name).numpy(),
                                   np.asarray(getattr(rj.state, name)),
                                   rtol=0, atol=atol, err_msg=name)
