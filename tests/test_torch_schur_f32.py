"""The port's float32 path: covariance and solve.

Counterparts of the JAX package's float32 covariance tests
(tests/test_schur.py ``test_shared_covariance_float32`` and
``test_shared_covariance_f32_process``), held within the port as the JAX
tests hold the JAX package within itself.  One 6-frame mono VI sequence
from the JAX simulator (50 Hz IMU, 0.1 s window slack) is built into a
problem in float32 and in float64.

Tolerances: the float32 covariance diagonal within rtol 0.05 of the float64
result, the JAX tests' own bound (``shared_covariance`` upcasts to float64,
so only the float32 rounding of the input state and data remains; the
reduced system's ~1e12 conditioning turns that rounding into percent-level
differences of the smallest variances).

The float32 staged solve itself stops short on this 6-frame sequence in
both packages (inertial-full cost 0.059 in the port and 0.061 in JAX,
against 1.3e-7 in float64), so no test holds a float32 solution to the
float64 one; ROADMAP.md queue 3 records it.
"""
import numpy as np
import pytest
import torch

from vicalib_tpu.io import sim as jsim
from vicalib_tpu_torch.solver import StageFlags as TFlags
from vicalib_tpu_torch.solver import run_staged
from vicalib_tpu_torch.solver.build import build_problem
from vicalib_tpu_torch.solver.stages import shared_covariance as t_cov

_FULL = dict(calibrate_imu=True, inertial_active=True, rotation_only=False,
             bias_active=True, scale_active=True, optimize_time_offset=True)


@pytest.fixture(scope="module")
def seq():
    cfg = jsim.default_mono_config(n_frames=6, model="linear", imu=True,
                                   imu_rate=50.0)
    return cfg, jsim.simulate(cfg)


def _build(cfg, sd, dtype):
    return build_problem(
        ["linear"], np.asarray(sd.frame_times), np.asarray(sd.pixels),
        np.asarray(sd.visible), np.asarray(sd.points_3d),
        widths=[c.width for c in cfg.cameras],
        heights=[c.height for c in cfg.cameras],
        imu_times=np.asarray(sd.imu_times), gyro=np.asarray(sd.gyro),
        accel=np.asarray(sd.accel), window_slack=0.1, dtype=dtype,
        device="cpu")


def test_shared_covariance_float32(seq):
    """A float32 problem's covariance is finite, float64, positive on the
    active entries and within rtol 0.05 of the float64 problem's."""
    cfg, sd = seq
    data32, state32 = _build(cfg, sd, torch.float32)
    assert state32.t_wk.dtype == torch.float32
    assert data32.imu.win_times.dtype == torch.float32
    data64, state64 = _build(cfg, sd, torch.float64)
    cov32 = t_cov(state32, data32, TFlags(**_FULL))
    cov64 = t_cov(state64, data64, TFlags(**_FULL))
    assert cov32.dtype == np.float64
    assert np.all(np.isfinite(cov32))
    d32, d64 = np.diag(cov32), np.diag(cov64)
    active = d64 > 1e-18            # identity rows of inactive entries
    assert active.sum() == 25       # every shared entry is free here
    assert np.all(d32[active] > 0)
    np.testing.assert_allclose(d32[active], d64[active], rtol=0.05)


def test_float32_state_gives_float64_quality_covariance(seq):
    """The port has no x64 switch: a float32 state and float32 data must
    still give a float64 covariance of float64 quality.  The state is the
    one a float32 staged solve reaches (every stage at most 5 LM
    iterations; the solve runs the float32 jitter of ``imu_weights`` and the
    LM loop with TF32 off); its covariance from the float32 tensors must
    equal, within rtol 1e-3, the covariance of the same values upcast to
    float64 on float64 data (measured 2.4e-4: the float32 rounding of the
    data, through the ~1e12 conditioning)."""
    from vicalib_tpu_torch import convert
    from vicalib_tpu_torch.solver.lm import LMOptions

    cfg, sd = seq
    data32, state32 = _build(cfg, sd, torch.float32)
    res = run_staged(state32, data32, TFlags(calibrate_imu=True),
                     LMOptions(max_iters=5), compute_cov=True)
    assert res.state.t_wk.dtype == torch.float32
    assert [s[0] for s in res.stages_run] == [
        "visual", "inertial-rotation", "inertial-full",
        "inertial-full+scale"]
    assert all(np.isfinite(s[2]) for s in res.stages_run)
    assert res.covariance.dtype == np.float64
    assert np.all(np.isfinite(res.covariance))
    data64, _ = _build(cfg, sd, torch.float64)
    state64 = convert.state_from_numpy(convert.state_to_numpy(res.state),
                                       "cpu")
    cov64 = t_cov(state64, data64, TFlags(**_FULL))
    d32, d64 = np.diag(res.covariance), np.diag(cov64)
    active = d64 > 1e-18
    assert np.all(d32[active] > 0)
    np.testing.assert_allclose(d32[active], d64[active], rtol=1e-3)

