"""The port's streaming calibrator against the JAX package's.

Chunked VI parity: one 16-frame mono VI sequence from the JAX simulator
(100 Hz IMU, gyro and accel biases, 4 ms time offset, 0.1 px pixel noise,
0.1 s window slack) is fed to both packages' ``StreamingCalibrator`` in two
chunks of 8 frames, the IMU interleaved by time up to 0.05 s past each
chunk's last frame.  Both chunks solve at capacity 16 (the first with 8 pad
frames), so the JAX side compiles its solver once (a VI solve compile costs
about 45 s on the CPU test machine); capacity growth between chunks is
driven by ``chip_smoke.py``'s stream phase (32 to 256), and padding against
no padding by the test below.
Every stage is capped at 5 LM iterations.

Tolerances: the same ``n_frames``, ``capacity`` and ``iterations`` per
chunk; cost within rtol 1e-6; the final intrinsics within 1e-6 px and T_ck,
biases, scales and time offset within 1e-8 (measured: cost 3e-12 relative,
intrinsics 5e-10 px, the rest below 5e-11 — the same float64 arithmetic in
other summation orders).
"""
import numpy as np
import pytest
import torch

from vicalib_tpu.io import sim as jsim
from vicalib_tpu.solver.lm import LMOptions as JOptions
from vicalib_tpu.streaming import StreamingCalibrator as JCal
from vicalib_tpu.streaming import _next_capacity as j_next_capacity
from vicalib_tpu_torch.solver.lm import LMOptions as TOptions
from vicalib_tpu_torch.streaming import StreamingCalibrator as TCal
from vicalib_tpu_torch.streaming import _next_capacity as t_next_capacity

N_FRAMES = 16
CHUNK = 8


@pytest.fixture(scope="module")
def seq():
    cfg = jsim.default_mono_config(
        n_frames=N_FRAMES, model="linear", imu=True, imu_rate=100.0,
        gyro_bias=np.array([0.01, -0.02, 0.015]),
        accel_bias=np.array([0.05, 0.02, -0.04]), time_offset=0.004,
        pixel_noise=0.1)
    return cfg, jsim.simulate(cfg)


def _stream(cal, sd):
    cursor = 0
    out = []
    for lo in range(0, N_FRAMES, CHUNK):
        hi = min(lo + CHUNK, N_FRAMES)
        take = np.searchsorted(sd.imu_times, sd.frame_times[hi - 1] + 0.05)
        cal.add_imu(sd.imu_times[cursor:take], sd.gyro[cursor:take],
                    sd.accel[cursor:take])
        cursor = take
        cal.add_frames(sd.frame_times[lo:hi], sd.pixels[:, lo:hi],
                       sd.visible[:, lo:hi])
        out.append(cal.solve())
    return out


def _kw(sd):
    return dict(model_names=["linear"], points_3d=sd.points_3d,
                widths=[800], heights=[600], window_slack=0.1)


@pytest.fixture(scope="module")
def runs(seq):
    _, sd = seq
    pub_j, pub_t = [], []
    jc = _stream(JCal(options=JOptions(max_iters=5),
                      stats_callback=pub_j.append, **_kw(sd)), sd)
    cal_t = TCal(options=TOptions(max_iters=5), stats_callback=pub_t.append,
                 device="cpu", **_kw(sd))
    tc = _stream(cal_t, sd)
    return jc, tc, pub_j, pub_t, cal_t


@pytest.mark.parametrize("n,cap", [(2, 16), (16, 16), (17, 32), (100, 128)])
def test_next_capacity(n, cap):
    assert t_next_capacity(n) == j_next_capacity(n) == cap


def test_chunks_match_jax(runs):
    jc, tc, pub_j, pub_t, _ = runs
    assert [c.n_frames for c in pub_t] == [8, 16]
    assert pub_t == tc and len(pub_j) == len(jc)
    for a, b in zip(jc, tc):
        assert (b.n_frames, b.capacity, b.iterations) == \
            (a.n_frames, a.capacity, a.iterations)
        np.testing.assert_allclose(b.cost, a.cost, rtol=1e-6)
        np.testing.assert_allclose(b.cam_rmse, a.cam_rmse, rtol=1e-6)
    sj, st = jc[-1].state, tc[-1].state
    np.testing.assert_allclose(st.intr.numpy(), np.asarray(sj.intr),
                               rtol=0, atol=1e-6)
    for name in ("q_ck", "p_ck", "biases", "scales", "g_dir",
                 "time_offset"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), rtol=0,
                                   atol=1e-8, err_msg=name)


def test_carry_state_leaves_the_previous_chunk_intact(runs, seq):
    """The warm start builds new tensors: the first chunk's state, which its
    ChunkResult still holds, is the state its solve returned."""
    _, tc, _, _, cal = runs
    first = tc[0].state
    assert first.q_wk.shape[0] == 16
    assert cal.last_result.state.q_wk.data_ptr() != first.q_wk.data_ptr()
    # the filled frames of chunk 1 were carried into chunk 2 and moved on
    assert not torch.equal(first.t_wk[:8], tc[1].state.t_wk[:8])


@pytest.mark.parametrize("stage", ["visual", "inertial-full+scale"])
def test_padding_is_inert(seq, stage):
    """8 filled frames solved with no padding and with 8 inert pad frames
    (zero-valid observations, factors past the IMU buffer): the same
    iterations and cost, and the filled frames' state and the shared
    parameters within 1e-9 (float64).  The LM solve is held from the same
    starting state: the visual stage, and the final stage resumed as every
    warm chunk runs it.  The one-time initializers are not inert in either
    package — ``initialize_gravity`` reads frame ``n_frames // 2`` and
    ``initialize_velocities`` differences the last filled frame against a
    pad — so a first chunk that fills less than its capacity starts its
    inertial stages elsewhere than the unpadded problem would (ROADMAP.md
    queue 3)."""
    from vicalib_tpu_torch.solver import StageFlags, run_staged
    from vicalib_tpu_torch.solver.build import build_problem

    _, sd = seq
    cal = TCal(device="cpu", **_kw(sd))
    n = 8
    take = np.searchsorted(sd.imu_times, sd.frame_times[n - 1] + 0.05)
    cal.add_imu(sd.imu_times[:take], sd.gyro[:take], sd.accel[:take])
    cal.add_frames(sd.frame_times[:n], sd.pixels[:, :n], sd.visible[:, :n])
    if stage == "visual":
        flags, resume = StageFlags(calibrate_imu=False), False
    else:
        flags, resume = cal._final_flags(True), True
    out = []
    for cap in (n, 2 * n):
        times, pixels, visible = cal._padded_inputs(cap)
        data, state = build_problem(
            ["linear"], times, pixels, visible, sd.points_3d, widths=[800],
            heights=[600], imu_times=cal.imu_times, gyro=cal.gyro,
            accel=cal.accel, window_slack=0.1, device="cpu")
        if cap > n:
            assert not data.imu.has_meas[n - 1:].any()
        out.append(run_staged(state, data, flags, TOptions(max_iters=4),
                              resume=resume))
    a, b = out
    assert [r[:2] for r in b.stages_run] == [r[:2] for r in a.stages_run]
    assert a.stages_run[-1][0] == stage
    np.testing.assert_allclose(b.info.cost, a.info.cost, rtol=1e-9)
    for name, x, y in zip(a.state._fields, a.state, b.state):
        if name in ("q_wk", "t_wk", "v_w"):
            y = y[:n]
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-9,
                                   err_msg=name)


def test_outlier_removal_matches_jax():
    """Camera-only streaming with outlier removal on the JAX test's
    kind of corrupted data (tests/test_streaming.py: ~2 % of the
    observations moved by 5-20 px), here 16 frames in two chunks of 8 (one
    solver shape for the JAX side to compile).  The persistent
    ``visible`` mask must equal JAX's bit for bit, and purge the corrupted
    observations as the JAX test requires."""
    cfg = jsim.default_mono_config(n_frames=16, model="linear",
                                   pixel_noise=0.05)
    sd = jsim.simulate(cfg)
    rng = np.random.default_rng(11)
    pixels = sd.pixels.copy()
    vis_idx = np.argwhere(sd.visible[0])
    pick = vis_idx[rng.choice(len(vis_idx), size=len(vis_idx) // 50,
                              replace=False)]
    for f, p in pick:
        pixels[0, f, p] += rng.uniform(5.0, 20.0, 2) * rng.choice([-1, 1], 2)
    kw = dict(model_names=["linear"], points_3d=sd.points_3d,
              widths=[800], heights=[600], calibrate_imu=False,
              remove_outliers=True, outlier_threshold=2.0)
    cals = [JCal(**kw), TCal(device="cpu", **kw)]
    for cal in cals:
        for lo in range(0, 16, 8):
            cal.add_frames(sd.frame_times[lo:lo + 8],
                           pixels[:, lo:lo + 8], sd.visible[:, lo:lo + 8])
            cal.solve()
    jc, tc = cals
    np.testing.assert_array_equal(tc.visible, jc.visible)
    assert tc.visible.sum() < sd.visible.sum()
    still = sum(bool(tc.visible[0, f, p]) for f, p in pick)
    assert still <= len(pick) // 5
    assert [c.iterations for c in tc.results] == \
        [c.iterations for c in jc.results]
    np.testing.assert_allclose(tc.last_result.cam_rmse,
                               jc.last_result.cam_rmse, rtol=1e-6)
