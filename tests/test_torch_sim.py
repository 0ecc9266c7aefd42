"""Port parity: io.sim.simulate and render_frames (torch vs JAX).

The simulators draw from the same numpy generators and evaluate the same
trajectory expressions in float64 (jacfwd in both), so observations agree to
rounding (atol 1e-10 px, 1e-12 on poses).  Rendered 400x300 frames must be
identical uint8 images: a pixel could differ only where 255*(1 - 0.87 cov)
lands within an ulp of an integer, and none does on these frames.
"""
import numpy as np

from vicalib_tpu.io import sim as jsim
from vicalib_tpu_torch.io import sim as tsim


def _config(mod, n_frames=3):
    cfg = mod.default_stereo_vi_config(n_frames=n_frames, model="linear",
                                       distance=0.40, orbit_radius=0.2)
    for cam in cfg.cameras:
        cam.params[:4] = [240.0, 240.0, 200.0, 150.0]
        cam.width, cam.height = 400, 300
    cfg.pixel_noise = 0.1
    cfg.gyro_noise = 1e-3
    cfg.accel_noise = 1e-2
    return cfg


def test_simulate_matches_jax():
    dj = jsim.simulate(_config(jsim))
    dt = tsim.simulate(_config(tsim), device="cpu")
    np.testing.assert_array_equal(dj.frame_times, dt.frame_times)
    np.testing.assert_array_equal(dj.visible, dt.visible)
    np.testing.assert_array_equal(dj.points_3d, dt.points_3d)
    np.testing.assert_array_equal(dj.imu_times, dt.imu_times)
    np.testing.assert_allclose(dt.pixels, dj.pixels, rtol=0, atol=1e-10)
    for a, b in zip(dj.T_wk, dt.T_wk):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dt.v_w, dj.v_w, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dt.gyro, dj.gyro, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dt.accel, dj.accel, rtol=0, atol=1e-11)


def test_render_frames_match_jax():
    dj = jsim.simulate(_config(jsim, n_frames=2))
    dt = tsim.simulate(_config(tsim, n_frames=2), device="cpu")
    for cam in range(2):
        fj = jsim.render_frames(dj, cam=cam)
        ft = tsim.render_frames(dt, cam=cam, device="cpu")
        assert ft.dtype == np.uint8 and ft.shape == (2, 300, 400)
        assert int((fj != ft).sum()) == 0
        assert (ft < 128).sum() > 1000          # dots are there
