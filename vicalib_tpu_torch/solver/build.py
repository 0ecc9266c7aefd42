"""Build a calibration problem (ProblemData + initial CalibState) from
per-frame observations and IMU streams.

The measurement-assembly layer between detection/simulation and the solver
(the reference's VicalibTask::AddImageMeasurements + AddFrame +
AddObservation + AddImuMeasurements, vicalib-task.cc:247-368, 680-698),
recast as batch construction of static-shape tensors on the problem's
device.  Host numpy does what the JAX package also does on the host: the
IMU window slicing and the raw-stream time-offset refinement.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..cameras import get_model
from ..detect import pnp
from ..geometry import quat_np
from ..imu import build_windows, gather_windows
from .assemble import ProblemData
from .problem import SharedLayout, init_state
from .residuals import CameraObs, ImuFactors


def refine_offset_guess(frame_times, q_wk, imu_times, gyro, guess,
                        search: float = 0.6, n_coarse: int = 601):
    """Coarse camera<->IMU time alignment from the RAW gyro stream.

    The first-IMU-sample alignment (vicalib-task.cc:633-653) assumes both
    streams start simultaneously; real rigs can be off by hundreds of ms —
    outside both the LM convergence basin (~10 ms) and the factor windows'
    slack.  The body angular-rate *magnitude* is rotation-invariant, so the
    offset is identified by scanning |gyro(t_mid - d)| against the
    camera-derived angular speed |log(q_k^-1 q_{k+1})| / dt over a coarse
    grid around ``guess`` (then one 10x finer pass).  Host-side numpy: runs
    once per problem build over a few hundred interpolations.
    """
    frame_times = np.asarray(frame_times, np.float64)
    q = np.asarray(q_wk, np.float64)
    imu_times = np.asarray(imu_times, np.float64)
    gyro = np.asarray(gyro, np.float64)
    if len(frame_times) < 3 or len(imu_times) < 4:
        return float(guess)
    dt = np.diff(frame_times)
    dq = quat_np.quat_mul(quat_np.inverse(q[:-1]), q[1:])
    omega = np.linalg.norm(quat_np.log(dq), axis=-1) / np.maximum(dt, 1e-9)
    t_mid = 0.5 * (frame_times[:-1] + frame_times[1:])
    gmag = np.linalg.norm(gyro, axis=1)

    def misfit(d):
        # sample only where the query lands inside the raw stream
        tq = t_mid - d
        ok = (tq >= imu_times[0]) & (tq <= imu_times[-1])
        if ok.sum() < max(4, len(t_mid) // 4):
            return np.inf
        z = np.interp(tq[ok], imu_times, gmag)
        return float(np.mean((z - omega[ok]) ** 2))

    best = float(guess)
    for half, n in ((search, n_coarse), (search / 50.0, 101)):
        grid = best + np.linspace(-half, half, n)
        costs = np.array([misfit(d) for d in grid])
        if not np.isfinite(costs).any():
            return float(guess)
        best = float(grid[int(np.argmin(costs))])
    return best


def build_problem(
    model_names: Sequence[str],
    frame_times: np.ndarray,          # (F,)
    pixels: np.ndarray,               # (C, F, P, 2)
    visible: np.ndarray,              # (C, F, P)
    points_3d: np.ndarray,            # (P, 3) target points (z=0 plane)
    widths: Sequence[int] = None,
    heights: Sequence[int] = None,
    imu_times: np.ndarray = None,
    gyro: np.ndarray = None,
    accel: np.ndarray = None,
    time_offset_guess: float = 0.0,
    window_slack: float = 0.35,
    intr0=None,
    T_ck0=None,
    dtype=torch.float64,
    device="cuda",
    init_poses: bool = True,
    use_ransac: bool = False,
    sample_idx=None,
    refine_time_offset: bool = False,
):
    """Returns (data: ProblemData, state: CalibState), both on ``device``.

    Frame poses are PnP-seeded from camera 0 with the initial intrinsics,
    as the reference does; ``sample_idx`` (F, n_hyp, 4) fixes the RANSAC
    samples (by default frame f draws with seed f).  With IMU streams, one
    factor per consecutive frame pair gets a window of raw samples covering
    ``window_slack`` seconds beyond its frame times.  With
    ``refine_time_offset`` the offset guess is refined by raw-stream
    gyro/vision alignment (:func:`refine_offset_guess`) before the windows
    are built — needed when camera and IMU device clocks are
    unsynchronized beyond the window slack.
    """
    C, F, P, _ = pixels.shape
    widths = widths or [800] * C
    heights = heights or [600] * C
    layout = SharedLayout.create(model_names)

    def T(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    fidx = T(np.repeat(np.arange(F), P), torch.int64)
    p_w = T(np.tile(points_3d, (F, 1)))
    obs = [CameraObs(frame_idx=fidx, p_w=p_w,
                     p_c=T(pixels[c].reshape(F * P, 2)),
                     valid=T(visible[c].reshape(F * P)),
                     points_per_frame=P)
           for c in range(C)]

    state = init_state(F, model_names, widths, heights, dtype=dtype,
                       device=device, intr0=intr0, T_ck0=T_ck0)

    if init_poses:
        model = get_model(model_names[0])
        vis0 = T(visible[0])
        q_wk, t_wk = pnp.init_frame_poses(
            model, state.intr[0][:model.n_params], T(pixels[0]),
            T(points_3d), vis0, (state.q_ck[0], state.p_ck[0]),
            use_ransac=use_ransac, sample_idx=sample_idx)
        # frames with fewer than 4 detections keep the placeholder pose
        any_vis = (torch.sum(vis0, dim=1) >= 4)[:, None]
        state = state._replace(q_wk=torch.where(any_vis, q_wk, state.q_wk),
                               t_wk=torch.where(any_vis, t_wk, state.t_wk))

    imu = None
    if imu_times is not None and len(imu_times) > 0:
        if refine_time_offset and init_poses:
            time_offset_guess = refine_offset_guess(
                frame_times, state.q_wk.cpu().numpy(), imu_times, gyro,
                time_offset_guess)
        win = build_windows(imu_times, frame_times,
                            offset_guess=time_offset_guess, slack=window_slack)
        t_w, g_w, a_w = gather_windows(
            np.asarray(imu_times), np.asarray(gyro), np.asarray(accel),
            win["idx0"], win["n_slots"])
        imu = ImuFactors(win_times=T(t_w), win_gyro=T(g_w), win_accel=T(a_w),
                         start=T(win["start"]), end=T(win["end"]),
                         has_meas=T(win["has_meas"], torch.bool),
                         frame_i=T(np.arange(F - 1), torch.int64),
                         consecutive=True, slack=float(window_slack))

    data = ProblemData(obs=obs, imu=imu, layout=layout, n_frames=F)
    state = state._replace(time_offset=T(time_offset_guess))
    return data, state


def problem_from_sim(sim_data, model_names=None, dtype=torch.float64,
                     device="cuda", time_offset_guess=0.0, use_imu=False,
                     intr0=None, use_ransac=False, window_slack=0.35,
                     refine_time_offset=False, sample_idx=None):
    """Convenience: wire a SimData into (ProblemData, initial CalibState)."""
    cfg = sim_data.config
    names = model_names or [c.model for c in cfg.cameras]
    kwargs = {}
    if use_imu:
        kwargs = dict(imu_times=sim_data.imu_times, gyro=sim_data.gyro,
                      accel=sim_data.accel,
                      time_offset_guess=time_offset_guess,
                      window_slack=window_slack,
                      refine_time_offset=refine_time_offset)
    return build_problem(
        names, sim_data.frame_times, sim_data.pixels, sim_data.visible,
        sim_data.points_3d,
        widths=[c.width for c in cfg.cameras],
        heights=[c.height for c in cfg.cameras],
        dtype=dtype, device=device, intr0=intr0, use_ransac=use_ransac,
        sample_idx=sample_idx, **kwargs)
