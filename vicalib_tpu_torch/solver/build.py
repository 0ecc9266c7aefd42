"""Build a calibration problem (ProblemData + initial CalibState) from
per-frame observations.

The measurement-assembly layer between detection/simulation and the solver
(the reference's VicalibTask::AddImageMeasurements + AddFrame +
AddObservation), recast as batch construction of static-shape tensors on
the problem's device.  Camera-only: IMU streams are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..cameras import get_model
from ..detect import pnp
from .assemble import ProblemData
from .problem import SharedLayout, init_state
from .residuals import CameraObs, imu_not_ported


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
    intr0=None,
    T_ck0=None,
    dtype=torch.float64,
    device="cuda",
    init_poses: bool = True,
    use_ransac: bool = False,
    sample_idx=None,
):
    """Returns (data: ProblemData, state: CalibState), both on ``device``.

    Frame poses are PnP-seeded from camera 0 with the initial intrinsics,
    as the reference does; ``sample_idx`` (F, n_hyp, 4) fixes the RANSAC
    samples (by default frame f draws with seed f).
    """
    if imu_times is not None and len(imu_times) > 0:
        imu_not_ported()
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

    data = ProblemData(obs=obs, imu=None, layout=layout, n_frames=F)
    state = state._replace(time_offset=T(time_offset_guess))
    return data, state
