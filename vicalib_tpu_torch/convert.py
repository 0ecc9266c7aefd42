"""Calibration state and problems between numpy dicts and the port.

The only "weights" this system carries are calibration state and
observations.  The dict keys are the field names of ``CalibState`` and
``CameraObs``, which are also the JAX package's names, so one dict of numpy
arrays gives both packages the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .solver.assemble import ProblemData
from .solver.problem import CalibState, SharedLayout
from .solver.residuals import CameraObs, ImuFactors


def state_from_numpy(d, device, dtype=torch.float64) -> CalibState:
    """dict of arrays keyed by CalibState field -> CalibState on device,
    in ``dtype`` (None: each array's own dtype)."""
    def T(x):
        t = torch.as_tensor(np.array(x), device=device)
        return t if dtype is None else t.to(dtype)

    return CalibState(**{k: T(d[k]) for k in CalibState._fields})


def state_to_numpy(state: CalibState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def problem_from_numpy(d, device, dtype=torch.float64) -> ProblemData:
    """dict {"model_names", "n_frames", "obs": [per-camera dicts with
    frame_idx, p_w, p_c, valid, points_per_frame], "imu": optional dict
    with the ImuFactors fields (win_times, win_gyro, win_accel, start, end,
    has_meas, frame_i, consecutive, slack)} -> ProblemData."""
    def T(x, dt=dtype):
        return torch.as_tensor(np.array(x), device=device).to(dt)

    obs = [CameraObs(frame_idx=T(o["frame_idx"], torch.int64),
                     p_w=T(o["p_w"]), p_c=T(o["p_c"]), valid=T(o["valid"]),
                     points_per_frame=o.get("points_per_frame"))
           for o in d["obs"]]
    imu = None
    if d.get("imu") is not None:
        m = d["imu"]
        imu = ImuFactors(
            win_times=T(m["win_times"]), win_gyro=T(m["win_gyro"]),
            win_accel=T(m["win_accel"]), start=T(m["start"]),
            end=T(m["end"]), has_meas=T(m["has_meas"], torch.bool),
            frame_i=T(m["frame_i"], torch.int64),
            consecutive=bool(m.get("consecutive", False)),
            slack=float(m.get("slack", 0.0)))
    return ProblemData(obs=obs, imu=imu,
                       layout=SharedLayout.create(d["model_names"]),
                       n_frames=int(d["n_frames"]))
