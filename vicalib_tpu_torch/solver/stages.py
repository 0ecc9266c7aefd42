"""Staged optimization schedule — the reference's SolveThread state machine,
camera-only.

The visual stage (camera-0 extrinsics fixed as the gauge, every other
camera's extrinsics and all intrinsics free) runs to convergence, then
optionally outlier removal and one re-solve.  The inertial stages and their
initializers belong to the IMU path, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .assemble import ProblemData
from .lm import LMInfo, LMOptions, LMSolver, materialize_info
from .problem import CalibState, StageFlags, frame_mask, shared_mask
from .residuals import imu_not_ported, reproj_residuals

log = logging.getLogger("vicalib_tpu_torch.solver")


@dataclasses.dataclass
class StagedResult:
    state: CalibState
    info: LMInfo
    stages_run: list               # (name, iters, cost, wall_s) per stage
    mse: float
    cam_rmse: np.ndarray
    total_iterations: int


def initialize_time_offset(*args, **kw):
    imu_not_ported()


def initialize_extrinsic_rotation(*args, **kw):
    imu_not_ported()


def initialize_velocities(*args, **kw):
    imu_not_ported()


def initialize_gravity(*args, **kw):
    imu_not_ported()


def remove_outliers(state: CalibState, data: ProblemData, cam_rmse,
                    threshold: float) -> ProblemData:
    """Invalidate observations with reprojection error above
    threshold * per-camera RMSE (RemoveOutliers, vicalibrator.h:859-916)."""
    new_obs = []
    for c, obs in enumerate(data.obs):
        r = reproj_residuals(state, obs, c, data.layout.model_names[c])
        err = torch.linalg.norm(r, dim=1)
        keep = (err <= threshold * float(cam_rmse[c])) & (obs.valid > 0)
        n_out = int(torch.sum((obs.valid > 0) & ~keep))
        log.info("camera %d: removing %d/%d conic outliers", c, n_out,
                 int(torch.sum(obs.valid > 0)))
        new_obs.append(dataclasses.replace(obs, valid=keep.to(obs.valid.dtype)))
    return dataclasses.replace(data, obs=new_obs)


def run_staged(state: CalibState, data: ProblemData, flags: StageFlags,
               options: LMOptions = LMOptions(),
               do_remove_outliers: bool = False,
               outlier_threshold: float = 2.0) -> StagedResult:
    """Run the camera-only schedule to completion on the problem's device."""
    if flags.calibrate_imu or data.imu is not None:
        imu_not_ported()
    solver = LMSolver(data, options)
    dtype = state.t_wk.dtype
    dev = state.t_wk.device
    pending = []                      # (stage_name, raw_info, wall)
    outliers_removed = False
    while True:
        fmask = frame_mask(flags, data.n_frames, dtype, dev)
        smask = shared_mask(data.layout, flags, dtype, dev)
        stage_name = "visual"
        log.info("=== stage: %s ===", stage_name)
        t_stage = time.time()
        state, raw = solver.solve(state, fmask, smask,
                                  inertial_scale=0.0,
                                  rotation_only=flags.rotation_only,
                                  lazy=True)
        pending.append((stage_name, raw, time.time() - t_stage))
        if do_remove_outliers and not outliers_removed:
            info = materialize_info(raw)
            data = remove_outliers(state, data, info.cam_rmse,
                                   outlier_threshold)
            solver = LMSolver(data, options)
            outliers_removed = True
        else:
            break

    # every stage's info with one device->host transfer
    all_vecs = torch.stack([raw for _, raw, _ in pending]).cpu().numpy()
    stages_run = []
    total_iters = 0
    for (stage_name, _, wall), vec in zip(pending, all_vecs):
        info = materialize_info(vec)
        stages_run.append((stage_name, info.iterations, info.cost, wall))
        total_iters += info.iterations
        log.info("stage %-22s iters %3d cost %.6e rmse %s",
                 stage_name, info.iterations, info.cost, info.cam_rmse)
    mse = info.cost / max(info.n_residuals, 1)
    return StagedResult(state=state, info=info, stages_run=stages_run,
                        mse=mse, cam_rmse=info.cam_rmse,
                        total_iterations=total_iters)
