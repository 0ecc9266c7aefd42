"""Normal-equation assembly into the structured arrow-plus-chain system.

The reference's analog is Ceres's Jacobian evaluation + normal-equations
construction; here each camera's frame-major Gram blocks
(residuals.reproj_frame_gram_fast) are placed straight into the frame
diagonal blocks, the frame-shared coupling and the shared block (see
schur.py).  The camera path only: IMU factors are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F_

from .problem import CalibState, SharedLayout
from .residuals import (ImuFactors, imu_not_ported, reproj_frame_gram_fast,
                        reproj_frame_sq, reproj_residuals)
from .robust import Cauchy, SoftL1


@dataclasses.dataclass
class ProblemData:
    """Problem inputs: observations grouped per camera (+ IMU windows, not
    ported yet, so always None here)."""
    obs: list                      # list[CameraObs], one per camera
    imu: ImuFactors | None
    layout: SharedLayout
    n_frames: int


def robust_costs(state: CalibState, data: ProblemData, weight_sqrt,
                 inertial_scale, rotation_only,
                 reproj_loss=SoftL1(0.5), imu_loss=Cauchy(100.0)):
    """Total robust cost (0.5 * sum rho(|r|^2), the Ceres convention) plus
    per-camera raw squared-error sums and observation counts for RMSE."""
    if data.imu is not None:
        imu_not_ported()
    cost = state.t_wk.new_zeros(())
    cam_sq, cam_cnt = [], []
    for c, obs in enumerate(data.obs):
        name = data.layout.model_names[c]
        if obs.points_per_frame is not None:
            s = reproj_frame_sq(state, obs, c, name).reshape(-1)
        else:
            r = reproj_residuals(state, obs, c, name)
            s = torch.sum(r * r, dim=1)
        cost = cost + 0.5 * torch.sum(reproj_loss.rho(s))
        cam_sq.append(torch.sum(s))
        cam_cnt.append(torch.sum(obs.valid))
    return cost, torch.stack(cam_sq), torch.stack(cam_cnt)


def assemble(state: CalibState, data: ProblemData, weight_sqrt,
             frame_mask, shared_mask, inertial_scale, rotation_only,
             reproj_loss=SoftL1(0.5), imu_loss=Cauchy(100.0)):
    """Build the structured GN system at ``state``.

    Returns (D (F,9,9), U (F-1,9,9), Hfs (F,9,S), Hss (S,S), gf (F,9),
    gs (S,), cost, n_residuals).  Masked tangent coordinates get zeroed
    Jacobian columns and a unit diagonal, which pins their increments to
    exactly zero (the analog of SetParameterBlockConstant).
    """
    if data.imu is not None:
        imu_not_ported()
    layout = data.layout
    F = data.n_frames
    S = layout.size
    dtype = state.t_wk.dtype
    dev = state.t_wk.device

    D = torch.zeros((F, 9, 9), dtype=dtype, device=dev)
    U = torch.zeros((max(F - 1, 1), 9, 9), dtype=dtype, device=dev)
    Hss = torch.zeros((S, S), dtype=dtype, device=dev)
    gf = torch.zeros((F, 9), dtype=dtype, device=dev)
    gs = torch.zeros((S,), dtype=dtype, device=dev)
    cost = torch.zeros((), dtype=dtype, device=dev)
    n_res = torch.zeros((), dtype=dtype, device=dev)
    stripes = []
    for c, obs in enumerate(data.obs):
        c0 = int(layout.cam_rot[c])
        ncols = 6 + int(layout.n_intr[c])
        if obs.points_per_frame is None:
            raise NotImplementedError(
                "assembly takes frame-major observations (points_per_frame "
                "set, as build_problem makes them)")
        col_mask = torch.cat(
            [frame_mask[:, :6],
             shared_mask[c0:c0 + ncols].expand(F, ncols)], dim=1)
        s, G = reproj_frame_gram_fast(state, obs, c, layout.model_names[c],
                                      col_mask, reproj_loss)
        n_res = n_res + torch.sum(obs.valid)
        cost = cost + 0.5 * torch.sum(reproj_loss.rho(s))
        D = D + F_.pad(G[:, :6, :6], (0, 3, 0, 3))
        gf = gf + F_.pad(G[:, :6, -1], (0, 3))
        stripes.append(F_.pad(G[:, :6, 6:6 + ncols], (0, 0, 0, 3)))
        Gs = torch.sum(G, dim=0)
        Hss[c0:c0 + ncols, c0:c0 + ncols] += Gs[6:6 + ncols, 6:6 + ncols]
        gs[c0:c0 + ncols] += Gs[6:6 + ncols, -1]
    # column stripes: cameras left to right, then the 15 inertial columns
    # (SharedLayout is contiguous in exactly this order)
    stripes.append(torch.zeros((F, 9, 15), dtype=dtype, device=dev))
    Hfs = torch.cat(stripes, dim=2)

    # pin masked coordinates: unit diagonal, zero gradient (already zero)
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    D = D + eye9[None] * (1.0 - frame_mask)[:, :, None] * eye9[None]
    Hss = Hss + torch.diag(1.0 - shared_mask)
    return D, U, Hfs, Hss, gf, gs, cost, n_res
