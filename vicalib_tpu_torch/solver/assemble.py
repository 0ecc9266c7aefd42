"""Normal-equation assembly into the structured arrow-plus-chain system.

The reference's analog is Ceres's Jacobian evaluation + normal-equations
construction; here each camera's frame-major Gram blocks
(residuals.reproj_frame_gram_fast) are placed straight into the frame
diagonal blocks, the frame-shared coupling and the shared block (see
schur.py).  IMU factors add to the frame diagonal and super-diagonal blocks
and to the 15 inertial shared columns: consecutive factors through one
(K, 34, 34) Gram placed by shifted concatenation, any other layout through
``index_add`` (segment sums over frame indices).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F_

from .problem import CalibState, SharedLayout
from .residuals import (ImuFactors, imu_residuals,
                        imu_residuals_and_jacobians, reproj_frame_gram_fast,
                        reproj_frame_sq, reproj_residuals)
from .robust import Cauchy, SoftL1


@dataclasses.dataclass
class ProblemData:
    """Problem inputs: observations grouped per camera + IMU windows."""
    obs: list                      # list[CameraObs], one per camera
    imu: ImuFactors | None
    layout: SharedLayout
    n_frames: int


def _seg_sum(x, idx, n):
    """Sum the rows of x into n segments by index (segment_sum)."""
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, idx, x)


def robust_costs(state: CalibState, data: ProblemData, weight_sqrt,
                 inertial_scale, rotation_only,
                 reproj_loss=SoftL1(0.5), imu_loss=Cauchy(100.0)):
    """Total robust cost (0.5 * sum rho(|r|^2), the Ceres convention) plus
    per-camera raw squared-error sums and observation counts for RMSE."""
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
    if data.imu is not None:
        r = imu_residuals(state, data.imu, weight_sqrt, rotation_only)
        r = r * inertial_scale
        s = torch.sum(r * r, dim=1)
        cost = cost + 0.5 * torch.sum(imu_loss.rho(s))
    return cost, torch.stack(cam_sq), torch.stack(cam_cnt)


def assemble(state: CalibState, data: ProblemData, weight_sqrt,
             frame_mask, shared_mask, inertial_scale, rotation_only,
             reproj_loss=SoftL1(0.5), imu_loss=Cauchy(100.0)):
    """Build the structured GN system at ``state``.

    Returns (D (F,9,9), U (F-1,9,9), Hfs (F,9,S), Hss (S,S), gf (F,9),
    gs (S,), cost, n_residuals).  ``inertial_scale`` is a 0/1 scalar
    gating the IMU terms; ``rotation_only`` (a Python bool) is the residual
    switch (vicalibrator.h:657-660).  Masked tangent coordinates get zeroed
    Jacobian columns and a unit diagonal, which pins their increments to
    exactly zero (the analog of SetParameterBlockConstant).
    """
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
    imu_stripe = torch.zeros((F, 9, 15), dtype=dtype, device=dev)
    if data.imu is not None:
        r, J1, J2, Jsh = imu_residuals_and_jacobians(
            state, data.imu, weight_sqrt, rotation_only)
        n_res = n_res + torch.sum(data.imu.has_meas.to(dtype))
        fi = data.imu.frame_i
        r = r * inertial_scale
        J1 = J1 * inertial_scale
        J2 = J2 * inertial_scale
        Jsh = Jsh * inertial_scale
        s = torch.sum(r * r, dim=1)
        cost = cost + 0.5 * torch.sum(imu_loss.rho(s))
        w = imu_loss.weight(s)
        r = r * w[:, None]
        J1 = J1 * w[:, None, None] * frame_mask[fi][:, None, :]
        J2 = J2 * w[:, None, None] * frame_mask[fi + 1][:, None, :]
        i0 = layout.g
        Jsh = Jsh * w[:, None, None] * shared_mask[None, None, i0:i0 + 15]

        if data.imu.consecutive and F > 1:
            # factor k couples frames (k, k+1): stack [J1 | J2 | Jsh | r]
            # (9+9+15+1 = 34 columns), read every block product out of one
            # (K, 34, 34) batched Gram, and accumulate into the frames by
            # shifted concatenation (no scatters)
            J_aug = torch.cat([J1, J2, Jsh, r[:, :, None]], dim=2)
            G = J_aug.transpose(1, 2) @ J_aug
            z199 = G.new_zeros((1, 9, 9))
            z19 = G.new_zeros((1, 9))
            z1915 = G.new_zeros((1, 9, 15))
            D = D + torch.cat([G[:, :9, :9], z199]) \
                + torch.cat([z199, G[:, 9:18, 9:18]])
            U = U + G[:, :9, 9:18]
            gf = gf + torch.cat([G[:, :9, -1], z19]) \
                + torch.cat([z19, G[:, 9:18, -1]])
            imu_stripe = (torch.cat([G[:, :9, 18:33], z1915])
                          + torch.cat([z1915, G[:, 9:18, 18:33]]))
            Gs = torch.sum(G, dim=0)
            Hss[i0:i0 + 15, i0:i0 + 15] += Gs[18:33, 18:33]
            gs[i0:i0 + 15] += Gs[18:33, -1]
        else:
            JtJ = lambda a, b: a.transpose(1, 2) @ b
            Jtr = lambda a: torch.einsum("kri,kr->ki", a, r)
            D = D + _seg_sum(JtJ(J1, J1), fi, F) \
                + _seg_sum(JtJ(J2, J2), fi + 1, F)
            if F > 1:
                U = U + _seg_sum(JtJ(J1, J2), fi, F - 1)
            gf = gf + _seg_sum(Jtr(J1), fi, F) + _seg_sum(Jtr(J2), fi + 1, F)
            imu_stripe = (_seg_sum(JtJ(J1, Jsh), fi, F)
                          + _seg_sum(JtJ(J2, Jsh), fi + 1, F))
            Hss[i0:i0 + 15, i0:i0 + 15] += torch.einsum(
                "kri,krj->ij", Jsh, Jsh)
            gs[i0:i0 + 15] += torch.einsum("kri,kr->i", Jsh, r)

    # column stripes: cameras left to right, then the 15 inertial columns
    # (SharedLayout is contiguous in exactly this order)
    stripes.append(imu_stripe)
    Hfs = torch.cat(stripes, dim=2)

    # pin masked coordinates: unit diagonal, zero gradient (already zero)
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    D = D + eye9[None] * (1.0 - frame_mask)[:, :, None] * eye9[None]
    Hss = Hss + torch.diag(1.0 - shared_mask)
    return D, U, Hfs, Hss, gf, gs, cost, n_res
