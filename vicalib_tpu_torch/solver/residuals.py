"""Batched reprojection residuals and the per-frame Gram assembly (torch).

Reprojection: ``r = project(T_ck * T_wk^-1 * p_w) - p_c``, 2-D, one per
observation.  The normal-equation blocks come from analytic geometry
Jacobians; only the camera model's 2-D projection is differentiated, per
point, with ``torch.func.jacfwd``.

Only the camera half is ported: an IMU factor given to the port raises
NotImplementedError (ROADMAP, queue 1: the IMU path).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

from ..cameras import get_model
from ..geometry import se3, so3
from .problem import CalibState


@dataclasses.dataclass
class CameraObs:
    """Observations for one camera (static shapes; invalid rows masked).

    ``points_per_frame``: when the rows are laid out as frame-major blocks
    of exactly P rows per frame (frame_idx == repeat(arange(F), P), the
    layout build_problem produces), assembly reduces with batched per-frame
    products.  None marks any other layout."""
    frame_idx: torch.Tensor   # (N,) int64
    p_w: torch.Tensor         # (N, 3) target points (world frame)
    p_c: torch.Tensor         # (N, 2) measured pixels
    valid: torch.Tensor       # (N,) float (0/1)
    points_per_frame: int = None


@dataclasses.dataclass
class ImuFactors:
    """Per frame-pair IMU windows.  The type exists so problems keep the
    reference's shape; the IMU path is not ported yet."""
    win_times: torch.Tensor
    win_gyro: torch.Tensor
    win_accel: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    has_meas: torch.Tensor
    frame_i: torch.Tensor
    consecutive: bool = False
    slack: float = 0.0


def imu_not_ported():
    raise NotImplementedError(
        "IMU factors are not ported yet; see ROADMAP.md queue 1 (the IMU "
        "path: imu/preintegrate, solver/weights and the IMU halves of "
        "residuals/assemble/build)")


def reproj_residuals(state: CalibState, obs: CameraObs, cam: int,
                     model_name: str):
    """(N, 2) residuals for one camera (valid-masked)."""
    model = get_model(model_name)
    fi = obs.frame_idx
    T_kw = se3.inverse((state.q_wk[fi], state.t_wk[fi]))
    p_cam = se3.transform((state.q_ck[cam], state.p_ck[cam]),
                          se3.transform(T_kw, obs.p_w))
    r = model.project(p_cam, state.intr[cam][:model.n_params]) - obs.p_c
    return r * obs.valid[:, None]


def _frame_major(obs: CameraObs, F: int):
    P = obs.points_per_frame
    return (obs.p_w.reshape(F, P, 3), obs.p_c.reshape(F, P, 2),
            obs.valid.reshape(F, P))


def reproj_frame_sq(state: CalibState, obs: CameraObs, cam: int,
                    model_name: str):
    """(F, P) masked squared reprojection errors — frame-major primal, the
    cost-only evaluation the LM loop runs per damping candidate."""
    model = get_model(model_name)
    F = state.t_wk.shape[0]
    pw_f, pc_f, valid_f = _frame_major(obs, F)
    intr = state.intr[cam][:model.n_params]
    R_ck = so3.to_matrix(state.q_ck[cam])
    R_wk = so3.to_matrix(state.q_wk)                          # (F, 3, 3)
    p_k = (pw_f - state.t_wk[:, None, :]) @ R_wk              # R_wk^T(pw-tw)
    p_cam = p_k @ R_ck.transpose(0, 1) + state.p_ck[cam]
    r = (model.project(p_cam, intr) - pc_f) * valid_f[..., None]
    return torch.sum(r * r, dim=-1)


def reproj_frame_gram_fast(state: CalibState, obs: CameraObs, cam: int,
                           model_name: str, col_mask, reproj_loss):
    """Analytic-geometry frame-major Gram assembly.

    Returns (s (F, P) raw squared errors, G (F, k+1, k+1)) where G's last
    row/column holds J^T r and the leading k x k block is the masked,
    robust-weighted J^T J, columns [pose(6) | rot(3) | trans(3) | intr].

    Derivation (right-multiplicative retractions, tangent [u(3), w(3)]):
      T_wk' = T_wk exp([u, w])  =>  p_k = R_wk^T (p_w - t_wk) perturbs as
      dp_k = -u + p_k x w, so  dp_c/du = -R_ck,  dp_c/dw = R_ck hat(p_k).
      q_ck' = q_ck exp(w_c)     =>  dp_c/dw_c = -R_ck hat(p_k) = -dp_c/dw.
      dp_c/dp_ck = I.  With A = dpi/dp_c and B = A R_ck:
      J = [ -B | B hat(p_k) | -B hat(p_k) | A | dpi/dintr ].
    """
    model = get_model(model_name)
    n_intr = model.n_params
    F = state.t_wk.shape[0]
    P = obs.points_per_frame
    pw_f, pc_f, valid_f = _frame_major(obs, F)
    k = 12 + n_intr
    intr = state.intr[cam][:n_intr]
    R_ck = so3.to_matrix(state.q_ck[cam])
    R_wk = so3.to_matrix(state.q_wk)
    p_k = (pw_f - state.t_wk[:, None, :]) @ R_wk              # (F, P, 3)
    p_cam = p_k @ R_ck.transpose(0, 1) + state.p_ck[cam]
    r = (model.project(p_cam, intr) - pc_f) * valid_f[..., None]
    s = torch.sum(r * r, dim=-1)
    w = reproj_loss.weight(s) * valid_f                       # (F, P)

    # per-point projection Jacobians (the only autodiff left)
    pi_jac = vmap(jacfwd(model.project, argnums=(0, 1)), in_dims=(0, None))
    A, Ji = pi_jac(p_cam.reshape(F * P, 3), intr)
    A = A.reshape(F, P, 2, 3)
    Ji = Ji.reshape(F, P, 2, n_intr)
    B = A @ R_ck                                              # dpi/dp_k
    px, py, pz = (p_k[..., i, None] for i in range(3))        # (F, P, 1)
    Bx, By, Bz = B[..., 0], B[..., 1], B[..., 2]              # (F, P, 2)
    # B @ hat(p_k): column c is B (p_k x e_c)
    BH = torch.stack([By * pz - Bz * py,
                      Bz * px - Bx * pz,
                      Bx * py - By * px], dim=-1)             # (F, P, 2, 3)
    J = torch.cat([-B, BH, -BH, A, Ji], dim=-1)               # (F, P, 2, k)
    J_aug = torch.cat([J * col_mask[:, None, None, :], r[..., None]],
                      dim=-1)                                 # (F,P,2,k+1)
    J_aug = (J_aug * w[..., None, None]).reshape(F, 2 * P, k + 1)
    G = J_aug.transpose(1, 2) @ J_aug                         # (F,k+1,k+1)
    return s, G
