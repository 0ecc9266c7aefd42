"""Batched residuals and Jacobians for the calibration problem (torch).

- Reprojection: ``r = project(T_ck * T_wk^-1 * p_w) - p_c``, 2-D, one per
  observation.  The normal-equation blocks come from analytic geometry
  Jacobians; only the camera model's 2-D projection is differentiated, per
  point, with ``torch.func.jacfwd``.
- VI factor (SwitchedFullImuCostFunction, ceres-cost-functions.h:379-490):
  9-D per consecutive-frame pair, see imu.preintegrate.  One call of
  ``imu.factor.imu_factor`` evaluates every factor, with its Jacobian
  against the 33 tangent columns at zero increment by forward-mode duals,
  and every damping candidate's factors at once: the CUDA kernel on a
  CUDA state, its plain twin on a CPU state.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

from ..cameras import get_model
from ..geometry import se3, so3
from ..imu.factor import imu_factor
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
    """Per frame-pair IMU windows (see imu.buffer.build_windows).

    Factor k couples frames (frame_i[k], frame_i[k] + 1).  ``consecutive``:
    frame_i == arange(K) with K == n_frames - 1, which lets assembly place
    the blocks by shifted concatenation instead of index_add scatters."""
    win_times: torch.Tensor   # (K, M)
    win_gyro: torch.Tensor    # (K, M, 3)
    win_accel: torch.Tensor   # (K, M, 3)
    start: torch.Tensor       # (K,)
    end: torch.Tensor         # (K,)
    has_meas: torch.Tensor    # (K,) bool
    frame_i: torch.Tensor     # (K,) int64 — first frame of the pair
    consecutive: bool = False
    # seconds of raw-sample margin each window carries beyond [start, end]
    # (build_windows slack) — the searchable time-offset range
    slack: float = 0.0


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


def _reproj_jacobian(model, state: CalibState, cam: int, p_k, p_c, valid):
    """Residuals and tangent Jacobians of rows with rig-frame points p_k
    (..., 3): r (..., 2) valid-masked, p_cam (..., 3) and J (..., 2, k),
    columns [pose(6) | rot(3) | trans(3) | intr].

    Derivation (right-multiplicative retractions, tangent [u(3), w(3)]):
      T_wk' = T_wk exp([u, w])  =>  p_k = R_wk^T (p_w - t_wk) perturbs as
      dp_k = -u + p_k x w, so  dp_c/du = -R_ck,  dp_c/dw = R_ck hat(p_k).
      q_ck' = q_ck exp(w_c)     =>  dp_c/dw_c = -R_ck hat(p_k) = -dp_c/dw.
      dp_c/dp_ck = I.  With A = dpi/dp_c and B = A R_ck:
      J = [ -B | B hat(p_k) | -B hat(p_k) | A | dpi/dintr ].
    """
    n_intr = model.n_params
    intr = state.intr[cam][:n_intr]
    R_ck = so3.to_matrix(state.q_ck[cam])
    p_cam = p_k @ R_ck.transpose(0, 1) + state.p_ck[cam]
    r = (model.project(p_cam, intr) - p_c) * valid[..., None]
    # per-point projection Jacobians (the only autodiff left)
    lead = tuple(p_k.shape[:-1])
    pi_jac = vmap(jacfwd(model.project, argnums=(0, 1)), in_dims=(0, None))
    A, Ji = pi_jac(p_cam.reshape(-1, 3), intr)
    A = A.reshape(lead + (2, 3))
    Ji = Ji.reshape(lead + (2, n_intr))
    B = A @ R_ck                                              # dpi/dp_k
    px, py, pz = (p_k[..., i, None] for i in range(3))        # (..., 1)
    Bx, By, Bz = B[..., 0], B[..., 1], B[..., 2]              # (..., 2)
    # B @ hat(p_k): column c is B (p_k x e_c)
    BH = torch.stack([By * pz - Bz * py,
                      Bz * px - Bx * pz,
                      Bx * py - By * px], dim=-1)             # (..., 2, 3)
    return r, torch.cat([-B, BH, -BH, A, Ji], dim=-1)


def reproj_frame_gram_fast(state: CalibState, obs: CameraObs, cam: int,
                           model_name: str, col_mask, reproj_loss):
    """Analytic-geometry frame-major Gram assembly.

    Returns (s (F, P) raw squared errors, G (F, k+1, k+1)) where G's last
    row/column holds J^T r and the leading k x k block is the masked,
    robust-weighted J^T J, columns [pose(6) | rot(3) | trans(3) | intr]
    (see :func:`_reproj_jacobian`).
    """
    model = get_model(model_name)
    F = state.t_wk.shape[0]
    P = obs.points_per_frame
    pw_f, pc_f, valid_f = _frame_major(obs, F)
    k = 12 + model.n_params
    R_wk = so3.to_matrix(state.q_wk)
    p_k = (pw_f - state.t_wk[:, None, :]) @ R_wk              # (F, P, 3)
    r, J = _reproj_jacobian(model, state, cam, p_k, pc_f, valid_f)
    s = torch.sum(r * r, dim=-1)
    w = reproj_loss.weight(s) * valid_f                       # (F, P)
    J_aug = torch.cat([J * col_mask[:, None, None, :], r[..., None]],
                      dim=-1)                                 # (F,P,2,k+1)
    J_aug = (J_aug * w[..., None, None]).reshape(F, 2 * P, k + 1)
    G = J_aug.transpose(1, 2) @ J_aug                         # (F,k+1,k+1)
    return s, G


def reproj_residuals_and_jacobians(state: CalibState, obs: CameraObs,
                                   cam: int, model_name: str):
    """Residuals plus tangent Jacobians for one camera, in any row layout.

    Returns (r (N,2), J_pose (N,2,6), J_rot (N,2,3), J_trans (N,2,3),
    J_intr (N,2,Pc)), all valid-masked: the analytic geometry of
    :func:`_reproj_jacobian`, row by row.
    """
    model = get_model(model_name)
    fi = obs.frame_idx
    R_wk = so3.to_matrix(state.q_wk[fi])                      # (N, 3, 3)
    p_k = ((obs.p_w - state.t_wk[fi])[:, None, :] @ R_wk)[:, 0]
    r, J = _reproj_jacobian(model, state, cam, p_k, obs.p_c, obs.valid)
    J = J * obs.valid[:, None, None]
    return r, J[..., :6], J[..., 6:9], J[..., 9:12], J[..., 12:]


# ----------------------------------------------------------------- IMU factors
def _imu_factor(state: CalibState, imu: ImuFactors, weight_sqrt,
                rotation_only: bool, jac: bool, candidates: bool = False):
    """imu.factor.imu_factor on ``state`` (with a leading candidate
    dimension where ``candidates``): (r (C, K, 9), J (C, K, 9, 33) or
    None)."""
    xs = (state.q_wk, state.t_wk, state.v_w, state.g_dir, state.biases,
          state.scales, state.time_offset)
    if not candidates:
        xs = tuple(x[None] for x in xs)
    xs = tuple(x.contiguous() for x in xs)
    if weight_sqrt is not None:
        weight_sqrt = weight_sqrt.contiguous()
    return imu_factor(xs, imu.win_times, imu.win_gyro, imu.win_accel,
                      imu.start, imu.end, imu.has_meas, imu.frame_i,
                      weight_sqrt, rotation_only, jac)


def imu_residuals(state: CalibState, imu: ImuFactors, weight_sqrt,
                  rotation_only: bool):
    """(K, 9) residuals for all IMU factors; ``weight_sqrt`` (K, 9, 9)."""
    return _imu_factor(state, imu, weight_sqrt, rotation_only,
                       jac=False)[0][0]


def imu_trial_residuals(trial_b: CalibState, imu: ImuFactors, weight_sqrt,
                        rotation_only: bool):
    """(C, K, 9) residuals of a batched trial state's C candidates (every
    tensor of ``trial_b`` with a leading candidate dimension), in one
    evaluation."""
    return _imu_factor(trial_b, imu, weight_sqrt, rotation_only, jac=False,
                       candidates=True)[0]


def imu_residuals_and_jacobians(state: CalibState, imu: ImuFactors,
                                weight_sqrt, rotation_only: bool):
    """Residuals plus tangent Jacobians for all IMU factors.

    Returns (r (K,9), J1 (K,9,9), J2 (K,9,9), J_sh (K,9,15)) where the shared
    columns are [g(2), biases(6), scales(6), time_offset(1)].
    """
    r, J = _imu_factor(state, imu, weight_sqrt, rotation_only, jac=True)
    return r[0], J[0, ..., :9], J[0, ..., 9:18], J[0, ..., 18:]
