"""Batched residuals and Jacobians for the calibration problem (torch).

- Reprojection: ``r = project(T_ck * T_wk^-1 * p_w) - p_c``, 2-D, one per
  observation.  The normal-equation blocks come from analytic geometry
  Jacobians; only the camera model's 2-D projection is differentiated, per
  point, with ``torch.func.jacfwd``.
- VI factor (SwitchedFullImuCostFunction, ceres-cost-functions.h:379-490):
  9-D per consecutive-frame pair, see imu.preintegrate.  Its Jacobians are
  reverse-mode (``torch.func.jacrev``: 9 outputs against 33 tangent
  inputs) in the tangent space at zero increment, vmapped over factors.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, jacrev, vmap

from ..cameras import get_model
from ..geometry import se3, so3
from ..imu import preintegrate
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


# ----------------------------------------------------------------- IMU factors
def _imu_one(state: CalibState, k_pose1, k_pose2, win_t, win_g, win_a,
             start, end, has_meas, weight_sqrt, rotation_only,
             dx1, dx2, dx_g, dx_b, dx_sf, dx_t):
    """Single IMU factor residual with tangent increments applied."""
    q1, t1, v1 = k_pose1
    q2, t2, v2 = k_pose2
    T1 = se3.retract((q1, t1), dx1[:6])
    v1 = v1 + dx1[6:9]
    T2 = se3.retract((q2, t2), dx2[:6])
    v2 = v2 + dx2[6:9]
    b = state.biases + dx_b
    return preintegrate.imu_factor_residual(
        T1, v1, T2, v2, win_t, win_g, win_a, start, end,
        state.g_dir + dx_g, b[:3], b[3:], state.scales + dx_sf,
        state.time_offset + dx_t[0], has_meas, weight_sqrt=weight_sqrt,
        rotation_only=rotation_only)


def _imu_args(state: CalibState, imu: ImuFactors):
    fi = imu.frame_i
    pose1 = (state.q_wk[fi], state.t_wk[fi], state.v_w[fi])
    pose2 = (state.q_wk[fi + 1], state.t_wk[fi + 1], state.v_w[fi + 1])
    arrs = (imu.win_times, imu.win_gyro, imu.win_accel, imu.start, imu.end,
            imu.has_meas)
    return pose1, pose2, arrs


def _zero_increments(state):
    z = state.t_wk.new_zeros
    return z(9), z(9), z(2), z(6), z(6), z(1)


def imu_residuals(state: CalibState, imu: ImuFactors, weight_sqrt,
                  rotation_only: bool):
    """(K, 9) residuals for all IMU factors; ``weight_sqrt`` (K, 9, 9)."""
    pose1, pose2, arrs = _imu_args(state, imu)
    zeros = _zero_increments(state)

    def one(p1, p2, wt, wg, wa, s, e, h, W):
        return _imu_one(state, p1, p2, wt, wg, wa, s, e, h, W,
                        rotation_only, *zeros)

    return vmap(one)(pose1, pose2, *arrs, weight_sqrt)


def imu_residuals_and_jacobians(state: CalibState, imu: ImuFactors,
                                weight_sqrt, rotation_only: bool):
    """Residuals plus tangent Jacobians for all IMU factors.

    Returns (r (K,9), J1 (K,9,9), J2 (K,9,9), J_sh (K,9,15)) where the shared
    columns are [g(2), biases(6), scales(6), time_offset(1)].
    """
    pose1, pose2, arrs = _imu_args(state, imu)
    zeros = _zero_increments(state)

    def f(dx1, dx2, dxg, dxb, dxsf, dxt, p1, p2, wt, wg, wa, s, e, h, W):
        return _imu_one(state, p1, p2, wt, wg, wa, s, e, h, W,
                        rotation_only, dx1, dx2, dxg, dxb, dxsf, dxt)

    def f_aux(*a):
        r = f(*a)
        return r, r

    def one(p1, p2, wt, wg, wa, s, e, h, W):
        (J1, J2, Jg, Jb, Jsf, Jt), r = jacrev(
            f_aux, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
            *zeros, p1, p2, wt, wg, wa, s, e, h, W)
        return r, J1, J2, torch.cat([Jg, Jb, Jsf, Jt], dim=1)

    return vmap(one)(pose1, pose2, *arrs, weight_sqrt)
