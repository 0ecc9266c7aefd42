"""Calibration problem state, tangent-space layout, masks, and retraction.

The whole state is one NamedTuple of tensors:

- frame blocks: ``(F, 9)`` tangent each — SE3 pose (6, [trans, rot]) +
  world velocity (3).  Poses retract right-multiplicatively.
- one shared block of size ``S``: per camera [so3 extrinsic rot (3),
  extrinsic trans (3), intrinsics (n_params_c)], then gravity dir (2),
  biases (6), scale factors (6), time offset (1).

Stage control (which parameters are active) is data, not structure: masks
over tangent coordinates.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..cameras import MAX_PARAMS, get_model
from ..cameras.models import default_params_np
from ..geometry import se3, so3


class CalibState(NamedTuple):
    """All optimized parameters (a tuple of tensors)."""
    q_wk: torch.Tensor      # (F, 4) frame (rig) orientations, world-from-rig
    t_wk: torch.Tensor      # (F, 3) frame translations
    v_w: torch.Tensor       # (F, 3) frame world velocities
    q_ck: torch.Tensor      # (C, 4) rig->camera rotations
    p_ck: torch.Tensor      # (C, 3) rig->camera translations
    intr: torch.Tensor      # (C, MAX_PARAMS) padded intrinsics
    g_dir: torch.Tensor     # (2,) gravity direction angles
    biases: torch.Tensor    # (6,) [gyro(3), accel(3)]
    scales: torch.Tensor    # (6,) [gyro(3), accel(3)]
    time_offset: torch.Tensor  # () camera<->IMU time offset (s)


@dataclasses.dataclass(frozen=True)
class SharedLayout:
    """Static indexing of the shared tangent block (hashable)."""
    model_names: tuple               # per camera
    cam_rot: tuple                   # (C,) start index of extrinsic rot
    cam_trans: tuple                 # (C,)
    cam_intr: tuple                  # (C,)
    n_intr: tuple                    # (C,) model n_params
    g: int
    biases: int
    scales: int
    time_offset: int
    size: int

    @staticmethod
    def create(model_names: Sequence[str]) -> "SharedLayout":
        names = tuple(model_names)
        rot, trans, intr, nintr = [], [], [], []
        off = 0
        for name in names:
            n = get_model(name).n_params
            rot.append(off)
            trans.append(off + 3)
            intr.append(off + 6)
            nintr.append(n)
            off += 6 + n
        g = off
        biases = off + 2
        scales = off + 8
        toff = off + 14
        return SharedLayout(names, tuple(rot), tuple(trans),
                            tuple(intr), tuple(nintr),
                            g, biases, scales, toff, toff + 1)

    @property
    def n_cams(self):
        return len(self.model_names)

    def block_names(self):
        """(name, start, size) per parameter block, in tangent order — the
        labels the reference prints with its covariance log
        (GetSolutionCovariance, vicalibrator.h:802-857)."""
        blocks = []
        for c, name in enumerate(self.model_names):
            blocks.append((f"cam{c}.R_ck", self.cam_rot[c], 3))
            blocks.append((f"cam{c}.p_ck", self.cam_trans[c], 3))
            blocks.append((f"cam{c}.intrinsics[{name}]", self.cam_intr[c],
                           self.n_intr[c]))
        blocks.append(("gravity(2-angle)", self.g, 2))
        blocks.append(("gyro_bias", self.biases, 3))
        blocks.append(("accel_bias", self.biases + 3, 3))
        blocks.append(("gyro_scale", self.scales, 3))
        blocks.append(("accel_scale", self.scales + 3, 3))
        blocks.append(("time_offset", self.time_offset, 1))
        return blocks


@dataclasses.dataclass(frozen=True)
class StageFlags:
    """Which parts of the optimization are active — the reference's stage
    machine state (vicalibrator.h:241-259, 976-1031)."""
    visual_active: bool = True
    inertial_active: bool = False
    rotation_only: bool = True
    bias_active: bool = False
    scale_active: bool = False
    optimize_time_offset: bool = True
    fix_intrinsics: bool = False
    calibrate_imu: bool = False

    def evolve(self, **kw):
        return dataclasses.replace(self, **kw)


def frame_mask(flags: StageFlags, n_frames: int, dtype, device):
    """(F, 9) tangent mask: pose always active; velocities only once the
    translation/velocity rows of the IMU residual are live (otherwise they
    have no constraints and would make the system singular)."""
    vel_on = flags.inertial_active and not flags.rotation_only
    m = np.ones((n_frames, 9))
    if not vel_on:
        m[:, 6:9] = 0.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def shared_mask(layout: SharedLayout, flags: StageFlags, dtype, device):
    """(S,) tangent mask:

    - camera 0 extrinsics: constant unless inertial stage (gauge fixing);
      in the inertial rotation-only stage the rotation is free but the
      translation stays constant
    - intrinsics free unless fix_intrinsics
    - g constant in the rotation-only stage
    - biases / scale factors / time offset per their stage flags; none of
      the IMU parameters are active before the inertial stage.
    """
    m = np.zeros(layout.size)
    C = layout.n_cams
    for c in range(C):
        free_rot = free_trans = True
        if c == 0:
            if not flags.inertial_active:
                free_rot = free_trans = False
            elif flags.rotation_only:
                free_trans = False
        if free_rot:
            m[layout.cam_rot[c]:layout.cam_rot[c] + 3] = 1.0
        if free_trans:
            m[layout.cam_trans[c]:layout.cam_trans[c] + 3] = 1.0
        if not flags.fix_intrinsics:
            m[layout.cam_intr[c]:layout.cam_intr[c] + layout.n_intr[c]] = 1.0
    if flags.calibrate_imu and flags.inertial_active:
        if not flags.rotation_only:
            m[layout.g:layout.g + 2] = 1.0
        if flags.bias_active:
            m[layout.biases:layout.biases + 6] = 1.0
        if flags.scale_active:
            m[layout.scales:layout.scales + 6] = 1.0
        if flags.optimize_time_offset:
            m[layout.time_offset] = 1.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def retract(state: CalibState, layout: SharedLayout, dx_f, dx_s) -> CalibState:
    """Apply masked tangent increments: frames (F,9) and shared (S,).

    Pose and extrinsic-rotation blocks use right-multiplicative exp
    retraction; everything else is additive.
    """
    q_wk, t_wk = se3.retract((state.q_wk, state.t_wk), dx_f[:, :6])
    v_w = state.v_w + dx_f[:, 6:9]

    q_ck, p_ck, intr = [], [], []
    for c in range(layout.n_cams):
        r0 = layout.cam_rot[c]
        dq = so3.exp(dx_s[r0:r0 + 3])
        q_ck.append(so3.quat_mul(state.q_ck[c], dq))
        t0 = layout.cam_trans[c]
        p_ck.append(state.p_ck[c] + dx_s[t0:t0 + 3])
        i0 = layout.cam_intr[c]
        n = int(layout.n_intr[c])
        di = torch.cat([dx_s[i0:i0 + n],
                        dx_s.new_zeros(MAX_PARAMS - n)])
        intr.append(state.intr[c] + di)

    return CalibState(
        q_wk=q_wk, t_wk=t_wk, v_w=v_w,
        q_ck=torch.stack(q_ck), p_ck=torch.stack(p_ck),
        intr=torch.stack(intr),
        g_dir=state.g_dir + dx_s[layout.g:layout.g + 2],
        biases=state.biases + dx_s[layout.biases:layout.biases + 6],
        scales=state.scales + dx_s[layout.scales:layout.scales + 6],
        time_offset=state.time_offset + dx_s[layout.time_offset],
    )


def init_state(n_frames, model_names, widths, heights, dtype, device,
               intr0=None, T_ck0=None) -> CalibState:
    """Starting state: frames at the reference's placeholder pose
    (SE3(I, [0,0,1000])), default intrinsics, identity extrinsics, zero
    biases / unit scales.  Built in numpy, one upload per field."""
    F = n_frames
    C = len(model_names)
    q_wk = np.tile(np.array([0., 0., 0., 1.]), (F, 1))
    t_wk = np.tile(np.array([0., 0., 1000.]), (F, 1))
    intr = []
    for c, name in enumerate(model_names):
        if intr0 is not None and intr0[c] is not None:
            p = np.asarray(intr0[c], dtype=np.float64)
        else:
            p = default_params_np(name, widths[c], heights[c])
        intr.append(np.concatenate([p, np.zeros(MAX_PARAMS - p.shape[0])]))
    if T_ck0 is None:
        q_ck = np.tile(np.array([0., 0., 0., 1.]), (C, 1))
        p_ck = np.zeros((C, 3))
    else:
        q_ck = np.stack([np.asarray(q) for q, _ in T_ck0])
        p_ck = np.stack([np.asarray(t) for _, t in T_ck0])

    def T(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                               device=device)

    return CalibState(
        q_wk=T(q_wk), t_wk=T(t_wk), v_w=T(np.zeros((F, 3))),
        q_ck=T(q_ck), p_ck=T(p_ck), intr=T(np.stack(intr)),
        g_dir=T(np.zeros(2)), biases=T(np.zeros(6)), scales=T(np.ones(6)),
        time_offset=T(0.0),
    )
