"""Visual-inertial sequence simulator (torch).

Generates, from analytic smooth trajectories, target-point observations per
camera per frame and IMU streams with biases/scale factors/gravity/time
offset baked in, plus the ground truth to validate against; and renders the
dot target as grayscale frames for the detection pipeline.

Conventions (matching solver/residuals.py):

- ``T_wk``: rig (IMU) pose, world-from-rig.  Reprojection uses
  ``p_cam = T_ck * T_wk^-1 * p_world``.
- gravity ``g_w = -g * (cos(p)sin(q), -sin(p), cos(p)cos(q))``, g = 9.8007.
- IMU model: ``omega_world = R (z_g * sf_g + b_g)``,
  ``a_world = R (z_a * sf_a + b_a) - g_w`` (additive bias convention).
- time offset: recorded IMU stamps are ``t_true - time_offset``.

Randomness comes from numpy generators (seeded by the config), so the
output is reproducible and equal to the JAX package's sim.  Trajectory
derivatives use ``torch.func.jacfwd``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..cameras.models import default_params_np, get_model
from ..device import resolve_device
from ..geometry import quat_np, se3, so3
from ..targets.grid import TargetGrid, make_target

GRAVITY_MAG = 9.8007  # m/s^2


def gravity_vector(g_dir, mag=GRAVITY_MAG):
    """2-angle gravity direction -> 3-vector."""
    p, q = g_dir[..., 0], g_dir[..., 1]
    sp, cp = torch.sin(p), torch.cos(p)
    sq, cq = torch.sin(q), torch.cos(q)
    return -mag * torch.stack([cp * sq, -sp, cp * cq], dim=-1)


# RDF permutation vision<-robotics; the ground-truth T_ck for a
# robotics-convention rig.
RDF_ROBOTICS_T_CK = np.array([
    [0.0, 1.0, 0.0],
    [0.0, 0.0, 1.0],
    [1.0, 0.0, 0.0],
])


@dataclasses.dataclass
class SimRigCamera:
    model: str                    # camera model name
    params: np.ndarray            # true intrinsics
    T_ck: tuple                   # true rig->camera pose (q, t)
    width: int = 800
    height: int = 600


@dataclasses.dataclass
class SimConfig:
    cameras: Sequence[SimRigCamera]
    target: TargetGrid
    n_frames: int = 80
    frame_rate: float = 10.0
    imu_rate: float = 200.0
    gyro_bias: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    accel_bias: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    gyro_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3))
    accel_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3))
    g_dir: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.15, -0.1]))
    time_offset: float = 0.0
    pixel_noise: float = 0.0
    gyro_noise: float = 0.0
    accel_noise: float = 0.0
    seed: int = 0
    orbit_radius: float = 0.35
    distance: float = 0.55
    wobble: float = 0.25


@dataclasses.dataclass
class SimData:
    config: SimConfig
    frame_times: np.ndarray          # (F,) image-clock timestamps
    T_wk: tuple                      # true rig poses ((F,4), (F,3))
    v_w: np.ndarray                  # (F,3) true world velocities
    pixels: np.ndarray               # (C, F, P, 2) projected grid points
    visible: np.ndarray              # (C, F, P) bool
    imu_times: np.ndarray            # (M,) recorded (offset-shifted) stamps
    gyro: np.ndarray                 # (M, 3)
    accel: np.ndarray                # (M, 3)
    points_3d: np.ndarray            # (P, 3) target circle centers


def _camera_trajectory(cfg: SimConfig, center):
    """Smooth analytic camera-0 world pose as a function of time t (a 0-d
    tensor): an orbit above the target plane looking at a slowly moving
    point on it, with a sinusoidal roll."""
    r = cfg.orbit_radius
    d = cfg.distance
    w = cfg.wobble

    def pos(t):
        return center + torch.stack([
            r * torch.sin(0.9 * t) + 0.08 * torch.sin(2.3 * t),
            r * 0.8 * torch.sin(0.7 * t + 1.0)
            + 0.06 * torch.sin(1.9 * t + 0.5),
            d + 0.12 * torch.sin(1.3 * t + 0.3),
        ])

    def look_target(t):
        return center + torch.stack([
            0.05 * torch.sin(1.1 * t + 0.7),
            0.05 * torch.sin(0.8 * t + 0.2),
            0.0 * t,
        ])

    def pose(t):
        p = pos(t)
        fwd = look_target(t) - p           # camera z points at the target
        fwd = fwd / torch.linalg.norm(fwd)
        up_hint = torch.stack([torch.sin(w * torch.sin(0.6 * t)),
                               -torch.cos(w * torch.sin(0.6 * t)),
                               0.0 * t])   # roll wobble
        right = so3.cross(-up_hint, fwd)
        right = right / torch.linalg.norm(right)
        down = so3.cross(fwd, right)
        R_wc = torch.stack([right, down, fwd], dim=1)  # columns = cam axes
        q = so3.from_matrix(R_wc)
        return q, p

    return pose


def simulate(cfg: SimConfig, device) -> SimData:
    """Simulate the sequence on ``device`` in float64; numpy outputs."""
    dev = resolve_device(device)
    f64 = torch.float64

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=f64, device=dev)

    rng = np.random.default_rng(cfg.seed)
    target = cfg.target
    points = T(target.circles_3d())
    center = T([(target.cols - 1) / 2.0 * target.spacing,
                (target.rows - 1) / 2.0 * target.spacing, 0.0])

    cam_pose_fn = _camera_trajectory(cfg, center)
    T_ck0 = (T(cfg.cameras[0].T_ck[0]), T(cfg.cameras[0].T_ck[1]))

    def rig_pose(t):
        # T_wk = T_wc0 * T_ck0  (reprojection: p_c = T_ck * T_wk^-1 * p_w)
        return se3.mul(cam_pose_fn(t), T_ck0)

    def rig_pose_flat(t):
        q, p = rig_pose(t)
        return torch.cat([q, p])

    d_pose = jacfwd(rig_pose_flat)
    dd_pos = jacfwd(lambda t: d_pose(t)[4:7])

    g_w = gravity_vector(T(cfg.g_dir))
    bg = T(cfg.gyro_bias)
    ba = T(cfg.accel_bias)
    sfg = T(cfg.gyro_scale)
    sfa = T(cfg.accel_scale)

    def imu_sample(t):
        q, _ = rig_pose(t)
        d = d_pose(t)
        qdot = d[:4]
        a_w = dd_pos(t)
        # omega_world from qdot: q(t+dt) = exp(w dt) * q => w = 2 Im(qdot q^-1)
        wq = so3.quat_mul(qdot, so3.inverse(q))
        omega_w = 2.0 * wq[:3]
        # invert the measurement model
        z_g = (so3.rotate(so3.inverse(q), omega_w) - bg) / sfg
        z_a = (so3.rotate(so3.inverse(q), a_w + g_w) - ba) / sfa
        return z_g, z_a

    duration = cfg.n_frames / cfg.frame_rate
    frame_times = np.arange(cfg.n_frames) / cfg.frame_rate + 0.1
    imu_t_true = np.arange(-0.05, duration + 0.35, 1.0 / cfg.imu_rate)

    (qf, pf), vf = vmap(lambda t: (rig_pose(t), d_pose(t)[4:7]))(
        T(frame_times))
    z_g, z_a = vmap(imu_sample)(T(imu_t_true))
    z_g = z_g.cpu().numpy()
    z_a = z_a.cpu().numpy()
    z_g = z_g + rng.normal(size=z_g.shape) * cfg.gyro_noise
    z_a = z_a + rng.normal(size=z_a.shape) * cfg.accel_noise

    # project through every camera
    all_pix, all_vis = [], []
    q_kw, t_kw = se3.inverse((qf, pf))
    for cam in cfg.cameras:
        model = get_model(cam.model)
        params = T(cam.params)
        T_ck = (T(cam.T_ck[0]), T(cam.T_ck[1]))
        p_k = se3.transform((q_kw[:, None], t_kw[:, None]), points[None])
        p_c = se3.transform(T_ck, p_k)
        pix = model.project(p_c, params)
        vis = ((p_c[..., 2] > 0.05) & (pix[..., 0] >= 0)
               & (pix[..., 0] <= cam.width - 1)
               & (pix[..., 1] >= 0) & (pix[..., 1] <= cam.height - 1))
        pix = pix.cpu().numpy()
        if cfg.pixel_noise > 0:
            pix = pix + rng.normal(size=pix.shape) * cfg.pixel_noise
        all_pix.append(pix)
        all_vis.append(vis.cpu().numpy())

    return SimData(
        config=cfg,
        frame_times=frame_times,
        T_wk=(qf.cpu().numpy(), pf.cpu().numpy()),
        v_w=vf.cpu().numpy(),
        pixels=np.stack(all_pix),
        visible=np.stack(all_vis),
        imu_times=imu_t_true - cfg.time_offset,
        gyro=z_g,
        accel=z_a,
        points_3d=points.cpu().numpy(),
    )


def default_stereo_vi_config(n_frames=80, model="linear",
                             time_offset=0.0, **kw) -> SimConfig:
    """A stereo VI rig mirroring the vi_sim fixture's geometry."""
    q_rdf = quat_np.from_matrix(RDF_ROBOTICS_T_CK)
    init = default_params_np(model)
    cams = [
        SimRigCamera(model=model, params=init.copy(),
                     T_ck=(q_rdf, np.zeros(3))),
        SimRigCamera(model=model, params=init.copy(),
                     T_ck=(q_rdf, np.array([0.0, -0.12, 0.0]))),
    ]
    cams[0].params[:] = [335.639853151, 335.639853151, 400.0, 300.0] + \
        [0.0] * (len(cams[0].params) - 4)
    cams[1].params[:] = [338.2, 337.1, 398.5, 302.5] + \
        [0.0] * (len(cams[1].params) - 4)
    return SimConfig(cameras=cams, target=make_target(),
                     n_frames=n_frames, time_offset=time_offset, **kw)


def default_multicam_vi_config(n_cams=4, n_frames=160, model="linear",
                               time_offset=0.0, **kw) -> SimConfig:
    """An n-camera VI rig: camera 0 at the RDF permutation from the IMU,
    the others offset/rotated slightly with distinct intrinsics."""
    rng = np.random.default_rng(1234)
    q_rdf = quat_np.from_matrix(RDF_ROBOTICS_T_CK)
    cams = []
    for c in range(n_cams):
        params = default_params_np(model)
        params[:4] = [335.64 + 2.1 * c, 335.64 + 1.3 * c,
                      400.0 - 1.5 * c, 300.0 + 1.1 * c]
        if c == 0:
            T_ck = (q_rdf.copy(), np.zeros(3))
        else:
            dq = quat_np.exp(rng.normal(size=3) * 0.02)
            off = rng.normal(size=3) * 0.06
            T_ck = (quat_np.quat_mul(q_rdf, dq), off)
        cams.append(SimRigCamera(model=model, params=params, T_ck=T_ck))
    return SimConfig(cameras=cams, target=make_target(),
                     n_frames=n_frames, time_offset=time_offset, **kw)


def default_mono_config(n_frames=60, model="poly2", imu=False,
                        **kw) -> SimConfig:
    params = default_params_np(model)
    params[:4] = [335.639853151, 335.639853151, 400.0, 300.0]
    if model == "poly2":
        params[4:6] = [-0.12, 0.03]
    elif model == "poly3":
        params[4:7] = [-0.12, 0.03, -0.004]
    elif model == "kb4":
        params[4:8] = [-0.04, 0.01, -0.002, 0.0004]
    elif model == "fov":
        params[4] = 0.85
    if imu:
        T_ck = (quat_np.from_matrix(RDF_ROBOTICS_T_CK), np.zeros(3))
    else:
        T_ck = (np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))
    cam = SimRigCamera(model=model, params=params, T_ck=T_ck)
    return SimConfig(cameras=[cam], target=make_target(), n_frames=n_frames,
                     **kw)


def render_frames(data: SimData, cam: int = 0, width=None, height=None,
                  supersample_edge=1.0, *, device, pixel_chunk=1 << 16):
    """Render grayscale frames of the dot target on ``device`` (float64).

    Inverse mapping: each pixel is unprojected through the true camera
    model, intersected with the target plane (z = 0) and shaded by its
    distance to the nearest dot, with a smooth edge about one pixel wide.
    The ray rotation is a quaternion rotate (cross products), never a
    reduced-precision matmul.

    Returns (F, H, W) uint8 numpy (white background, dark dots).
    """
    dev = resolve_device(device)
    f64 = torch.float64
    cfg = data.config
    camera = cfg.cameras[cam]
    W = width or camera.width
    H = height or camera.height
    model = get_model(camera.model)
    params = torch.as_tensor(np.asarray(camera.params), dtype=f64,
                             device=dev)
    target = cfg.target
    dots_xy = torch.as_tensor(target.circles_3d()[:, :2], dtype=f64,
                              device=dev)
    radii = torch.as_tensor(target.radii(), dtype=f64, device=dev)

    T_ck = (torch.as_tensor(np.asarray(camera.T_ck[0]), dtype=f64,
                            device=dev),
            torch.as_tensor(np.asarray(camera.T_ck[1]), dtype=f64,
                            device=dev))
    qf = torch.as_tensor(data.T_wk[0], dtype=f64, device=dev)
    tf = torch.as_tensor(data.T_wk[1], dtype=f64, device=dev)

    vs, us = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    pix = torch.stack([us.reshape(-1), vs.reshape(-1)], dim=1)   # (HW, 2)
    rays = model.unproject(pix, params)                          # (HW, 3)

    frames = []
    for k in range(qf.shape[0]):
        # camera pose: T_wc = T_wk * T_ck^-1
        q_wc, o = se3.mul((qf[k], tf[k]), se3.inverse(T_ck))
        d = so3.rotate(q_wc, rays)                               # (HW, 3)
        dz = torch.where(torch.abs(d[:, 2]) < 1e-9,
                         torch.full_like(d[:, 2], 1e-9), d[:, 2])
        tplane = -o[2] / dz
        pt = o[None, :2] + tplane[:, None] * d[:, :2]            # (HW, 2)
        # pixel footprint on the plane ~ z / f
        foot = torch.abs(tplane) * torch.linalg.norm(
            d[:, :2] * 0 + 1.0, dim=-1) / params[0]
        edge = torch.clamp(foot, min=1e-6) * supersample_edge
        cov = torch.empty(pt.shape[0], dtype=f64, device=dev)
        for s in range(0, pt.shape[0], pixel_chunk):
            p = pt[s:s + pixel_chunk]
            e = edge[s:s + pixel_chunk]
            dist = torch.sqrt(torch.sum(
                (p[:, None, :] - dots_xy[None, :, :]) ** 2, dim=2))
            c = torch.sigmoid((radii[None, :] - dist) / (e[:, None] * 0.5))
            cov[s:s + pixel_chunk] = torch.amax(c, dim=1)
        cov = torch.where(tplane > 0, cov, torch.zeros_like(cov))
        img = 255.0 * (1.0 - 0.87 * cov)
        frames.append(img.reshape(H, W).to(torch.uint8))
    return torch.stack(frames).cpu().numpy()
