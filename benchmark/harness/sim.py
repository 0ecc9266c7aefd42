"""Frozen simulator and renderer of the benchmark's rigs (plain torch+numpy).

A copy of ``vicalib_tpu_torch/io/sim.py`` and of the geometry, camera
models and target grids it needs, taken so that no later change to the
program can move the benchmark's inputs or its ground truth.  It imports
nothing of the program.

Conventions (those of the program's solver):

- ``T_wk``: rig (IMU) pose, world-from-rig; a point reprojects as
  ``p_cam = T_ck * T_wk^-1 * p_world``.  The world frame is the target's.
- quaternions are xyzw; a pose is ``(q, t)``.
- gravity ``g_w = -g * (cos(p)sin(q), -sin(p), cos(p)cos(q))``, g = 9.8007.
- IMU model: ``omega_world = R (z_g * sf_g + b_g)``,
  ``a_world = R (z_a * sf_a + b_a) - g_w``.
- time offset: recorded IMU stamps are ``t_true - time_offset``.

The seed draws only sensor noise: white noise on every IMU sample (numpy)
and on every pixel (a ``torch.Generator`` on the rendering device).  The
trajectory, the rig and the frame count are the configuration's, so every
seed asks the program for the same work.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

GRAVITY_MAG = 9.8007
# vision (RDF) axes from the robotics (FLU-like) rig axes
RDF_ROBOTICS = np.array([[0.0, 1.0, 0.0],
                         [0.0, 0.0, 1.0],
                         [1.0, 0.0, 0.0]])


# ------------------------------------------------------------- quaternions
def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def quat_inv(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def rotate(q, v):
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_from_matrix(R):
    """Unit quaternion of a rotation matrix (branch-free Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def sq(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    w0 = sq(1.0 + tr) / 2.0
    q0 = torch.stack([(m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                      (m10 - m01) / (4 * w0), w0], dim=-1)
    x1 = sq(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1),
                      (m21 - m12) / (4 * x1)], dim=-1)
    y2 = sq(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2),
                      (m02 - m20) / (4 * y2)], dim=-1)
    z3 = sq(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3,
                      (m10 - m01) / (4 * z3)], dim=-1)
    piv = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                       -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(piv, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(idx.shape + (1, 4)))
    q = q[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def se3_mul(a, b):
    return quat_mul(a[0], b[0]), rotate(a[0], b[1]) + a[1]


def se3_inv(a):
    qi = quat_inv(a[0])
    return qi, -rotate(qi, a[1])


def se3_apply(a, p):
    return rotate(a[0], p) + a[1]


# ------------------------------------------------------------ camera models
def _dehom(p):
    return p[..., :2] / p[..., 2:3]


def _r2(xy):
    return torch.sum(xy * xy, dim=-1, keepdim=True)


def _pix(xy, k):
    return torch.cat([k[..., 0:1] * xy[..., 0:1],
                      k[..., 1:2] * xy[..., 1:2]], dim=-1) + k[..., 2:4]


def _unit_z(xy):
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _poly(r2, ks):
    fac = torch.zeros_like(r2)
    for k in reversed(ks):
        fac = (fac + k) * r2
    return 1.0 + fac


def _fov_factor(xy, k):
    w = k[..., 4:5]
    r2 = _r2(xy)
    r = torch.sqrt(torch.clamp(r2, min=1e-24))
    tw = torch.tan(w / 2.0)
    small_w = torch.abs(w) < 1e-6
    safe_w = torch.where(small_w, torch.ones_like(w), w)
    fac = torch.where(r2 < 1e-12, 2.0 * tw / safe_w,
                      torch.atan(2.0 * r * tw) / (r * safe_w))
    return torch.where(small_w, torch.ones_like(fac), fac)


def _radial_ks(name, k):
    if name == "poly2":
        return lambda r2: _poly(r2, [k[..., 4:5], k[..., 5:6]])
    if name == "poly3":
        return lambda r2: _poly(r2, [k[..., 4:5], k[..., 5:6], k[..., 6:7]])
    if name == "rational6":
        return lambda r2: (_poly(r2, [k[..., 4:5], k[..., 5:6], k[..., 6:7]])
                           / _poly(r2, [k[..., 7:8], k[..., 8:9],
                                        k[..., 9:10]]))
    return None


def _kb4_theta(theta, k):
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[..., 4:5] + t2 * (k[..., 5:6] + t2 * (
        k[..., 6:7] + t2 * k[..., 7:8]))))


def project(name, p, k):
    """Pixels (..., 2) of camera-frame points (..., 3) under model ``name``
    with intrinsics ``k``."""
    if name == "linear":
        return _pix(_dehom(p), k)
    if name == "fov":
        xy = _dehom(p)
        return _pix(_fov_factor(xy, k) * xy, k)
    if name == "kb4":
        x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
        r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-24))
        theta = torch.atan2(r, z)
        scale = torch.where(x * x + y * y < 1e-16, 1.0 / z,
                            _kb4_theta(theta, k) / r)
        return _pix(torch.cat([x, y], dim=-1) * scale, k)
    xy = _dehom(p)
    return _pix(_radial_ks(name, k)(_r2(xy)) * xy, k)


def unproject(name, pix, k, iters=8):
    """Unit-depth rays (..., 3) of pixels (..., 2)."""
    xy_d = (pix - k[..., 2:4]) / k[..., 0:2]
    if name == "linear":
        return _unit_z(xy_d)
    rd = torch.sqrt(torch.clamp(_r2(xy_d), min=1e-24))
    if name == "fov":
        w = k[..., 4:5]
        small_w = torch.abs(w) < 1e-6
        safe_w = torch.where(small_w, torch.ones_like(w), w)
        ru = torch.tan(rd * safe_w) / (2.0 * torch.tan(w / 2.0))
        fac = torch.where(small_w | (rd * rd < 1e-12), torch.ones_like(rd),
                          ru / rd)
        return _unit_z(fac * xy_d)
    if name == "kb4":
        theta = rd
        for _ in range(iters):
            t2 = theta * theta
            dp = 1.0 + t2 * (3.0 * k[..., 4:5] + t2 * (5.0 * k[..., 5:6]
                             + t2 * (7.0 * k[..., 6:7] + t2 * 9.0
                                     * k[..., 7:8])))
            theta = theta - (_kb4_theta(theta, k) - rd) / dp
        return _unit_z(torch.tan(theta) / rd * xy_d)
    factor = _radial_ks(name, k)

    def g_of(r):
        return r * factor(r * r)

    ru = rd
    for _ in range(iters):
        g = ru * factor(ru * ru) - rd
        dg = jvp(g_of, (ru,), (torch.ones_like(ru),))[1]
        ru = ru - g / torch.where(torch.abs(dg) < 1e-12,
                                  torch.ones_like(dg), dg)
    return _unit_z(ru / rd * xy_d)


# ------------------------------------------------------------------ target
_PRESETS = {
    # name: (rows, cols, seed, spacing_m, large_rad_m, small_rad_m)
    "small": (10, 19, 71, 0.008, 0.00245, 0.00175),
    "medium": (10, 19, 71, 0.01355, 0.00423, 0.00283),
    "large": (24, 36, 57, 0.03, 0.009, 0.006),
    "letter": (10, 19, 71, 0.01355, 0.00423, 0.00283),
}


def _windows_unique(grid, k):
    seen = set()
    for rot in (grid, np.rot90(grid, 1), np.rot90(grid, 2),
                np.rot90(grid, 3)):
        r, c = rot.shape
        for i in range(r - k + 1):
            for j in range(c - k + 1):
                key = rot[i:i + k, j:j + k].tobytes()
                if key in seen:
                    return False
                seen.add(key)
    return True


def make_pattern(rows, cols, seed):
    """The seeded dot pattern of the program's ``targets/grid.py``."""
    n_win = 4 * max(rows - 3, 0) * max(cols - 3, 0)
    k = 4 if n_win <= 1000 else 5
    for attempt in range(1000):
        rng = np.random.default_rng(seed + 100003 * attempt)
        grid = (rng.random((rows, cols)) < 0.5).astype(np.int32)
        if _windows_unique(grid, k):
            return grid
    raise RuntimeError("no unique pattern for seed %d" % seed)


@dataclasses.dataclass
class Target:
    grid: np.ndarray
    spacing: float
    large_rad: float
    small_rad: float

    @property
    def rows(self):
        return self.grid.shape[0]

    @property
    def cols(self):
        return self.grid.shape[1]

    def circles_3d(self):
        cc, rr = np.meshgrid(np.arange(self.cols), np.arange(self.rows))
        pts = np.stack([cc.ravel(), rr.ravel(), np.zeros(cc.size)], axis=1)
        return pts * np.array([self.spacing, self.spacing, 1.0])

    def radii(self):
        return np.where(self.grid.ravel() == 1, self.large_rad,
                        self.small_rad)


def preset_target(name):
    rows, cols, seed, spacing, large, small = _PRESETS[name]
    return Target(make_pattern(rows, cols, seed), spacing, large, small)


# ------------------------------------------------------------------- rig
@dataclasses.dataclass
class Camera:
    model: str
    params: np.ndarray
    q_ck: np.ndarray
    t_ck: np.ndarray
    width: int
    height: int


@dataclasses.dataclass
class Rig:
    """One configuration file's rig, trajectory and noise."""
    cameras: list
    target: Target
    n_frames: int
    frame_rate: float
    imu_rate: float
    gyro_bias: np.ndarray
    accel_bias: np.ndarray
    gyro_scale: np.ndarray
    accel_scale: np.ndarray
    g_dir: np.ndarray
    time_offset: float
    distance: float
    orbit_radius: float
    wobble: float
    image_noise: float
    gyro_noise: float
    accel_noise: float


def _quat_np(R):
    return quat_from_matrix(torch.as_tensor(np.asarray(R, np.float64))
                            ).numpy()


def rig_from_config(conf, n_frames=None):
    """The Rig of a configuration file's dict (see configs/*.json)."""
    r = conf["rig"]
    cams = []
    for c in r["cameras"]:
        R = RDF_ROBOTICS if c["R_ck"] == "rdf" else np.asarray(c["R_ck"])
        cams.append(Camera(c["model"], np.asarray(c["params"], np.float64),
                           _quat_np(R), np.asarray(c["t_ck"], np.float64),
                           int(c["width"]), int(c["height"])))
    tr = conf["trajectory"]
    nz = conf["noise"]
    return Rig(
        cameras=cams, target=preset_target(conf["target"]["preset"]),
        n_frames=int(n_frames or conf["frames_per_camera"]),
        frame_rate=float(r["frame_rate_hz"]), imu_rate=float(r["imu_rate_hz"]),
        gyro_bias=np.asarray(r["gyro_bias"], np.float64),
        accel_bias=np.asarray(r["accel_bias"], np.float64),
        gyro_scale=np.asarray(r["gyro_scale"], np.float64),
        accel_scale=np.asarray(r["accel_scale"], np.float64),
        g_dir=np.asarray(r["g_dir"], np.float64),
        time_offset=float(r["time_offset_s"]),
        distance=float(tr["distance_m"]),
        orbit_radius=float(tr["orbit_radius_m"]), wobble=float(tr["wobble"]),
        image_noise=float(nz["image_sigma_gray"]),
        gyro_noise=float(nz["gyro_sigma_per_sample"]),
        accel_noise=float(nz["accel_sigma_per_sample"]))


@dataclasses.dataclass
class Truth:
    rig: Rig
    frame_times: np.ndarray       # (F,) image clock
    q_wk: np.ndarray              # (F, 4) true rig poses
    t_wk: np.ndarray              # (F, 3)
    v_wk: np.ndarray              # (F, 3) world velocities
    visible: np.ndarray           # (C, F, P) dot inside the frame
    imu_times: np.ndarray         # (M,) recorded stamps
    gyro: np.ndarray
    accel: np.ndarray


def gravity(g_dir):
    p, q = g_dir[..., 0], g_dir[..., 1]
    return -GRAVITY_MAG * torch.stack([torch.cos(p) * torch.sin(q),
                                       -torch.sin(p),
                                       torch.cos(p) * torch.cos(q)], dim=-1)


def _camera_pose_fn(rig, center):
    r, d, w = rig.orbit_radius, rig.distance, rig.wobble

    def pose(t):
        p = center + torch.stack([
            r * torch.sin(0.9 * t) + 0.08 * torch.sin(2.3 * t),
            r * 0.8 * torch.sin(0.7 * t + 1.0)
            + 0.06 * torch.sin(1.9 * t + 0.5),
            d + 0.12 * torch.sin(1.3 * t + 0.3)])
        look = center + torch.stack([0.05 * torch.sin(1.1 * t + 0.7),
                                     0.05 * torch.sin(0.8 * t + 0.2),
                                     0.0 * t])
        fwd = look - p
        fwd = fwd / torch.linalg.norm(fwd)
        up = torch.stack([torch.sin(w * torch.sin(0.6 * t)),
                          -torch.cos(w * torch.sin(0.6 * t)), 0.0 * t])
        right = cross(-up, fwd)
        right = right / torch.linalg.norm(right)
        down = cross(fwd, right)
        return quat_from_matrix(torch.stack([right, down, fwd], dim=1)), p

    return pose


def simulate(rig, seed, device):
    """The true trajectory, visibility and the recorded IMU stream."""
    f64 = torch.float64

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=f64, device=device)

    tgt = rig.target
    points = T(tgt.circles_3d())
    center = T([(tgt.cols - 1) / 2.0 * tgt.spacing,
                (tgt.rows - 1) / 2.0 * tgt.spacing, 0.0])
    cam_pose = _camera_pose_fn(rig, center)
    c0 = rig.cameras[0]
    T_ck0 = (T(c0.q_ck), T(c0.t_ck))

    def rig_pose(t):
        return se3_mul(cam_pose(t), T_ck0)

    def flat(t):
        q, p = rig_pose(t)
        return torch.cat([q, p])

    d_pose = jacfwd(flat)
    dd_pos = jacfwd(lambda t: d_pose(t)[4:7])
    g_w = gravity(T(rig.g_dir))
    bg, ba = T(rig.gyro_bias), T(rig.accel_bias)
    sfg, sfa = T(rig.gyro_scale), T(rig.accel_scale)

    def imu_sample(t):
        q, _ = rig_pose(t)
        d = d_pose(t)
        omega_w = 2.0 * quat_mul(d[:4], quat_inv(q))[:3]
        z_g = (rotate(quat_inv(q), omega_w) - bg) / sfg
        z_a = (rotate(quat_inv(q), dd_pos(t) + g_w) - ba) / sfa
        return z_g, z_a

    duration = rig.n_frames / rig.frame_rate
    frame_times = np.arange(rig.n_frames) / rig.frame_rate + 0.1
    imu_true = np.arange(-0.05, duration + 0.35, 1.0 / rig.imu_rate)
    qf, pf = vmap(rig_pose)(T(frame_times))
    vf = vmap(d_pose)(T(frame_times))[:, 4:7]
    z_g, z_a = vmap(imu_sample)(T(imu_true))
    rng = np.random.default_rng(seed)
    gyro = z_g.cpu().numpy() + rng.normal(size=z_g.shape) * rig.gyro_noise
    accel = z_a.cpu().numpy() + rng.normal(size=z_a.shape) * rig.accel_noise

    q_kw, t_kw = se3_inv((qf, pf))
    vis = []
    for cam in rig.cameras:
        p_k = se3_apply((q_kw[:, None], t_kw[:, None]), points[None])
        p_c = se3_apply((T(cam.q_ck), T(cam.t_ck)), p_k)
        pix = project(cam.model, p_c, T(cam.params))
        vis.append(((p_c[..., 2] > 0.05) & (pix[..., 0] >= 0)
                    & (pix[..., 0] <= cam.width - 1) & (pix[..., 1] >= 0)
                    & (pix[..., 1] <= cam.height - 1)).cpu().numpy())
    return Truth(rig=rig, frame_times=frame_times, q_wk=qf.cpu().numpy(),
                 t_wk=pf.cpu().numpy(), v_wk=vf.cpu().numpy(),
                 visible=np.stack(vis),
                 imu_times=imu_true - rig.time_offset, gyro=gyro,
                 accel=accel)


def render(truth, cam, gen, device, pixels_per_launch=None):
    """(F, H, W) uint8 frames of camera ``cam``: each pixel unprojected
    through the true model onto the target plane and shaded by its distance
    to the nearest dot (a smooth edge about a pixel wide), plus white noise
    of ``image_noise`` grey levels drawn from ``gen``.  Frames go through
    in batches of about ``pixels_per_launch`` pixels (2**23 on a card,
    2**20 on the CPU)."""
    f64 = torch.float64
    dev = torch.device(device)
    rig = truth.rig
    c = rig.cameras[cam]
    k = torch.as_tensor(c.params, dtype=f64, device=dev)
    dots = torch.as_tensor(rig.target.circles_3d()[:, :2], dtype=f64,
                           device=dev)
    radii = torch.as_tensor(rig.target.radii(), dtype=f64, device=dev)
    T_kc = se3_inv((torch.as_tensor(c.q_ck, dtype=f64, device=dev),
                    torch.as_tensor(c.t_ck, dtype=f64, device=dev)))
    qf = torch.as_tensor(truth.q_wk, dtype=f64, device=dev)
    tf = torch.as_tensor(truth.t_wk, dtype=f64, device=dev)
    H, W = c.height, c.width
    vs, us = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    rays = unproject(c.model, torch.stack([us.reshape(-1), vs.reshape(-1)],
                                          dim=1), k)
    # the dot that maximises (radius - distance) lies within one grid cell
    # of the nearest grid position: radii differ by less than a spacing
    tgt = rig.target
    cells = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)]
    budget = pixels_per_launch or (1 << 23 if dev.type == "cuda" else 1 << 20)
    B = max(1, budget // (H * W))
    frames = torch.empty((qf.shape[0], H, W), dtype=torch.uint8, device=dev)
    for i in range(0, qf.shape[0], B):
        q_wc, o = se3_mul((qf[i:i + B], tf[i:i + B]), T_kc)   # (b, 4), (b, 3)
        d = rotate(q_wc[:, None], rays[None])                  # (b, HW, 3)
        dz = torch.where(torch.abs(d[..., 2]) < 1e-9,
                         torch.full_like(d[..., 2], 1e-9), d[..., 2])
        tplane = -o[:, 2:3] / dz                               # (b, HW)
        p = o[:, None, :2] + tplane[..., None] * d[..., :2]
        edge = torch.clamp(torch.abs(tplane) * (2.0 ** 0.5) / k[0],
                           min=1e-6)
        near = torch.round(p / tgt.spacing).to(torch.int64)
        best = None
        for dr, dc in cells:
            j = (torch.clamp(near[..., 1] + dr, 0, tgt.rows - 1) * tgt.cols
                 + torch.clamp(near[..., 0] + dc, 0, tgt.cols - 1))
            v = radii[j] - torch.sqrt(torch.sum((p - dots[j]) ** 2, dim=-1))
            best = v if best is None else torch.maximum(best, v)
        # the sigmoid is monotone, so the nearest edge's coverage is the
        # sigmoid of the largest (radius - distance)
        cov = torch.where(tplane > 0, torch.sigmoid(best / (edge * 0.5)),
                          torch.zeros_like(best))
        img = 255.0 * (1.0 - 0.87 * cov)
        if rig.image_noise > 0:
            img = img + rig.image_noise * torch.randn(
                img.shape, generator=gen, dtype=f64, device=dev)
        frames[i:i + B] = torch.clamp(img, 0.0, 255.0).reshape(-1, H, W).to(
            torch.uint8)
    return frames.cpu().numpy()
