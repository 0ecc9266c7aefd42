"""A plain visual-inertial calibration: one dense Levenberg-Marquardt over
every parameter at once, in float64.

Written from the problem's definition (vicalib's cost), not from the
program's solver: no stages, no Schur complement, no structured assembly,
no padding of the problem to capacities.  The parameters are every frame's
rig pose T_wk and world velocity, each camera's T_ck and intrinsics, the
gravity direction (two angles), gyro and accel biases and scale factors,
and the camera-IMU time offset (IMU stamp + offset = image time).  The cost
is Ceres's convention, 0.5 * sum rho(|r|^2):

- reprojection, per detected dot: pi(R_ck R_wk^T (p_w - t_wk) + t_ck) -
  the detected pixel, under SoftL1 of scale 0.5 px;
- IMU, per consecutive frame pair: the rig state of the first frame is
  integrated over the pair's image-clock interval, one RK4 step per
  interval between IMU samples (the measurement linear in time within it,
  the stream interpolated linearly at the frame times), with
  omega_w = R (z_g * s_g + b_g) and a_w = R (z_a * s_a + b_a) - g_w, and
  r = [J_l(w)^-1 t_d, w, v_end - v_2] with (R_d, t_d) = T_end T_2^-1 and
  w = log R_d, whitened by W, the inverse Cholesky factor of r's
  covariance propagated from the per-sample noise (autograd Jacobians of
  r with respect to the raw samples), under Cauchy of scale 100.

Every iteration recomputes W at the current state, takes the whole
residual vector's Jacobian by forward-mode autograd (chunks of tangent
directions), forms the dense normal equations with the robust losses'
sqrt(rho') row weights, and solves them damped (Marquardt, lambda *
diag(H)) by Cholesky.  It starts from the simulator's truth and stops once
the Gauss-Newton decrement falls under ``tol`` of the cost, so the answer
is where the weights and the solution agree."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

GRAVITY_MAG = 9.8007
GYRO_SIGMA = 5.3088444e-5        # per IMU sample, vicalib's defaults
ACCEL_SIGMA = 0.001883649
REPROJ_B = 0.5 ** 2              # SoftL1(0.5)
IMU_B = 100.0 ** 2               # Cauchy(100)


# --------------------------------------------------------------- rotations
def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _eye(w):
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))


def _small(th2, tol=1e-8):
    return th2 < tol, torch.where(th2 < tol, torch.ones_like(th2), th2)


def exp_so3(w):
    """Rodrigues: I + A hat(w) + B hat(w)^2."""
    th2 = torch.sum(w * w, -1)
    small, safe = _small(th2)
    th = torch.sqrt(safe)
    A = torch.where(small, 1 - th2 / 6 + th2 * th2 / 120, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24 + th2 * th2 / 720,
                    (1 - torch.cos(th)) / safe)
    W = hat(w)
    return _eye(w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R):
    """The rotation vector of R (angles below pi)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1)
    s2 = torch.sum(v * v, -1)
    small, safe = _small(s2)
    s = torch.sqrt(safe)
    f = torch.where(small, 1 + s2 / 6 + 3 * s2 * s2 / 40,
                    torch.atan2(s, c) / s)
    return f[..., None] * v


def jl_inv(w):
    """The inverse left Jacobian of SO(3): I - hat/2 + C hat^2."""
    th2 = torch.sum(w * w, -1)
    small, safe = _small(th2, 1e-6)
    th = torch.sqrt(safe)
    C = torch.where(small, 1 / 12 + th2 / 720 + th2 * th2 / 30240,
                    1 / safe - (1 + torch.cos(th)) / (2 * th * torch.sin(th)))
    W = hat(w)
    return _eye(w) - 0.5 * W + C[..., None, None] * (W @ W)


def gravity(g_dir):
    p, q = g_dir[0], g_dir[1]
    return -GRAVITY_MAG * torch.stack([torch.cos(p) * torch.sin(q),
                                       -torch.sin(p),
                                       torch.cos(p) * torch.cos(q)])


def project(model, p, k):
    """Pixels of camera-frame points: pinhole, with calibu's poly2 radial
    factor 1 + k1 r^2 + k2 r^4 of the normalised point."""
    xy = p[..., :2] / p[..., 2:3]
    if model == "poly2":
        r2 = torch.sum(xy * xy, -1, keepdim=True)
        xy = xy * (1 + k[4] * r2 + k[5] * r2 * r2)
    elif model != "linear":
        raise ValueError("no plain projection of %r" % model)
    return xy * k[0:2] + k[2:4]


# ------------------------------------------------------------------ state
@dataclasses.dataclass
class State:
    R_wk: torch.Tensor      # (F, 3, 3) rig to world
    t_wk: torch.Tensor      # (F, 3)
    v_w: torch.Tensor       # (F, 3)
    R_ck: torch.Tensor      # (C, 3, 3) rig to camera
    t_ck: torch.Tensor      # (C, 3)
    intr: list              # C tensors of the models' parameters
    g_dir: torch.Tensor     # (2,)
    bias: torch.Tensor      # (6,) gyro, accel
    scale: torch.Tensor     # (6,) gyro, accel
    offset: torch.Tensor    # ()

    def size(self):
        return (9 * self.R_wk.shape[0] + sum(6 + k.shape[0]
                                             for k in self.intr) + 15)

    def retract(self, d):
        """The state moved by tangent ``d``: frames [rot, trans, vel],
        cameras [rot, trans, intrinsics], then gravity, biases, scales,
        offset.  Rotations move on the right, the rest adds."""
        F = self.R_wk.shape[0]
        f = d[:9 * F].reshape(F, 9)
        i = 9 * F
        R_ck, t_ck, intr = [], [], []
        for c, k in enumerate(self.intr):
            R_ck.append(self.R_ck[c] @ exp_so3(d[i:i + 3]))
            t_ck.append(self.t_ck[c] + d[i + 3:i + 6])
            intr.append(k + d[i + 6:i + 6 + k.shape[0]])
            i += 6 + k.shape[0]
        return State(self.R_wk @ exp_so3(f[:, 0:3]), self.t_wk + f[:, 3:6],
                     self.v_w + f[:, 6:9], torch.stack(R_ck),
                     torch.stack(t_ck), intr, self.g_dir + d[i:i + 2],
                     self.bias + d[i + 2:i + 8], self.scale + d[i + 8:i + 14],
                     self.offset + d[i + 14])


# -------------------------------------------------------------- IMU windows
@dataclasses.dataclass
class Windows:
    """Per frame pair: the raw samples from the last at or before the
    pair's start to the first at or after its end (IMU clock at the
    offset they were cut for), padded by repeating the last; ``e0``/``e1``
    pick the end's bracketing samples, ``inner`` the samples strictly
    inside."""
    t: torch.Tensor         # (K, L)
    g: torch.Tensor         # (K, L, 3)
    a: torch.Tensor         # (K, L, 3)
    e0: torch.Tensor        # (K, L) one-hot
    e1: torch.Tensor        # (K, L) one-hot
    inner: torch.Tensor     # (K, L) bool
    start: torch.Tensor     # (K,) image clock
    end: torch.Tensor       # (K,)


def cut_windows(imu_t, imu_g, imu_a, frame_t, offset, device):
    a = frame_t[:-1] - offset
    b = frame_t[1:] - offset
    lo = np.searchsorted(imu_t, a, side="right") - 1
    hi = np.searchsorted(imu_t, b, side="left")
    if len(a) and (lo.min() < 0 or hi.max() >= len(imu_t)):
        raise ValueError("the IMU stream does not cover every frame pair")
    n = hi - lo + 1
    L = int(n.max())
    idx = np.minimum(lo[:, None] + np.arange(L)[None], hi[:, None])
    j = np.arange(L)[None]
    T = lambda x, dt=torch.float64: torch.as_tensor(x, dtype=dt,
                                                    device=device)
    return Windows(T(imu_t[idx]), T(imu_g[idx]), T(imu_a[idx]),
                   T(j == (n - 2)[:, None]), T(j == (n - 1)[:, None]),
                   T((j >= 1) & (j <= (n - 2)[:, None]), torch.bool),
                   T(frame_t[:-1]), T(frame_t[1:]))


def _lerp(t0, t1, z0, z1, t):
    return z0 + (z1 - z0) * ((t - t0) / (t1 - t0))


def _imu_one(R1, t1, v1, R2, t2, v2, wt, wg, wa, e0, e1, inner, start, end,
             g_w, bias, scale, offset):
    """The 9-D residual of one frame pair (unwhitened)."""
    zs_g = _lerp(wt[0], wt[1], wg[0], wg[1], start - offset)
    zs_a = _lerp(wt[0], wt[1], wa[0], wa[1], start - offset)
    te0, te1 = e0 @ wt, e1 @ wt
    ze_g = _lerp(te0, te1, e0 @ wg, e1 @ wg, end - offset)
    ze_a = _lerp(te0, te1, e0 @ wa, e1 @ wa, end - offset)
    m = inner[1:, None]
    ts = torch.cat([start[None], torch.where(inner[1:], wt[1:] + offset, end),
                    end[None]])
    gs = torch.cat([zs_g[None], torch.where(m, wg[1:], ze_g), ze_g[None]])
    as_ = torch.cat([zs_a[None], torch.where(m, wa[1:], ze_a), ze_a[None]])
    bg, ba, sg, sa = bias[:3], bias[3:], scale[:3], scale[3:]

    def deriv(R, v, zg, za):
        return v, R @ (zg * sg + bg), R @ (za * sa + ba) - g_w

    def step(R, t, v, k, h):
        return exp_so3(k[1] * h) @ R, t + k[0] * h, v + k[2] * h

    R, t, v = R1, t1, v1
    for j in range(ts.shape[0] - 1):
        h = ts[j + 1] - ts[j]
        gm, am = 0.5 * (gs[j] + gs[j + 1]), 0.5 * (as_[j] + as_[j + 1])
        k1 = deriv(R, v, gs[j], as_[j])
        y = step(R, t, v, k1, 0.5 * h)
        k2 = deriv(y[0], y[2], gm, am)
        y = step(R, t, v, k2, 0.5 * h)
        k3 = deriv(y[0], y[2], gm, am)
        y = step(R, t, v, k3, h)
        k4 = deriv(y[0], y[2], gs[j + 1], as_[j + 1])
        k = tuple(p + 2 * q + 2 * r + s for p, q, r, s in
                  zip(k1, k2, k3, k4))
        R, t, v = step(R, t, v, k, h / 6)
    R_d = R @ R2.T
    w = log_so3(R_d)
    return torch.cat([jl_inv(w) @ (t - R_d @ t2), w, v - v2])


_imu_all = vmap(_imu_one, in_dims=(0,) * 14 + (None,) * 4)


def imu_residuals(st, win):
    return _imu_all(st.R_wk[:-1], st.t_wk[:-1], st.v_w[:-1], st.R_wk[1:],
                    st.t_wk[1:], st.v_w[1:], win.t, win.g, win.a, win.e0,
                    win.e1, win.inner, win.start, win.end,
                    gravity(st.g_dir), st.bias, st.scale, st.offset)


def imu_weights(st, win):
    """(K, 9, 9) W with W^T W the inverse of each residual's covariance
    under independent per-sample gyro and accel noise."""
    def one(*a):
        return _imu_one(*a, gravity(st.g_dir), st.bias, st.scale, st.offset)

    Jg, Ja = vmap(jacfwd(one, argnums=(7, 8)))(
        st.R_wk[:-1], st.t_wk[:-1], st.v_w[:-1], st.R_wk[1:], st.t_wk[1:],
        st.v_w[1:], win.t, win.g, win.a, win.e0, win.e1, win.inner,
        win.start, win.end)
    Jg, Ja = Jg.flatten(2), Ja.flatten(2)
    cov = (GYRO_SIGMA ** 2 * Jg @ Jg.transpose(1, 2)
           + ACCEL_SIGMA ** 2 * Ja @ Ja.transpose(1, 2))
    L = torch.linalg.cholesky(cov)
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device).expand_as(cov)
    return torch.linalg.solve_triangular(L, eye, upper=False)


# ---------------------------------------------------------------- problem
@dataclasses.dataclass
class Problem:
    models: list            # camera model names
    p_w: torch.Tensor       # (P, 3) target points
    pixels: torch.Tensor    # (C, F, P, 2) detections
    valid: torch.Tensor     # (C, F, P) float 0/1
    frame_t: np.ndarray     # (F,) image clock
    imu_t: np.ndarray       # (M,) IMU clock
    imu_g: np.ndarray       # (M, 3)
    imu_a: np.ndarray


def reproj_residuals(prob, st):
    """(C, F, P, 2), zero where nothing was detected."""
    p_k = (prob.p_w[None] - st.t_wk[:, None]) @ st.R_wk        # (F, P, 3)
    out = []
    for c, model in enumerate(prob.models):
        p_c = p_k @ st.R_ck[c].T + st.t_ck[c]
        out.append((project(model, p_c, st.intr[c]) - prob.pixels[c])
                   * prob.valid[c, ..., None])
    return torch.stack(out)


def _costs(prob, st, W, win):
    s_v = torch.sum(reproj_residuals(prob, st) ** 2, -1)
    r_i = (W @ imu_residuals(st, win)[..., None])[..., 0]
    s_i = torch.sum(r_i * r_i, -1)
    return (torch.sum(REPROJ_B * 2 * (torch.sqrt(1 + s_v / REPROJ_B) - 1))
            + torch.sum(IMU_B * torch.log1p(s_i / IMU_B))) * 0.5


def solve(prob, st, max_iters=60, tol=1e-13, chunk=256, log=None):
    """The state at the cost's minimum near ``st``; returns it with the
    iterations run and the final cost."""
    dev = st.t_wk.device
    n = st.size()
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    lam = 1e-8
    cost = None
    for it in range(1, max_iters + 1):
        win = cut_windows(prob.imu_t, prob.imu_g, prob.imu_a, prob.frame_t,
                          float(st.offset), dev)
        W = imu_weights(st, win)

        def resid_v(d):
            return reproj_residuals(prob, st.retract(d)).reshape(-1)

        def resid_i(d):
            return (W @ imu_residuals(st.retract(d), win)[..., None]
                    ).reshape(-1)

        zero = torch.zeros(n, dtype=torch.float64, device=dev)
        r = torch.cat([resid_v(zero), resid_i(zero)])
        nv = prob.valid.numel() * 2
        s_v = torch.sum(r[:nv].reshape(-1, 2) ** 2, -1)
        s_i = torch.sum(r[nv:].reshape(-1, 9) ** 2, -1)
        w = torch.cat([
            ((1 + s_v / REPROJ_B) ** -0.25).repeat_interleave(2),
            ((1 + s_i / IMU_B) ** -0.5).repeat_interleave(9)])
        J = torch.empty((r.shape[0], n), dtype=torch.float64, device=dev)
        # the reprojections' columns a chunk at a time (their tangents
        # fill the memory); the IMU rows are few, so all columns at once
        for i in range(0, n, chunk):
            J[:nv, i:i + chunk] = vmap(
                lambda v: jvp(resid_v, (zero,), (v,))[1])(
                eye[i:i + chunk]).T
        J[nv:] = vmap(lambda v: jvp(resid_i, (zero,), (v,))[1])(eye).T
        J *= w[:, None]
        H = J.T @ J
        g = J.T @ (r * w)
        del J
        cost = _costs(prob, st, W, win)
        D = torch.clamp(torch.diagonal(H), min=1e-12)
        while True:
            L, info = torch.linalg.cholesky_ex(H + lam * torch.diag(D))
            if int(info) == 0:
                d = -torch.cholesky_solve(g[:, None], L)[:, 0]
                decrement = float(-(g @ d))
                if decrement < tol * float(cost):
                    # at the minimum: what is left is rounding
                    return st.retract(d), it, float(cost)
                trial = st.retract(d)
                trial_cost = _costs(prob, trial, W, win)
                if bool(torch.isfinite(trial_cost)) and trial_cost < cost:
                    break
            lam *= 10.0
            if lam > 1e8:
                raise RuntimeError("the plain solve cannot reduce its cost")
        st = trial
        lam = max(lam / 10.0, 1e-12)
        if log:
            log("plain LM iteration %d: cost %.9e decrement %.3e" % (
                it, float(trial_cost), decrement))
    raise RuntimeError("the plain solve did not converge in %d iterations"
                       % max_iters)
