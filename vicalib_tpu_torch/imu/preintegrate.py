"""RK4 IMU preintegration and the 9-D visual-inertial residual (torch).

Re-derivation of the reference's jet-typed integration chain
(reference: include/vicalib/ceres-cost-functions.h:38-227 and types.h:330-687)
as batched PyTorch: per-interval RK4 locals, a log-depth quaternion prefix
product, and weighted sums, differentiated end to end with ``torch.func`` —
including through the camera<->IMU time offset, which enters via
differentiable re-interpolation of the measurement window (the jet-typed
``GetRange`` trick, ceres-cost-functions.h:393-400 /
interpolation-buffer.h:208-226).

State layout: 10-vector ``y = [t(3), q(4, xyzw), v(3)]`` (matches ImuPoseT's
operator Matrix<10,1>, types.h:188-194).  The quaternion is deliberately NOT
renormalized inside the chain, matching the reference's memcpy-without-
normalization (types.h:344-345).

Every function here is pure and free of in-place writes, host reads and
branches on tensor values, so it runs under ``torch.func.vmap`` (over
factors, and again over LM damping candidates) and ``jacrev``.  Degenerate
(zero-length) intervals keep every denominator "safe" before the
``torch.where`` that discards them: the untaken branch still runs backward,
and a NaN there would survive as NaN * 0.
"""
from __future__ import annotations

import torch

from ..geometry import se3, so3

GRAVITY_MAG = 9.8007  # types.h:40-42


def _ident_quat(like):
    """Identity quaternion(s) shaped like ``like`` (..., 4)."""
    return torch.zeros_like(like) + torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)


def gravity_vector(g_dir, mag=GRAVITY_MAG):
    """2-angle direction -> 3-vector (types.h:93-104)."""
    p, q = g_dir[..., 0], g_dir[..., 1]
    sp, cp = torch.sin(p), torch.cos(p)
    sq, cq = torch.sin(q), torch.cos(q)
    return -mag * torch.stack([cp * sq, -sp, cp * cq], dim=-1)


def _pose_derivative(y, zg, za, bg, ba, sf, g_w):
    """k = [v, omega_world, a_world] (GetPoseDerivativeJet, :80-105)."""
    q = y[3:7]
    v = y[7:10]
    omega = so3.rotate(q, zg * sf[:3] + bg)
    accel = so3.rotate(q, za * sf[3:] + ba) - g_w
    return torch.cat([v, omega, accel])


def _integrate_pose(y, k, dt):
    """Euler step of the state given derivative k (IntegratePoseJet, :38-56).

    Rotation integrates as q_new = exp(omega*dt) * q (left/world increment),
    translation and velocity as straight Euler.  No renormalization.
    """
    t = y[0:3] + k[0:3] * dt
    dq = so3.exp(k[3:6] * dt)
    q = so3.quat_mul(dq, y[3:7])
    v = y[7:10] + k[6:9] * dt
    return torch.cat([t, q, v])


def _interp_meas(z_start_g, z_end_g, z_start_a, z_end_a, t_start, t_end, dt):
    """Linear interpolation at offset dt into [t_start, t_end]
    (GetPoseDerivativeJet's alpha blend, cost-functions.h:86-90)."""
    denom = t_end - t_start
    safe = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom),
                       denom)
    alpha = (t_end - (t_start + dt)) / safe
    zg = z_start_g * alpha + z_end_g * (1.0 - alpha)
    za = z_start_a * alpha + z_end_a * (1.0 - alpha)
    return zg, za


def integrate_interval(y, t_start, t_end, zg0, zg1, za0, za1, bg, ba, sf,
                       g_w):
    """One RK4 step across a measurement interval (IntegrateImuJet, :139-177).

    Degenerate intervals (t_end == t_start, from window padding/clipping) are
    exact no-ops, as in the reference's early return (:150-152).
    """
    dt = t_end - t_start

    def deriv(y_at, frac_dt):
        zg, za = _interp_meas(zg0, zg1, za0, za1, t_start, t_end, frac_dt)
        return _pose_derivative(y_at, zg, za, bg, ba, sf, g_w)

    # guard dt == 0 inside the arithmetic so no NaN leaks into gradients
    zero = torch.abs(dt) < 1e-12
    safe_dt = torch.where(zero, torch.ones_like(dt), dt)

    k1 = deriv(y, 0.0 * safe_dt)
    y1 = _integrate_pose(y, k1, safe_dt * 0.5)
    k2 = deriv(y1, safe_dt / 2.0)
    y2 = _integrate_pose(y, k2, safe_dt * 0.5)
    k3 = deriv(y2, safe_dt / 2.0)
    y3 = _integrate_pose(y, k3, safe_dt)
    k4 = deriv(y3, safe_dt)
    k = k1 + 2.0 * k2 + 2.0 * k3 + k4
    y_new = _integrate_pose(y, k, safe_dt / 6.0)
    return torch.where(zero, y, y_new)


def _clip(x, lo, hi):
    """clip as maximum-then-minimum, so ties split the derivative evenly
    between the bound and x, as ``jnp.clip`` does (``torch.clamp`` passes
    all of it to x)."""
    return torch.minimum(hi, torch.maximum(lo, x))


def virtual_sequence(win_times, win_gyro, win_accel, start, end, time_offset):
    """Build the differentiable measurement sequence for one factor.

    Reproduces GetRange(start, end, offset) semantics with static shapes:
    every window slot's image-clock time is clipped to [start, end]; clipped
    slots re-interpolate the raw stream at the clip point, giving exactly the
    reference's interpolated endpoints; out-of-range slots collapse to
    zero-length intervals (no-ops in integration).  ``time_offset`` stays in
    the autodiff graph through both the slot times and the interpolation
    weights; the slot index ``j`` is integer and carries no derivative.

    The interpolation is a dense (M, M) one-hot weight matrix times the
    (M, 3) samples: a few vectorized compares and one small matmul per
    factor, with edge-clamped values.

    Args:
      win_times: (M,) raw stamps (monotone); win_gyro/win_accel: (M, 3).
    Returns:
      seq_times: (M,) image-clock times, monotone, clipped to [start, end]
      seq_gyro, seq_accel: (M, 3) values at those times
    """
    shifted = win_times + time_offset
    seq_times = _clip(shifted, start, end)
    raw_query = seq_times - time_offset

    M = win_times.shape[0]
    cnt = torch.sum(raw_query[:, None] >= win_times[None, :], dim=1)
    j = torch.clamp(cnt - 1, 0, M - 2)
    cols = torch.arange(M - 1, device=win_times.device)
    oh = (j[:, None] == cols[None, :]).to(win_gyro.dtype)     # (M, M-1)
    t_lo = oh @ win_times[:-1]
    t_hi = oh @ win_times[1:]
    denom = t_hi - t_lo
    denom = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom),
                        denom)
    alpha = _clip((raw_query - t_lo) / denom, torch.zeros_like(denom),
                  torch.ones_like(denom))                     # (M,)
    zcol = torch.zeros_like(oh[:, :1])
    W = (torch.cat([oh * (1.0 - alpha)[:, None], zcol], dim=1)
         + torch.cat([zcol, oh * alpha[:, None]], dim=1))     # (M, M)
    return seq_times, W @ win_gyro, W @ win_accel


def integrate_sequence_seq(y0, seq_times, seq_gyro, seq_accel, bg, ba, sf,
                           g_w):
    """Chain RK4 across the sequence one interval at a time
    (IntegrateResidualJet, :199-227).  The oracle for
    :func:`integrate_sequence`, which computes the same discrete update in
    O(log M) depth."""
    y = y0
    for k in range(seq_times.shape[0] - 1):
        y = integrate_interval(y, seq_times[k], seq_times[k + 1],
                               seq_gyro[k], seq_gyro[k + 1],
                               seq_accel[k], seq_accel[k + 1],
                               bg, ba, sf, g_w)
    return y


def _rk4_step_locals(t0, t1, zg0, zg1, za0, za1, bg, ba, sf):
    """Measurement-only RK4 step coefficients, batched over intervals:
    t0, t1 (N,), z* (N, 3), bg/ba (3,), sf (6,).

    The sequential RK4 step (:func:`integrate_interval`) factorizes exactly:
    because the world-frame increments it applies are conjugates of
    body-frame quantities (exp(R(q) w dt) * q == q * exp(w dt)), every
    stage's state dependence reduces to a left factor of the entry state, so

        q_{k+1} = q_k * gamma_k
        v_{k+1} = v_k + R(q_k) b_k          - g_w dt_k
        t_{k+1} = t_k + v_k dt_k + R(q_k) e_k - g_w dt_k^2/2

    with (gamma_k, b_k, e_k) functions of the interval's measurements,
    biases, and scale factors only.  Returns (gamma (N,4), b (N,3),
    e (N,3), dt (N,)); zero-length intervals give the identity step.
    """
    dt = t1 - t0
    zero = torch.abs(dt) < 1e-12
    safe_dt = torch.where(zero, torch.ones_like(dt), dt)[..., None]

    sg, sa = sf[:3], sf[3:]
    w1 = zg0 * sg + bg
    wm = 0.5 * (zg0 + zg1) * sg + bg
    we = zg1 * sg + bg
    a1 = za0 * sa + ba
    am = 0.5 * (za0 + za1) * sa + ba
    ae = za1 * sa + ba

    e1 = so3.exp(w1 * (safe_dt * 0.5))
    w2 = so3.rotate(e1, wm)
    e2 = so3.exp(w2 * (safe_dt * 0.5))
    w3 = so3.rotate(e2, wm)
    e3 = so3.exp(w3 * safe_dt)
    w4 = so3.rotate(e3, we)
    w_tot = (w1 + 2.0 * w2 + 2.0 * w3 + w4) / 6.0
    gamma = so3.exp(w_tot * safe_dt)

    a2 = so3.rotate(e1, am)
    a3 = so3.rotate(e2, am)
    a4 = so3.rotate(e3, ae)
    b = (a1 + 2.0 * a2 + 2.0 * a3 + a4) * (safe_dt / 6.0)
    e = (a1 + a2 + a3) * (safe_dt * safe_dt / 6.0)

    z = zero[..., None]
    return (torch.where(z, _ident_quat(gamma), gamma),
            torch.where(z, torch.zeros_like(b), b),
            torch.where(z, torch.zeros_like(e), e),
            torch.where(zero, torch.zeros_like(dt), dt))


def quat_prefix_product(g):
    """Inclusive prefix products P_k = g_0 * g_1 * ... * g_k of (N, 4)
    quaternions, in ceil(log2 N) doubling steps on shifted slices (no
    in-place writes).  Quaternion products are associative only in exact
    arithmetic, so the result differs from a left-to-right chain by
    rounding."""
    P = g
    d = 1
    while d < g.shape[0]:
        P = torch.cat([P[:d], so3.quat_mul(P[:-d], P[d:])], dim=0)
        d *= 2
    return P


def integrate_sequence(y0, seq_times, seq_gyro, seq_accel, bg, ba, sf, g_w):
    """Chain RK4 across the sequence — factorized, O(log M) parallel depth.

    Identical discrete math to :func:`integrate_sequence_seq` (same RK4
    stages, same interpolation), reorganized as batched per-step locals, a
    quaternion prefix product and weighted sums.
    """
    t0_, q0, v0 = y0[0:3], y0[3:7], y0[7:10]

    gamma, b, e, dt = _rk4_step_locals(
        seq_times[:-1], seq_times[1:], seq_gyro[:-1], seq_gyro[1:],
        seq_accel[:-1], seq_accel[1:], bg, ba, sf)

    # prefix rotations BEFORE each step: q_k = q0 * gamma_1 ... gamma_{k-1}
    P = quat_prefix_product(gamma)                           # inclusive
    P_pre = torch.cat([_ident_quat(P[:1]), P[:-1]], dim=0)   # exclusive
    q_k = so3.quat_mul(q0[None, :], P_pre)                   # (M-1, 4)

    T = torch.sum(dt)
    tau = T - torch.cumsum(dt, dim=0)        # time remaining AFTER step k
    Rb = so3.rotate(q_k, b)                  # (M-1, 3)
    Re_tb = so3.rotate(q_k, e + tau[:, None] * b)

    q_end = so3.quat_mul(q0, P[-1])
    v_end = v0 + torch.sum(Rb, dim=0) - g_w * T
    # gravity double integral: sum(dt^2/2 + tau*dt) telescopes to T^2/2
    g_quad = torch.sum(0.5 * dt * dt + tau * dt)
    t_end = t0_ + v0 * T + torch.sum(Re_tb, dim=0) - g_w * g_quad
    return torch.cat([t_end, q_end, v_end])


def integrate_trajectory(y0, seq_times, seq_gyro, seq_accel, bg, ba, sf,
                         g_w):
    """Positions after every RK4 step of the chain, (M-1, 3): the
    trajectory :func:`integrate_sequence_seq` passes through (the display
    strips of GetIntegrationPoses, vicalibrator.h:508-533), from the same
    factorized locals as :func:`integrate_sequence` — a prefix product and
    cumulative sums instead of a loop over the steps."""
    t0_, q0, v0 = y0[0:3], y0[3:7], y0[7:10]
    gamma, b, e, dt = _rk4_step_locals(
        seq_times[:-1], seq_times[1:], seq_gyro[:-1], seq_gyro[1:],
        seq_accel[:-1], seq_accel[1:], bg, ba, sf)
    P = quat_prefix_product(gamma)
    P_pre = torch.cat([_ident_quat(P[:1]), P[:-1]], dim=0)
    q_k = so3.quat_mul(q0[None, :], P_pre)                   # before step k
    dv = so3.rotate(q_k, b) - g_w * dt[:, None]
    v_k = v0 + torch.cat([torch.zeros_like(dv[:1]),
                          torch.cumsum(dv, dim=0)[:-1]])     # before step k
    dt2 = dt[:, None]
    step = v_k * dt2 + so3.rotate(q_k, e) - g_w * (0.5 * dt2 * dt2)
    return t0_ + torch.cumsum(step, dim=0)


_ROT_ROWS = (0., 0., 0., 1., 1., 1., 0., 0., 0.)


def imu_factor_residual(T_wx1, v1, T_wx2, v2, win_times, win_gyro, win_accel,
                        start, end, g_dir, bg, ba, sf, time_offset,
                        has_meas, weight_sqrt=None, rotation_only=False):
    """The 9-D switched VI residual (SwitchedFullImuCostFunction, :379-490).

    r[0:6] = log(T_end * T_wx2^-1)   (SE3 log, [trans, rot] order)
    r[6:9] = v_end - v2
    then r <- weight_sqrt @ r, and in the rotation-only stage (a Python
    bool: the stage is known on the host) the translation and velocity
    components are zeroed (:479-482).  Factors with no measurements
    (``has_meas`` a bool tensor) return zeros (:452-455).
    """
    g_w = gravity_vector(g_dir)
    q1, t1 = T_wx1
    y0 = torch.cat([t1, q1, v1])
    seq_t, seq_g, seq_a = virtual_sequence(
        win_times, win_gyro, win_accel, start, end, time_offset)
    y_end = integrate_sequence(y0, seq_t, seq_g, seq_a, bg, ba, sf, g_w)

    t_end = y_end[0:3]
    q_end = y_end[3:7]
    q_end = q_end / torch.linalg.norm(q_end)
    v_end = y_end[7:10]

    delta = se3.mul((q_end, t_end), se3.inverse(T_wx2))
    r = torch.cat([se3.log(delta), v_end - v2])
    if weight_sqrt is not None:
        r = weight_sqrt @ r
    if rotation_only:
        r = r * torch.tensor(_ROT_ROWS, dtype=r.dtype, device=r.device)
    return torch.where(has_meas, r, torch.zeros_like(r))


def end_state(T_wx1, v1, win_times, win_gyro, win_accel, start, end,
              g_dir, bg, ba, sf, time_offset):
    """Integrated end state y = [t, q, v] for covariance propagation / display
    (reference analog: IntegrateResidual used by UpdateImuWeights and
    GetIntegrationPoses, vicalibrator.h:508-533, 723-799)."""
    g_w = gravity_vector(g_dir)
    q1, t1 = T_wx1
    y0 = torch.cat([t1, q1, v1])
    seq_t, seq_g, seq_a = virtual_sequence(
        win_times, win_gyro, win_accel, start, end, time_offset)
    return integrate_sequence(y0, seq_t, seq_g, seq_a, bg, ba, sf, g_w)
