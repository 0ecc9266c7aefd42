"""Headless visualization — replaces the reference's Pangolin GUI.

The reference draws the target, per-frame camera frusta, IMU-integration
trajectories and detection overlays (vicalib-task.cc:414-605, GLLineStrip).
This module renders the same content to SVG (3-D scene via a simple
orthographic projection, 2-D detection overlay) with no GUI dependencies.
The SVG writers take host numpy arrays; ``integration_strips`` computes on
the state's device and returns host arrays.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from .geometry import quat_np


def _proj_iso(p, scale, cx, cy):
    """Isometric-ish orthographic projection for the 3-D scene."""
    x = p[..., 0] - 0.5 * p[..., 2]
    y = -p[..., 1] - 0.25 * p[..., 2]
    return x * scale + cx, y * scale + cy


def scene_svg(path, target, q_wk, t_wk, T_ck_list=None, imu_strips=None,
              width=900, height=700):
    """3-D scene: target dots, frame axes, camera frusta, IMU strips.

    imu_strips: optional list of (N_i, 3) integrated-position polylines
    (GetIntegrationPoses analog, vicalibrator.h:508-533 / gl-line-strip.h).
    With ``path`` None the SVG text is returned instead of written.
    """
    q_wk = np.asarray(q_wk)
    t_wk = np.asarray(t_wk)
    pts = target.circles_3d()
    all_pts = np.concatenate([pts, t_wk], axis=0)
    lo = all_pts.min(axis=0)
    hi = all_pts.max(axis=0)
    span = max(float(np.max(hi - lo)), 1e-6)
    scale = 0.75 * min(width, height) / span
    cx, cy = width * 0.5, height * 0.55
    center = 0.5 * (lo + hi)

    def P(p):
        return _proj_iso(np.asarray(p) - center, scale, cx, cy)

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" viewBox="0 0 {width} {height}">',
             f'<rect width="{width}" height="{height}" fill="white"/>']
    # target dots
    for i, p in enumerate(pts):
        x, y = P(p)
        r = 2.5 if target.grid.ravel()[i] else 1.5
        parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{r}" '
                     'fill="#444"/>')
    # frame axes (rig pose triads)
    axis_len = 0.04 * span
    colors = ["#d00", "#0a0", "#00d"]
    for k in range(len(q_wk)):
        R = quat_np.to_matrix(q_wk[k])
        o = t_wk[k]
        ox, oy = P(o)
        for a in range(3):
            e = o + R[:, a] * axis_len
            ex, ey = P(e)
            parts.append(f'<line x1="{ox:.1f}" y1="{oy:.1f}" x2="{ex:.1f}" '
                         f'y2="{ey:.1f}" stroke="{colors[a]}" '
                         'stroke-width="1"/>')
    # trajectory polyline
    xy = [P(t_wk[k]) for k in range(len(t_wk))]
    pl = " ".join(f"{x:.1f},{y:.1f}" for x, y in xy)
    parts.append(f'<polyline points="{pl}" fill="none" stroke="#888" '
                 'stroke-width="1"/>')
    # IMU integration strips
    if imu_strips:
        for strip in imu_strips:
            xy = [P(p) for p in np.asarray(strip)]
            pl = " ".join(f"{x:.1f},{y:.1f}" for x, y in xy)
            parts.append(f'<polyline points="{pl}" fill="none" '
                         'stroke="#e80" stroke-width="0.8"/>')
    parts.append("</svg>")
    svg = "\n".join(parts) + "\n"
    if path is None:       # callers that serve it live rather than save it
        return svg
    with open(path, "w") as f:
        f.write(svg)


def detection_svg(path, image_shape, centers, valid, grid_coords=None,
                  true_pixels=None):
    """2-D overlay: detected conic centers (crosses), grid ids, optional
    ground-truth projections — the Draw2d analog (vicalib-task.cc:492-594)."""
    H, W = image_shape
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
             f'height="{H}" viewBox="0 0 {W} {H}">',
             f'<rect width="{W}" height="{H}" fill="#f8f8f8"/>']
    centers = np.asarray(centers)
    for i in np.where(np.asarray(valid))[0]:
        x, y = centers[i]
        matched = grid_coords is not None and grid_coords[i, 0] >= 0
        c = "#0a0" if matched else "#d00"
        parts.append(f'<path d="M{x-3:.1f},{y:.1f}h6M{x:.1f},{y-3:.1f}v6" '
                     f'stroke="{c}" stroke-width="1"/>')
        if matched:
            parts.append(f'<text x="{x+3:.1f}" y="{y-3:.1f}" font-size="6" '
                         f'fill="#06c">{grid_coords[i,0]},{grid_coords[i,1]}'
                         '</text>')
    if true_pixels is not None:
        for x, y in np.asarray(true_pixels):
            parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="1.2" '
                         'fill="none" stroke="#aaa"/>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts) + "\n")


def integration_strips(state, data, n=None):
    """Per frame-pair integrated IMU trajectories (GetIntegrationPoses,
    vicalibrator.h:508-533) for scene_svg: a list of (M-1, 3) host arrays,
    one per factor (the first ``n``), computed for all factors at once."""
    from .imu import preintegrate

    imu = data.imu
    if imu is None:
        return []
    K = imu.start.shape[0] if n is None else min(n, imu.start.shape[0])
    g_w = preintegrate.gravity_vector(state.g_dir)
    bg, ba = state.biases[:3], state.biases[3:]

    def one(wt, wg, wa, s, e, t0, q0, v0):
        seq_t, seq_g, seq_a = preintegrate.virtual_sequence(
            wt, wg, wa, s, e, state.time_offset)
        return preintegrate.integrate_trajectory(
            torch.cat([t0, q0, v0]), seq_t, seq_g, seq_a, bg, ba,
            state.scales, g_w)

    traj = vmap(one)(imu.win_times[:K], imu.win_gyro[:K],
                     imu.win_accel[:K], imu.start[:K], imu.end[:K],
                     state.t_wk[:K], state.q_wk[:K], state.v_w[:K])
    return list(traj.cpu().numpy())
