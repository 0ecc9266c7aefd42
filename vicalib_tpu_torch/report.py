"""Self-contained HTML calibration report — the headless replacement for
the reference's Pangolin diagnostics GUI (vicalib-task.cc:154-225, 414-605:
live reprojection-error view, 2-D detection overlay, 3-D scene).

A batch pipeline wants the same information *after* the run: where the
target was seen in the image, how the reprojection errors are distributed,
how each stage converged, and what the inertial parameters came out as.
``write_html_report`` renders all of that into one dependency-free HTML
file (inline SVG charts; opens anywhere, archivable next to cameras.xml).

Enabled with ``-report_file report.html`` (a new capability — the
reference can only show this interactively while running).  The numbers
come from the solved state on its device; each array is copied to the host
once.
"""
from __future__ import annotations

import html

import numpy as np
import torch


def _np(x):
    """Host numpy copy of a tensor (or array-like)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ----------------------------------------------------------------- svg bits
def _svg_open(w, h):
    return (f'<svg viewBox="0 0 {w} {h}" width="{w}" height="{h}" '
            f'xmlns="http://www.w3.org/2000/svg" '
            f'style="background:#fff;border:1px solid #ccc">')


def _polyline(xs, ys, color, width=1.5):
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    return (f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="{width}"/>')


_COLORS = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd", "#ff7f0e",
           "#8c564b", "#e377c2", "#17becf"]


def _axis_labels(w, h, pad, x_label, y_label, y_max, x_max):
    out = [f'<line x1="{pad}" y1="{h - pad}" x2="{w - 8}" y2="{h - pad}" '
           f'stroke="#333"/>',
           f'<line x1="{pad}" y1="{h - pad}" x2="{pad}" y2="8" '
           f'stroke="#333"/>',
           f'<text x="{(w + pad) / 2}" y="{h - 4}" font-size="11" '
           f'text-anchor="middle" fill="#333">{x_label}</text>',
           f'<text x="10" y="{(h - pad) / 2}" font-size="11" fill="#333" '
           f'transform="rotate(-90 10 {(h - pad) / 2})" '
           f'text-anchor="middle">{y_label}</text>',
           f'<text x="{pad - 3}" y="14" font-size="10" text-anchor="end" '
           f'fill="#666">{y_max:.3g}</text>',
           f'<text x="{w - 8}" y="{h - pad + 12}" font-size="10" '
           f'text-anchor="end" fill="#666">{x_max:.4g}</text>']
    return "".join(out)


def _timeline_svg(series, x_label, y_label, w=640, h=180):
    """series: list of (label, (N,) values)."""
    pad = 42
    n = max(len(v) for _, v in series)
    y_max = max(1e-9, max(float(np.max(v)) for _, v in series if len(v)))
    parts = [_svg_open(w, h),
             _axis_labels(w, h, pad, x_label, y_label, y_max, n)]
    for i, (label, v) in enumerate(series):
        if not len(v):
            continue
        xs = pad + (np.arange(len(v)) / max(len(v) - 1, 1)) * (w - pad - 10)
        ys = (h - pad) - (np.asarray(v, float) / y_max) * (h - pad - 12)
        c = _COLORS[i % len(_COLORS)]
        parts.append(_polyline(xs, ys, c))
        parts.append(f'<text x="{w - 10}" y="{16 + 13 * i}" font-size="11" '
                     f'text-anchor="end" fill="{c}">{html.escape(label)}'
                     f'</text>')
    parts.append("</svg>")
    return "".join(parts)


def _hist_svg(series, x_label, w=640, h=180, bins=40):
    """Overlaid per-camera histograms: series = [(label, values)]."""
    pad = 42
    hi = max(1e-9, max((float(np.percentile(v, 99.5)) if len(v) else 0.0)
                       for _, v in series))
    counts = []
    for label, v in series:
        c, edges = np.histogram(np.clip(v, 0, hi), bins=bins, range=(0, hi))
        counts.append((label, c, edges))
    y_max = max(1, max(int(c.max()) for _, c, _ in counts))
    parts = [_svg_open(w, h),
             _axis_labels(w, h, pad, x_label, "count", y_max, hi)]
    for i, (label, c, edges) in enumerate(counts):
        xs = pad + (0.5 * (edges[:-1] + edges[1:]) / hi) * (w - pad - 10)
        ys = (h - pad) - (c / y_max) * (h - pad - 12)
        col = _COLORS[i % len(_COLORS)]
        parts.append(_polyline(xs, ys, col))
        parts.append(f'<text x="{w - 10}" y="{16 + 13 * i}" font-size="11" '
                     f'text-anchor="end" fill="{col}">{html.escape(label)}'
                     f'</text>')
    parts.append("</svg>")
    return "".join(parts)


def _coverage_svg(pixels, valid, width, height, w=320):
    """Detected-dot coverage over the image plane (GUI 2-D overlay analog:
    did the capture sweep the whole sensor?)."""
    h = max(int(w * height / max(width, 1)), 40)
    sx = w / max(width, 1)
    sy = h / max(height, 1)
    parts = [_svg_open(w, h)]
    pts = pixels[valid]
    step = max(len(pts) // 4000, 1)          # cap the svg size
    for u, v in np.asarray(pts[::step], float):
        parts.append(f'<circle cx="{u * sx:.1f}" cy="{v * sy:.1f}" r="1" '
                     f'fill="#1f77b4" fill-opacity="0.25"/>')
    parts.append("</svg>")
    return "".join(parts)


# ----------------------------------------------------------------- report
def write_html_report(path, model_names, state, data, result, stats,
                      widths, heights, target=None):
    """Render the post-run diagnostic report.

    ``data`` is the solved ProblemData (per-camera CameraObs), ``result``
    the StagedResult, ``stats`` the CalibrationStats the engine publishes.
    """
    from .geometry import quat_np
    from .solver.residuals import reproj_residuals

    C = len(model_names)
    F = data.n_frames

    # per-observation reprojection errors at the solution
    err_per_cam = []
    frame_rmse = []
    for c in range(C):
        obs = data.obs[c]
        r = _np(reproj_residuals(state, obs, c, model_names[c]))
        e = np.linalg.norm(r, axis=1)
        v = _np(obs.valid) > 0
        err_per_cam.append(e[v])
        fidx = _np(obs.frame_idx)
        sq = np.bincount(fidx, weights=e * e * v, minlength=F)
        cnt = np.maximum(np.bincount(fidx, weights=v.astype(float),
                                     minlength=F), 1)
        frame_rmse.append(np.sqrt(sq / cnt))

    rows = []
    rows.append("<!doctype html><html><head><meta charset='utf-8'>"
                "<title>vicalib_tpu_torch calibration report</title>"
                "<style>body{font-family:sans-serif;margin:24px;max-width:"
                "960px}table{border-collapse:collapse;margin:8px 0}"
                "td,th{border:1px solid #bbb;padding:3px 9px;font-size:13px;"
                "text-align:right}th{background:#f2f2f2}h2{margin-top:28px}"
                "code{background:#f6f6f6;padding:1px 4px}</style></head>"
                "<body>")
    ok = "SUCCESS" if getattr(stats, "status", None) is None or \
        str(stats.status).endswith("SUCCESS") else "FAILURE"
    rows.append(f"<h1>Calibration report — {ok}</h1>")
    rows.append(f"<p>{C} camera(s), {F} frames, "
                f"{result.total_iterations} solver iterations, "
                f"mse {result.mse:.3e}</p>")

    # stage table (PrintResults analog)
    rows.append("<h2>Solver stages</h2><table><tr><th>stage</th>"
                "<th>iterations</th><th>cost</th><th>wall [s]</th></tr>")
    for name, iters, cost, wall in result.stages_run:
        rows.append(f"<tr><td style='text-align:left'>{html.escape(name)}"
                    f"</td><td>{iters}</td><td>{cost:.6e}</td>"
                    f"<td>{wall:.2f}</td></tr>")
    rows.append("</table>")

    # per-camera parameters
    rows.append("<h2>Cameras</h2>")
    intr_all, q_all, t_all = _np(state.intr), _np(state.q_ck), _np(state.p_ck)
    for c in range(C):
        intr, q, t = intr_all[c], q_all[c], t_all[c]
        T = np.eye(4)
        T[:3, :3] = quat_np.to_matrix(q)
        T[:3, 3] = t
        rmse = float(result.cam_rmse[c])
        rows.append(f"<h3>camera {c} — {html.escape(model_names[c])}, "
                    f"rmse {rmse:.4f} px</h3>")
        n = {"linear": 4, "fov": 5, "poly2": 6, "poly3": 7,
             "rational6": 10, "kb4": 8}.get(model_names[c], 4)
        rows.append("<table><tr><th>params</th><td>"
                    + ", ".join(f"{v:.6g}" for v in intr[:n])
                    + "</td></tr><tr><th>T_ck</th><td><code>"
                    + "<br>".join(
                        " ".join(f"{v: .6f}" for v in row) for row in T[:3])
                    + "</code></td></tr></table>")
        rows.append("<p>sensor coverage of detected dots "
                    f"({widths[c]}x{heights[c]}):</p>")
        obs = data.obs[c]
        rows.append(_coverage_svg(
            _np(obs.p_c).reshape(-1, 2),
            _np(obs.valid).reshape(-1) > 0, widths[c], heights[c]))

    # error distributions
    rows.append("<h2>Reprojection errors</h2>")
    rows.append(_hist_svg([(f"cam{c}", err_per_cam[c]) for c in range(C)],
                          "reprojection error [px]"))
    rows.append("<p>per-frame RMSE over the capture:</p>")
    rows.append(_timeline_svg([(f"cam{c}", frame_rmse[c])
                               for c in range(C)],
                              "frame", "rmse [px]"))

    # inertial block
    if data.imu is not None:
        from .imu.preintegrate import gravity_vector

        b = _np(state.biases)
        sf = _np(state.scales)
        g = _np(gravity_vector(state.g_dir))
        rows.append("<h2>Inertial parameters</h2><table>")
        rows.append("<tr><th>gyro bias [rad/s]</th><td>"
                    + ", ".join(f"{v:.6g}" for v in b[:3]) + "</td></tr>")
        rows.append("<tr><th>accel bias [m/s&sup2;]</th><td>"
                    + ", ".join(f"{v:.6g}" for v in b[3:]) + "</td></tr>")
        rows.append("<tr><th>scale factors</th><td>"
                    + ", ".join(f"{v:.6g}" for v in sf) + "</td></tr>")
        rows.append("<tr><th>gravity (world) [m/s&sup2;]</th><td>"
                    + ", ".join(f"{v:.5g}" for v in g) + "</td></tr>")
        rows.append("<tr><th>camera&harr;IMU time offset [s]</th>"
                    f"<td>{float(_np(state.time_offset)):.6f}</td></tr>")
        rows.append("</table>")

    if result.covariance is not None:
        sd = np.sqrt(np.maximum(np.diag(result.covariance), 0.0))
        rows.append("<h2>Shared-parameter standard deviations</h2>")
        rows.append("<table><tr><th>block</th><th>sigma</th></tr>")
        for name, start, size in data.layout.block_names():
            rows.append(f"<tr><td style='text-align:left'>"
                        f"{html.escape(name)}</td><td>"
                        + ", ".join(f"{v:.3g}" for v in
                                    sd[start:start + size]) + "</td></tr>")
        rows.append("</table>")

    rows.append("</body></html>")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    return path
