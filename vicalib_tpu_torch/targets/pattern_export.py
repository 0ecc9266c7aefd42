"""Export a target grid as a printable EPS or SVG pattern.

Reference analog: calibu::TargetGridDot::SaveEPS / SaveSVG used by
-output_pattern_file (reference: src/vicalib-engine.cc:467-494).
"""
from __future__ import annotations

from .grid import TargetGrid

_PTS_PER_M = 72.0 / 2.54 * 100.0  # points per meter (vicalib-engine.cc:479)


def save_eps(target: TargetGrid, path: str, pts_per_unit: float = _PTS_PER_M):
    w_pt = (target.cols - 1) * target.spacing * pts_per_unit
    h_pt = (target.rows - 1) * target.spacing * pts_per_unit
    margin = 2 * target.large_rad * pts_per_unit
    lines = [
        "%!PS-Adobe-3.0 EPSF-3.0",
        f"%%BoundingBox: 0 0 {w_pt + 2 * margin:.2f} {h_pt + 2 * margin:.2f}",
        "%%EndComments",
        "0 setgray",
    ]
    radii = target.radii()
    for idx, (x, y, _) in enumerate(target.circles_3d()):
        cx = x * pts_per_unit + margin
        cy = y * pts_per_unit + margin
        r = radii[idx] * pts_per_unit
        lines.append(f"newpath {cx:.3f} {cy:.3f} {r:.3f} 0 360 arc fill")
    lines.append("showpage")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def save_svg(target: TargetGrid, path: str, px_per_m: float = 10000.0):
    w = ((target.cols - 1) * target.spacing + 4 * target.large_rad) * px_per_m
    h = ((target.rows - 1) * target.spacing + 4 * target.large_rad) * px_per_m
    margin = 2 * target.large_rad * px_per_m
    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.1f}" '
        f'height="{h:.1f}" viewBox="0 0 {w:.1f} {h:.1f}">',
        f'<rect width="{w:.1f}" height="{h:.1f}" fill="white"/>',
    ]
    radii = target.radii()
    for idx, (x, y, _) in enumerate(target.circles_3d()):
        cx = x * px_per_m + margin
        cy = y * px_per_m + margin
        r = radii[idx] * px_per_m
        lines.append(
            f'<circle cx="{cx:.2f}" cy="{cy:.2f}" r="{r:.2f}" fill="black"/>')
    lines.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
