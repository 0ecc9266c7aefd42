"""Adaptive thresholding — the Calibu ImageProcessing equivalent (torch).

Grayscale frame -> local-mean adaptive threshold with ``at_threshold = 0.9``
and window ``width / at_window_ratio`` (ratio 30), ``black_on_white`` dots.
The box mean comes from a float32 integral image (2-D cumsum), so it is O(1)
per pixel.  The detection kernel (detect/kernels.py) sums its windows in
int32 instead, which is exact; this module is the portable single-frame
form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def box_mean(img, radius):
    """Local box mean with clamped borders via integral image.  img: (H, W)."""
    H, W = img.shape
    dev = img.device
    ii = torch.cumsum(torch.cumsum(img.to(torch.float32), 0), 1)
    ii = F.pad(ii, (1, 0, 1, 0))
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    y0 = torch.clamp(ys - radius, 0, H)
    y1 = torch.clamp(ys + radius + 1, 0, H)
    x0 = torch.clamp(xs - radius, 0, W)
    x1 = torch.clamp(xs + radius + 1, 0, W)
    a = ii[y1[:, None], x1[None, :]]
    b = ii[y0[:, None], x1[None, :]]
    c = ii[y1[:, None], x0[None, :]]
    d = ii[y0[:, None], x0[None, :]]
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).to(torch.float32)
    return (a - b - c + d) / area


def adaptive_threshold(img, at_threshold=0.9, at_window_ratio=30.0,
                       black_on_white=True, radius=None):
    """Binary foreground mask of dark dots on a light background.

    Foreground iff pixel < local_mean * at_threshold (black_on_white), the
    Calibu parameterization.  Returns (H, W) bool.
    """
    H, W = img.shape
    if radius is None:
        radius = max(int(W / at_window_ratio / 2), 1)
    mean = box_mean(img, radius)
    imgf = img.to(torch.float32)
    if black_on_white:
        t = torch.tensor(at_threshold, dtype=torch.float32, device=img.device)
        return imgf < mean * t
    t = torch.tensor(2.0 - at_threshold, dtype=torch.float32,
                     device=img.device)
    return imgf > mean * t
