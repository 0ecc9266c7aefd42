"""Adaptive threshold + connected-component labels, plain PyTorch.

The plain version of the program's threshold + labelling kernel (the
program's kernel equals it bit for bit), kept here as the reference's own
detector.  Per frame of a
(B, H, W) float32 batch, edge-padded so that H % 8 == 0 and W % 128 == 0:

(a) box mean over the clamped (2r+1)^2 window, summed exactly in int32;
(b) mask = img < mean * t (black on white), else img > mean * (2 - t);
(c) 8-connected labels = minimum 1-based flat index of the component, by
    Jacobi 3x3 min sweeps until a sweep changes nothing or ``n_iters``
    sweeps ran;
(d) compact ids: a representative is a masked pixel that kept its own
    index, its id is its rank in flat order, ids above ``max_labels`` become
    0, and the ids spread through the mask by a second bounded sweep.

Output: ``(labels > 0, labels)`` with labels int32, 0 = background.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BIG = torch.iinfo(torch.int32).max


def threshold_and_label(imgs, radius, at_threshold=0.9, black_on_white=True,
                        n_iters=64, max_labels=512):
    """Fused adaptive threshold + CC labelling over a frame batch (plain)."""
    return threshold_and_label_ref(imgs, radius, at_threshold,
                                   black_on_white, n_iters, max_labels)


# ----------------------------------------------------------------- plain
def _threshold_mask(imgs, radius, at_threshold, black_on_white):
    """(a) + (b): exact int window sums, float32 mean and compare."""
    B, H, W = imgs.shape
    dev = imgs.device
    r = int(radius)
    v = imgs.to(torch.int32).to(torch.int64)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    y0 = torch.clamp(ys - r, min=0)
    y1 = torch.clamp(ys + r, max=H - 1)
    x0 = torch.clamp(xs - r, min=0)
    x1 = torch.clamp(xs + r, max=W - 1)
    cy = F.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))          # (B, H+1, W)
    col = cy[:, y1 + 1] - cy[:, y0]                           # (B, H, W)
    cx = F.pad(torch.cumsum(col, dim=2), (1, 0))              # (B, H, W+1)
    s = cx[:, :, x1 + 1] - cx[:, :, x0]
    cnt = ((y1 - y0 + 1)[:, None] * (x1 - x0 + 1)[None, :])
    mean = s.to(torch.float32) / cnt.to(torch.float32)
    if black_on_white:
        t = torch.tensor(at_threshold, dtype=torch.float32, device=dev)
        return imgs < mean * t
    t = torch.tensor(2.0 - at_threshold, dtype=torch.float32, device=dev)
    return imgs > mean * t


def _sweep(labels, mask):
    """One Jacobi 3x3 min sweep (separable: column min, then row min)."""
    p = F.pad(labels, (1, 1, 1, 1), value=BIG)
    r = torch.minimum(torch.minimum(p[:, :-2], p[:, 1:-1]), p[:, 2:])
    m = torch.minimum(torch.minimum(r[:, :, :-2], r[:, :, 1:-1]),
                      r[:, :, 2:])
    return torch.where(mask, m, BIG)


def _propagate(labels, mask, n_iters):
    """Bounded sweeps, each frame until a sweep changes nothing.  Returns
    (labels, sweeps (B,) int64): the sweeps the kernel runs per frame."""
    B = labels.shape[0]
    active = torch.ones(B, dtype=torch.bool, device=labels.device)
    sweeps = torch.zeros(B, dtype=torch.int64, device=labels.device)
    for _ in range(n_iters):
        new = _sweep(labels, mask)
        sweeps += active
        active = active & (new != labels).flatten(1).any(dim=1)
        labels = new
        if not bool(active.any()):
            break
    return labels, sweeps


def threshold_and_label_ref(imgs, radius, at_threshold=0.9,
                            black_on_white=True, n_iters=64, max_labels=512,
                            return_sweeps=False):
    """Plain PyTorch version of the kernel, on any device.

    With ``return_sweeps`` also returns the (B, 2) sweeps of the label and
    compact phases per frame, the work the kernel does on these inputs.
    """
    B, H, W = imgs.shape
    dev = imgs.device
    mask = _threshold_mask(imgs, radius, at_threshold, black_on_white)
    idx = (torch.arange(H * W, dtype=torch.int32, device=dev)
           + 1).reshape(H, W)
    labels = torch.where(mask, idx, BIG)
    labels, sw_a = _propagate(labels, mask, n_iters)
    rep = mask & (labels == idx)
    rank = torch.cumsum(rep.reshape(B, H * W).to(torch.int32), dim=1,
                        dtype=torch.int32).reshape(B, H, W)
    cid = torch.where(rank <= max_labels, rank, 0)
    compact, sw_b = _propagate(torch.where(rep, cid, BIG), mask, n_iters)
    out = torch.where(mask, compact, 0)
    if return_sweeps:
        return out > 0, out, torch.stack([sw_a, sw_b], dim=1)
    return out > 0, out
