"""Connected components + ellipse (conic) extraction, batched torch.

Calibu ConicFinder equivalent: find dark blobs and fit ellipses, filtered by
``conic_min_area = 4``, ``conic_min_density = 0.6``, ``conic_min_aspect =
0.2``.

``find_conics_batch`` is the detection hot path: it pads a frame batch to
tile multiples, runs the plain threshold + labelling (kernels.py), gathers
blob moments per compact component id with ``index_add_``, and refines the
centers on the raw image.  Every shape is static given the frame size and
``max_conics``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .kernels import threshold_and_label


@dataclasses.dataclass(frozen=True)
class ConicParams:
    min_area: float = 4.0
    min_density: float = 0.6
    min_aspect: float = 0.2
    max_conics: int = 512          # static K for the compact ids
    cc_iters: int = 64             # label-propagation sweeps
    # sub-pixel refinement (refine_centers): iterative windowed darkness
    # centroid on the raw image.  0 iters disables.
    refine_iters: int = 3
    refine_power: float = 2.0
    refine_r_scale: float = 1.6    # window half-size ~ scale*radius + add
    refine_r_add: float = 1.0
    refine_r_min: int = 2
    refine_r_max: int = 6          # static gather shape = 2*r_max+1
    refine_vor: float = 0.45       # cap half-size at vor * nearest-neighbor
    #                                distance so tight grids don't pull in
    #                                neighboring dots' tails


def moments_from_compact(comp, img, params: ConicParams):
    """Blob moments -> ellipse centers/axes with Calibu's filters, from
    compact component ids (0 = background; ids above K are dropped).

    comp, img: (B, H, W) (or (H, W) for one frame).  Centroids use
    darkness-weighted moments ((255 - I) within the component); shape
    filters use the binary moments.  All in float32.  Returns a dict of
    (B, K, ...) tensors: center [x, y], radius, area, valid.
    """
    single = comp.dim() == 2
    if single:
        comp, img = comp[None], img[None]
    B, H, W = comp.shape
    K = params.max_conics
    dev = comp.device
    flat = comp.reshape(B, H * W).to(torch.int64)
    pix = torch.arange(H * W, device=dev)
    keep = (flat > 0) & (flat <= K)
    b_idx, p_idx = torch.nonzero(keep, as_tuple=True)
    seg = b_idx * (K + 1) + flat[b_idx, p_idx]
    pp = pix[p_idx]
    ys = torch.div(pp, W, rounding_mode="floor").to(torch.float32)
    xs = torch.remainder(pp, W).to(torch.float32)
    ones = torch.ones_like(xs)
    w = 255.0 - img.reshape(B, H * W)[b_idx, p_idx].to(torch.float32)
    vals = torch.stack([ones, xs, ys, xs * xs, ys * ys, xs * ys, w, w * xs,
                        w * ys], dim=-1)
    M = torch.zeros((B * (K + 1), 9), dtype=torch.float32, device=dev)
    M.index_add_(0, seg, vals)
    M = M.reshape(B, K + 1, 9)
    m00, m10, m01, m20, m02, m11, w00, wx, wy = M.unbind(-1)

    area = m00
    denom = torch.clamp(area, min=1.0)
    cx = m10 / denom
    cy = m01 / denom
    # central second moments around the binary centroid (shape filters)
    mu20 = m20 / denom - cx * cx
    mu02 = m02 / denom - cy * cy
    mu11 = m11 / denom - cx * cy
    # darkness-weighted centroid for the reported center (sub-pixel)
    w00 = torch.clamp(w00, min=1e-6)
    cx = wx / w00
    cy = wy / w00
    # ellipse semi-axes from the covariance eigenvalues (a = 2 sqrt(l))
    tr = mu20 + mu02
    det = mu20 * mu02 - mu11 * mu11
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    l1 = tr / 2.0 + disc
    l2 = torch.clamp(tr / 2.0 - disc, min=1e-6)
    a = 2.0 * torch.sqrt(torch.clamp(l1, min=1e-6))
    b = 2.0 * torch.sqrt(l2)
    aspect = b / torch.clamp(a, min=1e-6)
    density = area / torch.clamp(math.pi * a * b, min=1e-6)

    valid = ((area >= params.min_area)
             & (aspect >= params.min_aspect)
             & (density >= params.min_density))
    center = torch.stack([cx, cy], dim=-1)
    radius = torch.sqrt(torch.clamp(area, min=0.0) / math.pi)
    out = {"center": center[:, 1:K + 1], "radius": radius[:, 1:K + 1],
           "area": area[:, 1:K + 1], "valid": valid[:, 1:K + 1]}
    if single:
        out = {k: v[0] for k, v in out.items()}
    return out


def refine_centers(img, comp, centers, radius, valid, H, W,
                   params: ConicParams):
    """Sub-pixel center refinement: iterative windowed darkness centroid.

    Per dot: take a (2*r_max+1)^2 window at the rounded current center,
    estimate the background as the masked window max, weight each pixel by
    ``(bg - I)^power`` times a radial taper around the current center, and
    recenter; iterate.  The per-dot half-size scales with the detected
    radius and is capped at ``refine_vor`` times the nearest-detection
    distance; labelled pixels of other components are masked out.

    img, comp: (B, Hp, Wp) padded image + compact ids; centers (B, K, 2);
    radius, valid: (B, K).  H, W: the unpadded frame size.  Returns refined
    (B, K, 2).  Dots whose window leaves the HxW image keep their moments
    center.  As in the reference, the window's start is clamped to lie
    inside the padded frame.
    """
    B, Hp, Wp = img.shape
    K = centers.shape[1]
    dev = img.device
    dtype = img.dtype
    RO = params.refine_r_max
    WIN = 2 * RO + 1
    off = torch.arange(WIN, dtype=torch.int64, device=dev) - RO
    offx = off[None, :]
    offy = off[:, None]
    ids = torch.arange(1, K + 1, dtype=torch.int32, device=dev)
    # nearest-neighbor distance among valid detections (invalid -> +inf)
    d2 = torch.sum((centers[:, :, None, :] - centers[:, None, :, :]) ** 2,
                   dim=-1)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    d2 = torch.where(valid[:, None, :] & ~eye,
                     d2, torch.tensor(math.inf, dtype=d2.dtype, device=dev))
    dnn = torch.sqrt(torch.min(d2, dim=2).values)
    r_want = torch.round(params.refine_r_scale * radius + params.refine_r_add)
    r_vor = torch.floor(params.refine_vor * dnn)
    r_eff = torch.clamp(torch.minimum(r_want, r_vor), params.refine_r_min,
                        RO).to(torch.int64)                     # (B, K)
    reff = r_eff[..., None, None]
    rmask = (offx.abs() <= reff) & (offy.abs() <= reff)       # (B,K,WIN,WIN)
    rad2 = (r_eff.to(dtype) + 0.5) ** 2
    bsel = torch.arange(B, device=dev)[:, None, None, None]
    cid = ids[None, :, None, None]

    c = centers
    for _ in range(params.refine_iters):
        xi = torch.round(c[..., 0]).to(torch.int64)
        yi = torch.round(c[..., 1]).to(torch.int64)
        ok = ((xi - r_eff >= 0) & (xi + r_eff <= W - 1)
              & (yi - r_eff >= 0) & (yi + r_eff <= H - 1))
        y0, x0 = yi - RO, xi - RO
        y0c = torch.clamp(y0, 0, Hp - WIN)[..., None, None]
        x0c = torch.clamp(x0, 0, Wp - WIN)[..., None, None]
        rows = y0c + offy + RO
        cols = x0c + offx + RO
        patch = img[bsel, rows, cols]                    # (B,K,WIN,WIN)
        cp = comp[bsel, rows, cols]
        keep = rmask & ((cp == 0) | (cp == cid))
        bg = torch.amax(torch.where(keep, patch, -math.inf), dim=(-2, -1))
        wgt = torch.where(keep, torch.clamp(bg[..., None, None] - patch,
                                            min=0.0), 0.0) ** params.refine_power
        xs = (x0[..., None, None] + RO + offx).to(dtype)
        ys = (y0[..., None, None] + RO + offy).to(dtype)
        rr2 = (xs - c[..., 0, None, None]) ** 2 + (ys - c[..., 1, None, None]) ** 2
        wgt = wgt * torch.clamp(1.0 - rr2 / rad2[..., None, None], min=0.0)
        s = torch.sum(wgt, dim=(-2, -1))
        cx = torch.sum(wgt * xs, dim=(-2, -1)) / torch.clamp(s, min=1e-6)
        cy = torch.sum(wgt * ys, dim=(-2, -1)) / torch.clamp(s, min=1e-6)
        new = torch.stack([cx, cy], dim=-1)
        c = torch.where((ok & (s > 0))[..., None], new, c)
    return torch.where(valid[..., None], c, centers)


def _pad_to_tiles(imgs):
    """Edge-pad (B, H, W) on the bottom/right to tile multiples
    (H -> x8, W -> x128); returns (padded, H, W).  The pad changes the box
    mean near the right and bottom borders and the flat indices the labels
    rank by, so detections depend on it."""
    B, H, W = imgs.shape
    Hp = -(-H // 8) * 8
    Wp = -(-W // 128) * 128
    if (Hp, Wp) != (H, W):
        ys = torch.clamp(torch.arange(Hp, device=imgs.device), max=H - 1)
        xs = torch.clamp(torch.arange(Wp, device=imgs.device), max=W - 1)
        imgs = imgs[:, ys][:, :, xs].contiguous()
    return imgs, H, W


MAX_BATCH = 32      # frames per kernel call (bounds the moments and
#                     refinement intermediates)


def _extract_batch(comp, padded, H, W, params):
    """Drop tile-padding detections (after compaction, so slot numbering
    does not depend on the pad), then batched blob moments."""
    Hp, Wp = padded.shape[1:]
    iy = torch.arange(Hp, device=comp.device)[:, None]
    ix = torch.arange(Wp, device=comp.device)[None, :]
    inb = (iy < H) & (ix < W)
    comp = torch.where(inb[None], comp, 0)
    return moments_from_compact(comp, padded, params)


def find_conics_batch(imgs, params: ConicParams = ConicParams(),
                      at_threshold=0.9, at_window_ratio=30.0,
                      black_on_white=True, device="cuda"):
    """Batched pipeline over (B, H, W) frames (numpy or tensor, any dtype).

    Runs on ``device``.  Returns a dict of (B, K, ...)
    tensors on that device: center, radius, area, valid.  Detections in the
    bottom/right tile padding are discarded.  Batches above MAX_BATCH are
    processed in chunks.
    """
    dev = torch.device(device)
    if len(imgs) > MAX_BATCH:
        outs = [find_conics_batch(imgs[i:i + MAX_BATCH], params,
                                  at_threshold, at_window_ratio,
                                  black_on_white, device)
                for i in range(0, len(imgs), MAX_BATCH)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    if isinstance(imgs, np.ndarray):
        imgs = torch.from_numpy(np.ascontiguousarray(imgs))
    imgs = imgs.to(device=dev).to(torch.float32)
    B, H0, W0 = imgs.shape
    radius = max(int(W0 / at_window_ratio / 2), 1)
    padded, H, W = _pad_to_tiles(imgs)
    _, comp = threshold_and_label(
        padded.contiguous(), radius, at_threshold,
        black_on_white=black_on_white, n_iters=params.cc_iters,
        max_labels=params.max_conics)
    det = _extract_batch(comp, padded, H, W, params)
    if params.refine_iters > 0:
        det["center"] = refine_centers(padded, comp, det["center"],
                                       det["radius"], det["valid"], H, W,
                                       params)
    return det
