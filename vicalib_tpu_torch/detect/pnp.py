"""Batched planar pose estimation (PnP) for per-frame initialization.

Reference analog: calibu::PosePnPRansac seeding each frame's pose before the
solve.  The target is planar, so PnP is a homography DLT + decomposition,
batched over any leading dims (frames, hypotheses), with a RANSAC whose
hypotheses are all evaluated in one batch.

All functions work in normalized camera coordinates: pixels are unprojected
through the current camera model first, so distortion is handled by the
model's ``unproject``.
"""
from __future__ import annotations

import torch

from ..geometry import se3, so3


def _normalise(pts, w):
    """Hartley normalisation of points (..., N, 2) under weights (..., N):
    the points moved to their weighted centroid and scaled to unit rms
    distance, and the (..., 3, 3) transform that does it."""
    sw = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mu = torch.sum(pts * w[..., None], dim=-2) / sw               # (..., 2)
    sc = torch.sqrt(torch.sum(w[..., None] * (pts - mu[..., None, :]) ** 2,
                              dim=(-2, -1)) / sw[..., 0]) + 1e-9
    z = torch.zeros_like(sc)
    o = torch.ones_like(sc)
    T = torch.stack([
        torch.stack([1 / sc, z, -mu[..., 0] / sc], dim=-1),
        torch.stack([z, 1 / sc, -mu[..., 1] / sc], dim=-1),
        torch.stack([z, z, o], dim=-1)], dim=-2).to(pts.dtype)
    return (pts - mu[..., None, :]) / sc[..., None, None], T


def _dlt_normal(xy_plane, xy_norm, w):
    """A^T A of the weighted DLT of a plane->image homography.
    (..., N, 2), (..., N, 2), (..., N) -> (..., 9, 9)."""
    x, y = xy_plane[..., 0], xy_plane[..., 1]
    u, v = xy_norm[..., 0], xy_norm[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    return A.transpose(-1, -2) @ A


def _dlt_homography(xy_plane, xy_norm, w):
    """Weighted DLT homography plane->normalized-image.
    (..., N, 2), (..., N, 2), (..., N) -> (..., 3, 3)."""
    # smallest right singular vector of A == eigenvector of A^T A
    _, evecs = torch.linalg.eigh(_dlt_normal(xy_plane, xy_norm, w))
    h = evecs[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def _pose_from_homography(H):
    """Decompose a plane->normalized-image homography into (R, t), T_cw.

    H ~ [r1 r2 t]; scale fixed by |r1|; orthogonalized via SVD; sign fixed
    so that the plane origin has positive depth.
    """
    H = H * torch.sign(H[..., 2, 2])[..., None, None]
    scale = 0.5 * (torch.linalg.norm(H[..., :, 0], dim=-1)
                   + torch.linalg.norm(H[..., :, 1], dim=-1))
    Hn = H / torch.clamp(scale, min=1e-12)[..., None, None]
    r1, r2, t = Hn[..., :, 0], Hn[..., :, 1], Hn[..., :, 2]
    r3 = so3.cross(r1, r2)
    R_approx = torch.stack([r1, r2, r3], dim=-1)
    # project onto SO(3)
    Uu, _, Vt = torch.linalg.svd(R_approx)
    d = torch.linalg.det(Uu @ Vt)
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (Uu * diag[..., None, :]) @ Vt
    return R, t


def pnp_planar(rays_xy, p3d_xy, valid):
    """Pose T_cw from plane points.  rays_xy: (..., N, 2) normalized image
    coords, p3d_xy: (..., N, 2) plane coords (z=0), valid: (..., N) 0/1
    weights.  Returns (q_cw (..., 4), t_cw (..., 3))."""
    w = valid / torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1.0)
    pn, Tp = _normalise(p3d_xy.expand_as(rays_xy), w)
    rn, Tr = _normalise(rays_xy, w)
    Hn = _dlt_homography(pn, rn, valid)
    H = torch.linalg.solve(Tr, Hn @ Tp)
    R, t = _pose_from_homography(H)
    return so3.from_matrix(R), t


def reprojection_errors(q_cw, t_cw, rays_xy, p3d_xy):
    """Normalized-coordinate reprojection error per point, (..., N)."""
    p3 = torch.cat([p3d_xy, torch.zeros_like(p3d_xy[..., :1])], dim=-1)
    pc = so3.rotate(q_cw[..., None, :], p3) + t_cw[..., None, :]
    proj = pc[..., :2] / torch.clamp(pc[..., 2:3], min=1e-9)
    return torch.linalg.norm(proj - rays_xy, dim=-1)


def draw_sample_idx(valid, n_hyp, seeds):
    """RANSAC minimal samples: (F, n_hyp, 4) point indices drawn with
    replacement, with probability proportional to validity, from a
    ``torch.Generator`` seeded per frame with ``seeds[f]``.
    valid: (F, N)."""
    F, N = valid.shape
    dev = valid.device
    probs = valid / torch.clamp(torch.sum(valid, dim=1, keepdim=True),
                                min=1.0)
    has = (torch.sum(valid, dim=1) > 0).tolist()
    g = torch.Generator(device=dev)
    out = []
    for f in range(F):
        g.manual_seed(int(seeds[f]))          # as fresh as a new generator
        p = probs[f] if has[f] else torch.ones(N, dtype=probs.dtype,
                                               device=dev)
        out.append(torch.multinomial(p, n_hyp * 4, replacement=True,
                                     generator=g).reshape(n_hyp, 4))
    return torch.stack(out)


def pnp_ransac(rays_xy, p3d_xy, valid, n_hyp=64, inlier_thresh=0.01,
               seed=0, sample_idx=None):
    """RANSAC planar PnP, all hypotheses in one batch.

    rays_xy: (..., N, 2); p3d_xy: (N, 2) or (..., N, 2); valid: (..., N).
    Each hypothesis fits a homography to 4 sampled valid points; the best
    hypothesis by inlier count is refined on its inliers.  ``sample_idx``
    (..., n_hyp, 4) gives the samples; by default they are drawn by
    :func:`draw_sample_idx` with seed ``seed`` (an int for one frame, or one
    seed per frame).  Returns (q_cw, t_cw, inlier_mask).
    """
    batch = rays_xy.shape[:-2]
    N = rays_xy.shape[-2]
    dtype = rays_xy.dtype
    if sample_idx is None:
        v2 = valid.reshape(-1, N)
        seeds = ([seed] if isinstance(seed, int) else list(seed))
        if len(seeds) != v2.shape[0]:
            raise ValueError("one seed per frame expected")
        sample_idx = draw_sample_idx(v2, n_hyp, seeds).reshape(
            batch + (n_hyp, 4))
    n_hyp = sample_idx.shape[-2]
    sel = torch.zeros(batch + (n_hyp, N), dtype=dtype, device=rays_xy.device)
    sel.scatter_(-1, sample_idx.to(torch.int64), 1.0)
    sel = sel * valid[..., None, :]
    p3 = p3d_xy.expand(batch + (N, 2)) if p3d_xy.dim() == 2 else p3d_xy
    rays_h = rays_xy[..., None, :, :].expand(batch + (n_hyp, N, 2))
    p3_h = p3[..., None, :, :].expand(batch + (n_hyp, N, 2))
    qs, ts = pnp_planar(rays_h, p3_h, sel)
    err = reprojection_errors(qs, ts, rays_h, p3_h)
    inl = (err < inlier_thresh) & (valid[..., None, :] > 0)
    scores = torch.sum(inl, dim=-1)
    best = torch.argmax(scores, dim=-1)                       # (...)
    q0 = torch.gather(qs, -2, best[..., None, None].expand(
        batch + (1, 4)))[..., 0, :]
    t0 = torch.gather(ts, -2, best[..., None, None].expand(
        batch + (1, 3)))[..., 0, :]
    err = reprojection_errors(q0, t0, rays_xy, p3)
    inliers = ((err < inlier_thresh) & (valid > 0)).to(dtype)
    q, t = pnp_planar(rays_xy, p3, inliers)
    return q, t, inliers


def init_frame_poses(model, params, pixels, p3d, valid, T_ck,
                     use_ransac=False, sample_idx=None):
    """Initialize rig poses T_wk for all frames from one camera's detections.

    pixels: (F, P, 2); p3d: (P, 3) target points (z=0 plane); valid: (F, P);
    T_ck: (q, t).  T_wk = T_cw^-1 * T_ck.  RANSAC draws frame f's samples
    with seed f unless ``sample_idx`` (F, n_hyp, 4) is given.
    Returns (q_wk (F,4), t_wk (F,3)).
    """
    rays = model.unproject(pixels, params)[..., :2]
    p3d_xy = p3d[:, :2].to(rays.dtype)
    valid = valid.to(rays.dtype)
    F = rays.shape[0]
    if use_ransac:
        q, t, _ = pnp_ransac(rays, p3d_xy, valid, seed=range(F),
                             sample_idx=sample_idx)
    else:
        q, t = pnp_planar(rays, p3d_xy.expand(F, -1, -1), valid)
    T_ck = (T_ck[0].expand(F, 4), T_ck[1].expand(F, 3))
    return se3.mul(se3.inverse((q, t)), T_ck)
