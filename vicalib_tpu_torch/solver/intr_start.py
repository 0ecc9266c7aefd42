"""A closed-form start of each camera's intrinsics from its own detections.

Upstream starts every camera at f = 300 with zero distortion
(vicalib-engine.cc:207-257).  A camera whose focal length or distortion is
far from that (the EuRoC rig: f = 458, k1 = -0.28) can then land in a wrong
basin of the visual stage, and PnP seeds the frame poses from the same
wrong camera.  Here the start comes from the target's plane-to-pixel
homographies instead:

1. the pixels, centred on the image centre, undistorted (for a model with
   distortion) by a division model whose one coefficient makes the
   homographies fit best, which needs no focal length;
2. one homography per frame (``pnp._dlt_homography`` on Hartley-normalised
   points), from the target plane to those pixels;
3. Zhang's two constraints per homography, with the principal point at the
   image centre and zero skew, solved for 1/fx^2 and 1/fy^2 by least
   squares over all frames (a single f where fx and fy are not separable);
4. each frame's pose from its homography, then fx, fy and the model's
   leading distortion terms by linear least squares on those poses
   (``fov``: a search over w); a term the points cannot fix keeps its
   default;
5. steps 2-4 again on pixels undistorted by the model's own estimate,
   until the estimate stops moving (a fixed point, extrapolated).

Frames with fewer than 4 detections, or whose homography is ill-conditioned,
do not vote.  With no usable frame, or no positive focal length from
Zhang's constraints, a camera keeps the default (and the log says so);
where the later rounds fit the pixels worse than the first, the first
round's estimate is kept.  Host work: torch float64 on the CPU, whatever
the solve's device.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from .. import obs
from ..cameras import get_model
from ..cameras.models import default_params_np
from ..detect.pnp import (_dlt_homography, _dlt_normal, _normalise,
                          _pose_from_homography)

log = logging.getLogger("vicalib_tpu_torch.engine")

MIN_POINTS = 4
MAX_FRAMES = 32
# extrapolation steps of the fixed point (each up to three rounds)
MAX_STEPS = 8
# the rounds stop when a step moves f / image size and each term by less
TOL = 1e-3
# samples of the radial table that undistorts the pixels
TABLE = 4096
# values of each of the three scans of the first undistortion
SCAN = 13
# a homography votes when its DLT null space is one-dimensional: the second
# smallest eigenvalue of the normalised A^T A above this share of the largest
MIN_EIG_RATIO = 1e-8
# a least-squares column set is kept while its condition stays below this
MAX_COND = 1e8

# the parameter indices of the distortion terms fitted linearly (the
# leading two; rational6's are its numerator's k1, k2)
_RADIAL = {"poly2": (4, 5), "poly3": (4, 5), "rational6": (4, 5),
           "kb4": (4, 5)}


def _homographies(plane_xy, img_xy, w):
    """Plane -> image homographies (F, 3, 3), each of unit norm."""
    pn, Tp = _normalise(plane_xy, w)
    qn, Tq = _normalise(img_xy, w)
    H = torch.linalg.solve(Tq, _dlt_homography(pn, qn, w) @ Tp)
    return H / torch.clamp(torch.linalg.norm(H, dim=(-2, -1)),
                           min=1e-300)[..., None, None]


def _well_conditioned(plane_xy, img_xy, w):
    """(F,) whether each frame's DLT has a one-dimensional null space: the
    second smallest eigenvalue of its normalised A^T A above MIN_EIG_RATIO
    of the largest (not so for points on or near one line)."""
    ev = torch.linalg.eigvalsh(_dlt_normal(_normalise(plane_xy, w)[0],
                                           _normalise(img_xy, w)[0], w))
    return ev[..., 1] > MIN_EIG_RATIO * torch.clamp(ev[..., -1], min=1e-300)


def _lstsq(M, rhs):
    """Least squares with column scaling; None where the scaled columns'
    condition number exceeds MAX_COND."""
    scale = torch.clamp(torch.linalg.norm(M, dim=0), min=1e-300)
    Ms = M / scale
    s = torch.linalg.svdvals(Ms)
    if s.numel() == 0 or not bool(s[-1] > s[0] / MAX_COND):
        return None
    return torch.linalg.lstsq(Ms, rhs[:, None]).solution[:, 0] / scale


def _zhang_focal(H):
    """fx, fy of homographies to centred pixels (principal point 0, zero
    skew): Zhang's h1' B h2 = 0 and h1' B h1 = h2' B h2 with B = diag(a, b,
    1), a = 1/fx^2, b = 1/fy^2.  A single f (a = b) where the two are not
    separable; None where neither gives a positive solution."""
    h1, h2 = H[..., :, 0], H[..., :, 1]
    M = torch.cat([torch.stack([h1[:, 0] * h2[:, 0], h1[:, 1] * h2[:, 1]], -1),
                   torch.stack([h1[:, 0] ** 2 - h2[:, 0] ** 2,
                                h1[:, 1] ** 2 - h2[:, 1] ** 2], -1)])
    rhs = -torch.cat([h1[:, 2] * h2[:, 2], h1[:, 2] ** 2 - h2[:, 2] ** 2])
    ab = _lstsq(M, rhs)
    if ab is None or not bool((ab > 0).all()):
        a = _lstsq(M.sum(-1, keepdim=True), rhs)
        if a is None or not bool(a[0] > 0):
            return None
        ab = a.expand(2)
    return 1.0 / torch.sqrt(ab)


@functools.lru_cache(maxsize=1)
def _table_rays():
    """(TABLE, 3) rays along x at angles from 0 to 1.55 rad off the axis."""
    ru = torch.tan(torch.linspace(0.0, 1.55, TABLE, dtype=torch.float64))
    return torch.stack([ru, torch.zeros_like(ru), torch.ones_like(ru)], -1)


def _radial_table(model, params, rd_max):
    """The model's distorted radius r_d against the undistorted r_u (unit
    focal length; every model here is radially symmetric), sampled from 0
    to where r_d reaches ``rd_max``: (r_d, r_u) increasing, or None where
    r_d is not increasing up to ``rd_max`` (no inverse there)."""
    unit = params.clone()
    unit[0:2], unit[2:4] = 1.0, 0.0
    xyz = _table_rays()
    ru = xyz[:, 0]
    rd = model.project(xyz, unit)[:, 0].contiguous()
    reach = torch.nonzero(rd >= rd_max)
    if len(reach) == 0:
        return None
    n = int(reach[0]) + 1
    rd, ru = rd[:n], ru[:n]
    if n < 2 or not bool((rd[1:] > rd[:-1]).all()):
        return None
    return rd, ru


def _undistort(model, params, pixc, w):
    """Centred pixels (..., 2) undistorted by ``params``, in pixels, by
    interpolation in the radial table; None where the model has no
    inverse over those of weight ``w`` > 0."""
    f = params[0:2]
    xd = pixc / f
    rd = torch.linalg.norm(xd, dim=-1)
    tab = _radial_table(model, params, float(rd[w > 0].max()))
    if tab is None:
        return None
    rd_t, ru_t = tab
    ru = torch.from_numpy(np.interp(rd.numpy(), rd_t.numpy(), ru_t.numpy()))
    scale = torch.where(rd > 0, ru / torch.clamp(rd, min=1e-300),
                        torch.ones_like(rd))
    return xd * scale[..., None] * f


def _model_columns(name, xu):
    """For normalised undistorted points xu (..., 2): the undistorted
    projection ``base`` and the radial factors ``g`` of the fitted terms,
    with x_d = base * (1 + sum_j k_j g_j)."""
    r2 = (xu * xu).sum(-1, keepdim=True)
    if name == "kb4":
        r = torch.sqrt(torch.clamp(r2, min=1e-24))
        theta = torch.atan(r)
        t2 = theta * theta
        return xu * theta / r, [t2, t2 * t2]
    return xu, [r2, r2 * r2]


def _fit(model, default, xu, pixc):
    """fx, fy and the model's leading distortion terms from the poses'
    undistorted points xu and the centred pixels pixc (N, 2): per axis
    u = f * base * (1 + sum_j k_j g_j), linear in f and f k_j; k_j is the
    mean of the two axes.  ``fov``: the w of a search whose f is linear.
    The last term is dropped, and keeps its value in ``default``, while
    the points cannot fix it (the columns' condition number over
    MAX_COND) or it leaves the model without an inverse over the
    points."""
    p = default.clone()
    if model.name == "fov":
        ws = torch.linspace(0.02, 2.5, 125, dtype=xu.dtype)
        trial = p.expand(len(ws), -1).clone()
        trial[:, 0:2] = 1.0
        trial[:, 2:4] = 0.0
        trial[:, 4] = ws
        xyz = torch.cat([xu, torch.ones_like(xu[:, :1])], -1)
        pred = model.project(xyz[None], trial[:, None])          # (G, N, 2)
        f = (pred * pixc).sum(1) / torch.clamp((pred * pred).sum(1),
                                               min=1e-300)
        err = ((pixc - f[:, None] * pred) ** 2).sum((-2, -1))
        best = int(torch.argmin(err))
        p[0:2], p[4] = f[best], ws[best]
        return p
    base, g = _model_columns(model.name, xu)
    r_pix = float(torch.linalg.norm(pixc, dim=-1).max())
    terms = list(_RADIAL.get(model.name, ()))
    while True:
        sol = []
        for ax in range(2):
            b = base[:, ax]
            M = torch.stack([b] + [b * g[j - 4][:, 0] for j in terms], -1)
            sol.append(_lstsq(M, pixc[:, ax]))
        if all(x is not None and bool(x[0] > 0) for x in sol):
            trial = p.clone()
            sx, sy = sol
            trial[0], trial[1] = sx[0], sy[0]
            for n, j in enumerate(terms):
                trial[j] = 0.5 * (sx[n + 1] / sx[0] + sy[n + 1] / sy[0])
            if not terms or _radial_table(
                    model, trial, r_pix / float(trial[0:2].min())) \
                    is not None:
                return trial
        if not terms:
            return None
        terms.pop()


class _Camera:
    """One camera's voting frames, and one round of the start."""

    def __init__(self, model, pixels, visible, points_3d, width, height):
        dt = torch.float64
        self.model = model
        self.default = torch.as_tensor(
            default_params_np(model.name, width, height), dtype=dt)
        self.c = self.default[2:4]
        self.s0 = float(max(width, height))   # pixels in image-size units
        pix = torch.as_tensor(pixels, dtype=dt)
        w = torch.as_tensor(visible, dtype=dt)
        plane = torch.as_tensor(points_3d[:, :2], dtype=dt).expand(
            len(pix), -1, -1)
        good = _well_conditioned(plane, pix, w)
        self.pix, self.w, self.plane = pix[good], w[good], plane[good]
        self.n = int(good.sum())

    def division(self):
        """The first undistortion, which needs no focal length: the
        division model x_u = x_d / (1 + lam |x_d|^2) on centred pixels in
        units of the image size, with the lam whose homographies fit the
        pixels best (three ever finer scans, each one batch).  Returns the
        undistorted centred pixels."""
        xd = (self.pix - self.c) / self.s0
        r2 = (xd * xd).sum(-1, keepdim=True)
        r2_max = float(r2[self.w > 0].max())
        p3 = torch.cat([self.plane, torch.ones_like(self.plane[..., :1])],
                       -1)
        lo, hi = -0.8 / r2_max, 4.0 / r2_max    # 1 + lam r^2 stays >= 0.2
        for _ in range(3):
            lam = torch.linspace(lo, hi, SCAN, dtype=xd.dtype)
            den = 1.0 + lam[:, None, None, None] * r2      # (S, F, N, 1)
            xu = xd / den
            H = _homographies(self.plane.expand_as(xu), xu,
                              self.w.expand(len(lam), -1, -1))
            q = torch.einsum("sfij,fnj->sfni", H, p3)
            e = (q[..., :2] / q[..., 2:3] - xu) * den
            cost = ((e * e).sum(-1) * self.w).sum((-2, -1))
            i = int(torch.argmin(cost))
            step = (hi - lo) / (SCAN - 1)
            lo, hi = float(lam[i]) - step, float(lam[i]) + step
        return xd / (1.0 + float(lam[i]) * r2) * self.s0

    def round(self, params):
        """Homographies to the pixels undistorted by ``params`` (None: by
        the division model, or as they are for a model without
        distortion), Zhang's focal lengths, the frames' poses and a fit of
        the model to them.  Returns (params, reprojection rms in px) or
        None."""
        ideal = self.pix - self.c
        if params is not None:
            ideal = _undistort(self.model, params, ideal, self.w)
            if ideal is None:
                return None
        elif self.model.name != "linear":
            ideal = self.division()
        H = _homographies(self.plane, ideal / self.s0, self.w)
        f = _zhang_focal(H)
        if f is None:
            return None
        f = f * self.s0
        Kinv = torch.diag(torch.cat([self.s0 / f, f.new_ones(1)]))
        R, t = _pose_from_homography(Kinv @ H)
        p3 = torch.cat([self.plane, torch.zeros_like(self.plane[..., :1])],
                       -1)
        pc = torch.einsum("fij,fnj->fni", R, p3) + t[:, None]
        xu = pc[..., :2] / torch.clamp(pc[..., 2:3], min=1e-9)
        sel = self.w > 0
        p = _fit(self.model, self.default, xu[sel], (self.pix - self.c)[sel])
        if p is None or not bool(torch.isfinite(p).all()):
            return None
        e2 = ((self.model.project(pc, p) - self.pix) ** 2).sum(-1)
        rms = float(torch.sqrt((e2 * self.w).sum() / self.w.sum()))
        return (p, rms) if np.isfinite(rms) else None


def _scaled(p, s0):
    """The parameters as one vector of comparable units."""
    return torch.cat([p[0:2] / s0, p[4:]])


def camera_start(model_name, pixels, visible, points_3d, width, height):
    """The start of one camera: (params (n_params,) float64 numpy, frames
    whose homography voted).  pixels (F, P, 2), visible
    (F, P), points_3d (P, 3) on the target plane z = 0.  At most
    MAX_FRAMES usable frames, spread evenly over the recording, take part.

    The rounds are a fixed-point iteration of the parameters: one round
    alone closes only about a third of the distance to the fixed point on a
    strongly distorted camera, so each pair of rounds is extrapolated along
    its last step (vector Aitken), and the extrapolation is kept where the
    round from it moves less than the last step did.  The result is the
    last round's, or the first round's where that fits the pixels better."""
    model = get_model(model_name)
    default = default_params_np(model.name, width, height)
    vis = np.asarray(visible, bool)
    frames = np.flatnonzero(vis.sum(1) >= MIN_POINTS)
    if len(frames) == 0:
        return default, 0
    if len(frames) > MAX_FRAMES:
        frames = frames[np.linspace(0, len(frames) - 1,
                                    MAX_FRAMES).round().astype(int)]
    cam = _Camera(model, np.asarray(pixels)[frames], vis[frames],
                  np.asarray(points_3d), width, height)
    first = cam.round(None) if cam.n else None
    if first is None:
        return default, 0

    def moved(a, b):
        return float(torch.linalg.norm(_scaled(b - a, cam.s0)))

    x, out = first[0], cam.round(first[0])
    for _ in range(MAX_STEPS):
        if out is None or moved(x, out[0]) < TOL:
            break
        two = cam.round(out[0])
        if two is None:
            break
        d1, d2 = out[0] - x, two[0] - out[0]
        s1, s2 = _scaled(d1, cam.s0), _scaled(d2, cam.s0)
        rho = float(torch.clamp(s2 @ s1 / torch.clamp(s1 @ s1, min=1e-300),
                                0.0, 0.9))
        jump = two[0] + rho / (1.0 - rho) * d2
        landed = cam.round(jump)
        if landed is not None and moved(jump, landed[0]) < moved(
                out[0], two[0]):
            x, out = jump, landed
        else:
            x, out = out[0], two
    if out is None or not out[1] <= first[1]:
        out = first
    return out[0].numpy(), cam.n


def start_intrinsics(model_names, pixels, visible, points_3d, widths,
                     heights):
    """Each camera's start (float64 numpy vectors) from its detections:
    pixels (C, F, P, 2), visible (C, F, P).  Recorded as span
    ``vicalib.engine.intr_start`` and counter
    ``vicalib.engine.intr_start_frames`` (the frames whose homography
    voted, summed over cameras)."""
    out = []
    with obs.span("vicalib.engine.intr_start"):
        voted = 0
        for cam, name in enumerate(model_names):
            params, n = camera_start(name, pixels[cam], visible[cam],
                                     points_3d, widths[cam], heights[cam])
            if n == 0:
                log.info("camera %d: no frame fixes the intrinsics; "
                         "starting from the default", cam)
            else:
                log.info("camera %d: intrinsics start %s from %d frames",
                         cam, np.array2string(params, precision=4), n)
            out.append(params)
            voted += n
        obs.count("vicalib.engine.intr_start_frames", voted)
    return out
