"""Differentiable camera models (project / unproject), Calibu-equivalent.

=============  ========  =====================================  =========================
name           n_params  params                                 type string
=============  ========  =====================================  =========================
``linear``     4         fu fv u0 v0                            calibu_fu_fv_u0_v0
``fov``        5         fu fv u0 v0 w                          calibu_fu_fv_u0_v0_w
``poly2``      6         fu fv u0 v0 k1 k2                      calibu_fu_fv_u0_v0_k1_k2
``poly3``      7         fu fv u0 v0 k1 k2 k3                   calibu_fu_fv_u0_v0_k1_k2_k3
``rational6``  10        fu fv u0 v0 k1..k6                     calibu_fu_fv_u0_v0_rational6
``kb4``        8         fu fv u0 v0 k0 k1 k2 k3                calibu_fu_fv_u0_v0_kb4
=============  ========  =====================================  =========================

``project`` takes a 3-D point ``(..., 3)`` in the camera frame and a
parameter vector ``(..., n_params)`` (extra trailing entries are ignored, so
padded parameter arrays work) and returns pixels ``(..., 2)``.  Both
functions are pure tensor code and work under ``torch.func`` (the solver
differentiates ``project`` w.r.t. the point and the intrinsics).

``unproject`` maps pixels to unit-depth rays; distortion models invert the
radial factor with a fixed number of Newton iterations.
"""
from __future__ import annotations

import torch
from torch.func import jvp

MAX_PARAMS = 10  # rational6 is the widest model


def _dehom(p):
    z = p[..., 2:3]
    return p[..., :2] / z


def _r2(xy):
    return torch.sum(xy * xy, dim=-1, keepdim=True)


def _pix(xy, params):
    fu = params[..., 0:1]
    fv = params[..., 1:2]
    c = params[..., 2:4]
    return torch.cat([fu * xy[..., 0:1], fv * xy[..., 1:2]], dim=-1) + c


def _with_unit_z(xy):
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


# ------------------------------------------------------------------ linear
def project_linear(p, params):
    return _pix(_dehom(p), params)


def unproject_linear(pix, params):
    xy = (pix - params[..., 2:4]) / params[..., 0:2]
    return _with_unit_z(xy)


# ------------------------------------------------------------------ fov
def project_fov(p, params):
    xy = _dehom(p)
    w = params[..., 4:5]
    r2 = _r2(xy)
    r = torch.sqrt(torch.clamp(r2, min=1e-24))
    tanwhalf = torch.tan(w / 2.0)
    # factor = atan(2 r tan(w/2)) / (r w), with small-r and small-w limits
    small_w = torch.abs(w) < 1e-6
    small_r = r2 < 1e-12
    safe_w = torch.where(small_w, torch.ones_like(w), w)
    fac_main = torch.atan(2.0 * r * tanwhalf) / (r * safe_w)
    fac_small_r = 2.0 * tanwhalf / safe_w
    fac = torch.where(small_r, fac_small_r, fac_main)
    fac = torch.where(small_w, torch.ones_like(fac), fac)
    return _pix(fac * xy, params)


def unproject_fov(pix, params):
    xy_d = (pix - params[..., 2:4]) / params[..., 0:2]
    w = params[..., 4:5]
    rd2 = _r2(xy_d)
    rd = torch.sqrt(torch.clamp(rd2, min=1e-24))
    tanwhalf = torch.tan(w / 2.0)
    small_w = torch.abs(w) < 1e-6
    safe_w = torch.where(small_w, torch.ones_like(w), w)
    ru = torch.tan(rd * safe_w) / (2.0 * tanwhalf)
    fac = torch.where(small_w | (rd2 < 1e-12), torch.ones_like(rd), ru / rd)
    return _with_unit_z(fac * xy_d)


# ------------------------------------------------------------------ polynomial radial
def _poly_factor(r2, ks):
    """1 + k1 r^2 + k2 r^4 + ... (Horner)."""
    fac = torch.zeros_like(r2)
    for k in reversed(ks):
        fac = (fac + k) * r2
    return 1.0 + fac


def project_poly2(p, params):
    xy = _dehom(p)
    r2 = _r2(xy)
    fac = _poly_factor(r2, [params[..., 4:5], params[..., 5:6]])
    return _pix(fac * xy, params)


def project_poly3(p, params):
    xy = _dehom(p)
    r2 = _r2(xy)
    fac = _poly_factor(r2, [params[..., 4:5], params[..., 5:6],
                            params[..., 6:7]])
    return _pix(fac * xy, params)


def project_rational6(p, params):
    xy = _dehom(p)
    r2 = _r2(xy)
    num = _poly_factor(r2, [params[..., 4:5], params[..., 5:6],
                            params[..., 6:7]])
    den = _poly_factor(r2, [params[..., 7:8], params[..., 8:9],
                            params[..., 9:10]])
    return _pix(num / den * xy, params)


def _radial_unproject(pix, params, factor_of_r2, iters=8):
    """Newton-invert r_d = r_u * factor(r_u^2) for radial models."""
    xy_d = (pix - params[..., 2:4]) / params[..., 0:2]
    rd = torch.sqrt(torch.clamp(_r2(xy_d), min=1e-24))

    def g_of(r):
        return r * factor_of_r2(r * r)

    ru = rd
    for _ in range(iters):
        f = factor_of_r2(ru * ru)
        g = ru * f - rd
        # elementwise derivative of r * factor(r^2) (forward mode)
        dg = jvp(g_of, (ru,), (torch.ones_like(ru),))[1]
        ru = ru - g / torch.where(torch.abs(dg) < 1e-12,
                                  torch.ones_like(dg), dg)
    fac = ru / rd
    return _with_unit_z(fac * xy_d)


def unproject_poly2(pix, params):
    ks = [params[..., 4:5], params[..., 5:6]]
    return _radial_unproject(pix, params, lambda r2: _poly_factor(r2, ks))


def unproject_poly3(pix, params):
    ks = [params[..., 4:5], params[..., 5:6], params[..., 6:7]]
    return _radial_unproject(pix, params, lambda r2: _poly_factor(r2, ks))


def unproject_rational6(pix, params):
    num_ks = [params[..., 4:5], params[..., 5:6], params[..., 6:7]]
    den_ks = [params[..., 7:8], params[..., 8:9], params[..., 9:10]]
    return _radial_unproject(
        pix, params,
        lambda r2: _poly_factor(r2, num_ks) / _poly_factor(r2, den_ks))


# ------------------------------------------------------------------ Kannala-Brandt (kb4)
def project_kb4(p, params):
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    k = params[..., 4:8]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-24))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    # theta + k0 t^3 + k1 t^5 + k2 t^7 + k3 t^9
    poly = theta * (1.0 + t2 * (k[..., 0:1] + t2 * (k[..., 1:2] + t2 * (
        k[..., 2:3] + t2 * k[..., 3:4]))))
    small = (x * x + y * y) < 1e-16
    scale = torch.where(small, 1.0 / z, poly / r)
    xy = torch.cat([x, y], dim=-1) * scale
    return _pix(xy, params)


def unproject_kb4(pix, params, iters=8):
    xy_d = (pix - params[..., 2:4]) / params[..., 0:2]
    k = params[..., 4:8]
    rd = torch.sqrt(torch.clamp(_r2(xy_d), min=1e-24))

    def poly(theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (k[..., 0:1] + t2 * (k[..., 1:2] + t2 * (
            k[..., 2:3] + t2 * k[..., 3:4]))))

    theta = rd
    for _ in range(iters):
        t2 = theta * theta
        dp = 1.0 + t2 * (3.0 * k[..., 0:1] + t2 * (5.0 * k[..., 1:2] + t2 * (
            7.0 * k[..., 2:3] + t2 * 9.0 * k[..., 3:4])))
        theta = theta - (poly(theta) - rd) / dp
    fac = torch.tan(theta) / rd
    return _with_unit_z(fac * xy_d)


# ------------------------------------------------------------------ registry
class CameraModel:
    __slots__ = ("name", "n_params", "type_string", "project", "unproject")

    def __init__(self, name, n_params, type_string, project, unproject):
        self.name = name
        self.n_params = n_params
        self.type_string = type_string
        self.project = project
        self.unproject = unproject

    def init_params(self, width, height, dtype, device):
        """Default starting intrinsics (reference: vicalib-engine.cc:207-257)."""
        return torch.tensor(_default_params(self.name, self.n_params, width,
                                            height), dtype=dtype,
                            device=device)

    def K(self, params):
        fu, fv, u0, v0 = params[0], params[1], params[2], params[3]
        z = torch.zeros_like(fu)
        o = torch.ones_like(fu)
        return torch.stack([
            torch.stack([fu, z, u0]), torch.stack([z, fv, v0]),
            torch.stack([z, z, o])])


def _default_params(name, n_params, width, height):
    base = [300.0, 300.0, width / 2.0, height / 2.0]
    extra = [0.2] if name == "fov" else [0.0] * (n_params - 4)
    return base + extra


MODELS = {
    "linear": CameraModel("linear", 4, "calibu_fu_fv_u0_v0",
                          project_linear, unproject_linear),
    "fov": CameraModel("fov", 5, "calibu_fu_fv_u0_v0_w",
                       project_fov, unproject_fov),
    "poly2": CameraModel("poly2", 6, "calibu_fu_fv_u0_v0_k1_k2",
                         project_poly2, unproject_poly2),
    "poly3": CameraModel("poly3", 7, "calibu_fu_fv_u0_v0_k1_k2_k3",
                         project_poly3, unproject_poly3),
    "rational6": CameraModel("rational6", 10, "calibu_fu_fv_u0_v0_rational6",
                             project_rational6, unproject_rational6),
    "kb4": CameraModel("kb4", 8, "calibu_fu_fv_u0_v0_kb4",
                       project_kb4, unproject_kb4),
}

# aliases accepted by the reference CLI (src/vicalib-engine.cc:223,233)
MODEL_ALIASES = {"poly": "poly3", "rational": "rational6"}

TYPE_STRING_TO_NAME = {m.type_string: m.name for m in MODELS.values()}
# calibu XML files also use these legacy type names
TYPE_STRING_TO_NAME.update({
    "calibu_f_u0_v0": "linear",
    "calibu_fu_fv_u0_v0_k1_k2_k3": "poly3",
})


def get_model(name: str) -> CameraModel:
    return MODELS[MODEL_ALIASES.get(name, name)]


def default_params_np(name, width=800, height=600):
    """Default intrinsics as a float64 numpy vector (host code)."""
    import numpy as np
    model = get_model(name)
    return np.asarray(_default_params(model.name, model.n_params, width,
                                      height), dtype=np.float64)


def pad_params(params, dtype=None):
    """Pad an intrinsics vector to MAX_PARAMS for homogeneous stacking."""
    params = torch.as_tensor(params, dtype=dtype)
    return torch.cat([params, torch.zeros(MAX_PARAMS - params.shape[-1],
                                          dtype=params.dtype,
                                          device=params.device)])
