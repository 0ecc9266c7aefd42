"""SO(3) operations on unit quaternions, Sophus-compatible (torch).

Quaternion storage layout is ``[x, y, z, w]`` (Eigen ``coeffs()`` order):
``x[0..2]`` are the imaginary parts and ``x[3]`` is the scalar part.

All functions are pure, follow the dtype and device of their inputs, and
work under ``torch.func`` transforms (vmap, jacfwd).  Shapes: quaternions
``(..., 4)``, vectors ``(..., 3)``, matrices ``(..., 3, 3)``.
"""
from __future__ import annotations

import torch

# Small-angle switch point.  Below this squared angle the Taylor expansions
# are used so derivatives stay finite at the identity.  Taylor truncation
# error at theta ~ 1e-4 (~theta^4) is below f64 eps, while the untaken
# branch's denominators stay clear of float32 subnormals.
_EPS2 = 1e-8


def identity(dtype, device):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def cross(a, b):
    """Broadcasting 3-vector cross product (component form, vmap-safe)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_mul(q1, q2):
    """Hamilton product q1 * q2 in xyzw layout."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def inverse(q):
    """Inverse of a unit quaternion (= conjugate)."""
    return quat_conj(q)


def normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q: R(q) @ v.

    Uses v' = v + 2*w*(u x v) + 2*(u x (u x v)).
    """
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def to_matrix(q):
    """Rotation matrix of a unit quaternion, shape (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def from_matrix(R):
    """Unit quaternion (xyzw) from a rotation matrix. Branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    qw0 = _safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], dim=-1)

    qx1 = _safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], dim=-1)

    qy2 = _safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], dim=-1)

    qz3 = _safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)          # (..., 4, 4)
    gidx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(qs, -2, gidx)[..., 0, :]
    return normalize(q)


def hat(w):
    """Skew-symmetric matrix of w, shape (..., 3, 3)."""
    z = torch.zeros_like(w[..., 0])
    m = torch.stack(
        [z, -w[..., 2], w[..., 1],
         w[..., 2], z, -w[..., 0],
         -w[..., 1], w[..., 0], z],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def exp(w):
    """SO(3) exponential: tangent (..., 3) -> unit quaternion (..., 4).

    q = [sin(|w|/2) * w/|w|, cos(|w|/2)] (Sophus).
    """
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS2))
    half = 0.5 * theta
    small = theta2 < _EPS2
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    wq = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([k * w, wq], dim=-1)


def log(q):
    """SO(3) logarithm: unit quaternion (..., 4) -> tangent (..., 3).

    Always the principal rotation vector (|angle| <= pi): q and -q map to
    the same result.
    """
    q = torch.where(q[..., 3:4] < 0, -q, q)
    u = q[..., :3]
    w = q[..., 3:4]
    n2 = torch.sum(u * u, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=_EPS2))
    small = n2 < _EPS2
    # 2*atan2(n, w)/n with Taylor 2/w * (1 - n^2/(3 w^2))
    w_safe = torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w)
    k = torch.where(
        small,
        2.0 / w_safe * (1.0 - n2 / (3.0 * torch.clamp(w * w, min=1e-30))),
        2.0 * torch.atan2(n, w) / n,
    )
    return k * u


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def jl(w):
    """Left Jacobian of SO(3): I + (1-cos)/t^2 [w]x + (t-sin)/t^3 [w]x^2.

    Denominators are floored (not only branch-selected) so derivatives
    through the untaken branch never see 0/0.
    """
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = hat(w)
    W2 = W @ W
    safe2 = torch.clamp(theta2, min=_EPS2)
    theta = torch.sqrt(safe2)
    small = theta2 < _EPS2
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe2 * theta))
    return _eye_like(W) + a * W + b * W2


def jl_inv(w):
    """Inverse left Jacobian of SO(3).  Safe denominators like jl."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    W = hat(w)
    W2 = W @ W
    safe2 = torch.clamp(theta2, min=_EPS2)
    theta = torch.sqrt(safe2)
    half = 0.5 * theta
    small = theta2 < _EPS2
    sin_half = torch.sin(half)
    sin_safe = torch.where(torch.abs(sin_half) < 1e-30,
                           torch.ones_like(sin_half), sin_half)
    # (1/t^2)(1 - (t/2) cot(t/2))
    c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / sin_safe) / safe2,
    )
    return _eye_like(W) - 0.5 * W + c * W2
