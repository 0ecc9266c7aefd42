"""Pure-numpy quaternion/SE3 helpers for *host-side* code paths.

Configuration builders, initializers and other host logic work on numpy
arrays and never touch the device.  These mirror geometry.so3/se3 (xyzw
layout, Sophus conventions) exactly; device code uses the torch versions.
"""
from __future__ import annotations

import numpy as np


def quat_mul(q1, q2):
    x1, y1, z1, w1 = np.moveaxis(q1, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(q2, -1, 0)
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], axis=-1)


def inverse(q):
    return np.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def rotate(q, v):
    u = q[..., :3]
    w = q[..., 3:4]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def to_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def from_matrix(R):
    """Single rotation matrix -> xyzw quaternion (host-side scalar version)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-30)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    if q[3] < 0:
        q = -q
    return q


def exp(w):
    w = np.asarray(w, dtype=np.float64)
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    small = theta < 1e-8
    safe = np.where(small, 1.0, theta)
    k = np.where(small, 0.5 - theta ** 2 / 48.0, np.sin(safe / 2) / safe)
    c = np.where(small, 1.0 - theta ** 2 / 8.0, np.cos(safe / 2))
    return np.concatenate([k * w, c[..., :1] if c.ndim == w.ndim else c],
                          axis=-1)


def log(q):
    q = np.asarray(q, dtype=np.float64)
    q = np.where(q[..., 3:4] < 0, -q, q)
    u = q[..., :3]
    w = q[..., 3:4]
    n = np.linalg.norm(u, axis=-1, keepdims=True)
    small = n < 1e-9
    safe = np.where(small, 1.0, n)
    k = np.where(small, 2.0 / np.maximum(w, 1e-12),
                 2.0 * np.arctan2(safe, w) / safe)
    return k * u


def se3_mul(a, b):
    qa, ta = a
    qb, tb = b
    return quat_mul(qa, qb), rotate(qa, tb) + ta


def se3_inverse(a):
    q, t = a
    qi = inverse(q)
    return qi, -rotate(qi, t)
