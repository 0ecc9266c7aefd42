"""SE(3) operations, Sophus-compatible (torch).

A pose is the pair ``(q, t)`` with ``q`` a unit quaternion ``(..., 4)`` in
xyzw layout and ``t`` a translation ``(..., 3)``.  The flat 7-vector layout
is ``[qx, qy, qz, qw, tx, ty, tz]`` (the data layout of ``Sophus::SE3d``).

Tangent layout follows Sophus: ``[upsilon(3), omega(3)]``, translation
first.  ``exp([u, w]) = (exp_so3(w), J_l(w) @ u)`` and the solver
retraction is the right increment ``T * exp(dx)``.
"""
from __future__ import annotations

import torch

from . import so3


def identity(dtype, device):
    return (so3.identity(dtype, device),
            torch.zeros(3, dtype=dtype, device=device))


def mul(a, b):
    """Compose two poses: a * b."""
    qa, ta = a
    qb, tb = b
    return so3.quat_mul(qa, qb), so3.rotate(qa, tb) + ta


def inverse(a):
    q, t = a
    qi = so3.inverse(q)
    return qi, -so3.rotate(qi, t)


def transform(a, p):
    """Apply pose to point(s): R p + t."""
    q, t = a
    return so3.rotate(q, p) + t


def exp(x):
    """SE(3) exponential: tangent (..., 6) [u, w] -> pose."""
    u = x[..., :3]
    w = x[..., 3:]
    q = so3.exp(w)
    V = so3.jl(w)
    t = torch.einsum("...ij,...j->...i", V, u)
    return q, t


def log(a):
    """SE(3) logarithm: pose -> tangent (..., 6) [u, w]."""
    q, t = a
    w = so3.log(q)
    Vinv = so3.jl_inv(w)
    u = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([u, w], dim=-1)


def retract(a, dx):
    """Right-multiplicative retraction: T * exp(dx); dx = [du(3), dw(3)]."""
    return mul(a, exp(dx))


def to_matrix(a):
    """Homogeneous 4x4 matrix (..., 4, 4)."""
    q, t = a
    R = so3.to_matrix(q)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def from_matrix(T):
    return so3.from_matrix(T[..., :3, :3]), T[..., :3, 3]
