"""Port parity: geometry.so3 / se3 (torch) against the JAX package.

Same numpy inputs through both, float64.  Tolerance 1e-12: both evaluate the
same closed-form expressions in double precision, so they differ only by
rounding (a few ulps of O(1) values).  The small-angle inputs exercise the
Taylor branches (theta^2 < 1e-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicalib_tpu.geometry import se3 as jse3
from vicalib_tpu.geometry import so3 as jso3
from vicalib_tpu_torch.geometry import se3 as tse3
from vicalib_tpu_torch.geometry import so3 as tso3

ATOL = 1e-12


def _vecs(rng, n, scale):
    return rng.normal(size=(n, 3)) * scale


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 2.5])
@pytest.mark.parametrize("fn", ["exp", "jl", "jl_inv", "hat"])
def test_so3_tangent_maps(fn, scale):
    w = _vecs(np.random.default_rng(0), 16, scale)
    _close(getattr(jso3, fn)(jnp.asarray(w)), getattr(tso3, fn)(_t(w)))


@pytest.mark.parametrize("case", ["random", "near_identity", "negative_w"])
def test_so3_log_and_matrices(case):
    rng = np.random.default_rng(1)
    if case == "random":
        q = _quats(rng, 16)
    elif case == "near_identity":
        q = np.asarray(jso3.exp(jnp.asarray(_vecs(rng, 16, 1e-6))))
    else:
        q = -_quats(rng, 16) * np.sign(_quats(rng, 16)[:, 3:4])
    _close(jso3.log(jnp.asarray(q)), tso3.log(_t(q)))
    _close(jso3.to_matrix(jnp.asarray(q)), tso3.to_matrix(_t(q)))
    R = np.asarray(jso3.to_matrix(jnp.asarray(q)))
    _close(jso3.from_matrix(jnp.asarray(R)), tso3.from_matrix(_t(R)))


def test_so3_products():
    rng = np.random.default_rng(2)
    q1, q2 = _quats(rng, 16), _quats(rng, 16)
    v = _vecs(rng, 16, 3.0)
    _close(jso3.quat_mul(jnp.asarray(q1), jnp.asarray(q2)),
           tso3.quat_mul(_t(q1), _t(q2)))
    _close(jso3.inverse(jnp.asarray(q1)), tso3.inverse(_t(q1)))
    _close(jso3.rotate(jnp.asarray(q1), jnp.asarray(v)),
           tso3.rotate(_t(q1), _t(v)))


@pytest.mark.parametrize("scale", [1e-6, 0.7])
def test_se3_maps(scale):
    rng = np.random.default_rng(3)
    x = np.concatenate([_vecs(rng, 16, 1.0), _vecs(rng, 16, scale)], axis=1)
    qj, tj = jse3.exp(jnp.asarray(x))
    qt, tt = tse3.exp(_t(x))
    _close(qj, qt)
    _close(tj, tt)
    _close(jse3.log((qj, tj)), tse3.log((qt, tt)), atol=1e-11)
    b = (_quats(rng, 16), _vecs(rng, 16, 2.0))
    jb = (jnp.asarray(b[0]), jnp.asarray(b[1]))
    tb = (_t(b[0]), _t(b[1]))
    for a_j, a_t in zip(jse3.mul((qj, tj), jb), tse3.mul((qt, tt), tb)):
        _close(a_j, a_t)
    for a_j, a_t in zip(jse3.inverse(jb), tse3.inverse(tb)):
        _close(a_j, a_t)
    p = _vecs(rng, 16, 1.0)
    _close(jse3.transform(jb, jnp.asarray(p)), tse3.transform(tb, _t(p)))
    _close(jse3.to_matrix(jb), tse3.to_matrix(tb))
