"""Port parity: all six camera models, project and unproject (torch vs JAX).

Same numpy points and intrinsics through both packages in float64.  Pixels
agree within atol 1e-9 px: the expressions and the fixed Newton iteration
counts of the inverses are the same, so only rounding differs (pixel values
~1e3 carry ~1e-13 of rounding per operation).  Rays are unit-depth
normalized coordinates, held to the same 1e-9.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicalib_tpu.cameras import models as jm
from vicalib_tpu_torch.cameras import models as tm

PARAMS = {
    "linear": [335.6, 334.9, 400.0, 300.0],
    "fov": [335.6, 334.9, 400.0, 300.0, 0.85],
    "poly2": [335.6, 334.9, 400.0, 300.0, -0.12, 0.03],
    "poly3": [335.6, 334.9, 400.0, 300.0, -0.12, 0.03, -0.004],
    "rational6": [335.6, 334.9, 400.0, 300.0, 0.1, -0.02, 0.001, 0.08,
                  -0.01, 0.002],
    "kb4": [335.6, 334.9, 400.0, 300.0, -0.04, 0.01, -0.002, 0.0004],
}
ATOL = 1e-9


def _points(n=64, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform([-0.6, -0.45, 0.4], [0.6, 0.45, 2.0], size=(n, 3))
    p[0] = [0.0, 0.0, 1.0]                      # on the axis: small-r paths
    return p


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_project_unproject_match_jax(name):
    params = np.asarray(PARAMS[name])
    p = _points()
    jmod, tmod = jm.get_model(name), tm.get_model(name)
    pix_j = np.asarray(jmod.project(jnp.asarray(p), jnp.asarray(params)))
    pix_t = tmod.project(torch.as_tensor(p), torch.as_tensor(params))
    np.testing.assert_allclose(pix_t.numpy(), pix_j, rtol=0, atol=ATOL)
    ray_j = np.asarray(jmod.unproject(jnp.asarray(pix_j),
                                      jnp.asarray(params)))
    ray_t = tmod.unproject(torch.as_tensor(pix_j), torch.as_tensor(params))
    np.testing.assert_allclose(ray_t.numpy(), ray_j, rtol=0, atol=ATOL)
    # and the inverse really inverts (to the Newton solve's accuracy)
    np.testing.assert_allclose(ray_t.numpy()[:, :2], p[:, :2] / p[:, 2:],
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_registry_helpers_match_jax(name):
    jmod, tmod = jm.get_model(name), tm.get_model(name)
    assert (jmod.n_params, jmod.type_string) == (tmod.n_params,
                                                 tmod.type_string)
    np.testing.assert_array_equal(np.asarray(jmod.init_params(640, 480)),
                                  tmod.init_params(640, 480, torch.float64,
                                                   "cpu").numpy())
    params = np.asarray(PARAMS[name])
    np.testing.assert_array_equal(np.asarray(jmod.K(jnp.asarray(params))),
                                  tmod.K(torch.as_tensor(params)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jm.pad_params(jnp.asarray(params))),
        tm.pad_params(torch.as_tensor(params)).numpy())
