"""Port parity: detect.pnp (torch) against the JAX package.

RANSAC's samples come from ``jax.random.choice`` in the reference, which
torch cannot reproduce, so the port's ``pnp_ransac`` takes them as an input:
the test draws them the way JAX does and feeds the same indices to both.
Poses agree within atol 1e-9 (the same DLT, eigh and SVD in float64 on
well-conditioned 190-point problems).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vicalib_tpu.cameras import get_model as j_model
from vicalib_tpu.detect import pnp as jp
from vicalib_tpu.io import sim as jsim
from vicalib_tpu_torch.cameras import get_model as t_model
from vicalib_tpu_torch.detect import pnp as tp

ATOL = 1e-9


def _frames(n=4):
    cfg = jsim.default_mono_config(n_frames=n, model="poly2",
                                   distance=0.42, orbit_radius=0.25,
                                   pixel_noise=0.3)
    data = jsim.simulate(cfg)
    params = cfg.cameras[0].params
    rays = np.asarray(j_model("poly2").unproject(
        jnp.asarray(data.pixels[0]), jnp.asarray(params)))[..., :2]
    valid = data.visible[0].astype(np.float64)
    # a few gross outliers for RANSAC to reject
    rays = rays.copy()
    rays[:, :5] += 0.2
    return data, params, rays, valid


def _jax_samples(valid, n_hyp=64):
    out = []
    for f, v in enumerate(valid):
        key = jax.random.fold_in(jax.random.PRNGKey(0), f)
        probs = v / max(v.sum(), 1.0)
        out.append(np.asarray(jax.random.choice(
            key, len(v), shape=(n_hyp, 4), p=jnp.asarray(probs))))
    return np.stack(out)


def test_pnp_planar_matches_jax():
    data, _, rays, valid = _frames()
    p3 = data.points_3d[:, :2]
    for f in range(len(rays)):
        qj, tj = jp.pnp_planar(jnp.asarray(rays[f]), jnp.asarray(p3),
                               jnp.asarray(valid[f]))
        qt, tt = tp.pnp_planar(torch.as_tensor(rays[f]),
                               torch.as_tensor(p3), torch.as_tensor(valid[f]))
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=ATOL)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=ATOL)


def test_pnp_ransac_with_jax_samples_matches_jax():
    data, _, rays, valid = _frames()
    p3 = data.points_3d[:, :2]
    idx = _jax_samples(valid)
    qt, tt, inl_t = tp.pnp_ransac(torch.as_tensor(rays), torch.as_tensor(p3),
                                  torch.as_tensor(valid),
                                  sample_idx=torch.as_tensor(idx))
    for f in range(len(rays)):
        qj, tj, inl_j = jp.pnp_ransac(jnp.asarray(rays[f]), jnp.asarray(p3),
                                      jnp.asarray(valid[f]), seed=f)
        np.testing.assert_array_equal(inl_t[f].numpy(), np.asarray(inl_j))
        np.testing.assert_allclose(qt[f].numpy(), np.asarray(qj), atol=ATOL)
        np.testing.assert_allclose(tt[f].numpy(), np.asarray(tj), atol=ATOL)
        assert inl_t[f, :5].sum() == 0          # the outliers are rejected


def test_init_frame_poses_default_draws_recover_the_truth():
    """With its own per-frame generator draws the port lands on the same
    refined pose (refit on the inlier set) as the JAX reference."""
    data, params, _, valid = _frames()
    pix = data.pixels[0].copy()
    pix[:, :5] += 40.0
    T_ck = (np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))
    qj, tj = jp.init_frame_poses(j_model("poly2"), jnp.asarray(params),
                                 jnp.asarray(pix), data.points_3d,
                                 jnp.asarray(valid),
                                 tuple(jnp.asarray(x) for x in T_ck),
                                 use_ransac=True)
    qt, tt = tp.init_frame_poses(t_model("poly2"), torch.as_tensor(params),
                                 torch.as_tensor(pix),
                                 torch.as_tensor(data.points_3d),
                                 torch.as_tensor(valid),
                                 tuple(torch.as_tensor(x) for x in T_ck),
                                 use_ransac=True)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-9)
    # 0.3 px pixel noise: the initial poses are within ~1 cm of the truth
    np.testing.assert_allclose(tt.numpy(), data.T_wk[1], atol=2e-2)


def test_default_draws_are_per_frame_seeded_generators():
    """Frame f's samples are what a fresh torch.Generator seeded with f
    draws, so a run's RANSAC samples do not depend on the frames before."""
    _, _, _, valid = _frames()
    v = torch.as_tensor(valid)
    idx = tp.draw_sample_idx(v, 64, [5, 0, 7, 3])
    for row, seed in enumerate([5, 0, 7, 3]):
        g = torch.Generator()
        g.manual_seed(seed)
        want = torch.multinomial(v[row] / v[row].sum(), 256, replacement=True,
                                 generator=g).reshape(64, 4)
        assert torch.equal(idx[row], want)
