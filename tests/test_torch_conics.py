"""Port parity: detect.conics (torch) against the JAX package.

``find_conics_batch(device="cpu")`` runs the kernel's plain version and must
agree with JAX ``find_conics_batch(backend="pallas")`` (Pallas in interpret
mode): identical ``valid`` masks and component areas (integer counts), and
moments centers bit for bit (both add in flat pixel order in float32).  The
refined centers agree within 2e-4 px: the refinement sums 13x13 float32
windows, and the two libraries reduce them in different orders; at
coordinates below 512 px a float32 ulp is 3.05e-5 px, so that is a few ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicalib_tpu.detect import conics as jc
from vicalib_tpu.io import sim as jsim
from vicalib_tpu_torch.detect import conics as tc

CENTER_ATOL = 2e-4


@pytest.fixture(scope="module")
def frames():
    cfg = jsim.default_mono_config(n_frames=2, model="linear",
                                   distance=0.42, orbit_radius=0.25)
    cfg.cameras[0].params[:4] = [240.0, 240.0, 200.0, 150.0]
    cfg.cameras[0].width, cfg.cameras[0].height = 400, 300
    return jsim.render_frames(jsim.simulate(cfg), cam=0)


@pytest.mark.parametrize("refine_iters", [0, 3])
def test_find_conics_batch_matches_pallas_path(frames, refine_iters):
    params_j = jc.ConicParams(max_conics=256, refine_iters=refine_iters)
    params_t = tc.ConicParams(max_conics=256, refine_iters=refine_iters)
    out_j = jc.find_conics_batch(frames, params_j, backend="pallas")
    out_t = tc.find_conics_batch(frames, params_t, device="cpu")
    v = np.asarray(out_j["valid"])
    np.testing.assert_array_equal(out_t["valid"].numpy(), v)
    assert v.sum() > 300
    np.testing.assert_array_equal(out_t["area"].numpy(),
                                  np.asarray(out_j["area"]))
    atol = 0.0 if refine_iters == 0 else CENTER_ATOL
    np.testing.assert_allclose(out_t["center"].numpy()[v],
                               np.asarray(out_j["center"])[v], rtol=0,
                               atol=atol)
    # radius = sqrt(area / pi) of equal areas: XLA:CPU's float32 sqrt is
    # not correctly rounded, so allow 2 ulps
    np.testing.assert_allclose(out_t["radius"].numpy(),
                               np.asarray(out_j["radius"]), rtol=2.5e-7)


def test_label_and_compact_match_jax(frames):
    img = frames[0].astype(np.float32)
    from vicalib_tpu.detect.image_proc import adaptive_threshold
    mask = np.asarray(adaptive_threshold(jnp.asarray(img)))
    lab_j = np.asarray(jc.label_components(jnp.asarray(mask), 64))
    lab_t = tc.label_components(torch.from_numpy(mask.copy()), 64).numpy()
    np.testing.assert_array_equal(lab_t, lab_j)
    for K in (16, 512):
        np.testing.assert_array_equal(
            tc.compact_labels(torch.from_numpy(lab_t), K).numpy(),
            np.asarray(jc.compact_labels(jnp.asarray(lab_j), K)))


def test_batches_above_max_batch_are_chunked():
    rng = np.random.default_rng(0)
    n = tc.MAX_BATCH + 3
    imgs = np.full((n, 40, 120), 230, np.uint8)
    for k in range(n):
        for j in range(6):
            y, x = rng.integers(6, 30), rng.integers(6, 110)
            imgs[k, y:y + 4, x:x + 4] = 20
    params = tc.ConicParams(max_conics=32)
    whole = tc.find_conics_batch(imgs, params, device="cpu")
    parts = [tc.find_conics_batch(imgs[i:i + 5], params, device="cpu")
             for i in range(0, n, 5)]
    for key in whole:
        np.testing.assert_array_equal(
            whole[key].numpy(),
            torch.cat([p[key] for p in parts]).numpy())
    assert whole["valid"].shape == (n, 32)
