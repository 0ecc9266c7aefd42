"""The detection kernel module: its plain version against the JAX Pallas
kernel, and the wrapper's contract.

``threshold_and_label_ref`` must equal JAX ``threshold_and_label`` run in
Pallas interpret mode bit for bit (labels are integers; the box sums are
exact in both).  Two synthetic frames pin the semantics: a serpentine
component that needs more than the 64-sweep bound (its labels must match
the bounded reference, several labels per component), and a frame with more
than 512 dots (the overflow ids must be 0).  The CUDA kernel itself is held
to this plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vicalib_tpu.detect.conics import _pad_to_tiles as j_pad
from vicalib_tpu.detect.image_proc import adaptive_threshold as j_at
from vicalib_tpu.detect.image_proc import box_mean as j_box
from vicalib_tpu.detect.pallas_kernels import threshold_and_label as j_tl
from vicalib_tpu.io import sim as jsim
from vicalib_tpu_torch.detect import image_proc, kernels


def _rendered(n=2):
    cfg = jsim.default_mono_config(n_frames=n, model="linear",
                                   distance=0.42, orbit_radius=0.25)
    cfg.cameras[0].params[:4] = [240.0, 240.0, 200.0, 150.0]
    cfg.cameras[0].width, cfg.cameras[0].height = 400, 300
    return jsim.render_frames(jsim.simulate(cfg), cam=0)


def _serpentine():
    img = np.full((1, 64, 256), 255, np.float32)
    for r in range(4, 60, 3):
        img[0, r, 4:250] = 0
    for i, r in enumerate(range(4, 57, 3)):
        img[0, r:r + 4, 249 if i % 2 == 0 else 4] = 0
    return img


def _many_dots():
    img = np.full((1, 128, 256), 255, np.float32)
    for y in range(2, 126, 4):
        for x in range(2, 254, 4):
            img[0, y:y + 2, x:x + 2] = 0
    return img


def _both(imgs, radius, **kw):
    _, lab_j = j_tl(jnp.asarray(imgs), radius, 0.9, n_iters=64,
                    max_labels=512, interpret=True, **kw)
    _, lab_t, sweeps = kernels.threshold_and_label_ref(
        torch.from_numpy(np.ascontiguousarray(imgs)), radius, 0.9,
        n_iters=64, max_labels=512, return_sweeps=True, **kw)
    return np.asarray(lab_j), lab_t.numpy(), sweeps.numpy()


@pytest.mark.parametrize("black_on_white", [True, False])
def test_plain_version_matches_pallas_on_rendered_frames(black_on_white):
    frames = _rendered()
    if not black_on_white:
        frames = 255 - frames
    padded, H, W = j_pad(jnp.asarray(frames, jnp.float32))
    radius = max(int(W / 30.0 / 2), 1)
    lab_j, lab_t, _ = _both(np.asarray(padded), radius,
                            black_on_white=black_on_white)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert (lab_t > 0).sum() > 1000


def test_plain_version_matches_pallas_beyond_sweep_bound():
    lab_j, lab_t, sweeps = _both(_serpentine(), 4)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert sweeps[0, 0] == 64                     # the bound was reached
    # one connected snake, but the bound leaves it several labels
    assert len(np.unique(lab_t[lab_t > 0])) > 1


def test_plain_version_matches_pallas_beyond_max_labels():
    img = _many_dots()
    lab_j, lab_t, _ = _both(img, 4)
    np.testing.assert_array_equal(lab_t, lab_j)
    mask = kernels._threshold_mask(torch.from_numpy(img), 4, 0.9,
                                   True).numpy()
    assert lab_t.max() == 512
    assert ((lab_t == 0) & mask).sum() > 0        # overflow ids are 0


def test_box_mean_and_adaptive_threshold_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(60, 96)).astype(np.float32)
    # integral-image sums stay below 2^24 here, so both are exact
    np.testing.assert_array_equal(
        image_proc.box_mean(torch.from_numpy(img), 5).numpy(),
        np.asarray(j_box(jnp.asarray(img), 5)))
    for bow in (True, False):
        np.testing.assert_array_equal(
            image_proc.adaptive_threshold(torch.from_numpy(img),
                                          black_on_white=bow).numpy(),
            np.asarray(j_at(jnp.asarray(img), black_on_white=bow)))


# ------------------------------------------------------------ the wrapper
def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    kernels.LAUNCHES["threshold_and_label"] = 0
    img = torch.from_numpy(_many_dots())
    mask, lab = kernels.threshold_and_label(img, 4)
    _, ref = kernels.threshold_and_label_ref(img, 4)
    assert torch.equal(lab, ref) and torch.equal(mask, ref > 0)
    assert kernels.LAUNCHES["threshold_and_label"] == 0


@pytest.mark.parametrize("bad", ["dtype", "unpadded", "noncontiguous",
                                 "rank", "too_wide"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    img = torch.from_numpy(_many_dots())
    if bad == "dtype":
        img = img.to(torch.float64)
    elif bad == "unpadded":
        img = img[:, :100, :200].contiguous()
    elif bad == "noncontiguous":
        img = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([_many_dots()] * 2, axis=2)))[:, :, ::2]
    elif bad == "too_wide":
        img = torch.full((1, 8, kernels._MAX_WIDTH + 128), 255.0)
    else:
        img = img[0]
    with pytest.raises((TypeError, ValueError)):
        kernels.threshold_and_label(img, 4)


def test_engine_default_device_raises_without_cuda(monkeypatch):
    """No fallback: the default device is cuda, and without a CUDA device
    the engine refuses instead of running on the CPU."""
    from vicalib_tpu_torch.config import VicalibConfig
    from vicalib_tpu_torch.detect.conics import find_conics_batch
    from vicalib_tpu_torch.engine import VicalibEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VicalibEngine(VicalibConfig(cam="file:///nowhere/*.pgm"))
    with pytest.raises(RuntimeError, match="cuda"):
        find_conics_batch(_many_dots())
