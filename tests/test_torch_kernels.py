"""The detection kernel module: its plain version against the JAX Pallas
kernel, and the wrapper's contract.

``threshold_and_label_ref`` must equal JAX ``threshold_and_label`` run in
Pallas interpret mode bit for bit (labels are integers; the box sums are
exact in both).  Two synthetic frames pin the semantics: a serpentine
component that needs more than the 64-sweep bound (its labels must match
the bounded reference, several labels per component), and a frame with more
than 512 dots (the overflow ids must be 0).  The CUDA kernel itself is held
to this plain version on the card by chip_smoke.py; its sweep schedule
(chunks of K Jacobi steps on tiles with a K-pixel halo) is mirrored here in
PyTorch and held to one sweep at a time bit for bit.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
                                 "rank", "too_wide", "radius"])
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
        # more pixels than int32 labels index; never allocated
        img = torch.empty((1, 8, 2 ** 28 + 128), device="meta")
    elif bad == "rank":
        img = img[0]
    with pytest.raises((TypeError, ValueError)):
        kernels.threshold_and_label(
            img, kernels._MAX_RADIUS + 1 if bad == "radius" else 4)


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


# ------------------------------------------------- the kernel's schedule
def _chunked_propagate(labels, mask, n_iters, k, tile):
    """The CUDA kernel's sweep schedule in PyTorch.  Chunks of k Jacobi steps
    (the last one the remainder of n_iters), each on (ty, tx) tiles extended
    by a k-pixel halo in which unmasked and out-of-frame pixels read as
    INT_MAX; only the masked interior is written back.  Tiles without mask
    are skipped, the buffers hold junk at unmasked pixels, and a frame whose
    chunk changed no interior pixel in its last step runs no more chunks."""
    B, H, W = labels.shape
    ty, tx = tile
    nty, ntx = -(-H // ty), -(-W // tx)
    ey, ex = ty + 2 * k, tx + 2 * k
    pad = (k, k + ntx * tx - W, k, k + nty * ty - H)

    def tiles(x, value):                   # (B, nty, ntx, ey, ex) views
        return F.pad(x, pad, value=value).unfold(1, ey, ty).unfold(2, ex, tx)

    ext_mask = tiles(mask.to(torch.int32), 0).bool()
    inner_mask = ext_mask[..., k:k + ty, k:k + tx]
    has_mask = inner_mask.flatten(3).any(-1)
    junk = torch.randint(-2 ** 31, 2 ** 31 - 1, labels.shape,
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    state = torch.where(mask, labels, junk)
    running = torch.ones(B, dtype=torch.bool)
    for c in range(-(-n_iters // k)):
        steps = min(k, n_iters - c * k)
        sel = has_mask & running[:, None, None]
        x = tiles(torch.where(mask, state, kernels.BIG), kernels.BIG)[sel]
        m = ext_mask[sel]
        for _ in range(steps):
            prev, x = x, kernels._sweep(x, m)
        inner = (slice(None), slice(k, k + ty), slice(k, k + tx))
        mi = m[inner]
        out = (F.pad(state, (0, ntx * tx - W, 0, nty * ty - H))
               .reshape(B, nty, ty, ntx, tx).permute(0, 1, 3, 2, 4).clone())
        out[sel] = torch.where(mi, x[inner], out[sel])
        state = out.permute(0, 1, 3, 2, 4).reshape(B, nty * ty,
                                                   ntx * tx)[:, :H, :W]
        changed = ((x[inner] != prev[inner]) & mi).flatten(1).any(1)
        running = torch.zeros(B, dtype=torch.bool).index_put(
            (sel.nonzero()[:, 0][changed],), torch.tensor(True))
    return torch.where(mask, state, kernels.BIG)


@functools.lru_cache(maxsize=None)
def _schedule_frame(name):
    if name == "rendered":
        padded, H, W = j_pad(jnp.asarray(_rendered(), jnp.float32))
        return (torch.from_numpy(np.array(padded)),
                max(int(W / 30.0 / 2), 1))
    return torch.from_numpy({"serpentine": _serpentine,
                             "many_dots": _many_dots}[name]()), 4


@pytest.mark.parametrize("tile", [(24, 80), (13, 40)])
@pytest.mark.parametrize("frame", ["serpentine", "many_dots", "rendered"])
@pytest.mark.parametrize("n_iters", [0, 7, 64])
@pytest.mark.parametrize("k", [1, 5, 8, 16, 64, 100])
def test_chunk_schedule_equals_one_sweep_at_a_time(k, n_iters, frame, tile,
                                                    monkeypatch):
    """Both bounded phases (labels, then compact ids) run in the kernel's
    chunk schedule give the labels of one global sweep at a time."""
    imgs, radius = _schedule_frame(frame)
    _, want = kernels.threshold_and_label_ref(imgs, radius, n_iters=n_iters)
    monkeypatch.setattr(kernels, "_propagate", lambda lab, m, n: (
        _chunked_propagate(lab, m, n, k, tile), None))
    _, got = kernels.threshold_and_label_ref(imgs, radius, n_iters=n_iters)
    assert torch.equal(got, want)
