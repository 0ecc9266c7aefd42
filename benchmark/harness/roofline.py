"""Peaks of the card and the least work of the program's kernels, counted
from the frames the program is handed, never from its padded buffers."""
from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), published data sheet at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def frame_dims(shape, cameras):
    """(height, width) of the frames behind a kernel call on a padded
    (B, H', W') batch: the largest camera frame that fits inside it."""
    _, hp, wp = shape
    fits = [(c["height"], c["width"]) for c in cameras
            if c["height"] <= hp and c["width"] <= wp]
    if not fits:
        raise ValueError("no camera frame fits a %s batch" % (shape,))
    return max(fits, key=lambda hw: hw[0] * hw[1])


def threshold_and_label_bytes(shape, cameras):
    """Least bytes of one threshold_and_label call: each pixel of the
    unpadded frames read once as 8 bits and its int32 label written once."""
    h, w = frame_dims(shape, cameras)
    return shape[0] * h * w * (1 + 4)
