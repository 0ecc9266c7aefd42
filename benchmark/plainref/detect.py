"""The reference's own detections: every frame of a camera through the
plain threshold and labelling (kernels.py), the conic centres (conics.py)
and the plain grid matcher (grid_match.py), with the program's default
detector settings.  The matcher runs over a pool of worker processes;
``shutdown`` stops it."""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np
import torch

from .conics import ConicParams, find_conics_batch
from .grid_match import match_target

# the program's defaults (-conic_min_area ... -at_window_ratio)
PARAMS = ConicParams(max_conics=512, min_area=4.0, min_density=0.6,
                     min_aspect=0.2, refine_iters=3, refine_power=2.0)
AT_THRESHOLD = 0.9
AT_WINDOW_RATIO = 30.0
BATCH = 32
_pool = None


def _match_one(centers, radii, valid, pattern):
    m = match_target(centers, radii, valid, pattern)
    return m.grid_coords if m.ok else None


_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
_env = None


def _matcher():
    """The pool, its workers each on one thread: numpy's threads spinning
    in eight processes at once stall the machine.  The workers start on
    demand and take this process's environment, which keeps the setting
    until ``shutdown``."""
    global _pool, _env
    if _pool is None:
        _env = {k: os.environ.get(k) for k in _ONE_THREAD}
        os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
        _pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"))
    return _pool


def shutdown():
    """Stop the matcher's worker processes and wait for them to end."""
    global _pool
    if _pool is not None:
        _pool.shutdown(wait=True, cancel_futures=True)
        _pool = None
        for k, v in _env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def detect_frames(frames, pattern, device):
    """pixels (F, P, 2) and visible (F, P) of (F, H, W) uint8 ``frames``
    against the 0/1 ``pattern`` (rows, cols) of the target."""
    pattern = np.asarray(pattern)
    F = len(frames)
    P = pattern.size
    pixels = np.zeros((F, P, 2))
    visible = np.zeros((F, P), dtype=bool)
    futs = []
    for i in range(0, F, BATCH):
        det = find_conics_batch(torch.from_numpy(np.ascontiguousarray(
            frames[i:i + BATCH])), PARAMS, at_threshold=AT_THRESHOLD,
            at_window_ratio=AT_WINDOW_RATIO, device=device)
        det = {k: v.cpu().numpy() for k, v in det.items()}
        futs += [(i + k, det["center"][k], _matcher().submit(
            _match_one, det["center"][k], det["radius"][k],
            det["valid"][k].astype(bool), pattern))
            for k in range(det["center"].shape[0])]
    for f, centers, fut in futs:
        coords = fut.result()
        if coords is None:
            continue
        sel = coords[:, 0] >= 0
        gidx = coords[sel, 1] * pattern.shape[1] + coords[sel, 0]
        pixels[f, gidx] = centers[sel]
        visible[f, gidx] = True
    return pixels, visible
