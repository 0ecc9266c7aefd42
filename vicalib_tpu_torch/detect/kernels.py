"""Adaptive threshold + connected-component labels: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel
``vicalib_tpu/detect/pallas_kernels.py::threshold_and_label`` (body
``_detect_kernel``).  Per frame of a (B, H, W) float32 batch, edge-padded so
that H % 8 == 0 and W % 128 == 0 (``conics._pad_to_tiles``):

(a) box mean over the clamped (2r+1)^2 window, summed exactly in int32;
(b) mask = img < mean * t (black on white), else img > mean * (2 - t);
(c) 8-connected labels = minimum 1-based flat index of the component, by
    Jacobi 3x3 min sweeps until a sweep changes nothing or ``n_iters``
    sweeps ran (a component that needs more keeps several labels);
(d) compact ids: a representative is a masked pixel that kept its own
    index, its id is its rank in flat order, ids above ``max_labels`` become
    0, and the ids spread through the mask by a second bounded sweep.

Output: ``(labels > 0, labels)`` with labels int32, 0 = background.  A masked
pixel that the bound leaves unreached keeps INT_MAX, as in the reference.

``threshold_and_label`` dispatches on the tensor's device alone: a CPU tensor
takes ``threshold_and_label_ref``, a CUDA tensor launches the kernel in
``csrc/threshold_label.cu`` (built with nvcc for sm_90a on first use) or
raises.  The window sums are taken of the pixel values truncated to int32,
so the result equals the reference bit for bit on 8-bit frames.  The
kernel runs the bounded sweeps of (c) and (d) as chunks of several Jacobi
steps per launch on tiles with a halo as wide as the chunk;
``tests/test_torch_kernels.py`` mirrors that schedule in PyTorch and holds
it to one sweep at a time bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch
import torch.nn.functional as F

BIG = torch.iinfo(torch.int32).max

# launches of each CUDA kernel, counted by its wrapper where it launches
LAUNCHES = {"threshold_and_label": 0}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "threshold_label.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
# labels are 1-based flat indices in int32, and INT_MAX marks "unlabelled"
_MAX_PIXELS = BIG - 1
# the threshold pass keeps 32 rows of (128 + 2r) | 1 int32 column sums in the
# 48 KB of shared memory a block gets by default
_MAX_RADIUS = 127

_lib = None
_lock = threading.Lock()


def _nvcc():
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(verbose=False):
    """Compile csrc/threshold_label.cu for sm_90a into build/ (once per
    source version) and load it.  Returns the ctypes library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:12]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libthreshold_label_{tag}.so")
        if not os.path.exists(so):
            tmp = "%s.%d.tmp" % (so, os.getpid())
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, _SRC]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed (%d):\n%s%s" % (
                    res.returncode, res.stdout, res.stderr))
            if verbose:
                print(res.stdout + res.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        fn = lib.vt_threshold_and_label
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        cfg = (ctypes.c_int * 3)()
        lib.vt_tile_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.vt_tile_config.restype = None
        lib.vt_tile_config(cfg)
        lib.tile_config = tuple(cfg)
        _lib = lib
        return lib


def tile_config():
    """(tile rows, tile columns, Jacobi steps per launch) of the built
    kernel."""
    return build().tile_config


def _check(imgs, radius, n_iters, max_labels):
    if not isinstance(imgs, torch.Tensor):
        raise TypeError("imgs must be a torch.Tensor")
    if imgs.dim() != 3:
        raise ValueError("imgs must be (B, H, W), got %s" % (
            tuple(imgs.shape),))
    if imgs.dtype != torch.float32:
        raise TypeError("imgs must be float32, got %s" % imgs.dtype)
    B, H, W = imgs.shape
    if H % 8 or W % 128:
        raise ValueError("frames must be padded to H %% 8 == 0 and "
                         "W %% 128 == 0 (conics._pad_to_tiles); got %dx%d"
                         % (H, W))
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    if H * W > _MAX_PIXELS:
        raise ValueError("a %dx%d frame has more pixels than int32 labels "
                         "can index (%d)" % (H, W, _MAX_PIXELS))
    if B > 65535:
        raise ValueError("at most 65535 frames per call")
    if not 1 <= radius <= _MAX_RADIUS or n_iters < 0 or max_labels < 0:
        raise ValueError("1 <= radius <= %d, n_iters >= 0, max_labels >= 0"
                         % _MAX_RADIUS)


def threshold_and_label(imgs, radius, at_threshold=0.9, black_on_white=True,
                        n_iters=64, max_labels=512):
    """Fused adaptive threshold + CC labelling over a frame batch.

    imgs: (B, H, W) float32, H % 8 == 0, W % 128 == 0, contiguous.  Returns
    (mask (B,H,W) bool, compact labels (B,H,W) int32).
    """
    _check(imgs, radius, n_iters, max_labels)
    if imgs.device.type == "cpu":
        return threshold_and_label_ref(imgs, radius, at_threshold,
                                       black_on_white, n_iters, max_labels)
    if imgs.device.type != "cuda":
        raise ValueError("no kernel for device %s" % imgs.device)
    if imgs.data_ptr() % 16:
        raise ValueError("imgs must start on a 16-byte boundary")
    lib = build()
    ty, tx, steps = lib.tile_config
    B, H, W = imgs.shape
    dev = imgs.device
    out = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    mask = torch.empty((B, H, W), dtype=torch.uint8, device=dev)
    # int32 scratch in one allocation: two label buffers, the list of active
    # tiles, representatives per row, and flags (per chunk of each phase a
    # "changed" row, each phase's result buffer per frame, the count of
    # active tiles)
    n = B * H * W
    sizes = [n, n, B * -(-H // ty) * (W // tx), B * H,
             (2 * -(-n_iters // steps) + 2) * B + 1]
    buf0, buf1, active_tiles, row_cnt, flags = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    # the threshold factor is rounded to float32 as the reference does:
    # 2 - t is formed in double first, then rounded
    factor = at_threshold if black_on_white else 2.0 - at_threshold
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vt_threshold_and_label(
            imgs.data_ptr(), out.data_ptr(), buf0.data_ptr(),
            buf1.data_ptr(), mask.data_ptr(), active_tiles.data_ptr(),
            row_cnt.data_ptr(), flags.data_ptr(), B, H, W, int(radius),
            int(n_iters), ctypes.c_float(factor), int(bool(black_on_white)),
            int(max_labels), stream)
    if err != 0:
        raise RuntimeError("threshold_and_label kernel failed: CUDA error "
                           "%d" % err)
    LAUNCHES["threshold_and_label"] += 1
    # the kernel leaves out > 0 in the mask buffer
    return mask.view(torch.bool), out


# ----------------------------------------------------------------- plain
def _threshold_mask(imgs, radius, at_threshold, black_on_white):
    """(a) + (b): exact int window sums, float32 mean and compare."""
    B, H, W = imgs.shape
    dev = imgs.device
    r = int(radius)
    v = imgs.to(torch.int32).to(torch.int64)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    y0 = torch.clamp(ys - r, min=0)
    y1 = torch.clamp(ys + r, max=H - 1)
    x0 = torch.clamp(xs - r, min=0)
    x1 = torch.clamp(xs + r, max=W - 1)
    cy = F.pad(torch.cumsum(v, dim=1), (0, 0, 1, 0))          # (B, H+1, W)
    col = cy[:, y1 + 1] - cy[:, y0]                           # (B, H, W)
    cx = F.pad(torch.cumsum(col, dim=2), (1, 0))              # (B, H, W+1)
    s = cx[:, :, x1 + 1] - cx[:, :, x0]
    cnt = ((y1 - y0 + 1)[:, None] * (x1 - x0 + 1)[None, :])
    mean = s.to(torch.float32) / cnt.to(torch.float32)
    if black_on_white:
        t = torch.tensor(at_threshold, dtype=torch.float32, device=dev)
        return imgs < mean * t
    t = torch.tensor(2.0 - at_threshold, dtype=torch.float32, device=dev)
    return imgs > mean * t


def _sweep(labels, mask):
    """One Jacobi 3x3 min sweep (separable: column min, then row min)."""
    p = F.pad(labels, (1, 1, 1, 1), value=BIG)
    r = torch.minimum(torch.minimum(p[:, :-2], p[:, 1:-1]), p[:, 2:])
    m = torch.minimum(torch.minimum(r[:, :, :-2], r[:, :, 1:-1]),
                      r[:, :, 2:])
    return torch.where(mask, m, BIG)


def _propagate(labels, mask, n_iters):
    """Bounded sweeps, each frame until a sweep changes nothing.  Returns
    (labels, sweeps (B,) int64): the sweeps the kernel runs per frame."""
    B = labels.shape[0]
    active = torch.ones(B, dtype=torch.bool, device=labels.device)
    sweeps = torch.zeros(B, dtype=torch.int64, device=labels.device)
    for _ in range(n_iters):
        new = _sweep(labels, mask)
        sweeps += active
        active = active & (new != labels).flatten(1).any(dim=1)
        labels = new
        if not bool(active.any()):
            break
    return labels, sweeps


def threshold_and_label_ref(imgs, radius, at_threshold=0.9,
                            black_on_white=True, n_iters=64, max_labels=512,
                            return_sweeps=False):
    """Plain PyTorch version of the kernel, on any device.

    With ``return_sweeps`` also returns the (B, 2) sweeps of the label and
    compact phases per frame, the work the kernel does on these inputs.
    """
    B, H, W = imgs.shape
    dev = imgs.device
    mask = _threshold_mask(imgs, radius, at_threshold, black_on_white)
    idx = (torch.arange(H * W, dtype=torch.int32, device=dev)
           + 1).reshape(H, W)
    labels = torch.where(mask, idx, BIG)
    labels, sw_a = _propagate(labels, mask, n_iters)
    rep = mask & (labels == idx)
    rank = torch.cumsum(rep.reshape(B, H * W).to(torch.int32), dim=1,
                        dtype=torch.int32).reshape(B, H, W)
    cid = torch.where(rank <= max_labels, rank, 0)
    compact, sw_b = _propagate(torch.where(rep, cid, BIG), mask, n_iters)
    out = torch.where(mask, compact, 0)
    if return_sweeps:
        return out > 0, out, torch.stack([sw_a, sw_b], dim=1)
    return out > 0, out
