"""ctypes bindings for the native (C++) host library: PGM decoding and
grid association.

Loads the repository's native/libvicalib_native.so if it is there.  This is
host code: when the library is absent, callers use the Python readers and
the Python grid matcher (sources.py, targets/grid_match.py).
"""
from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

log = logging.getLogger("vicalib_tpu_torch.native")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libvicalib_native.so")

_lib = None
_tried = False


def get_lib():
    """The native host library, or None when it is absent or cannot be
    loaded here.  It is never built from here: ``make -C native`` does."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        log.info("native library not loadable (%s); using python IO", e)
        return None
    lib.vn_read_pgm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.vn_read_pgm.restype = ctypes.c_int
    lib.vn_read_pgm_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.vn_read_pgm_batch.restype = ctypes.c_int
    if hasattr(lib, "vn_match_grid"):
        lib.vn_match_grid.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int64)]
        lib.vn_match_grid.restype = ctypes.c_int64
    if hasattr(lib, "vn_match_grid_batch"):
        lib.vn_match_grid_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.vn_match_grid_batch.restype = None
    _lib = lib
    return _lib


def read_pgm_batch(paths, width, height, nthreads=0):
    """Parallel-decode PGM files -> (n, H, W) uint8, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width), dtype=np.uint8)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    failures = lib.vn_read_pgm_batch(
        blob, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width, height, nthreads)
    if failures:
        log.warning("native PGM batch: %d failures; falling back", failures)
        return None
    return out


def read_pgm(path):
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    # probe size first with a small header read via python (cheap)
    with open(path, "rb") as f:
        head = f.read(64)
    import re
    m = re.match(rb"P5\s+(?:#[^\n]*\n\s*)*(\d+)\s+(\d+)", head)
    if not m:
        return None
    width, height = int(m.group(1)), int(m.group(2))
    out = np.empty((height, width), dtype=np.uint8)
    w.value, h.value = width, height
    rc = lib.vn_read_pgm(path.encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         ctypes.byref(w), ctypes.byref(h))
    return out if rc == 0 else None


def match_grid(centers, radii, valid, pattern, min_matched=16,
               min_agreement=0.8):
    """Native grid association (grid_match.cpp) or None if unavailable.

    Returns (n_matched, grid_coords (K, 2) int64 with -1 for unmatched), or
    None when the native library is missing or found no grid."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "vn_match_grid"):
        return None
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    pattern = np.ascontiguousarray(pattern, dtype=np.int32)
    K = len(centers)
    rows, cols = pattern.shape
    out = np.empty((K, 2), dtype=np.int64)
    n = lib.vn_match_grid(
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        radii.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        K, pattern.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows, cols, min_matched, min_agreement,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return (int(n), out) if n >= 0 else (-1, out)


def match_grid_batch(centers, radii, valid, pattern, min_matched=16,
                     min_agreement=0.8, nthreads=0):
    """Threaded native grid association over a frame batch.

    centers: (F, K, 2), radii: (F, K), valid: (F, K).  Returns
    (n_matched (F,) int64 with -1 for no-grid frames, coords (F, K, 2)),
    or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "vn_match_grid_batch"):
        return None
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    pattern = np.ascontiguousarray(pattern, dtype=np.int32)
    F, K = radii.shape
    rows, cols = pattern.shape
    out = np.empty((F, K, 2), dtype=np.int64)
    out_n = np.empty((F,), dtype=np.int64)
    lib.vn_match_grid_batch(
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        radii.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        F, K, pattern.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows, cols, min_matched, min_agreement,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nthreads)
    return out_n, out
