"""The explicit device of an entry point.

An entry point runs where its caller says, ``"cuda"`` by default.  Asking
for ``"cuda"`` on a machine without a usable CUDA device is an error: the
port never moves work to the CPU on its own.
"""
from __future__ import annotations

import hashlib
import os
import subprocess

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU" % str(device))
    return dev


def _nvcc():
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    return path if os.path.exists(path) else "nvcc"


def nvcc_library(source: str, verbose=False) -> str:
    """Compile ``csrc/<source>`` for sm_90a into a shared library with a
    plain C interface under build/, once per version of the source, and
    return its path (for ``ctypes.CDLL``).  ``verbose`` prints the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)."""
    src = os.path.join(_PKG_DIR, "csrc", source)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(source)[0]
    so = os.path.join(BUILD_DIR, "lib%s_%s.so" % (stem, tag))
    if not os.path.exists(so):
        tmp = "%s.%d.tmp" % (so, os.getpid())
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s%s" % (
                res.returncode, res.stdout, res.stderr))
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, so)
    return so
