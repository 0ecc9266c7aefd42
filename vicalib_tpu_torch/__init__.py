"""vicalib_tpu_torch — the PyTorch/CUDA port of the JAX package vicalib_tpu
(which stays beside it as the reference).

Camera intrinsics and camera-to-camera extrinsics from images of a dot
target: detection (adaptive threshold and connected components as a CUDA
kernel), grid association, planar PnP, and a staged Levenberg-Marquardt
solve with Schur-complement frame elimination.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; they never fall back.
"""

__version__ = "0.1.0"
