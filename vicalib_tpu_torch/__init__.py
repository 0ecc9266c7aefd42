"""vicalib_tpu_torch — the PyTorch/CUDA port of the JAX package vicalib_tpu
(which stays beside it as the reference).

Camera intrinsics, camera-to-IMU extrinsics, IMU biases, scale factors,
gravity and the camera-IMU time offset from images of a dot target and an
IMU stream: detection (adaptive threshold and connected components as a
CUDA kernel), grid association, planar PnP, RK4 IMU preintegration, and a
staged Levenberg-Marquardt solve with Schur-complement frame elimination.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; they never fall back.
"""

__version__ = "0.1.0"
