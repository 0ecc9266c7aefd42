"""Small host-side utilities: boxcar static-motion filter, stats struct.

Reference analogs: include/vicalib/boxcar-filter.h (moving-average static
detector feeding -use_only_when_static) and
include/vicalib/calibration-stats.h (the 30 ms status snapshot pushed to the
update callback).
"""
from __future__ import annotations

import collections
import dataclasses
import enum

import numpy as np


class BoxcarFilter:
    """Moving-average static-motion detector (boxcar-filter.h:12-83):
    stores |sample| over a window; stable iff the window is full and every
    deviation from the mean is below the threshold."""

    def __init__(self, window: int, threshold: float):
        self.window = window
        self.threshold = threshold
        self._buf = collections.deque(maxlen=window)

    def add(self, sample):
        self._buf.append(np.abs(np.asarray(sample, dtype=np.float64)))

    def is_stable(self) -> bool:
        if len(self._buf) < self.window:
            return False
        arr = np.stack(self._buf)
        mean = arr.mean(axis=0)
        return bool(np.all(np.abs(arr - mean) < self.threshold))


class CalibrationStatus(enum.Enum):
    """calibration-stats.h:17-23."""
    INACTIVE = 0
    CAPTURING = 1
    OPTIMIZING = 2
    SUCCESS = 3
    FAILURE = 4


@dataclasses.dataclass
class CalibrationStats:
    """calibration-stats.h:15-43."""
    num_cameras: int
    status: CalibrationStatus = CalibrationStatus.INACTIVE
    num_frames_processed: list = None
    reprojection_error: list = None
    total_mse: float = 0.0
    num_iterations: int = 0
    ts: float = 0.0                     # camera<->IMU time offset
    t_ck_vec: list = None               # per-camera (q, t)
    cam_intrinsics: list = None

    def __post_init__(self):
        if self.num_frames_processed is None:
            self.num_frames_processed = [0] * self.num_cameras
        if self.reprojection_error is None:
            self.reprojection_error = [0.0] * self.num_cameras
        if self.t_ck_vec is None:
            self.t_ck_vec = []
        if self.cam_intrinsics is None:
            self.cam_intrinsics = []

    def copy(self):
        return dataclasses.replace(
            self,
            num_frames_processed=list(self.num_frames_processed),
            reprojection_error=list(self.reprojection_error),
            t_ck_vec=list(self.t_ck_vec),
            cam_intrinsics=list(self.cam_intrinsics))
