"""Time-indexed IMU measurement store and padded window extraction.

A batch redesign of the reference's ``InterpolationBufferT``
(reference: include/vicalib/interpolation-buffer.h:51-227), host numpy,
copied from the JAX package.  Instead of a
pointer-walking buffer queried inside each cost evaluation, measurements live
in flat arrays and each IMU factor (a consecutive-frame pair) gets a fixed-size
contiguous *window* of raw samples sliced out ahead of time.  Inside the
differentiable residual, the window is re-interpolated at offset-shifted times
(see preintegrate.virtual_sequence), reproducing GetRange's semantics —
interpolated endpoints exactly at the frame times, interior samples shifted by
the time offset — while keeping every shape static, so the factors batch
on the device.
"""
from __future__ import annotations

import numpy as np


class ImuBuffer:
    """Append-only store of (time, gyro, accel) with monotone timestamps."""

    def __init__(self):
        self._times = []
        self._gyro = []
        self._accel = []

    def __len__(self):
        return len(self._times)

    @property
    def end_time(self):
        return self._times[-1] if self._times else -np.inf

    @property
    def start_time(self):
        return self._times[0] if self._times else np.inf

    def add(self, gyro, accel, time):
        """Reference analog: AddElement; rejects non-monotone stamps
        (interpolation-buffer.h:70-71, vicalibrator.h:370-380)."""
        if self._times and time <= self._times[-1]:
            raise ValueError(
                f"IMU timestamps are not monotone: {time} <= {self._times[-1]}")
        self._times.append(float(time))
        self._gyro.append(np.asarray(gyro, dtype=np.float64))
        self._accel.append(np.asarray(accel, dtype=np.float64))

    def add_batch(self, gyro, accel, times):
        for g, a, t in zip(np.asarray(gyro), np.asarray(accel),
                           np.asarray(times)):
            self.add(g, a, t)

    def arrays(self):
        return (np.asarray(self._times), np.stack(self._gyro),
                np.stack(self._accel))

    def has_range(self, start, end, offset=0.0):
        """True iff [start, end] (image clock) is covered by the buffer
        (reference: HasElement at interpolation-buffer.h:121-125)."""
        if not self._times:
            return False
        return (start >= self._times[0] + offset
                and end <= self._times[-1] + offset)


def build_windows(times, frame_times, offset_guess=0.0, slack=0.5,
                  max_slots=None):
    """Slice a fixed-size raw-sample window per consecutive-frame factor.

    Args:
      times: (M,) raw IMU stamps (monotone).
      frame_times: (F,) image-clock frame stamps.
      offset_guess: nominal time offset; the window covers offsets within
        ``offset_guess +- slack`` so the solver can move the offset without
        rebuilding windows.
      slack: seconds of margin on each side.
      max_slots: force the window width (else the max needed width is used).

    Returns dict with, for K = F-1 factors:
      idx0: (K,) start index of each window into the raw arrays
      n_slots: static window width
      start, end: (K,) factor time bounds (frame times, image clock)
      has_meas: (K,) bool — whether the buffer covers [start, end]
        at the offset guess (empty factors produce zero residuals, matching
        ceres-cost-functions.h:452-455).
    """
    times = np.asarray(times)
    frame_times = np.asarray(frame_times)
    M = len(times)
    starts = frame_times[:-1]
    ends = frame_times[1:]
    lo = np.searchsorted(times, starts - offset_guess - slack, side="right") - 1
    hi = np.searchsorted(times, ends - offset_guess + slack, side="left") + 1
    lo = np.clip(lo, 0, M - 1)
    hi = np.clip(hi, 1, M)
    width = int(np.max(hi - lo)) if len(lo) else 2
    if max_slots is not None:
        if width > max_slots:
            raise ValueError(
                f"IMU window needs {width} slots > max_slots={max_slots}")
        width = max_slots
    idx0 = np.clip(lo, 0, max(M - width, 0))
    has = ((starts >= times[0] + offset_guess)
           & (ends <= times[-1] + offset_guess)) if M else np.zeros(
               len(starts), bool)
    return {
        "idx0": idx0.astype(np.int32),
        "n_slots": width,
        "start": starts,
        "end": ends,
        "has_meas": has,
    }


def gather_windows(times, gyro, accel, idx0, n_slots):
    """Materialize (K, n_slots) window arrays from raw streams."""
    idx = idx0[:, None] + np.arange(n_slots)[None, :]
    idx = np.clip(idx, 0, len(times) - 1)
    return times[idx], gyro[idx], accel[idx]
