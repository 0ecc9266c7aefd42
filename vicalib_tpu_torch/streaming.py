"""Incremental (streaming) calibration: solve while capturing.

Reference analog: the background solver thread + 30 ms stats publication
(vicalib-engine.cc:375-433; vicalibrator.h:263-274, 682-687) — the reference
keeps one Ceres problem, adds frames as they arrive, and re-solves
continuously, publishing CalibrationStats as it goes.

Frames arrive in *chunks*; the problem lives in fixed-capacity tensors whose
capacity grows in powers of two.  Unfilled frame slots carry zero-valid
observations and empty IMU factors (has_meas=False): they contribute zero
residuals and Jacobians and their damped increments are zero, so the padding
is inert.  The capacities are the JAX package's, which keeps every chunk's
problem, and so its result, equal to the JAX package's.  After each chunk
the staged solver re-solves warm-started from the previous estimate: the
first chunk runs the full staged schedule (gravity / extrinsic-rotation /
time-offset initialization); later chunks resume at the final stage, which
converges in a handful of iterations.  The per-chunk stats callback is the
cadence analog of the reference's 30 ms polling loop.

Everything runs on the calibrator's explicit device (``"cuda"`` unless the
caller passes ``device="cpu"``); the frame and IMU buffers are host numpy.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import obs
from .device import resolve_device
from .geometry import se3
from .solver import StageFlags, run_staged
from .solver.build import build_problem
from .solver.lm import LMOptions
from .solver.stages import remove_outliers as _remove_outliers
from .solver.weights import IMU_ACCEL_SIGMA, IMU_GYRO_SIGMA

log = logging.getLogger("vicalib_tpu_torch.streaming")


def _next_capacity(n: int, minimum: int = 16) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class ChunkResult:
    n_frames: int                  # filled frames so far
    capacity: int                  # padded problem size solved
    cam_rmse: np.ndarray
    cost: float
    n_residuals: int               # residual count behind ``cost``
    iterations: int
    time_offset: float
    wall_s: float
    state: object                  # CalibState at this chunk (device)


class StreamingCalibrator:
    """Feed detections chunk by chunk; re-solve after each chunk.

    Args mirror build_problem: ``model_names``, target ``points_3d``
    (P, 3), per-camera ``widths``/``heights``; IMU streams may extend with
    each chunk.
    """

    def __init__(self, model_names, points_3d, widths=None, heights=None,
                 dtype=None, window_slack=0.35, calibrate_imu=True,
                 optimize_time_offset=True, options=None,
                 gyro_sigma=None, accel_sigma=None, stats_callback=None,
                 time_offset_guess=0.0, remove_outliers=False,
                 outlier_threshold=2.0, device="cuda"):
        self.device = resolve_device(device)
        self.model_names = list(model_names)
        self.points_3d = np.asarray(points_3d)
        self.widths = widths
        self.heights = heights
        self.dtype = dtype if dtype is not None else torch.float64
        self.window_slack = float(window_slack)
        self.calibrate_imu = calibrate_imu
        self.optimize_time_offset = optimize_time_offset
        self.options = options or LMOptions()
        self.gyro_sigma = gyro_sigma or IMU_GYRO_SIGMA
        self.accel_sigma = accel_sigma or IMU_ACCEL_SIGMA
        self.stats_callback = stats_callback
        self.time_offset_guess = float(time_offset_guess)
        self.remove_outliers = bool(remove_outliers)
        self.outlier_threshold = float(outlier_threshold)
        self.last_result = None        # StagedResult of the latest solve
        self._last_data = None         # ProblemData of the latest solve
        self._last_flags = None

        C = len(self.model_names)
        P = len(self.points_3d)
        self._C, self._P = C, P
        self.frame_times = np.zeros((0,))
        self.pixels = np.zeros((C, 0, P, 2))
        self.visible = np.zeros((C, 0, P), dtype=bool)
        self.imu_times = np.zeros((0,))
        self.gyro = np.zeros((0, 3))
        self.accel = np.zeros((0, 3))
        self._state = None             # warm-start CalibState
        self._filled = 0               # frames filled at last solve
        self._schedule_done = False    # full staged schedule ran once
        self.results: list[ChunkResult] = []

    @property
    def n_frames(self) -> int:
        return len(self.frame_times)

    def add_frames(self, times, pixels, visible):
        """Append a chunk of detected frames.

        times: (f,); pixels: (C, f, P, 2); visible: (C, f, P).
        """
        times = np.asarray(times, np.float64)
        pixels = np.asarray(pixels, np.float64)
        visible = np.asarray(visible, bool)
        self.frame_times = np.concatenate([self.frame_times, times])
        self.pixels = np.concatenate([self.pixels, pixels], axis=1)
        self.visible = np.concatenate([self.visible, visible], axis=1)

    def add_imu(self, times, gyro, accel):
        self.imu_times = np.concatenate([self.imu_times,
                                         np.asarray(times, np.float64)])
        self.gyro = np.concatenate([self.gyro, np.asarray(gyro)], axis=0)
        self.accel = np.concatenate([self.accel, np.asarray(accel)], axis=0)

    def _padded_inputs(self, cap: int):
        """Pad frame arrays to ``cap`` slots with inert frames."""
        F = self.n_frames
        pad = cap - F
        if pad == 0:
            return self.frame_times, self.pixels, self.visible
        # pad times keep monotonicity but run past the IMU buffer, so every
        # padded factor gets has_meas=False in build_windows
        dt = (self.frame_times[-1] - self.frame_times[-2]
              if F >= 2 else 0.1)
        extra = self.frame_times[-1] + dt * np.arange(1, pad + 1) + 1e3
        times = np.concatenate([self.frame_times, extra])
        pixels = np.concatenate(
            [self.pixels, np.zeros((self._C, pad, self._P, 2))], axis=1)
        visible = np.concatenate(
            [self.visible, np.zeros((self._C, pad, self._P), bool)], axis=1)
        return times, pixels, visible

    def _final_flags(self, use_imu):
        return StageFlags(
            calibrate_imu=use_imu, inertial_active=use_imu,
            rotation_only=False, bias_active=use_imu, scale_active=use_imu,
            optimize_time_offset=use_imu and self.optimize_time_offset)

    def solve(self) -> ChunkResult:
        """Re-solve with everything received so far (warm-started)."""
        F = self.n_frames
        if F < 2:
            raise ValueError("need at least 2 frames")
        with obs.span("vicalib.live.build") as build:
            cap = _next_capacity(F)
            times, pixels, visible = self._padded_inputs(cap)

            kw = {}
            use_imu = self.calibrate_imu and len(self.imu_times) > 1
            if use_imu:
                kw = dict(imu_times=self.imu_times, gyro=self.gyro,
                          accel=self.accel, window_slack=self.window_slack,
                          time_offset_guess=self.time_offset_guess)
            data, state = build_problem(
                self.model_names, times, pixels, visible, self.points_3d,
                widths=self.widths, heights=self.heights, dtype=self.dtype,
                device=self.device, **kw)

            if self._state is not None:
                state = self._carry_state(state, data.n_frames)
        self._filled = F

        if not self._schedule_done:
            flags = StageFlags(calibrate_imu=use_imu,
                               optimize_time_offset=(
                                   use_imu and self.optimize_time_offset))
            resume = False
        else:
            # warm re-solve at the final stage configuration
            flags = self._final_flags(use_imu)
            resume = True
        with obs.span("vicalib.live.solve") as solve:
            result = run_staged(state, data, flags, self.options,
                                gyro_sigma=self.gyro_sigma,
                                accel_sigma=self.accel_sigma, resume=resume)
            if self.remove_outliers:
                # Per-chunk outlier pass on the converged state (the
                # reference's RemoveOutliers + one re-solve,
                # vicalibrator.h:859-916, at the streaming cadence):
                # observations beyond threshold * per-camera RMSE are
                # invalidated PERSISTENTLY (the host visible mask feeds every
                # later chunk's rebuild) and the chunk re-solves once.
                data2 = _remove_outliers(result.state, data,
                                         result.cam_rmse,
                                         self.outlier_threshold)
                n_removed = 0
                for c in range(self._C):
                    keep = (data2.obs[c].valid.cpu().numpy()
                            .reshape(cap, self._P)[:F] > 0)
                    removed = self.visible[c, :F] & ~keep
                    n_removed += int(removed.sum())
                    self.visible[c, :F] &= keep
                if n_removed:
                    log.info("stream outliers: removed %d observations; "
                             "re-solving chunk", n_removed)
                    flags = self._final_flags(use_imu)
                    result = run_staged(result.state, data2, flags,
                                        self.options,
                                        gyro_sigma=self.gyro_sigma,
                                        accel_sigma=self.accel_sigma,
                                        resume=True)
                    data = data2
        self._state = result.state
        self._schedule_done = True
        self.last_result = result
        self._last_data = data
        self._last_flags = flags
        chunk = ChunkResult(
            n_frames=F, capacity=cap, cam_rmse=result.cam_rmse,
            cost=result.info.cost,
            n_residuals=int(result.info.n_residuals),
            iterations=result.total_iterations,
            time_offset=float(result.state.time_offset),
            wall_s=build.s + solve.s, state=result.state)
        self.results.append(chunk)
        log.info("chunk: %d frames (cap %d) cost %.6e rmse %s iters %d "
                 "%.2fs", F, cap, chunk.cost, chunk.cam_rmse,
                 chunk.iterations, chunk.wall_s,
                 extra={"chunk": {"n_frames": F, "capacity": cap,
                                  "iterations": chunk.iterations,
                                  "cost": chunk.cost,
                                  "wall_s": chunk.wall_s}})
        if self.stats_callback is not None:
            self.stats_callback(chunk)
        return chunk

    def _carry_state(self, fresh_state, cap):
        """Warm-start: copy previous estimates into the fresh state.

        Only the previously *filled* frames carry over — the previous
        problem's pad slots hold default poses, and overwriting a new
        frame's PnP init with one of those throws the solver into a far
        local minimum.  New tensors throughout: the previous chunk's state
        (still held by its ChunkResult) is never written."""
        prev = self._state
        n = min(self._filled, cap)
        # Convention alignment: the solved state's frame/extrinsic pair was
        # re-anchored by the extrinsic-rotation initialization (T_wk and
        # T_ck both right-multiplied by the same dT, leaving reprojection
        # invariant) — but the NEW frames' PnP poses were built against the
        # fresh state's DEFAULT camera-0 extrinsic.  Re-express them:
        # T_wk' = T_wk_fresh * T_ck0_default^-1 * T_ck0_carried.
        dT = se3.mul(se3.inverse((fresh_state.q_ck[0], fresh_state.p_ck[0])),
                     (prev.q_ck[0], prev.p_ck[0]))
        q_fix, t_fix = se3.mul(
            (fresh_state.q_wk, fresh_state.t_wk),
            (dT[0].expand_as(fresh_state.q_wk),
             dT[1].expand_as(fresh_state.t_wk)))
        return fresh_state._replace(
            q_wk=torch.cat([prev.q_wk[:n], q_fix[n:]]),
            t_wk=torch.cat([prev.t_wk[:n], t_fix[n:]]),
            v_w=torch.cat([prev.v_w[:n], fresh_state.v_w[n:]]),
            q_ck=prev.q_ck, p_ck=prev.p_ck, intr=prev.intr,
            g_dir=prev.g_dir, biases=prev.biases, scales=prev.scales,
            time_offset=prev.time_offset)
