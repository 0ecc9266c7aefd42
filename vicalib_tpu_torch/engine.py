"""VicalibEngine: end-to-end calibration orchestration.

Reference analog: VicalibEngine + VicalibTask (src/vicalib-engine.cc,
src/vicalib-task.cc) — sensor replay, static-motion gating, frame
selection, detection, measurement assembly, the staged visual-inertial
solve, success validation and output writing.  Batch-first: frames are
read and detected in bulk (the batched conic finder on the device + host
grid association), then one staged solver run replaces the background
solver thread.

Everything runs on the engine's explicit device, ``"cuda"`` unless the
caller passes ``device="cpu"``.  ``-stream_chunk N`` replaces the single
solve by chunked, warm-started re-solves (streaming.py) that publish stats,
rewrite ``-report_file`` and push a scene to ``-status_port`` after every
chunk.  ``-n_shards`` and a multi-process run (cli.py) split the solve over
the shards of a mesh (dist/); every process runs the whole pipeline and
only the primary writes files.  Each calibration runs in a recording of
spans and counters (obs.py) whose totals end the result log.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os

import numpy as np
import torch

from . import obs
from .config import VicalibConfig
from .device import resolve_device
from .geometry import quat_np
from .io import native as native_io
from .io import outputs as out_io
from .io import sources
from .targets import grid as grid_mod
from .targets import pattern_export
from .targets.grid_match import match_target
from .utils import BoxcarFilter, CalibrationStats, CalibrationStatus

log = logging.getLogger("vicalib_tpu_torch.engine")


@dataclasses.dataclass
class EngineResult:
    success: bool
    stats: CalibrationStats
    state: object                  # solver CalibState (tensors)
    result: object                 # solver StagedResult
    model_names: list
    timings: dict = None           # seconds per phase (device-synchronized)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _detect_all(images, target, cfg, device, max_conics=512):
    """Detect + associate the grid in every frame of one channel.

    images: list of (H, W) uint8.  Returns pixels (F, P, 2), visible (F, P),
    conic_rows (list for -output_conics).
    """
    from .detect.conics import ConicParams, find_conics_batch

    F = len(images)
    P = target.n_points
    params = ConicParams(max_conics=max_conics,
                         min_area=cfg.conic_min_area,
                         min_density=cfg.conic_min_density,
                         min_aspect=cfg.conic_min_aspect,
                         refine_iters=cfg.conic_refine_iters,
                         refine_power=cfg.conic_refine_power)
    # Chunks of 32 frames upload as uint8 (the cast to float32 happens on
    # the device) and are dispatched a few chunks ahead of the pulls.
    chunk = 32
    window = 4
    pixels = np.zeros((F, P, 2))
    visible = np.zeros((F, P), dtype=bool)
    conic_rows = []
    pts = target.circles_3d() if cfg.output_conics else None

    def dispatch(i):
        imgs = torch.from_numpy(np.stack(images[i:i + chunk]))
        return find_conics_batch(
            imgs, params, at_threshold=cfg.at_threshold,
            at_window_ratio=cfg.at_window_ratio,
            black_on_white=cfg.black_on_white, device=device)

    log.info("grid association: %s matcher", "native"
             if native_io.get_lib() is not None else "python")
    starts = list(range(0, F, chunk))
    inflight = {i: dispatch(i) for i in starts[:window]}
    for ci, i in enumerate(starts):
        det = {k: v.cpu().numpy() for k, v in inflight.pop(i).items()}
        nxt = ci + window
        if nxt < len(starts):
            inflight[starts[nxt]] = dispatch(starts[nxt])
        # grid association: the threaded native batch matcher when the
        # native host library is there, the python matcher otherwise
        n = det["center"].shape[0]
        with obs.span("vicalib.detect.match"):
            batch = native_io.match_grid_batch(det["center"], det["radius"],
                                               det["valid"], target.grid)
            if batch is not None:
                found = [batch[1][k] if int(batch[0][k]) >= 0 else None
                         for k in range(n)]
            else:
                found = []
                for k in range(n):
                    m = match_target(det["center"][k], det["radius"][k],
                                     det["valid"][k], target,
                                     backend="numpy")
                    found.append(m.grid_coords if m.ok else None)
        for k, grid_coords in enumerate(found):
            if grid_coords is None:
                continue
            sel = grid_coords[:, 0] >= 0
            gidx = (grid_coords[sel, 1] * target.cols + grid_coords[sel, 0])
            pixels[i + k, gidx] = det["center"][k][sel]
            visible[i + k, gidx] = True
            if cfg.output_conics:
                for co, gi in zip(np.where(sel)[0], gidx):
                    u, v = det["center"][k][co]
                    x, y, z = pts[gi]
                    conic_rows.append((i + k, int(gi), u, v, x, y, z))
    return pixels, visible, conic_rows


def make_grid(cfg: VicalibConfig) -> grid_mod.TargetGrid:
    """CreateGrid (vicalib-engine.cc:453-495); -grid_file loads a real
    printed target's bit pattern (see grid.load_grid_file)."""
    if cfg.grid_file:
        target = grid_mod.load_grid_file(
            cfg.grid_file, cfg.grid_spacing, cfg.grid_large_rad,
            cfg.grid_small_rad)
    elif cfg.grid_preset:
        target = grid_mod.load_preset(cfg.grid_preset)
    else:
        target = grid_mod.TargetGrid(
            grid_mod.make_pattern(cfg.grid_height, cfg.grid_width,
                                  cfg.grid_seed),
            cfg.grid_spacing, cfg.grid_large_rad, cfg.grid_small_rad)
    if cfg.output_pattern_file:
        path = cfg.output_pattern_file
        if path.lower().endswith(".eps"):
            pattern_export.save_eps(target, path)
        else:
            pattern_export.save_svg(target, path)
        log.info("File %s saved", path)
    return target


def camera_calibrations_differ(cfg, model_name, last_params, cur_params,
                               last_T, cur_T):
    """Success validation vs a previous calibration
    (CameraCalibrationsDiffer, vicalib-task.cc:714-805)."""
    last_params = np.asarray(last_params)
    cur_params = np.asarray(cur_params)[:len(last_params)]  # strip padding
    diffs = np.abs(last_params - cur_params)
    lims = [cfg.max_fx_diff, cfg.max_fy_diff, cfg.max_cx_diff,
            cfg.max_cy_diff]
    for i, lim in enumerate(lims):
        if diffs[i] > lim:
            log.error("intrinsic %d differs too much (%f)", i, diffs[i])
            return True
    if model_name == "fov" and diffs[4] > cfg.max_fov_w_diff:
        log.error("fov distortion differs too much (%f)", diffs[4])
        return True
    if model_name == "poly3" and (
            diffs[4] > cfg.max_poly3_diff_k1
            or diffs[5] > cfg.max_poly3_diff_k2
            or diffs[6] > cfg.max_poly3_diff_k3):
        log.error("poly3 distortion differs too much")
        return True
    dist = np.linalg.norm(np.asarray(last_T[1]) - np.asarray(cur_T[1]))
    if dist > cfg.max_camera_trans_diff:
        log.error("camera position differs by %f", dist)
        return True
    dq = quat_np.quat_mul(quat_np.inverse(np.asarray(last_T[0])),
                          np.asarray(cur_T[0]))
    R = quat_np.to_matrix(dq)
    ax = np.arctan2(R[2, 1], R[2, 2])
    ay = np.arctan2(-R[2, 0], np.hypot(R[2, 1], R[2, 2]))
    az = np.arctan2(R[1, 0], R[0, 0])
    if max(abs(ax), abs(ay), abs(az)) > cfg.max_camera_angle_diff:
        log.error("camera orientations differ: %f %f %f", ax, ay, az)
        return True
    return False


def imu_calibration_differs(cfg, last_biases, cur_biases):
    """IMU bias drift check.  The reference's comparisons are inverted
    (`< FLAGS_max_imu_*_diff` triggers the error path, vicalib-task.cc:811-827
    — a latent bug); this implements the intended `>` semantics."""
    diff = np.abs(np.asarray(last_biases) - np.asarray(cur_biases))
    if np.any(diff[:3] > cfg.max_imu_gyro_diff):
        log.error("gyro biases differ: %s", diff[:3])
        return True
    if np.any(diff[3:] > cfg.max_imu_accel_diff):
        log.error("accel biases differ: %s", diff[3:])
        return True
    return False


class VicalibEngine:
    def __init__(self, config: VicalibConfig, update_stats_callback=None,
                 device=None):
        self.cfg = config
        self.device = resolve_device(device if device is not None
                                     else config.device)
        self.cfg.apply_static_preset()
        self.update_stats = update_stats_callback or (lambda s: None)
        self.target = make_grid(config)
        if config.paused:
            log.warning("-paused requests an interactive GUI pause; batch "
                        "replay has no capture loop to pause — ignored")
        if config.device_serial not in ("-1", ""):
            log.warning("-device_serial selects a live capture device; "
                        "replay sources are addressed by URI — ignored")
        if not config.exit_vicalib_on_finish:
            log.warning("-noexit_vicalib_on_finish keeps the reference's GUI "
                        "alive after solving; the batch engine always "
                        "returns when done")

    def _model_names(self, n_channels):
        cfg = self.cfg
        if cfg.model_files:
            cams = []
            for path in cfg.model_files.split(","):
                cams.extend(out_io.read_cameras_xml(path))
            return [c["model"] for c in cams], cams
        names = [m for m in cfg.models.split(",") if m]
        if len(names) < n_channels:
            log.info("Only %d models declared; assuming poly3 for the rest",
                     len(names))
            names += ["poly3"] * (n_channels - len(names))
        return names[:n_channels], None

    def _run_streaming(self, cfg, model_names, sel_times, pixels, visible,
                       imu, widths, heights, dtype, options,
                       time_offset_guess, stats, intr0, write_outputs=True):
        """-stream_chunk N: incremental calibration during (replayed)
        capture — the reference's background-solver live mode
        (vicalib-engine.cc:375-433).  Frames are fed in chunks of N with
        IMU interleaved by time, from the start ``intr0``; stats are
        published after every chunk."""
        from . import viz
        from .report import write_html_report
        from .streaming import StreamingCalibrator

        F = len(sel_times)

        def publish(chunk):
            with obs.span("vicalib.live.publish"):
                stats.status = CalibrationStatus.OPTIMIZING
                # same units as batch mode (cost / n_residuals, run_staged)
                # so stats consumers can compare modes
                stats.total_mse = chunk.cost / max(chunk.n_residuals, 1)
                stats.reprojection_error = [float(r) for r in chunk.cam_rmse]
                stats.num_iterations = chunk.iterations
                stats.ts = chunk.time_offset
                self.update_stats(stats.copy())
                log.info("stream chunk: %d/%d frames rmse %s iters %d "
                         "%.2fs", chunk.n_frames, F, chunk.cam_rmse,
                         chunk.iterations, chunk.wall_s)
                if cfg.report_file and write_outputs:
                    # rewrite the HTML report after every chunk so a browser
                    # pointed at it shows the run converging (the batch-side
                    # replacement for the reference's live Pangolin panels,
                    # vicalib-task.cc:154-225)
                    write_html_report(cfg.report_file, model_names,
                                      chunk.state, cal._last_data,
                                      cal.last_result, stats, widths,
                                      heights, target=self.target)
                if self._status_server is not None:
                    # live 3-D view (the Pangolin scene panel analog,
                    # vicalib-engine.cc:388-432): host copies of the filled
                    # frames' poses, rendered to SVG text for the server
                    # thread
                    st = chunk.state
                    self._status_server.publish_scene(viz.scene_svg(
                        None, self.target,
                        st.q_wk[:chunk.n_frames].cpu().numpy(),
                        st.t_wk[:chunk.n_frames].cpu().numpy()))

        cal = StreamingCalibrator(
            model_names, self.target.circles_3d(), widths=widths,
            heights=heights, dtype=dtype, calibrate_imu=cfg.calibrate_imu,
            optimize_time_offset=cfg.find_time_offset, options=options,
            gyro_sigma=cfg.gyro_sigma, accel_sigma=cfg.accel_sigma,
            stats_callback=publish, time_offset_guess=time_offset_guess,
            remove_outliers=cfg.remove_outliers,
            outlier_threshold=cfg.outlier_threshold, intr0=intr0,
            device=self.device)
        cursor = 0
        sel_times = np.asarray(sel_times)
        for lo in range(0, F, cfg.stream_chunk):
            hi = min(lo + cfg.stream_chunk, F)
            if imu is not None:
                # feed IMU samples up to the chunk's end plus window slack
                t_hi = sel_times[hi - 1] + cal.window_slack \
                    - time_offset_guess
                take = int(np.searchsorted(imu.times, t_hi))
                if take > cursor:
                    cal.add_imu(imu.times[cursor:take],
                                imu.gyro[cursor:take],
                                imu.accel[cursor:take])
                    cursor = take
            cal.add_frames(sel_times[lo:hi], pixels[:, lo:hi],
                           visible[:, lo:hi])
            cal.solve()
        result = cal.last_result
        data = cal._last_data
        if cfg.compute_covariance:
            from .solver.stages import shared_covariance
            result.covariance = shared_covariance(
                result.state, data, cal._last_flags, cfg.gyro_sigma,
                cfg.accel_sigma)
        # drop the capacity-padding frames (and their observations and
        # factors) so downstream outputs (poses.txt, the report) line up
        # with the F selected frames
        s = result.state
        result.state = s._replace(q_wk=s.q_wk[:F], t_wk=s.t_wk[:F],
                                  v_w=s.v_w[:F])
        n_obs = F * data.obs[0].points_per_frame
        kept = [dataclasses.replace(
            o, frame_idx=o.frame_idx[:n_obs], p_w=o.p_w[:n_obs],
            p_c=o.p_c[:n_obs], valid=o.valid[:n_obs]) for o in data.obs]
        imu = None if data.imu is None else dataclasses.replace(
            data.imu, **{k: getattr(data.imu, k)[:F - 1] for k in (
                "win_times", "win_gyro", "win_accel", "start", "end",
                "has_meas", "frame_i")})
        return result, dataclasses.replace(data, obs=kept, imu=imu,
                                           n_frames=F)

    def run(self) -> EngineResult:
        from .dist.multihost import is_primary

        self._status_server = None
        if self.cfg.status_port > 0 and is_primary():
            # live observability (vicalib-engine.cc:108, 388-432 polls
            # CalibrationStats for the GUI every 30 ms): serve the latest
            # stats + the (per-chunk rewritten) HTML report over HTTP
            from .status import StatusServer

            server = StatusServer(self.cfg.status_port,
                                  report_path=self.cfg.report_file
                                  or None).start()
            inner = self.update_stats

            def update_with_status(s):
                server.publish(s)
                inner(s)

            self.update_stats = update_with_status
            self._status_server = server
        try:
            return self._run()
        finally:
            if self._status_server is not None:
                self._status_server.stop()
                self.update_stats = inner

    def _run(self) -> EngineResult:
        """One calibration inside its own recording of spans and counters
        (obs.py); with -profile_dir, inside a torch.profiler Chrome trace
        from the read to the outputs."""
        cfg = self.cfg
        prof_ctx = contextlib.nullcontext()
        if cfg.profile_dir:
            # the counterpart of the JAX package's jax.profiler trace, with
            # device activity on a CUDA device; the port's spans show in it
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof_ctx = profile(activities=acts)
        with obs.recording() as rec, prof_ctx as prof:
            res = self._calibrate(rec)
        if prof is not None:
            os.makedirs(cfg.profile_dir, exist_ok=True)
            trace = os.path.join(cfg.profile_dir,
                                 "vicalib_trace_%d.json" % os.getpid())
            prof.export_chrome_trace(trace)
            log.info("wrote profiler trace %s", trace)
        return res

    def _calibrate(self, rec) -> EngineResult:
        from .dist.multihost import is_primary, world_size
        from .solver import StageFlags, run_staged
        from .solver.build import build_problem
        from .solver.lm import LMOptions

        cfg = self.cfg
        dev = self.device
        timings = {}
        if not cfg.cam:
            raise ValueError("No camera URI given")
        with obs.span("vicalib.engine.read") as sp:
            camera = sources.parse_camera_uri(cfg.cam)
            camera.frame_rate = cfg.frame_rate_hint
            imu = sources.parse_imu_uri(
                cfg.imu, use_system_time=cfg.use_system_time) \
                if cfg.imu else None
            if imu is None:
                cfg.calibrate_imu = False

            # ---- camera<->IMU clock handling (vicalib-task.cc:633-653).
            # With -use_system_time both streams carry host stamps and are
            # already synchronized (offset init 0).  With device time the
            # clocks are unrelated: initialize the offset by aligning the
            # first IMU sample with the first frame — the same assumption
            # the reference makes (both streams start when recording starts)
            # — and let the solver refine it.  Convention: imu_time + offset
            # = image time.
            time_offset_guess = 0.0
            if (imu is not None and cfg.calibrate_imu and cfg.find_time_offset
                    and not cfg.use_system_time and len(imu.times)
                    and camera.n_frames):
                time_offset_guess = (float(camera.channel_stamps(0)[0])
                                     - float(imu.times[0]))
                if abs(time_offset_guess) > 1e-6:
                    log.info("unsynchronized clocks: initial camera-IMU time "
                             "offset %.6f s from first IMU sample",
                             time_offset_guess)

            C = camera.num_channels
            model_names, preload = self._model_names(C)
            stats = CalibrationStats(C, status=CalibrationStatus.CAPTURING)
            # several processes: every one runs the engine, only the primary
            # writes files, so processes sharing a directory do not race
            write_outputs = is_primary()

            # ---- capture loop: static-motion gating + frame selection
            # (vicalib-engine.cc:497-555)
            accel_filter = BoxcarFilter(10, cfg.static_accel_threshold)
            gyro_filter = BoxcarFilter(10, cfg.static_gyro_threshold)
            # first IMU time expressed on the image clock (offset applied)
            first_imu_time = imu.times[0] + time_offset_guess \
                if imu is not None and len(imu.times) else -np.inf
            imu_cursor = 0

            # superframe association matches channels by nearest stamp to
            # channel 0, dropping frames any channel misses
            # (vicalib-task.cc:612-678)
            assoc_times, assoc_sel = sources.associate_channels(
                camera, system=cfg.use_system_time)
            if len(assoc_times) < camera.n_frames:
                log.info("async channels: %d/%d superframes associated",
                         len(assoc_times), camera.n_frames)
            sel_times, sel_indices = [], []
            skipped = 0
            for k in range(len(assoc_times)):
                t = float(assoc_times[k])
                if imu is not None and cfg.use_only_when_static:
                    while imu_cursor < len(imu.times) and \
                            imu.times[imu_cursor] + time_offset_guess <= t:
                        accel_filter.add(imu.accel[imu_cursor])
                        gyro_filter.add(imu.gyro[imu_cursor])
                        imu_cursor += 1
                    if not (accel_filter.is_stable()
                            and gyro_filter.is_stable()):
                        continue
                if skipped < cfg.frame_skip:
                    skipped += 1
                    continue
                skipped = 0
                # frames before the first IMU sample have no factor to join
                if imu is not None and t <= first_imu_time:
                    continue
                sel_times.append(t)
                sel_indices.append(k)
                if (cfg.num_vicalib_frames > 0
                        and len(sel_times) >= cfg.num_vicalib_frames):
                    break
            if len(sel_times) < 2:
                raise RuntimeError("not enough usable frames")
            log.info("selected %d/%d frames", len(sel_times), camera.n_frames)
            sel_images = [camera.read_batch(
                c, [int(assoc_sel[c][j]) for j in sel_indices])
                for c in range(C)]
            sel_indices = [int(assoc_sel[0][j]) for j in sel_indices]
        timings["read"] = sp.s

        # ---- detection (vicalib-task.cc:247-368)
        with obs.span("vicalib.engine.detect") as sp:
            F = len(sel_times)
            pixels, visible, conic_rows_all = [], [], []
            for c in range(C):
                pix, vis, rows = _detect_all(sel_images[c], self.target, cfg,
                                             dev)
                pixels.append(pix)
                visible.append(vis)
                conic_rows_all.extend(rows)
                stats.num_frames_processed[c] = int(np.sum(vis.any(axis=1)))
            pixels = np.stack(pixels)
            visible = np.stack(visible)
        timings["detect"] = sp.s
        if cfg.output_conics and write_outputs:
            out_io.write_conics_csv("conics.csv", conic_rows_all)
        if cfg.clip_good and write_outputs:
            good = visible.any(axis=2).all(axis=0)
            np.savez_compressed(
                "good_frames.npz",
                timestamps=np.asarray(sel_times)[good],
                frame_indices=np.asarray(sel_indices)[good],
                **{f"cam{c}": np.stack(sel_images[c])[good]
                   for c in range(C)})
            log.info("clip_good: wrote %d/%d frames to good_frames.npz",
                     int(good.sum()), F)

        # ---- problem assembly + staged solve
        stats.status = CalibrationStatus.OPTIMIZING
        self.update_stats(stats.copy())
        dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        intr0 = T_ck0 = None
        if preload is not None:
            intr0 = [c["params"] for c in preload]
            T_ck0 = []
            for c in preload:
                # the stored pose is T_wc; with an IMU the robotics-to-
                # vision RDF is baked in, so un-bake it
                q_wc = quat_np.from_matrix(np.asarray(c["T_wc"])[:3, :3])
                t_wc = np.asarray(c["T_wc"])[:3, 3]
                if cfg.calibrate_imu:
                    q_r = quat_np.from_matrix(np.linalg.inv(
                        out_io.RDF_ROBOTICS))
                    q_wc, t_wc = quat_np.se3_mul(
                        (q_wc, t_wc), quat_np.se3_inverse(
                            (q_r, np.zeros(3))))
                T_ck0.append(quat_np.se3_inverse((q_wc, t_wc)))
        heights = [img[0].shape[0] for img in sel_images]
        widths = [img[0].shape[1] for img in sel_images]

        kw = {}
        if imu is not None:
            # with unsynchronized device clocks the first-sample alignment
            # can still be off by the stream-start gap; the raw-stream
            # gyro/vision refinement pins it inside the window slack
            kw = dict(imu_times=imu.times, gyro=imu.gyro, accel=imu.accel,
                      time_offset_guess=time_offset_guess,
                      refine_time_offset=(not cfg.use_system_time
                                          and cfg.find_time_offset
                                          and cfg.calibrate_imu))
        with obs.span("vicalib.engine.build") as sp:
            if intr0 is None:
                # no preload: start from the target's homographies, in live
                # mode from the first chunk's frames alone
                from .solver.intr_start import start_intrinsics
                first = cfg.stream_chunk if cfg.stream_chunk > 0 else F
                intr0 = start_intrinsics(
                    model_names, pixels[:, :first], visible[:, :first],
                    self.target.circles_3d(), widths, heights)
            if cfg.stream_chunk > 0:
                # streaming does its own incremental problem builds; keep the
                # time-offset refinement: PnP poses from a visual-only build,
                # then raw-stream gyro/vision alignment, so streaming handles
                # clock skew beyond the first-sample guess as batch mode does
                for flag_set, name in ((cfg.n_shards > 1, "-n_shards"),
                                       (bool(cfg.checkpoint_file),
                                        "-checkpoint_file"),
                                       (bool(cfg.resume_file),
                                        "-resume_file")):
                    if flag_set:
                        log.warning("%s is not supported with -stream_chunk "
                                    "— ignored", name)
                data = state = None
                if kw.get("refine_time_offset"):
                    from .solver.build import refine_offset_guess
                    _, state_v = build_problem(
                        model_names, np.asarray(sel_times), pixels, visible,
                        self.target.circles_3d(), widths=widths,
                        heights=heights, dtype=dtype, device=dev, intr0=intr0,
                        T_ck0=T_ck0, use_ransac=True)
                    time_offset_guess = float(refine_offset_guess(
                        np.asarray(sel_times), state_v.q_wk.cpu().numpy(),
                        imu.times, imu.gyro, time_offset_guess))
                    log.info("refined camera-IMU time offset guess: %.6f s",
                             time_offset_guess)
            else:
                data, state = build_problem(
                    model_names, np.asarray(sel_times), pixels, visible,
                    self.target.circles_3d(), widths=widths, heights=heights,
                    dtype=dtype, device=dev, intr0=intr0, T_ck0=T_ck0,
                    use_ransac=True, **kw)
            _sync(dev)
        timings["build"] = sp.s

        flags = StageFlags(
            calibrate_imu=cfg.calibrate_imu,
            inertial_active=cfg.has_initial_guess and cfg.calibrate_imu,
            rotation_only=not cfg.has_initial_guess,
            bias_active=cfg.has_initial_guess,
            scale_active=cfg.has_initial_guess,
            optimize_time_offset=cfg.find_time_offset,
            fix_intrinsics=not cfg.calibrate_intrinsics)
        options = LMOptions(max_iters=cfg.max_iters,
                            function_tolerance=cfg.function_tolerance)
        mesh = None
        if (cfg.n_shards > 1 or world_size() > 1) and cfg.stream_chunk == 0:
            from .dist import make_mesh
            mesh = make_mesh(cfg.n_shards if cfg.n_shards > 1 else None,
                             device=dev.type)
        resume = False
        if cfg.resume_file and cfg.stream_chunk == 0:
            from .checkpoint import load_checkpoint
            state, saved_flags, meta = load_checkpoint(
                cfg.resume_file, dtype=dtype, device=dev)
            if saved_flags is not None:
                flags = saved_flags
            resume = True
            log.info("resuming from %s (stage %s)", cfg.resume_file,
                     meta.get("stage"))
        with obs.span("vicalib.engine.solve") as sp:
            if cfg.stream_chunk > 0:
                result, data = self._run_streaming(
                    cfg, model_names, sel_times, pixels, visible, imu,
                    widths, heights, dtype, options, time_offset_guess,
                    stats, intr0, write_outputs=write_outputs)
            else:
                result = run_staged(
                    state, data, flags, options,
                    do_remove_outliers=cfg.remove_outliers,
                    outlier_threshold=cfg.outlier_threshold,
                    gyro_sigma=cfg.gyro_sigma, accel_sigma=cfg.accel_sigma,
                    checkpoint_path=(cfg.checkpoint_file or None)
                    if write_outputs else None,
                    compute_cov=cfg.compute_covariance, mesh=mesh,
                    resume=resume)
            _sync(dev)
        timings["solve"] = sp.s
        if mesh is not None:
            calls = rec.n("vicalib.dist.collective")
            nbytes = rec.count("vicalib.dist.collective_bytes")
            secs = rec.seconds("vicalib.dist.collective")
            log.info("sharded solve: %s; %d collectives, %d bytes, %.3f s",
                     mesh.describe(), calls, nbytes, secs,
                     extra={"collectives": dict(
                         placement=mesh.describe(), calls=calls,
                         bytes=nbytes, seconds=secs,
                         iterations=result.total_iterations)})
        state = result.state
        q_ck = state.q_ck.cpu().numpy()
        p_ck = state.p_ck.cpu().numpy()
        intr = state.intr.cpu().numpy()
        biases = state.biases.cpu().numpy()

        # ---- stats + validation (vicalib-task.cc:831-856)
        stats.total_mse = result.mse
        stats.reprojection_error = [float(r) for r in result.cam_rmse]
        stats.num_iterations = result.total_iterations
        stats.ts = float(state.time_offset)
        stats.t_ck_vec = [(q_ck[c], p_ck[c]) for c in range(C)]
        stats.cam_intrinsics = [intr[c] for c in range(C)]
        success = all(r <= cfg.max_reprojection_error
                      for r in stats.reprojection_error)
        if success and cfg.has_initial_guess and preload is not None:
            for c in range(C):
                if camera_calibrations_differ(
                        cfg, model_names[c], intr0[c],
                        stats.cam_intrinsics[c], T_ck0[c],
                        stats.t_ck_vec[c]):
                    success = False
            if imu is not None and imu_calibration_differs(
                    cfg, np.zeros(6), biases):
                success = False
        stats.status = (CalibrationStatus.SUCCESS if success
                        else CalibrationStatus.FAILURE)
        self.update_stats(stats.copy())

        # ---- result log (PrintResults analog, -output_log_file)
        if cfg.output_log_file and write_outputs:
            with open(cfg.output_log_file, "w") as f:
                f.write("-" * 42 + "\n")
                for c in range(C):
                    f.write(f"Camera: {c} ({model_names[c]})\n")
                    f.write("params: %s\n" % np.array2string(
                        stats.cam_intrinsics[c], precision=9))
                    T = np.eye(4)
                    T[:3, :3] = quat_np.to_matrix(stats.t_ck_vec[c][0])
                    T[:3, 3] = stats.t_ck_vec[c][1]
                    f.write("T_ck:\n%s\n" % np.array2string(T, precision=9))
                    f.write(f"rmse: {stats.reprojection_error[c]:.6f} px\n")
                f.write("bw_ba= %s\n" % biases)
                f.write("sfw_sfa= %s\n" % state.scales.cpu().numpy())
                f.write("G= %s\n" % state.g_dir.cpu().numpy())
                f.write("ts= %s\n" % stats.ts)
                f.write("mse= %s  iterations= %d\n" %
                        (stats.total_mse, stats.num_iterations))
                for row in result.stages_run:
                    f.write("stage %s: iters=%d cost=%.6e wall=%.2fs\n" %
                            tuple(row))
                for row in rec.rows():
                    f.write(row + "\n")
                if result.covariance is not None:
                    # named per-block marginals, like the reference's
                    # covariance log (vicalibrator.h:802-857: block name +
                    # covariance + std-dev per block)
                    f.write("shared-parameter covariance blocks:\n")
                    for name, start, size in data.layout.block_names():
                        blk = result.covariance[start:start + size,
                                                start:start + size]
                        sd = np.sqrt(np.maximum(np.diag(blk), 0.0))
                        f.write("%s: sigma= %s\ncov=\n%s\n" % (
                            name, np.array2string(sd, precision=6),
                            np.array2string(blk, precision=4)))
                    f.write("full shared-parameter covariance:\n%s\n" %
                            np.array2string(result.covariance, precision=4))

        # ---- outputs (vicalib-engine.cc:355-373, 406-422)
        if write_outputs:
            out_io.write_cameras_xml(
                cfg.output, model_names, stats.cam_intrinsics,
                stats.t_ck_vec, widths, heights,
                calibrate_imu=cfg.calibrate_imu)
            q_wk = state.q_wk.cpu().numpy()
            t_wk = state.t_wk.cpu().numpy()
            if cfg.print_poses:
                good = visible.any(axis=(0, 2))
                out_io.write_poses_txt("poses.txt", q_wk, t_wk, good=good)
            if cfg.save_poses:
                out_io.write_poses_csv("poses.csv", q_wk, t_wk)
        if cfg.report_file and write_outputs:
            from .report import write_html_report
            write_html_report(cfg.report_file, model_names, state, data,
                              result, stats, widths, heights,
                              target=self.target)
            log.info("wrote calibration report to %s", cfg.report_file)

        log.info("phase seconds: %s", " ".join(
            "%s=%.3f" % kv for kv in timings.items()),
            extra={"timings": dict(timings)})
        return EngineResult(success=success, stats=stats, state=state,
                            result=result, model_names=model_names,
                            timings=timings)
