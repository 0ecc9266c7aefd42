"""Typed configuration mirroring the reference's gflags inventory.

Every field corresponds to a DEFINE_* in the reference (vicalib-engine.cc:30-104
and vicalib-task.cc:16-51); names and defaults match so command lines port
directly (the CLI also accepts gflags-style ``-flag``/``-noflag``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class VicalibConfig:
    # --- sensors / input (vicalib-engine.cc:79-87)
    cam: str = ""
    imu: str = ""
    models: str = ""
    model_files: str = ""
    device_serial: str = "-1"

    # --- grid (vicalib-engine.cc:44-55, 88-93)
    grid_height: int = 10
    grid_width: int = 19
    grid_spacing: float = 0.01355
    grid_seed: int = 71
    grid_preset: str = ""
    grid_file: str = ""              # load a printed target's 0/1 bitmap
    grid_large_rad: float = 0.00423
    grid_small_rad: float = 0.00283
    output_pattern_file: str = ""

    # --- capture control (vicalib-engine.cc:43, 58, 67-78)
    paused: bool = False                  # vicalib-engine.cc (GUI pause)
    scaled_ir_depth_cal: bool = False     # declared in reference, unused
    frame_skip: int = 0
    num_vicalib_frames: int = -1
    static_accel_threshold: float = 0.08
    static_gyro_threshold: float = 0.04
    static_threshold_preset: int = 0
    use_only_when_static: bool = False
    use_static_threshold_preset: bool = False
    use_system_time: bool = True          # vicalib-task.cc:50-51

    # --- detection tuning (the reference exposes these as live CVars,
    # vicalib-task.cc:114-123, 208-213; Calibu defaults)
    black_on_white: bool = True
    at_threshold: float = 0.9
    at_window_ratio: float = 30.0
    conic_min_area: float = 4.0
    conic_min_density: float = 0.6
    conic_min_aspect: float = 0.2
    # sub-pixel center refinement (detect/conics.refine_centers; no
    # reference analog — Calibu's ConicFinder refines differently); 0
    # disables and falls back to the component-moments centroid
    conic_refine_iters: int = 3
    conic_refine_power: float = 2.0

    # --- optimization (vicalib-engine.cc:35-42, 94-104; vicalib-task.cc:21-24)
    calibrate_imu: bool = True
    calibrate_intrinsics: bool = True
    has_initial_guess: bool = False
    find_time_offset: bool = True
    function_tolerance: float = 1e-6
    max_iters: int = 200
    gyro_sigma: float = 5.3088444e-5
    accel_sigma: float = 0.001883649
    remove_outliers: bool = False
    outlier_threshold: float = 2.0

    # --- outputs (vicalib-engine.cc:40, 51, 56-64)
    clip_good: bool = False               # vicalib-task.cc:19, 283-296
    save_poses: bool = False
    print_poses: bool = False
    output: str = "cameras.xml"
    output_log_file: str = "vicalibrator.log"
    output_conics: bool = False
    # post-run HTML diagnostic report (new capability: the batch-pipeline
    # replacement for the reference's live Pangolin views — see report.py)
    report_file: str = ""
    exit_vicalib_on_finish: bool = True
    max_reprojection_error: float = 0.15

    # --- success validation thresholds (vicalib-task.cc:26-48)
    max_fx_diff: float = 10.0
    max_fy_diff: float = 10.0
    max_cx_diff: float = 10.0
    max_cy_diff: float = 10.0
    max_fov_w_diff: float = 0.3
    max_poly3_diff_k1: float = 0.1
    max_poly3_diff_k2: float = 0.1
    max_poly3_diff_k3: float = 0.1
    max_camera_trans_diff: float = 0.1
    max_camera_angle_diff: float = 0.1
    max_imu_gyro_diff: float = 0.1
    max_imu_accel_diff: float = 0.1

    # --- framework-native knobs (no reference analog)
    dtype: str = "float64"          # solver precision
    # the explicit device the engine runs on; asking for "cuda" without a
    # CUDA device raises.  Not a command-line flag.
    device: str = "cuda"
    n_shards: int = 0               # 0 = single device
    # multi-host runtime (dist/multihost.py): set all three on every
    # process; n_shards then defaults to the number of processes
    coordinator_address: str = ""   # "host0:port" of process 0
    num_processes: int = 0
    process_id: int = -1
    frame_rate_hint: float = 10.0   # for sources without timestamps
    compute_covariance: bool = False  # reference: COMPUTE_VICALIB_COVARIANCE
    stream_chunk: int = 0           # >0: incremental solve every N frames
    status_port: int = 0            # >0: serve live stats/report over HTTP
    #                                 (the headless analog of the live GUI;
    #                                 0 picks off; see status.py)
                                    # (the reference's background-solver
                                    # live mode, vicalib-engine.cc:375-433)
    checkpoint_file: str = ""       # native mid-solve checkpoint (npz)
    resume_file: str = ""           # resume staged solve from a checkpoint
    profile_dir: str = ""           # profiler trace of the solve

    def apply_static_preset(self):
        """-use_static_threshold_preset (vicalib-engine.cc:276-291)."""
        if not self.use_static_threshold_preset:
            return
        if self.static_threshold_preset == 0:      # manual
            self.static_accel_threshold = 0.09
            self.static_gyro_threshold = 0.05
        elif self.static_threshold_preset == 1:    # strict
            self.static_accel_threshold = 0.05
            self.static_gyro_threshold = 0.025
        else:
            raise ValueError(
                f"Unknown static threshold preset "
                f"{self.static_threshold_preset}")
