"""Drive the PyTorch/CUDA port on one CUDA card and check it.

  python3 chip_smoke.py              # all phases (needs one CUDA card)
  python3 chip_smoke.py --profile    # also trace the main path with
                                     # torch.profiler (device time by kernel)
  python3 chip_smoke.py --kernels-only   # phases 1-3: build and check
                                         # the kernels

Phases, in order; any failure exits non-zero:
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build every CUDA kernel of the main path with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (a 32-frame batch of padded 800x600
     stereo frames) plus edge cases (synthetic frames, inverted and noise
     frames, other sweep bounds, one frame): labels must agree bit for bit;
     times from CUDA events (median of 12 after warm-up), device launches
     per call from torch.profiler.  Then the IMU factor kernel
     (``imu_factor``) at the VI cells' shapes (the vi_sim rig: 191 factors
     at 10 Hz / 100 Hz; the EuRoC rig: 399 factors at 20 Hz / 200 Hz;
     windows of the engine's 0.35 s slack), in float64 and float32: the
     residual and Jacobian (C = 1) and the value of 3 candidates (C = 3),
     rotation-only on and off, and a zero time offset with the stamps on
     the frame grid and some factors without measurements; held to its
     plain twin (``imu_factor_plain``), in float64 within 1e-10 of the
     largest entry; in float32 the kernel's distance from the float64
     twin on the same inputs within 10 times the float32 twin's and
     within 1e-3 of the largest entry; its time beside its bound and the
     twin's;
  4. the visual path at full width: 192 stereo 800x600 frames rendered by
     the port's simulator, written as PGM files and calibrated through
     ``vicalib_tpu_torch.cli.main`` (the linear model, camera-only); the
     cameras.xml it writes is held to the simulator's ground truth and the
     kernel's launch count must have risen during this phase;
  5. the visual-inertial path at full width: the JAX package's VI workload
     (bench.py:626-713, 482-623) — 192 stereo 800x600 frames with the RDF
     camera-IMU rotation, a 100 Hz IMU with gyro and accel biases and a
     4 ms time offset — written as PGM files plus accel.txt / gyro.txt /
     timestamp.txt and calibrated through ``cli.main`` with ``-imu``: the
     whole staged schedule (visual, inertial-rotation, inertial-full,
     inertial-full+scale).  Gates: every camera's T_ck within 1e-3
     (|se3.log(T_est T_true^-1)|, read from the log file), rmse < 0.12 px,
     intrinsics within 0.5 px, |ts - 0.004| < 2e-3 s, and the kernel
     launched during the phase, every IMU factor through the IMU factor
     kernel.  Prints the stage table (iterations, cost,
     wall time), the biases and the phase seconds; with ``--profile`` also
     the device's busy share and top kernels of the VI run.  Then the LM
     loop's CUDA graphs against its eager loop on the same problem: the
     engine in this process as it runs (the step and the IMU weight
     refresh replayed as CUDA graphs, under
     ``torch.cuda.set_sync_debug_mode("error")`` while a graph body runs
     or is captured), its staged solve recorded and solved again from the
     same problem and start with ``solver.lm._graph_path`` answering False
     (every body eager).  Prints the captures, the replays, the LM seconds
     and the largest differences; fails unless every stage takes the same
     iterations, the intrinsics agree within 1e-6 px and T_ck, the biases
     and the time offset within 1e-9;
  6. the live (streaming) path on phase 5's files: ``cli.main`` with
     ``-stream_chunk 32 -report_file ... -compute_covariance`` — six chunks
     at capacities 32, 64, 128, 128, 256, 256, each a warm-started re-solve.
     Phase 5's gates, plus: the report exists and parses as HTML, and the
     kernel launched.  Prints the chunk table (frames, capacity, LM
     iterations, cost, wall seconds); with ``--profile`` the run also
     passes ``-profile_dir`` and the device's busy share of the run is
     read from the Chrome trace the engine writes.  Then the graphed
     against the eager LM loop as in phase 5, on every chunk's staged
     solve of a stream: the same iterations in every stage and phase 5's
     tolerances on every chunk's answer;
  7. checkpoint and resume on phase 5's files: ``cli.main`` with
     ``-checkpoint_file``, then again with ``-resume_file``.  Both pass
     phase 5's gates; the resumed run must start at the saved stage, and the
     two cameras.xml files must agree within a tenth of the gates;
  8. the tracker on camera 0's 192 frames (``tracker.main`` with the
     stream phase's cameras.xml as ``-model_files``): at least 95 % of the
     frames tracked, every T_gw within 1e-3 rad and 1 mm of the simulator's
     true camera pose, and one kernel launch per frame;
  9. the sharded solve on phase 5's files, holding each run to phase 5's
     gates and to phase 5's answer with the JAX package's tolerances for
     a sharded against a single-device solve (tests/test_dist.py:97-105:
     rmse rtol 2e-3, q_ck 1e-5, biases 1e-4, time offset 1e-5):
     (a) ``cli.main(<phase-5 argv> -n_shards 2)`` in this process, both
         shards on cuda:0 — prints the stage table, seconds per LM
         iteration and the shard placement;
     (b) the same argv in two processes, ``python -m
         vicalib_tpu_torch.cli ... -coordinator_address 127.0.0.1:<port>
         -num_processes 2 -process_id {0,1}`` (run through runpy, which
         prints the process's kernel launch counts at exit), both on the
         one card and writing to one directory: both exit 0, exactly one
         cameras.xml, written by rank 0, both ranks log the same
         iterations per stage; prints the backend, each rank's wall time,
         the bytes all-reduced per LM iteration and the seconds spent in
         collectives; a failed or late process kills both;
     (c) ``rectify:[file=<phase 4's cameras.xml>]//file://[...]``: phase
         4's images undistorted through phase 4's linear calibration (an
         identity remap up to bilinear rounding) and calibrated
         camera-only: phase 4's gates;
 10. the ``kernels`` JSON line (launches per path), the nvidia-smi line
     and, last, the result.

Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES = 192                 # per camera, as the JAX bench (bench.py:36)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# H100 SXM non-tensor 32-bit rate for single (non-FMA) operations such as
# mins, compares and adds: the published 67 TFLOP/s fp32 peak counts an FMA
# as two operations
NON_FMA_OPS_PER_S = 33.5e12
# the JAX package's VI workload (bench.py:639-643, 155)
VI_GYRO_BIAS = np.array([0.01, -0.02, 0.015])
VI_ACCEL_BIAS = np.array([0.05, 0.02, -0.04])
VI_TIME_OFFSET = 0.004
# a sharded against a single-device solve (tests/test_dist.py:97-105)
SHARD_TOL = {"rmse_rtol": 2e-3, "q_ck": 1e-5, "biases": 1e-4, "ts": 1e-5}
# the LM loop replayed as CUDA graphs against its eager loop: intrinsics
# (px), T_ck (quaternion and translation entries), biases, time offset (s)
GRAPH_TOL = {"intr_px": 1e-6, "T_ck": 1e-9, "biases": 1e-9, "ts": 1e-9}
# the two-process phase: seconds before both processes are killed
TWO_PROCESS_TIMEOUT_S = 400
# H100 SXM float64 outside the tensor cores, an FMA counted as two
FP64_FLOPS_PER_S = 34e12
# the IMU factor kernel in float64 against its plain twin and the
# torch.func path: largest difference over the largest entry
IMU_TOL = 1e-10
# in float32, against the twin in float64 on the same inputs: at most this
# many times the float32 twin's own error, and never above the ceiling
IMU_F32_FACTOR = 10.0
IMU_F32_CEIL = 1e-3
REPLACES = {"threshold_and_label": "vicalib_tpu/detect/pallas_kernels.py:194",
            "imu_factor": "none: the JAX package leaves the IMU factor to "
                          "XLA; added for the ~4,400 autodiff ops an LM step "
                          "that it replaces"}
SOURCES = {"threshold_and_label": "vicalib_tpu_torch/csrc/threshold_label.cu",
           "imu_factor": "vicalib_tpu_torch/csrc/imu_factor.cu"}


def fail(msg):
    print("FAIL: " + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail("nvidia-smi failed: %s" % res.stderr)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps=12, warmup=2):
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_time_ms(fn, reps=12):
    """Median host milliseconds to enqueue fn() (the device drained before
    each call)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def stereo_config(sim, n_frames):
    """The bench geometry (800x600, target at 0.35 m, orbit 0.12 m) as a
    visual-only stereo rig: cam 0 at the rig origin, cam 1 at -0.12 m y."""
    cfg = sim.default_stereo_vi_config(n_frames=n_frames, model="linear",
                                       distance=0.35, orbit_radius=0.12)
    cfg.cameras[0].T_ck = (np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))
    cfg.cameras[1].T_ck = (np.array([0.0, 0.0, 0.0, 1.0]),
                           np.array([0.0, -0.12, 0.0]))
    return cfg


def vi_config(sim, n_frames):
    """The JAX package's VI workload: the bench geometry with the stereo
    VI rig as the simulator defines it (both cameras at the RDF rotation
    from the IMU, cam 1 at -0.12 m y), 100 Hz IMU, biases, 4 ms offset."""
    return sim.default_stereo_vi_config(
        n_frames=n_frames, model="linear", distance=0.35, orbit_radius=0.12,
        imu_rate=100.0, gyro_bias=VI_GYRO_BIAS, accel_bias=VI_ACCEL_BIAS,
        time_offset=VI_TIME_OFFSET)


def write_rig(sim, sources, data, root, dev, imu=False):
    """Render every camera into <root>/cam<c>/f*.pgm with a timestamps.txt
    per directory and, with ``imu``, the IMU stream into <root>/imu.
    Returns the camera directories."""
    dirs = []
    for c in range(len(data.config.cameras)):
        d = os.path.join(root, "cam%d" % c)
        os.makedirs(d)
        for k, img in enumerate(sim.render_frames(data, cam=c, device=dev)):
            sources.write_pgm(os.path.join(d, "f%05d.pgm" % k), img)
        np.savetxt(os.path.join(d, "timestamps.txt"), data.frame_times)
        dirs.append(d)
    if imu:
        d = os.path.join(root, "imu")
        os.makedirs(d)
        np.savetxt(os.path.join(d, "accel.txt"), data.accel)
        np.savetxt(os.path.join(d, "gyro.txt"), data.gyro)
        np.savetxt(os.path.join(d, "timestamp.txt"), data.imu_times)
    return dirs


def parse_log(path):
    """The result log of ``-output_log_file``: per camera T_ck (4x4) and
    rmse, then bw_ba, ts and the stage rows."""
    with open(path) as f:
        text = f.read()
    nums = lambda s: np.array([float(x) for x in
                               re.findall(r"[-+0-9.eE]+", s)])
    out = {"T_ck": [nums(b).reshape(4, 4) for b in re.findall(
        r"T_ck:\n(\[\[.*?\]\])", text, re.S)],
        "rmse": [float(x) for x in re.findall(r"rmse: ([0-9.eE+-]+) px",
                                              text)],
        "stages": re.findall(
            r"stage (\S+): iters=(\d+) cost=(\S+) wall=([0-9.]+)s", text)}
    m = re.search(r"bw_ba= (\[.*?\])", text, re.S)
    out["bw_ba"] = nums(m.group(1)) if m else None
    m = re.search(r"ts= (\S+)", text)
    out["ts"] = float(m.group(1)) if m else None
    return out


def edge_frames():
    """Synthetic frames, each (1, H, W), with the radius to threshold them:
    a serpentine that needs more sweeps than the bound, >512 dots, 8-bit
    noise (a dense mask), a diagonal band across many tile borders, and
    blobs touching all four frame edges and corners."""
    serp = np.full((1, 64, 256), 255, np.float32)
    for r in range(4, 60, 3):
        serp[0, r, 4:250] = 0
    for i, r in enumerate(range(4, 57, 3)):
        serp[0, r:r + 4, 249 if i % 2 == 0 else 4] = 0
    dots = np.full((1, 128, 256), 255, np.float32)
    for y in range(2, 126, 4):
        for x in range(2, 254, 4):
            dots[0, y:y + 2, x:x + 2] = 0
    noise = np.random.default_rng(0).integers(
        0, 256, size=(1, 600, 896)).astype(np.float32)
    diag = np.full((1, 600, 896), 255, np.float32)
    for y in range(600):
        diag[0, y, y + 100:y + 103] = 0
    edges = np.full((1, 600, 896), 255, np.float32)
    for x in range(0, 896, 50):
        edges[0, :5, x:x + 5] = 0
        edges[0, -5:, x:x + 5] = 0
    for y in range(0, 600, 50):
        edges[0, y:y + 5, :5] = 0
        edges[0, y:y + 5, -5:] = 0
    edges[0, -5:, -5:] = 0
    return [("serpentine", serp, 4), (">512 dots", dots, 4),
            ("noise", noise, 13), ("diagonal", diag, 13),
            ("edges", edges, 13)]


def device_launches(fn):
    """Device kernels and memsets of one call of fn, from torch.profiler,
    with their device time by name; None where the profiler records no
    device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    n = 0
    for e in prof.key_averages():
        if e.device_type == cuda:
            n += e.count
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            log("  device %9.4f ms %3d x  %s" % (t / 1e3, e.count,
                                                 e.key[:80]))
    return n or None


def active_tile_share(mask, tile):
    """Share of the kernel's tiles whose pixels hold any mask."""
    ty, tx = tile
    B, H, W = mask.shape
    m = torch.nn.functional.pad(mask, (0, -W % tx, 0, -H % ty))
    m = m.reshape(B, m.shape[1] // ty, ty, W // tx, tx)
    return float(m.any(dim=4).any(dim=2).float().mean())


def kernel_phase(dev):
    from vicalib_tpu_torch.detect import kernels
    from vicalib_tpu_torch.detect.conics import MAX_BATCH, _pad_to_tiles
    from vicalib_tpu_torch.io import sim

    cfg = stereo_config(sim, MAX_BATCH // 2)
    t0 = time.time()
    data = sim.simulate(cfg, device=dev)
    frames = np.concatenate([sim.render_frames(data, cam=c, device=dev)
                             for c in range(2)])
    log("rendered %s frames in %.2f s" % (frames.shape, time.time() - t0))
    imgs = torch.from_numpy(frames).to(dev).to(torch.float32)
    padded, H0, W0 = _pad_to_tiles(imgs)
    padded = padded.contiguous()
    radius = max(int(W0 / 30.0 / 2), 1)
    kw = dict(at_threshold=0.9, black_on_white=True, n_iters=64,
              max_labels=512)

    mask_k, lab_k = kernels.threshold_and_label(padded, radius, **kw)
    torch.cuda.synchronize()
    mask_p, lab_p, sweeps = kernels.threshold_and_label_ref(
        padded, radius, return_sweeps=True, **kw)
    mism = int((lab_k != lab_p).sum()) + int((mask_k != mask_p).sum())
    err = int((lab_k.to(torch.int64) - lab_p.to(torch.int64)).abs().max())
    log("threshold_and_label %s: %d mismatching labels or mask px, %d "
        "labelled px, sweeps per frame (label, compact) max %s"
        % (tuple(padded.shape), mism, int((lab_p > 0).sum()),
           sweeps.max(dim=0).values.tolist()))
    if mism:
        fail("kernel labels differ from the plain version")
    cases = [(name, torch.from_numpy(fr).to(dev), r, kw)
             for name, fr, r in edge_frames()]
    cases += [("inverted batch", (255 - padded).contiguous(), radius,
               dict(kw, black_on_white=False)),
              ("n_iters=5", padded, radius, dict(kw, n_iters=5)),
              ("n_iters=0", padded, radius, dict(kw, n_iters=0)),
              ("B=1", padded[:1].contiguous(), radius, kw)]
    for name, t, r, kw_c in cases:
        ma, a = kernels.threshold_and_label(t, r, **kw_c)
        mb, b, sw = kernels.threshold_and_label_ref(t, r, return_sweeps=True,
                                                    **kw_c)
        torch.cuda.synchronize()
        n = int((a != b).sum()) + int((ma != mb).sum())
        log("edge case %s %s: %d mismatching labels or mask px, %d "
            "labelled px, max "
            "label %d, max sweeps %s" % (name, tuple(t.shape), n,
                                    int((b > 0).sum()), int(b.max()),
                                    sw.max(dim=0).values.tolist()))
        if n:
            fail("kernel differs from the plain version on " + name)
        mism += n

    call = lambda: kernels.threshold_and_label(padded, radius, **kw)
    ms = time_ms(call)
    host_ms = host_time_ms(call)
    plain_ms = time_ms(
        lambda: kernels.threshold_and_label_ref(padded, radius, **kw))
    n_dev = device_launches(call)
    mask = lab_p > 0
    tiles = active_tile_share(mask, kernels.tile_config()[:2])
    B, H, W = padded.shape
    npx = B * H * W
    bytes_moved = npx * (4 + 4)            # f32 frames in, int32 labels out
    # per pixel: box sums as an integral image (4 adds), mean and threshold
    # (3), rank scan (2); per masked pixel 9 (8 mins + compare) for each
    # sweep its frame executes
    masked = mask.flatten(1).sum(dim=1).cpu()
    ops = npx * (4 + 3 + 2) + int((sweeps.sum(dim=1).cpu() * masked).sum()) * 9
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / NON_FMA_OPS_PER_S * 1e3
    row = {"name": "threshold_and_label", "route": "cuda",
           "source": SOURCES["threshold_and_label"],
           "replaces": REPLACES["threshold_and_label"],
           "launches": None, "max_abs_err": float(err), "mismatches": mism,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
           "library_ms": None, "shape": [B, H, W],
           "sweeps": int(sweeps.sum()), "masked_px": int(masked.sum()),
           "host_ms": host_ms, "device_launches_per_call": n_dev,
           "active_tile_share": tiles,
           "tile_config": list(kernels.tile_config())}
    log("kernel %.4f ms (host enqueue %.4f ms), plain %.4f ms, bound %.4f "
        "ms (%s); %s device launches per call; %.4f of tiles active"
        % (ms, host_ms, plain_ms, row["bound_ms"], row["bound_by"], n_dev,
           tiles))
    return [row]


def imu_problem(dev, n_frames, frame_rate, imu_rate):
    """The IMU factors of the simulator's stereo VI rig at the given rates
    as the engine builds them (windows of 0.35 s slack), and a state near
    the truth: (ImuFactors, CalibState)."""
    from vicalib_tpu_torch.imu.buffer import build_windows, gather_windows
    from vicalib_tpu_torch.io import sim
    from vicalib_tpu_torch.solver.problem import CalibState
    from vicalib_tpu_torch.solver.residuals import ImuFactors

    cfg = sim.default_stereo_vi_config(
        n_frames=n_frames, model="linear", distance=0.35, orbit_radius=0.12,
        frame_rate=frame_rate, imu_rate=imu_rate, gyro_bias=VI_GYRO_BIAS,
        accel_bias=VI_ACCEL_BIAS, time_offset=VI_TIME_OFFSET)
    data = sim.simulate(cfg, device=dev)
    win = build_windows(data.imu_times, data.frame_times, slack=0.35)
    wt, wg, wa = gather_windows(data.imu_times, data.gyro, data.accel,
                                win["idx0"], win["n_slots"])

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=dev)

    F = len(data.frame_times)
    imu = ImuFactors(win_times=T(wt), win_gyro=T(wg), win_accel=T(wa),
                     start=T(win["start"]), end=T(win["end"]),
                     has_meas=torch.as_tensor(win["has_meas"], device=dev),
                     frame_i=torch.arange(F - 1, device=dev),
                     consecutive=True, slack=0.35)
    rng = np.random.default_rng(5)
    q_wk, t_wk = data.T_wk
    z = torch.zeros((1, 4), dtype=torch.float64, device=dev)
    state = CalibState(
        q_wk=T(q_wk), t_wk=T(t_wk + 1e-3 * rng.standard_normal(t_wk.shape)),
        v_w=T(data.v_w + 1e-3 * rng.standard_normal(data.v_w.shape)),
        q_ck=z, p_ck=z[:, :3], intr=z, g_dir=T(cfg.g_dir),
        biases=T(np.concatenate([VI_GYRO_BIAS, VI_ACCEL_BIAS])
                 + 1e-3 * rng.standard_normal(6)),
        scales=T(1.0 + 1e-3 * rng.standard_normal(6)),
        time_offset=T(0.0031))
    return imu, state


def _on_grid(imu, state):
    """Zero time offset with the stamps on the frame grid (ties at the
    clip bounds), every seventh factor without measurements."""
    wt = torch.round((imu.win_times + VI_TIME_OFFSET) * 1000.0) / 1000.0
    has = imu.has_meas.clone()
    has[::7] = False
    ties = int((wt == imu.start[:, None]).sum()
               + (wt == imu.end[:, None]).sum())
    return (dataclasses.replace(imu, win_times=wt, has_meas=has),
            state._replace(time_offset=torch.zeros_like(state.time_offset)),
            ties)


def _f32_pairs(xs, imu, W, ro, C, r, J, rt, Jt):
    """The float32 kernel's and twin's results against the twin in
    float64 on the same (float32) inputs."""
    from vicalib_tpu_torch.imu import factor

    up = (lambda x: x.double() if x.is_floating_point() else x)
    r64, J64 = factor.imu_factor_plain(
        tuple(up(x).contiguous() for x in xs), *[up(getattr(imu, f)) for f in (
            "win_times", "win_gyro", "win_accel", "start", "end",
            "has_meas", "frame_i")], up(W), ro, C == 1)
    pairs = [("kernel r", r.double(), r64), ("twin r", rt.double(), r64)]
    if C == 1:
        pairs += [("kernel J", J.double(), J64), ("twin J", Jt.double(), J64)]
    return pairs


def _kernel_state(state, candidates):
    """``imu_factor``'s state tuple: a leading candidate dimension (added
    unless ``candidates``), contiguous."""
    xs = (state.q_wk, state.t_wk, state.v_w, state.g_dir, state.biases,
          state.scales, state.time_offset)
    return tuple((x if candidates else x[None]).contiguous() for x in xs)


def _candidates(state):
    """Three candidate states stacked as the LM step's trial state: the
    state and two with moved frames, biases and time offset."""
    outs = [state._replace(t_wk=state.t_wk + d, v_w=state.v_w - d,
                           biases=state.biases + d,
                           time_offset=state.time_offset + 0.1 * d)
            for d in (0.0, 1e-4, -2e-4)]
    return type(state)(*[torch.stack(xs) for xs in zip(*outs)])


def _twin_ops(fn):
    """Float arithmetic element-operations of one call of ``fn`` (each
    output element of an arithmetic op counts one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    names = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "sin", "cos",
             "atan2", "maximum", "minimum", "clamp", "sum", "cumsum"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func._schema.name.split("::")[-1] in names and isinstance(
                    out, torch.Tensor) and out.is_floating_point():
                Count.n += out.numel()
            return out

    with Count():
        fn()
    return Count.n


def imu_kernel_phase(dev):
    """Phase 3, the IMU factor kernel: see the module docstring."""
    from vicalib_tpu_torch import obs
    from vicalib_tpu_torch.imu import factor

    shapes = {"vi_sim": (192, 10.0, 100.0), "euroc": (400, 20.0, 200.0)}
    out = {}
    worst = 0.0
    for name, (F, fr, ir) in shapes.items():
        imu64, st64 = imu_problem(dev, F, fr, ir)
        K, M = imu64.win_times.shape
        gen = torch.Generator(device=dev).manual_seed(11)
        W64 = (30.0 * torch.eye(9, dtype=torch.float64, device=dev)
               + torch.randn(K, 9, 9, generator=gen, dtype=torch.float64,
                             device=dev))
        grid64, gst64, ties = _on_grid(imu64, st64)
        log("IMU factor kernel, %s shapes: K=%d factors of M=%d slots, %d "
            "stamps on a clip bound in the grid case" % (name, K, M, ties))
        for dtype in (torch.float64, torch.float32):
            cast = (lambda x: x.to(dtype) if x.is_floating_point() else x)
            W = W64.to(dtype)
            for case, imu0, st0 in (("offset", imu64, st64),
                                    ("grid", grid64, gst64)):
                imu = dataclasses.replace(imu0, **{
                    f: cast(getattr(imu0, f)) for f in (
                        "win_times", "win_gyro", "win_accel", "start",
                        "end")})
                st = type(st0)(*[cast(x) for x in st0])
                trial = _candidates(st)
                for ro, C in ((False, 1), (True, 1), (False, 3), (True, 3)):
                    xs = _kernel_state(trial if C == 3 else st, C == 3)
                    args = (xs, imu.win_times, imu.win_gyro, imu.win_accel,
                            imu.start, imu.end, imu.has_meas, imu.frame_i,
                            W, ro, C == 1)
                    r, J = factor.imu_factor(*args)
                    rt, Jt = factor.imu_factor_plain(*args)
                    pairs = [("twin r", r, rt)]
                    if C == 1:
                        pairs.append(("twin J", J, Jt))
                    if dtype == torch.float32:
                        pairs = _f32_pairs(xs, imu, W, ro, C, r, J, rt, Jt)
                    torch.cuda.synchronize()
                    errs = {}
                    for label, a, b in pairs:
                        errs[label] = float((a - b).abs().max()
                                            / b.abs().max().clamp(min=1e-300))
                    if dtype == torch.float64:
                        bad = {k: e for k, e in errs.items()
                               if not e <= IMU_TOL}
                        worst = max([worst] + list(errs.values()))
                    else:
                        bad = {k: e for k, e in errs.items() if k.startswith(
                            "kernel") and not e <= min(
                                IMU_F32_FACTOR * errs[k.replace("kernel",
                                                                "twin")],
                                IMU_F32_CEIL)}
                    if bad:
                        fail("IMU factor kernel, %s %s %s C=%d "
                             "rotation_only=%s: %s (float64: above %g; "
                             "float32: above %g times the twin's or %g)"
                             % (name, str(dtype), case, C, ro, bad, IMU_TOL,
                                IMU_F32_FACTOR, IMU_F32_CEIL))
                    log("  %s %-7s %-6s C=%d rotation_only=%-5s %s"
                        % (name, str(dtype)[6:], case, C, ro,
                           " ".join("%s %.2e" % kv for kv in errs.items())))
        # times at these shapes, float64
        xs1 = _kernel_state(st64, False)
        xs3 = _kernel_state(_candidates(st64), True)
        common = (imu64.win_times, imu64.win_gyro, imu64.win_accel,
                  imu64.start, imu64.end, imu64.has_meas, imu64.frame_i,
                  W64, False)
        jac = lambda: factor.imu_factor(xs1, *common, True)
        val = lambda: factor.imu_factor(xs3, *common, False)
        twin = lambda: factor.imu_factor_plain(xs1, *common, True)
        with obs.recording() as rec:
            jac()
            val()
        # a kernel's time from 20 launches back to back (one launch alone
        # would time the host's enqueue too)
        row = {"K": K, "M": M, "F": F,
               "launches_per_call": rec.count("vicalib.imu.kernel_launches")
               / 2,
               "jac_ms": time_ms(lambda: [jac() for _ in range(20)]) / 20,
               "value_c3_ms": time_ms(lambda: [val() for _ in range(20)])
               / 20,
               "twin_jac_ms": time_ms(twin),
               "host_jac_ms": host_time_ms(jac)}
        # bytes: the windows, bounds, flags, frame indices, weights and
        # frames read once, r and J written once
        nbytes = (8 * (K * M * 7 + 2 * K + 81 * K + 10 * F + 15
                       + 9 * K + 9 * 33 * K) + 9 * K)
        ops = _twin_ops(twin)
        # the bound is the bytes; the twin's element operations (every
        # lane, both sides of every select) at the float64 peak are an
        # estimate of the arithmetic, not a bound
        row.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   bytes=nbytes, twin_ops=ops,
                   twin_ops_ms=ops / FP64_FLOPS_PER_S * 1e3)
        log("IMU factor kernel, %s: residual+Jacobian %.4f ms (host "
            "enqueue %.4f ms), value of 3 candidates %.4f ms; twin %.4f "
            "ms; bound %.4f ms (bytes: %d); the twin's %d float64 element "
            "operations %.4f ms at the peak; %g launches per call"
            % (name, row["jac_ms"], row["host_jac_ms"], row["value_c3_ms"],
               row["twin_jac_ms"], row["bound_ms"], nbytes, ops,
               row["twin_ops_ms"], row["launches_per_call"]))
        out[name] = row
    e = out["euroc"]
    return [{"name": "imu_factor", "route": "cuda",
             "source": SOURCES["imu_factor"],
             "replaces": REPLACES["imu_factor"], "launches": None,
             "max_rel_err_f64": worst, "ms": e["jac_ms"],
             "plain_ms": e["twin_jac_ms"], "bound_ms": e["bound_ms"],
             "bound_by": e["bound_by"], "library_ms": None,
             "shapes": out}]


class _Capture(logging.Handler):
    """The engine's phase seconds and the streaming calibrator's chunk rows,
    from the structured extras of their log records."""

    def __init__(self):
        super().__init__()
        self.timings = None
        self.collectives = None
        self.chunks = []

    def emit(self, record):
        if hasattr(record, "timings"):
            self.timings = record.timings
        if hasattr(record, "collectives"):
            self.collectives = record.collectives
        if hasattr(record, "chunk"):
            self.chunks.append(record.chunk)


def _device_profile(prof, wall_s, top=15):
    """Device time by kernel (and copy) from a torch.profiler run, and the
    device's busy share of the wall time.  Only device-side events count,
    so an op and the kernel it launched are not counted twice."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log("profile: device busy %.1f ms of %.1f ms wall (%.1f%%), %d device "
        "events; top:" % (busy_ms, wall_s * 1e3,
                          100.0 * busy_ms / (wall_s * 1e3),
                          sum(r[1] for r in rows)))
    for ms, n, key in rows[:top]:
        log("  %9.3f ms %6d x  %s" % (ms, n, key[:90]))


def _launches(rec):
    """The CUDA kernels' launches in a recording (obs.py)."""
    return {"threshold_and_label": rec.count(
        "vicalib.detect.kernel_launches"),
        "imu_factor": rec.count("vicalib.imu.kernel_launches")}


def run_cli(dev, argv, profile=False, chunks=None, sharded=None):
    """One ``cli.main`` run with the kernel launches counted in a recording
    around it; under ``profile`` also the device profile.  The
    streaming chunk rows are appended to ``chunks`` when it is given, the
    sharded solve's record (placement, collectives) is put in ``sharded``
    when it is given."""
    from vicalib_tpu_torch import cli, obs

    cap = _Capture()
    loggers = [logging.getLogger("vicalib_tpu_torch.engine"),
               logging.getLogger("vicalib_tpu_torch.streaming")]
    for lg in loggers:
        lg.addHandler(cap)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.time()
    with obs.recording() as rec:
        rc = cli.main(argv, device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches(rec)
    if prof is not None:
        prof.__exit__(None, None, None)
        _device_profile(prof, wall)
    for lg in loggers:
        lg.removeHandler(cap)
    log("cli.main rc=%d in %.2f s; phase seconds %s; launches %s"
        % (rc, wall, cap.timings, launches))
    if rc != 0:
        fail("cli.main returned %d" % rc)
    imu = "-imu" in argv
    for k, n in launches.items():
        if n <= 0 and (k != "imu_factor" or imu):
            fail("kernel %s was not launched on this path" % k)
    if imu:
        n, nk = (rec.count("vicalib.imu.factors"),
                 rec.count("vicalib.imu.kernel_factors"))
        log("IMU factors evaluated %d, by the kernel %d" % (n, nk))
        if n <= 0 or nk != n:
            fail("%d of %d IMU factors went through the kernel" % (nk, n))
    if chunks is not None:
        chunks.extend(cap.chunks)
    if sharded is not None:
        sharded.update(cap.collectives or {})
    return launches, cap.timings, wall


def engine_run(dev, argv):
    """One calibration through the engine in this process, with cli.main's
    configuration of ``argv``, inside a recording.  Returns (EngineResult,
    recording, wall seconds)."""
    from vicalib_tpu_torch import cli, obs
    from vicalib_tpu_torch.engine import VicalibEngine

    cfg, _ = cli.parse_args(argv)
    cfg.device = str(dev)
    t0 = time.time()
    with obs.recording() as rec:
        res = VicalibEngine(cfg).run()
    torch.cuda.synchronize()
    return res, rec, time.time() - t0


def _sync_checked(run):
    """``_Graphs.run`` under set_sync_debug_mode("error"): a body that
    synchronises with the host, eager or captured, raises."""
    def checked(self, key, body):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, key, body)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return checked


def _lm_row(rec):
    n = rec.n("vicalib.lm.iter")
    return {"iters": n, "lm_s": rec.seconds("vicalib.lm.iter"),
            "wait_s": rec.seconds("vicalib.lm.wait"),
            "captures": rec.count("vicalib.lm.graph_capture"),
            "replays": rec.count("vicalib.lm.graph_replay"),
            "replay_s": rec.seconds("vicalib.lm.replay")}


def graph_check(dev, root, dirs, label, extra=()):
    """The LM loop's CUDA graphs against its eager loop on the same
    problems: the engine runs on phase 5's files with ``extra`` flags as it
    runs (every graph body under _sync_checked), recording each staged
    solve it makes (one per batch calibration, one per chunk); each is then
    solved again from the same problem and start with
    ``solver.lm._graph_path`` answering False (every body eager).  Equal
    iterations per stage, and GRAPH_TOL on every solve's answer."""
    from vicalib_tpu_torch import obs, solver, streaming
    from vicalib_tpu_torch.solver import lm

    solves = []
    staged = solver.run_staged

    def recorded(*a, **k):
        res = staged(*a, **k)
        solves.append((a, k, res))
        return res

    out = os.path.join(root, "%s_graphs" % label)
    os.makedirs(out)
    saved = lm._Graphs.run
    solver.run_staged = streaming.run_staged = recorded
    lm._Graphs.run = _sync_checked(lm._Graphs.run)
    try:
        _, rec_g, wall = engine_run(dev, vi_argv(root, dirs, out)
                                    + list(extra))
    finally:
        solver.run_staged = streaming.run_staged = staged
        lm._Graphs.run = saved
    lm._graph_path, saved = (lambda data, state: False), lm._graph_path
    try:
        with obs.recording() as rec_e:
            eager = [staged(*a, **k) for a, k, _ in solves]
        torch.cuda.synchronize()
    finally:
        lm._graph_path = saved
    runs = {"graphed": _lm_row(rec_g), "eager": _lm_row(rec_e)}
    for mode, r in runs.items():
        log("%s %s: %d LM iterations in %.3f s (%.1f ms each, wait %.1f "
            "ms); %d captures, %d replayed iterations (%.0f%%), %.3f s in "
            "replay calls" % (label, mode, r["iters"], r["lm_s"],
                              1e3 * r["lm_s"] / max(r["iters"], 1),
                              1e3 * r["wait_s"] / max(r["iters"], 1),
                              r["captures"], r["replays"],
                              100.0 * r["replays"] / max(r["iters"], 1),
                              r["replay_s"]))
    diff = dict.fromkeys(GRAPH_TOL, 0.0)
    stages = []
    for (_, _, g), e in zip(solves, eager):
        stages.append([(n, int(i)) for n, i, *_ in g.stages_run])
        if stages[-1] != [(n, int(i)) for n, i, *_ in e.stages_run]:
            fail("%s: the graphed solve's iterations %s differ from the "
                 "eager solve's %s" % (label, g.stages_run, e.stages_run))
        a, b = g.state, e.state
        q_sign = torch.sign(torch.sum(a.q_ck * b.q_ck, dim=1, keepdim=True))
        for k, v in (("intr_px", a.intr - b.intr),
                     ("T_ck", torch.cat([(a.q_ck - q_sign * b.q_ck),
                                         a.p_ck - b.p_ck], dim=1)),
                     ("biases", a.biases - b.biases),
                     ("ts", a.time_offset - b.time_offset)):
            diff[k] = max(diff[k], float(v.abs().max()))
    log("%s: %d staged solves, iterations %s; graphed against eager: "
        "largest differences %s (tolerances %s)"
        % (label, len(solves), stages,
           {k: "%.3g" % v for k, v in diff.items()}, GRAPH_TOL))
    g, e = runs["graphed"], runs["eager"]
    if not solves or g["iters"] != e["iters"]:
        fail("%s: %d solves, %d graphed and %d eager iterations"
             % (label, len(solves), g["iters"], e["iters"]))
    if g["captures"] <= 0 or g["replays"] <= 0 or e["replays"] != 0:
        fail("%s: the graphed run captured %d and replayed %d, the eager "
             "run replayed %d" % (label, g["captures"], g["replays"],
                                  e["replays"]))
    for k, v in diff.items():
        if not v <= GRAPH_TOL[k]:
            fail("%s: graphed and eager solves differ in %s by %.3g (above "
                 "%g)" % (label, k, v, GRAPH_TOL[k]))
    return {"diff": diff, "stages": stages, "engine_wall_s": wall, **runs}


def check_intrinsics(cams, cfg):
    for c in range(len(cfg.cameras)):
        dp = np.abs(cams[c]["params"] - cfg.cameras[c].params[:4])
        log("cam %d params %s (truth %s) |d| max %.4g px"
            % (c, np.round(cams[c]["params"], 4), cfg.cameras[c].params[:4],
               dp.max()))
        if not np.all(np.isfinite(cams[c]["params"])) or dp.max() > 0.5:
            fail("cam %d intrinsics off by more than 0.5 px" % c)


def se3_err(a, b):
    """|se3.log(a b^-1)| of two (q, t) poses."""
    from vicalib_tpu_torch.geometry import quat_np, se3
    e = quat_np.se3_mul(a, quat_np.se3_inverse(b))
    return float(torch.linalg.norm(se3.log(
        (torch.as_tensor(e[0]), torch.as_tensor(e[1])))))


def main_path_phase(dev, n_frames, profile=False):
    """The visual path: camera-only stereo calibration through cli.main;
    then phase 9 (c), the same images through ``rectify:`` with the
    calibration just made."""
    from vicalib_tpu_torch.io import sim, sources

    cfg = stereo_config(sim, n_frames)
    with tempfile.TemporaryDirectory(prefix="vicalib_smoke_") as root:
        t0 = time.time()
        data = sim.simulate(cfg, device=dev)
        dirs = write_rig(sim, sources, data, root, dev)
        log("rendered and wrote %d x 2 frames in %.2f s"
            % (n_frames, time.time() - t0))
        cam_uri = "file://[%s/*.pgm,%s/*.pgm]" % tuple(dirs)
        launches, timings, wall, rmse, err = visual_run(
            dev, cfg, cam_uri, root, "visual", profile)
        rect = visual_run(dev, cfg, "rectify:[file=%s]//%s" % (
            os.path.join(root, "visual", "cameras.xml"), cam_uri), root,
            "rectify")
    return (launches, timings, wall, rmse, err), rect


def visual_run(dev, cfg, cam_uri, root, label, profile=False):
    """One camera-only stereo calibration of ``cam_uri`` through cli.main
    into <root>/<label>, held to phase 4's gates."""
    from vicalib_tpu_torch.geometry import quat_np
    from vicalib_tpu_torch.io.outputs import read_cameras_xml

    out = os.path.join(root, label)
    os.makedirs(out)
    xml = os.path.join(out, "cameras.xml")
    logf = os.path.join(out, "vicalibrator.log")
    argv = ["-models", "linear,linear", "-cam", cam_uri,
            "-nouse_only_when_static", "-output", xml,
            "-output_log_file", logf]
    launches, timings, wall = run_cli(dev, argv, profile)
    cams = read_cameras_xml(xml)
    rmse = parse_log(logf)["rmse"]
    if len(cams) != 2 or len(rmse) != 2:
        fail("expected 2 cameras in cameras.xml and the log")
    check_intrinsics(cams, cfg)
    # T_ck = T_wc^-1 (vision RDF); cam 1 relative to cam 0 vs the truth
    T = []
    for c in range(2):
        q_wc = quat_np.from_matrix(cams[c]["T_wc"][:3, :3])
        T.append(quat_np.se3_inverse((q_wc, cams[c]["T_wc"][:3, 3])))
    rel = quat_np.se3_mul(T[1], quat_np.se3_inverse(T[0]))
    q_t, t_t = cfg.cameras[1].T_ck
    err = se3_err(rel, (np.asarray(q_t), np.asarray(t_t)))
    log("%s: cam 1 extrinsic error %.3e (gate 1e-3), rmse %s px (gate 0.12)"
        % (label, err, rmse))
    if not err < 1e-3:
        fail("cam 1 extrinsic error %.3e above 1e-3" % err)
    if not max(rmse) < 0.12:
        fail("rmse %s above 0.12 px" % rmse)
    return launches, timings, wall, rmse, err


def write_vi_rig(dev, n_frames, root):
    """Render the VI workload into ``root`` (cam0, cam1, imu); returns the
    simulator config, its data and the camera directories."""
    from vicalib_tpu_torch.io import sim, sources

    cfg = vi_config(sim, n_frames)
    t0 = time.time()
    data = sim.simulate(cfg, device=dev)
    dirs = write_rig(sim, sources, data, root, dev, imu=True)
    log("rendered and wrote %d x 2 frames and %d IMU samples in %.2f s"
        % (n_frames, len(data.imu_times), time.time() - t0))
    return cfg, data, dirs


def vi_argv(root, dirs, out):
    """cli.main flags of the VI workload, writing into directory ``out``."""
    return ["-models", "linear,linear",
            "-cam", "file://[%s/*.pgm,%s/*.pgm]" % tuple(dirs),
            "-imu", "csv://" + os.path.join(root, "imu"),
            "-nouse_only_when_static",
            "-output", os.path.join(out, "cameras.xml"),
            "-output_log_file", os.path.join(out, "vicalibrator.log")]


def check_vi(cfg, out, label):
    """Phase 5's gates on the cameras.xml and result log in ``out``."""
    from vicalib_tpu_torch.geometry import quat_np
    from vicalib_tpu_torch.io.outputs import read_cameras_xml

    cams = read_cameras_xml(os.path.join(out, "cameras.xml"))
    res = parse_log(os.path.join(out, "vicalibrator.log"))
    log("%s stages (name, iterations, cost, wall s):" % label)
    for row in res["stages"]:
        log("  %-22s %4s %s %s" % row)
    log("%s biases bw_ba %s (truth %s %s); ts %.6g s (truth %g)"
        % (label, res["bw_ba"], VI_GYRO_BIAS, VI_ACCEL_BIAS, res["ts"],
           VI_TIME_OFFSET))
    if len(cams) != 2 or len(res["rmse"]) != 2 or len(res["T_ck"]) != 2:
        fail("expected 2 cameras in cameras.xml and the log")
    check_intrinsics(cams, cfg)
    errs = []
    for c in range(2):
        T = res["T_ck"][c]
        est = (quat_np.from_matrix(T[:3, :3]), T[:3, 3])
        q_t, t_t = cfg.cameras[c].T_ck
        errs.append(se3_err(est, (np.asarray(q_t), np.asarray(t_t))))
    log("%s T_ck errors %s (gate 1e-3), rmse %s px (gate 0.12), "
        "|ts - %g| = %.3g s (gate 2e-3)"
        % (label, ["%.3e" % e for e in errs], res["rmse"], VI_TIME_OFFSET,
           abs(res["ts"] - VI_TIME_OFFSET)))
    if not max(errs) < 1e-3:
        fail("%s T_ck error %s above 1e-3" % (label, errs))
    if not max(res["rmse"]) < 0.12:
        fail("%s rmse %s above 0.12 px" % (label, res["rmse"]))
    if not abs(res["ts"] - VI_TIME_OFFSET) < 2e-3:
        fail("%s time offset %.6g not within 2e-3 s of %g"
             % (label, res["ts"], VI_TIME_OFFSET))
    return cams, res, errs


def vi_phase(dev, cfg, root, dirs, profile=False):
    """The visual-inertial path: images + IMU CSV through cli.main -imu."""
    out = os.path.join(root, "vi")
    os.makedirs(out)
    launches, timings, wall = run_cli(dev, vi_argv(root, dirs, out), profile)
    _, res, errs = check_vi(cfg, out, "VI")
    graphs = graph_check(dev, root, dirs, "VI")
    return {"launches": launches, "phase_s": timings, "cli_wall_s": wall,
            "graphs": graphs,
            "rmse_px": res["rmse"], "T_ck_err": errs, "ts": res["ts"],
            "bw_ba": res["bw_ba"].tolist(),
            "T_ck": [T.tolist() for T in res["T_ck"]],
            "stages": [[n, int(i), float(c), float(w)]
                       for n, i, c, w in res["stages"]]}


def chrome_trace_busy(path):
    """Device busy milliseconds (kernels, copies, memsets) and the span of
    the trace, from a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    return sum(e["dur"] for e in dev) / 1e3, (t1 - t0) / 1e3, len(dev)


def stream_phase(dev, cfg, root, dirs, profile=False):
    """The live path: cli.main -stream_chunk 32 on phase 5's files."""
    import html.parser

    out = os.path.join(root, "stream")
    os.makedirs(out)
    report = os.path.join(out, "report.html")
    argv = vi_argv(root, dirs, out) + ["-stream_chunk", "32",
                                       "-report_file", report,
                                       "-compute_covariance"]
    prof_dir = os.path.join(out, "profile")
    if profile:
        argv += ["-profile_dir", prof_dir]
    chunks = []
    launches, timings, wall = run_cli(dev, argv, chunks=chunks)
    log("stream chunks (frames, capacity, LM iterations, cost, wall s):")
    for c in chunks:
        log("  %4d %4d %4d %.6e %.3f" % (c["n_frames"], c["capacity"],
                                         c["iterations"], c["cost"],
                                         c["wall_s"]))
    if [c["capacity"] for c in chunks] != [32, 64, 128, 128, 256, 256]:
        fail("stream capacities %s" % [c["capacity"] for c in chunks])
    _, res, errs = check_vi(cfg, out, "stream")
    with open(report) as f:
        text = f.read()
    parser = html.parser.HTMLParser()
    parser.feed(text)
    parser.close()
    if not (text.startswith("<!doctype html>") and text.rstrip().endswith(
            "</html>") and "standard deviations" in text):
        fail("the stream report is not the expected HTML")
    log("stream report: %d bytes of HTML" % len(text))
    busy = None
    if profile:
        traces = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)]
        if len(traces) != 1:
            fail("expected one -profile_dir trace, found %s" % traces)
        busy_ms, span_ms, n_ev = chrome_trace_busy(traces[0])
        busy = {"busy_ms": busy_ms, "span_ms": span_ms, "events": n_ev,
                "share": busy_ms / span_ms}
        log("stream -profile_dir trace %s: device busy %.1f ms of %.1f ms "
            "(%.1f%%), %d device events" % (traces[0], busy_ms, span_ms,
                                             100.0 * busy_ms / span_ms,
                                             n_ev))
    graphs = graph_check(dev, root, dirs, "stream",
                         ["-stream_chunk", "32"])
    return {"launches": launches, "phase_s": timings, "cli_wall_s": wall,
            "graphs": graphs,
            "chunks": chunks, "rmse_px": res["rmse"], "T_ck_err": errs,
            "ts": res["ts"], "bw_ba": res["bw_ba"].tolist(),
            "profile_trace": busy,
            "xml": os.path.join(out, "cameras.xml")}


def resume_phase(dev, cfg, root, dirs):
    """-checkpoint_file, then -resume_file from that checkpoint."""
    from vicalib_tpu_torch.io.outputs import read_cameras_xml

    outs = [os.path.join(root, n) for n in ("ckpt", "resumed")]
    ckpt = os.path.join(outs[0], "state.npz")
    runs = []
    for out, extra in zip(outs, (["-checkpoint_file", ckpt],
                                 ["-resume_file", ckpt])):
        os.makedirs(out)
        launches, timings, wall = run_cli(dev, vi_argv(root, dirs, out)
                                          + extra)
        _, res, errs = check_vi(cfg, out, os.path.basename(out))
        runs.append({"launches": launches, "phase_s": timings,
                     "cli_wall_s": wall, "T_ck_err": errs, "ts": res["ts"],
                     "stages": [[n, int(i), float(c), float(w)]
                                for n, i, c, w in res["stages"]]})
    with open(ckpt + ".json") as f:
        saved = json.load(f)["meta"]["stage"]
    resumed = [r[0] for r in runs[1]["stages"]]
    log("checkpoint at stage %s; resumed run's stages %s, iterations %s"
        % (saved, resumed, [r[1] for r in runs[1]["stages"]]))
    if resumed[0] != saved:
        fail("the resumed run started at %s, not the saved stage %s"
             % (resumed[0], saved))
    # The resumed stage starts from a converged state, so it may move the
    # answer only by a tenth of what the accuracy gates allow: intrinsics
    # 0.05 px (gate 0.5), camera poses 1e-4 (gate 1e-3 on T_ck), time
    # offset 2e-4 s (gate 2e-3).
    a, b = (read_cameras_xml(os.path.join(o, "cameras.xml")) for o in outs)
    d_intr = max(float(np.abs(x["params"] - y["params"]).max())
                 for x, y in zip(a, b))
    d_pose = max(float(np.abs(x["T_wc"] - y["T_wc"]).max())
                 for x, y in zip(a, b))
    d_ts = abs(runs[0]["ts"] - runs[1]["ts"])
    log("checkpointed vs resumed cameras.xml: intrinsics |d| %.3g px "
        "(gate 0.05), T_wc |d| %.3g (gate 1e-4), ts |d| %.3g s (gate 2e-4)"
        % (d_intr, d_pose, d_ts))
    if not (d_intr < 0.05 and d_pose < 1e-4 and d_ts < 2e-4):
        fail("the resumed calibration moved away from the checkpointed one")
    return {"checkpoint": runs[0], "resumed": runs[1], "saved_stage": saved,
            "d_intrinsics_px": d_intr, "d_T_wc": d_pose, "d_ts_s": d_ts}


def agreement(label, res, ref):
    """A run's result log ``res`` against phase 5's (``ref``, vi_phase's
    dict) with SHARD_TOL; fails past a tolerance."""
    from vicalib_tpu_torch.geometry import quat_np

    d_rmse = max(abs(a - b) / b for a, b in zip(res["rmse"], ref["rmse_px"]))
    d_q = 0.0
    for T, T_ref in zip(res["T_ck"], ref["T_ck"]):
        q = quat_np.from_matrix(np.asarray(T)[:3, :3])
        q_ref = quat_np.from_matrix(np.asarray(T_ref)[:3, :3])
        d_q = max(d_q, min(np.abs(q - q_ref).max(), np.abs(q + q_ref).max()))
    d_b = float(np.abs(res["bw_ba"] - np.asarray(ref["bw_ba"])).max())
    d_ts = abs(res["ts"] - ref["ts"])
    got = {"rmse_rtol": d_rmse, "q_ck": float(d_q), "biases": d_b,
           "ts": d_ts}
    log("%s against phase 5: %s (tolerances %s)"
        % (label, {k: "%.3g" % v for k, v in got.items()}, SHARD_TOL))
    for k, v in got.items():
        if not v <= SHARD_TOL[k]:
            fail("%s differs from phase 5's run: %s %.3g above %g"
                 % (label, k, v, SHARD_TOL[k]))
    return got


def stage_iters(rows):
    return [(n, int(i)) for n, i, *_ in rows]


def sharded_phase(dev, cfg, root, dirs, ref):
    """Phase 9 (a): -n_shards 2 in this process, both shards on cuda:0."""
    out = os.path.join(root, "sharded")
    os.makedirs(out)
    info = {}
    launches, timings, wall = run_cli(
        dev, vi_argv(root, dirs, out) + ["-n_shards", "2"], sharded=info)
    _, res, errs = check_vi(cfg, out, "sharded")
    iters = sum(int(r[1]) for r in res["stages"])
    per_it = timings["solve"] / iters
    log("sharded (one process): %s; solve %.3f s over %d LM iterations = "
        "%.4f s per iteration (phase 5: %.4f s)"
        % (info.get("placement"), timings["solve"], iters, per_it,
           ref["phase_s"]["solve"] / sum(r[1] for r in ref["stages"])))
    if info.get("placement") is None or "shards [0, 1] of 2" not in \
            info["placement"]:
        fail("the sharded run did not report two shards: %s" % info)
    return {"launches": launches, "phase_s": timings, "cli_wall_s": wall,
            "placement": info["placement"], "s_per_iteration": per_it,
            "iterations": iters, "T_ck_err": errs, "rmse_px": res["rmse"],
            "ts": res["ts"], "agreement": agreement("sharded", res, ref),
            "stages": [[n, int(i), float(c), float(w)]
                       for n, i, c, w in res["stages"]]}


# the CLI module run as ``python -m vicalib_tpu_torch.cli`` (runpy) inside
# a recording, which prints the process's kernel launch counts when it exits
_CLI_WORKER = (
    "import json, runpy\n"
    "from vicalib_tpu_torch import obs\n"
    "with obs.recording() as rec:\n"
    "    try:\n"
    "        runpy.run_module('vicalib_tpu_torch.cli', run_name='__main__', "
    "alter_sys=True)\n"
    "    finally:\n"
    "        print('KERNEL_LAUNCHES ' + json.dumps({'threshold_and_label': "
    "rec.count('vicalib.detect.kernel_launches'), 'imu_factor': "
    "rec.count('vicalib.imu.kernel_launches')}), flush=True)\n")


def two_process_phase(cfg, root, dirs, ref):
    """Phase 9 (b): the CLI in two processes on the one card, joined by
    torch.distributed, writing into one directory."""
    out = os.path.join(root, "two_process")
    os.makedirs(out)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(out, "rank%d.txt" % r) for r in (0, 1)]
    files = [open(p, "w") for p in logs]
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI_WORKER] + vi_argv(root, dirs, out) + [
            "-coordinator_address", "127.0.0.1:%d" % port,
            "-num_processes", "2", "-process_id", str(r)],
        stdout=files[r], stderr=subprocess.STDOUT, cwd=out, env=env)
        for r in (0, 1)]
    walls = [None, None]
    try:
        while any(w is None for w in walls):
            for r, p in enumerate(procs):
                if walls[r] is None and p.poll() is not None:
                    walls[r] = time.time() - t0
                    if p.returncode != 0:
                        raise RuntimeError("rank %d exited %d"
                                           % (r, p.returncode))
            if time.time() - t0 > TWO_PROCESS_TIMEOUT_S:
                raise RuntimeError("not done within %d s"
                                   % TWO_PROCESS_TIMEOUT_S)
            time.sleep(0.2)
        err = None
    except RuntimeError as e:
        err = str(e)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    texts = []
    for r, path in enumerate(logs):
        with open(path) as f:
            texts.append(f.read())
        log("rank %d log, last lines:\n  %s" % (r, "\n  ".join(
            texts[r].strip().splitlines()[-6:])))
    if err is not None:
        fail("two-process run: " + err)
    xmls = sorted(n for n in os.listdir(out) if n.endswith(".xml"))
    if xmls != ["cameras.xml"] or "process 1 wrote nothing" not in texts[1] \
            or "wrote %s" % os.path.join(out, "cameras.xml") not in texts[0]:
        fail("expected one cameras.xml, written by rank 0: %s" % xmls)
    _, res, errs = check_vi(cfg, out, "two-process")
    ranks = []
    for r, text in enumerate(texts):
        m = re.search(r"sharded solve: (.*?); (\d+) collectives, (\d+) "
                      r"bytes, ([0-9.]+) s", text)
        k = re.search(r"^KERNEL_LAUNCHES (.*)$", text, re.M)
        ph = re.search(r"phase seconds: (.*)$", text, re.M)
        st = re.findall(r"stage (\S+)\s+iters\s+(\d+) cost", text)
        if m is None or k is None or not st:
            fail("rank %d's log lacks the sharded solve, stage or kernel "
                 "lines" % r)
        launches = json.loads(k.group(1))
        if min(launches.values()) <= 0:
            fail("rank %d launched no kernel: %s" % (r, launches))
        iters = sum(int(i) for _, i in st)
        ranks.append({"phase_s": ph and ph.group(1), "collectives":
                      int(m.group(2)), "placement": m.group(1),
                      "bytes": int(m.group(3)),
                      "collective_s": float(m.group(4)), "wall_s": walls[r],
                      "stages": [(n, int(i)) for n, i in st],
                      "iterations": iters, "launches": launches,
                      "bytes_per_iteration": int(m.group(3)) / iters})
    if ranks[0]["stages"] != ranks[1]["stages"]:
        fail("the ranks took different iterations per stage: %s / %s"
             % (ranks[0]["stages"], ranks[1]["stages"]))
    if ranks[0]["stages"] != stage_iters(res["stages"]):
        fail("rank 0's log and result file disagree on the stages")
    for r, d in enumerate(ranks):
        log("rank %d: %s; wall %.2f s (phase seconds %s); stages %s; %d "
            "collectives, %d bytes (%.0f per LM iteration), %.3f s in "
            "collectives; launches %s"
            % (r, d["placement"], d["wall_s"], d["phase_s"], d["stages"],
               d["collectives"], d["bytes"], d["bytes_per_iteration"],
               d["collective_s"], d["launches"]))
    return {"ranks": ranks, "T_ck_err": errs, "rmse_px": res["rmse"],
            "ts": res["ts"], "agreement": agreement("two-process", res, ref),
            "launches": ranks[0]["launches"]}


def tracker_phase(dev, data, dirs, model_xml):
    """tracker.main over camera 0's frames with the calibrated model; every
    T_gw against the simulator's true camera pose."""
    import contextlib
    import io

    from vicalib_tpu_torch import obs, tracker
    from vicalib_tpu_torch.geometry import quat_np

    poses = os.path.join(os.path.dirname(dirs[0]), "tracker_poses.txt")
    argv = ["-cam", "file://%s/*.pgm" % dirs[0], "-models", "linear",
            "-model_files", model_xml, "-output_poses", poses]
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), obs.recording() as rec:
        rc = tracker.main(argv, device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches(rec)
    text = buf.getvalue()
    frames = [int(k) for k in re.findall(r"^frame (\d+) ", text, re.M)]
    mats = np.array([float(x) for ln in re.findall(r"^[+-].*$", text, re.M)
                     for x in ln.split()]).reshape(-1, 4, 4)
    F = len(data.frame_times)
    log("tracker rc=%d in %.2f s: %d/%d frames tracked, launches %s"
        % (rc, wall, len(frames), F, launches))
    if rc != 0 or len(frames) < 0.95 * F or len(mats) != len(frames):
        fail("tracker tracked %d of %d frames" % (len(frames), F))
    if launches["threshold_and_label"] != F:
        fail("tracker launched the kernel %d times for %d frames"
             % (launches["threshold_and_label"], F))
    # the true grid-from-camera pose of camera 0: T_cw = T_ck T_wk^-1.
    # Gate 1e-3 rad and 1 mm: one frame's planar PnP (a normalized DLT
    # homography, no refinement) from up to 190 dots detected to ~0.01-0.1
    # px at a 0.35 m target distance, with calibrated intrinsics, was off by
    # at most 1.5e-4 rad and 1.1e-4 m on a 64-frame CPU rehearsal of this
    # rig; a wrong convention or frame misses by tenths of a radian or
    # centimetres
    q_ck, t_ck = (np.asarray(x) for x in data.config.cameras[0].T_ck)
    q_wk, t_wk = (np.asarray(x) for x in data.T_wk)
    rot, trans = [], []
    for k, T in zip(frames, mats):
        q_t, t_t = quat_np.se3_mul((q_ck, t_ck), quat_np.se3_inverse(
            (q_wk[k], t_wk[k])))
        dq = quat_np.quat_mul(quat_np.inverse(q_t),
                              quat_np.from_matrix(T[:3, :3]))
        rot.append(float(np.linalg.norm(quat_np.log(dq))))
        trans.append(float(np.linalg.norm(T[:3, 3] - t_t)))
    log("tracker T_gw vs truth: rotation median %.3g max %.3g rad (gate "
        "1e-3), translation median %.3g max %.3g m (gate 1e-3)"
        % (np.median(rot), max(rot), np.median(trans), max(trans)))
    if not (max(rot) < 1e-3 and max(trans) < 1e-3):
        fail("tracker poses off the simulator's truth")
    return {"launches": launches, "wall_s": wall, "tracked": len(frames),
            "frames": F, "rot_err_max": max(rot), "trans_err_max":
            max(trans), "rot_err_median": float(np.median(rot)),
            "trans_err_median": float(np.median(trans))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path with torch.profiler")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (build and check the kernels)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    from vicalib_tpu_torch.detect import kernels

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device: %s (%d visible); nvidia-smi: %s"
        % (kind, torch.cuda.device_count(), smi))
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)

    from vicalib_tpu_torch.imu import factor

    t0 = time.time()
    kernels.build(verbose=True)
    factor.build(verbose=True)
    log("kernel build: %.2f s" % (time.time() - t0))

    rows = kernel_phase(dev) + imu_kernel_phase(dev)
    if args.kernels_only:
        log(json.dumps({"kernels": rows}))
        log(json.dumps({"ok": True, "phases": "1-3"}))
        return
    (launches, timings, wall, rmse, err), rect = main_path_phase(
        dev, N_FRAMES, profile=args.profile)
    log("visual path: %s" % json.dumps(
        {"frames_per_camera": N_FRAMES, "cli_wall_s": wall,
         "phase_s": timings, "rmse_px": rmse, "cam1_T_err": err}))
    log("rectify path: %s" % json.dumps(
        {"cli_wall_s": rect[2], "phase_s": rect[1], "rmse_px": rect[3],
         "cam1_T_err": rect[4], "launches": rect[0]}))
    with tempfile.TemporaryDirectory(prefix="vicalib_smoke_vi_") as root:
        cfg, data, dirs = write_vi_rig(dev, N_FRAMES, root)
        vi = vi_phase(dev, cfg, root, dirs, profile=args.profile)
        log("VI path: %s" % json.dumps(dict(vi, frames_per_camera=N_FRAMES)))
        stream = stream_phase(dev, cfg, root, dirs, profile=args.profile)
        log("stream path: %s" % json.dumps(
            {k: v for k, v in stream.items() if k != "xml"}))
        resume = resume_phase(dev, cfg, root, dirs)
        log("resume path: %s" % json.dumps(resume))
        trk = tracker_phase(dev, data, dirs, stream["xml"])
        log("tracker path: %s" % json.dumps(trk))
        sharded = sharded_phase(dev, cfg, root, dirs, vi)
        log("sharded path: %s" % json.dumps(sharded))
        two = two_process_phase(cfg, root, dirs, vi)
        log("two-process path: %s" % json.dumps(two))
    paths = {"visual": launches, "vi": vi["launches"],
             "stream": stream["launches"],
             "resume": resume["resumed"]["launches"],
             "tracker": trk["launches"], "sharded": sharded["launches"],
             "two_process_rank0": two["launches"], "rectify": rect[0]}
    for r in rows:
        # this slice's main path (the sharded run) in "launches"; every
        # path's count beside it
        r["launches"] = sharded["launches"][r["name"]]
        r["launches_by_path"] = {p: n[r["name"]] for p, n in paths.items()}
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
