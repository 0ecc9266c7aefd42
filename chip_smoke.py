"""Drive the PyTorch/CUDA port on one CUDA card and check it.

  python3 chip_smoke.py              # all phases (needs one CUDA card)
  python3 chip_smoke.py --profile    # also trace the main path with
                                     # torch.profiler (device time by kernel)

Phases, in order; any failure exits non-zero:
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build every CUDA kernel of the main path with nvcc (sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (a 32-frame batch of padded 800x600
     stereo frames) plus edge cases (synthetic frames, inverted and noise
     frames, other sweep bounds, one frame): labels must agree bit for bit;
     times from CUDA events (median of 12 after warm-up), device launches
     per call from torch.profiler;
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
     launched during the phase.  Prints the stage table (iterations, cost,
     wall time), the biases and the phase seconds; with ``--profile`` also
     the device's busy share and top kernels of the VI run;
  6. the ``kernels`` JSON line, the nvidia-smi line and, last, the result.

Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import re
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
REPLACES = {"threshold_and_label": "vicalib_tpu/detect/pallas_kernels.py:194"}
SOURCES = {"threshold_and_label": "vicalib_tpu_torch/csrc/threshold_label.cu"}


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


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.timings = None

    def emit(self, record):
        if hasattr(record, "timings"):
            self.timings = record.timings


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


def run_cli(dev, argv, profile=False):
    """One ``cli.main`` run with every kernel count set to 0 just before it
    and read just after; under ``profile`` also the device profile."""
    from vicalib_tpu_torch import cli
    from vicalib_tpu_torch.detect import kernels

    cap = _Capture()
    eng_log = logging.getLogger("vicalib_tpu_torch.engine")
    eng_log.addHandler(cap)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.time()
    rc = cli.main(argv, device=str(dev))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    if prof is not None:
        prof.__exit__(None, None, None)
        _device_profile(prof, wall)
    eng_log.removeHandler(cap)
    log("cli.main rc=%d in %.2f s; phase seconds %s; launches %s"
        % (rc, wall, cap.timings, launches))
    if rc != 0:
        fail("cli.main returned %d" % rc)
    for k, n in launches.items():
        if n <= 0:
            fail("kernel %s was not launched on this path" % k)
    return launches, cap.timings, wall


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
    """The visual path: camera-only stereo calibration through cli.main."""
    from vicalib_tpu_torch.geometry import quat_np
    from vicalib_tpu_torch.io import sim, sources
    from vicalib_tpu_torch.io.outputs import read_cameras_xml

    cfg = stereo_config(sim, n_frames)
    with tempfile.TemporaryDirectory(prefix="vicalib_smoke_") as root:
        t0 = time.time()
        data = sim.simulate(cfg, device=dev)
        dirs = write_rig(sim, sources, data, root, dev)
        log("rendered and wrote %d x 2 frames in %.2f s"
            % (n_frames, time.time() - t0))
        xml = os.path.join(root, "cameras.xml")
        logf = os.path.join(root, "vicalibrator.log")
        argv = ["-models", "linear,linear",
                "-cam", "file://[%s/*.pgm,%s/*.pgm]" % tuple(dirs),
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
    log("cam 1 extrinsic error %.3e (gate 1e-3), rmse %s px (gate 0.12)"
        % (err, rmse))
    if not err < 1e-3:
        fail("cam 1 extrinsic error %.3e above 1e-3" % err)
    if not max(rmse) < 0.12:
        fail("rmse %s above 0.12 px" % rmse)
    return launches, timings, wall, rmse, err


def vi_phase(dev, n_frames, profile=False):
    """The visual-inertial path: images + IMU CSV through cli.main -imu."""
    from vicalib_tpu_torch.geometry import quat_np
    from vicalib_tpu_torch.io import sim, sources
    from vicalib_tpu_torch.io.outputs import read_cameras_xml

    cfg = vi_config(sim, n_frames)
    with tempfile.TemporaryDirectory(prefix="vicalib_smoke_vi_") as root:
        t0 = time.time()
        data = sim.simulate(cfg, device=dev)
        dirs = write_rig(sim, sources, data, root, dev, imu=True)
        log("rendered and wrote %d x 2 frames and %d IMU samples in %.2f s"
            % (n_frames, len(data.imu_times), time.time() - t0))
        xml = os.path.join(root, "cameras.xml")
        logf = os.path.join(root, "vicalibrator.log")
        argv = ["-models", "linear,linear",
                "-cam", "file://[%s/*.pgm,%s/*.pgm]" % tuple(dirs),
                "-imu", "csv://" + os.path.join(root, "imu"),
                "-nouse_only_when_static", "-output", xml,
                "-output_log_file", logf]
        launches, timings, wall = run_cli(dev, argv, profile)
        cams = read_cameras_xml(xml)
        res = parse_log(logf)
    log("VI stages (name, iterations, cost, wall s):")
    for row in res["stages"]:
        log("  %-22s %4s %s %s" % row)
    log("VI biases bw_ba %s (truth %s %s); ts %.6g s (truth %g)"
        % (res["bw_ba"], VI_GYRO_BIAS, VI_ACCEL_BIAS, res["ts"],
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
    log("VI T_ck errors %s (gate 1e-3), rmse %s px (gate 0.12), "
        "|ts - %g| = %.3g s (gate 2e-3)"
        % (["%.3e" % e for e in errs], res["rmse"], VI_TIME_OFFSET,
           abs(res["ts"] - VI_TIME_OFFSET)))
    if not max(errs) < 1e-3:
        fail("VI T_ck error %s above 1e-3" % errs)
    if not max(res["rmse"]) < 0.12:
        fail("VI rmse %s above 0.12 px" % res["rmse"])
    if not abs(res["ts"] - VI_TIME_OFFSET) < 2e-3:
        fail("VI time offset %.6g not within 2e-3 s of %g"
             % (res["ts"], VI_TIME_OFFSET))
    return {"launches": launches, "phase_s": timings, "cli_wall_s": wall,
            "rmse_px": res["rmse"], "T_ck_err": errs, "ts": res["ts"],
            "bw_ba": res["bw_ba"].tolist(),
            "stages": [[n, int(i), float(c), float(w)]
                       for n, i, c, w in res["stages"]]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path with torch.profiler")
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

    t0 = time.time()
    kernels.build(verbose=True)
    log("kernel build: %.2f s" % (time.time() - t0))

    rows = kernel_phase(dev)
    launches, timings, wall, rmse, err = main_path_phase(
        dev, N_FRAMES, profile=args.profile)
    log("visual path: %s" % json.dumps(
        {"frames_per_camera": N_FRAMES, "cli_wall_s": wall,
         "phase_s": timings, "rmse_px": rmse, "cam1_T_err": err}))
    vi = vi_phase(dev, N_FRAMES, profile=args.profile)
    log("VI path: %s" % json.dumps(dict(vi, frames_per_camera=N_FRAMES)))
    for r in rows:
        # the newest path's count; every path's count beside it
        r["launches"] = vi["launches"][r["name"]]
        r["launches_by_path"] = {"visual": launches[r["name"]],
                                 "vi": vi["launches"][r["name"]]}
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
