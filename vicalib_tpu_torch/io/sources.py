"""Data sources: image-file and CSV-IMU replay — the HAL-driver equivalent.

Cameras come in through HAL-style URIs: ``file://<dir>/images/*.pgm``, and
multi-channel rigs use one glob per channel, ``file://[glob0,glob1]``, like
HAL's split-image URIs; ``deinterlace://<inner>`` and
``rectify:[file=cameras.xml]//<inner>`` wrap another source, and
``uvc:[dev=/dev/video0,...]//`` captures from a V4L2 camera (io/uvc.py).
IMU streams come in as ``csv://<dir>`` (accel.txt / gyro.txt /
timestamp.txt).  Host code (numpy); the frames go to the device in
``engine._detect_all``.

PGM (P2/P5) parsing is in Python; the native host library (native/), when
present, decodes PGM batches on a thread pool; PNG/JPG need PIL.
"""
from __future__ import annotations

import dataclasses
import glob as globlib
import logging
import os
import re

import numpy as np

from .uvc import UvcSource

log = logging.getLogger("vicalib_tpu_torch.sources")


def read_pgm(path: str) -> np.ndarray:
    """Read a P5 (binary) or P2 (ascii) PGM file -> (H, W) uint8/uint16."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, whitespace/comments, width, height, maxval
    tokens = []
    i = 0
    while len(tokens) < 4:
        m = re.match(rb"\s*(#[^\n]*\n|\S+)", data[i:])
        if m is None:
            raise ValueError(f"bad PGM header in {path}")
        tok = m.group(1)
        i += m.end()
        if not tok.startswith(b"#"):
            tokens.append(tok)
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), \
        int(tokens[3])
    if magic == b"P5":
        dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
        img = np.frombuffer(data[i + 1:], dtype=dtype,
                            count=w * h).reshape(h, w)
        return img.astype(np.uint8) if maxval < 256 else img
    if magic == b"P2":
        vals = np.array(data[i:].split(), dtype=int)
        return vals[:w * h].reshape(h, w).astype(np.uint8)
    raise ValueError(f"unsupported PGM magic {magic!r} in {path}")


def write_pgm(path: str, img: np.ndarray):
    img = np.asarray(img, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def read_image(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pgm":
        from . import native
        img = native.read_pgm(path)
        return img if img is not None else read_pgm(path)
    try:
        from PIL import Image
        img = np.asarray(Image.open(path).convert("L"))
        return img
    except ImportError as e:
        raise ValueError(
            f"cannot decode {ext} without PIL; use .pgm") from e


@dataclasses.dataclass
class CameraSource:
    """Replays image files as a (multi-channel) camera.

    Reference analog: hal::Camera with the file:// driver
    (vicalib-engine.cc:126, 514-527).  Timestamps come from a
    ``timestamps.txt`` next to the images if present, else the frame index
    over ``frame_rate``.
    """
    channel_globs: list
    frame_rate: float = 10.0

    def __post_init__(self):
        self.files = [sorted(globlib.glob(g)) for g in self.channel_globs]
        # Per-channel clocks: each channel's directory may carry its own
        # timestamps.txt / system_times.txt (async multi-camera rigs where
        # channels deliver at different times).  Repeated consecutive
        # stamps within a channel are de-dup'd — the reference drops
        # images whose timestamp did not advance
        # (vicalib-task.cc:612-678, esp. 633-653).
        self._ch_device = []
        self._ch_system = []
        for c, flist in enumerate(self.files):
            nch = len(flist)
            dev = sys_t = None
            if flist:
                tdir = os.path.dirname(flist[0])
                tfile = os.path.join(tdir, "timestamps.txt")
                if os.path.exists(tfile):
                    dev = np.loadtxt(tfile).reshape(-1)[:nch]
                sfile = os.path.join(tdir, "system_times.txt")
                if os.path.exists(sfile):
                    sys_t = np.loadtxt(sfile).reshape(-1)[:nch]
            if dev is not None:
                if len(dev) < nch:
                    flist = flist[:len(dev)]
                    nch = len(flist)
                # de-dup repeated stamps (keep the first occurrence)
                keep = np.ones(nch, dtype=bool)
                if nch > 1:
                    keep[1:] = np.diff(dev[:nch]) > 0
                if not keep.all():
                    flist = [f for f, k in zip(flist, keep) if k]
                    dev = dev[:nch][keep]
                    if sys_t is not None:
                        sys_t = sys_t[:nch][keep]
                dev = np.asarray(dev, dtype=np.float64)
            self.files[c] = flist
            # dev None = index clock (k / frame_rate), synthesized lazily
            # so a post-construction frame_rate override still applies
            self._ch_device.append(dev)
            self._ch_system.append(None if sys_t is None
                                   else np.asarray(sys_t, dtype=np.float64))
        self.n_frames = min(len(f) for f in self.files) if self.files else 0

    def channel_stamps(self, c: int, system: bool = False) -> np.ndarray:
        """Per-channel frame stamps (post de-dup), device or system clock
        (the system clock falls back to the device clock when a channel has
        no system_times.txt, i.e. the clocks are assumed synchronized)."""
        if system and self._ch_system[c] is not None:
            return self._ch_system[c]
        if self._ch_device[c] is not None:
            return self._ch_device[c]
        return np.arange(len(self.files[c])) / self.frame_rate

    @property
    def num_channels(self):
        return len(self.files)

    def read_batch(self, channel: int, indices):
        """Decode many frames of one channel at once (native thread pool
        when available — the reference's HAL-driver role)."""
        paths = [self.files[channel][k] for k in indices]
        if not paths:
            return []
        if all(p.lower().endswith(".pgm") for p in paths):
            from . import native
            first = read_image(paths[0])
            h, w = first.shape
            batch = native.read_pgm_batch(paths, w, h)
            if batch is not None:
                return list(batch)
        return [read_image(p) for p in paths]


@dataclasses.dataclass
class ImuSource:
    """CSV IMU replay: accel.txt / gyro.txt / timestamp.txt in a directory.

    Reference analog: hal::IMU with the csv:// driver (README.md:48,
    vicalib-engine.cc:136-138).  Each file has one row per sample; accel and
    gyro rows are 3 values (or 4 with a leading timestamp), timestamp.txt
    carries the stamps.  A two-column timestamp.txt models the reference's
    device/system clock pair (ImuMsg::device_time / system_time,
    vicalib-task.cc:689-691): column 0 is the device clock, column 1 the
    system clock; ``use_system_time`` selects which one ``times`` exposes.
    """
    directory: str
    use_system_time: bool = False

    def __post_init__(self):
        d = self.directory
        accel = np.atleast_2d(np.loadtxt(os.path.join(d, "accel.txt"),
                                         delimiter=None))
        gyro = np.atleast_2d(np.loadtxt(os.path.join(d, "gyro.txt")))
        ts_path = os.path.join(d, "timestamp.txt")
        self.device_times = self.system_times = None
        if os.path.exists(ts_path):
            ts = np.loadtxt(ts_path)
            if ts.ndim == 1:
                self.device_times = self.system_times = ts
            else:
                self.device_times = ts[:, 0]
                self.system_times = ts[:, 1]
        else:
            self.device_times = self.system_times = accel[:, 0]
            accel = accel[:, 1:]
            gyro = gyro[:, 1:]
        self.times = (self.system_times if self.use_system_time
                      else self.device_times)
        self.accel = accel[:, -3:]
        self.gyro = gyro[:, -3:]
        n = min(len(self.times), len(self.accel), len(self.gyro))
        self.times, self.accel, self.gyro = (
            self.times[:n], self.accel[:n], self.gyro[:n])


class _Wrapper:
    """A source over another source: it forwards the clock and frame rate
    of the source it wraps (what the engine reads besides the frames)."""

    def __init__(self, inner):
        self.inner = inner
        self.n_frames = inner.n_frames

    @property
    def frame_rate(self):
        return self.inner.frame_rate

    @frame_rate.setter
    def frame_rate(self, rate):
        self.inner.frame_rate = rate


class DeinterlaceSource(_Wrapper):
    """``deinterlace://<inner>``: split each interlaced frame's even/odd
    scanlines into a 2-channel rig (the reference's HAL deinterlace
    source, README.md:34-42)."""

    @property
    def num_channels(self):
        return 2 * self.inner.num_channels

    def channel_stamps(self, c, system=False):
        return self.inner.channel_stamps(c // 2, system)

    def read_batch(self, channel, indices):
        inner_c, field = divmod(channel, 2)
        batch = self.inner.read_batch(inner_c, indices)
        return [im[field::2] for im in batch]


def rectify_map(model_name, params, width, height):
    """(H, W, 2) source pixel of every output pixel of a rectified image:
    the output pixel's ray through the pinhole K of ``params`` projected
    through the distorted model (float64, on the CPU)."""
    import torch

    from ..cameras.models import get_model

    params = np.asarray(params, dtype=np.float64)
    fu, fv, u0, v0 = params[:4]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    rays = np.stack([(u - u0) / fu, (v - v0) / fv, np.ones_like(u)],
                    axis=-1)
    src = get_model(model_name).project(
        torch.as_tensor(rays.reshape(-1, 3)), torch.as_tensor(params))
    return src.numpy().reshape(height, width, 2)


class RectifySource(_Wrapper):
    """``rectify:[file=cameras.xml]//<inner>``: undistort every channel to
    its linear (pinhole-K) model via a precomputed bilinear remap (the
    reference's HAL rectify source, README.md:34-42).  The table is built
    once per channel from the rig file's camera model
    (:func:`rectify_map`) and applied on the host."""

    def __init__(self, inner, rig_file: str):
        from .outputs import read_cameras_xml

        super().__init__(inner)
        cams = read_cameras_xml(rig_file)
        if len(cams) < inner.num_channels:
            raise ValueError(
                f"rig file {rig_file} has {len(cams)} cameras; "
                f"source has {inner.num_channels} channels")
        self._maps = [
            rectify_map(cam["model"], cam["params"], int(cam["width"]),
                        int(cam["height"])).astype(np.float32)
            for cam in cams[:inner.num_channels]]

    @property
    def num_channels(self):
        return self.inner.num_channels

    def channel_stamps(self, c, system=False):
        return self.inner.channel_stamps(c, system)

    @staticmethod
    def _remap(img, src):
        h, w = img.shape[:2]
        x = np.clip(src[..., 0], 0, w - 1.001)
        y = np.clip(src[..., 1], 0, h - 1.001)
        x0 = x.astype(np.int32)
        y0 = y.astype(np.int32)
        fx = x - x0
        fy = y - y0
        im = img.astype(np.float32)
        top = im[y0, x0] * (1 - fx) + im[y0, x0 + 1] * fx
        bot = im[y0 + 1, x0] * (1 - fx) + im[y0 + 1, x0 + 1] * fx
        return (top * (1 - fy) + bot * fy).astype(img.dtype)

    def read_batch(self, channel, indices):
        batch = self.inner.read_batch(channel, indices)
        return [self._remap(im, self._maps[channel]) for im in batch]


def associate_channels(camera, system: bool = False, tol: float = None):
    """Nearest-time superframe association for async multi-camera rigs.

    The reference assembles superframes from channels that deliver at
    different times, de-duping repeated stamps per channel and matching
    images by timestamp (vicalib-task.cc:612-678).  Batch equivalent:
    channel 0 is the reference clock; for every channel-0 frame, each other
    channel contributes its nearest-stamp frame if it lies within ``tol``
    (default: 45% of the median channel-0 frame interval); frames any
    channel misses are dropped.

    Returns (times (F,), sel (C, F) int32 per-channel frame indices).
    Index-aligned sources (no per-channel stamps) come back as the
    identity mapping.
    """
    C = camera.num_channels
    ref = camera.channel_stamps(0, system)
    stamps = [camera.channel_stamps(c, system) for c in range(C)]
    if all(len(s) == len(ref) and np.array_equal(s, ref) for s in stamps):
        n = len(ref)
        return ref, np.tile(np.arange(n, dtype=np.int32), (C, 1))
    if tol is None:
        tol = 0.45 * float(np.median(np.diff(ref))) if len(ref) > 1 else 0.05
    sel = np.zeros((C, len(ref)), dtype=np.int32)
    ok = np.ones(len(ref), dtype=bool)
    sel[0] = np.arange(len(ref))
    for c in range(1, C):
        s = stamps[c]
        j = np.clip(np.searchsorted(s, ref), 0, len(s) - 1)
        j_lo = np.maximum(j - 1, 0)
        pick = np.where(np.abs(s[j_lo] - ref) <= np.abs(s[j] - ref),
                        j_lo, j)
        sel[c] = pick
        ok &= np.abs(s[pick] - ref) <= tol
    return ref[ok], sel[:, ok]


def parse_camera_uri(uri: str):
    """HAL-style camera URIs (README.md:34-42): ``file://<glob>`` /
    ``file://[g0,g1]`` / bare glob, optionally wrapped by
    ``deinterlace://...`` and ``rectify:[file=cameras.xml]//...``.
    ``uvc:[dev=/dev/video0,num=100,w=640,h=480,fps=30]//`` captures live
    from a V4L2 USB camera (io/uvc.py) when its frames are first read, then
    replays them through the same pipeline; wrapped in ``deinterlace://``
    or ``rectify:``, it captures here, while the URI is parsed."""
    m = re.match(r"^(\w+):(\[[^\]]*\])?//(.*)$", uri)
    scheme = m.group(1).lower() if m else "file"
    opts = {}
    if m and m.group(2):
        for kv in m.group(2).strip("[]").split(","):
            if "=" in kv:
                k, v = kv.split("=", 1)
                opts[k.strip()] = v.strip()
    if scheme == "uvc":
        path = m.group(3)
        return UvcSource(device=opts.get("dev", path or "/dev/video0"),
                         num=int(opts.get("num", 100)),
                         width=int(opts.get("w", 0)),
                         height=int(opts.get("h", 0)),
                         fps=float(opts.get("fps", 30.0)))
    if scheme in ("deinterlace", "rectify"):
        inner = parse_camera_uri(m.group(3))
        if isinstance(inner, UvcSource):
            log.info("%s over uvc: capturing %d frames from %s now, while "
                     "the camera URI is parsed", scheme, inner.num,
                     inner.device)
        if scheme == "deinterlace":
            return DeinterlaceSource(inner)
        return RectifySource(inner, opts.get("file", "cameras.xml"))
    path = m.group(3) if m else uri
    if path.startswith("["):
        globs = [g.strip() for g in path.strip("[]").split(",")]
    else:
        globs = [path]
    return CameraSource(globs)


def parse_imu_uri(uri: str, use_system_time: bool = False) -> ImuSource:
    path = uri[len("csv://"):] if uri.startswith("csv://") else uri
    return ImuSource(path, use_system_time=use_system_time)
