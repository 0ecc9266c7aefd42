"""Data sources: image-file and CSV-IMU replay — the HAL-driver equivalent.

Cameras come in through HAL-style URIs: ``file://<dir>/images/*.pgm``, and
multi-channel rigs use one glob per channel, ``file://[glob0,glob1]``, like
HAL's split-image URIs.  IMU streams come in as ``csv://<dir>``
(accel.txt / gyro.txt / timestamp.txt).  Host code (numpy); the frames go
to the device in ``engine._detect_all``.

PGM (P2/P5) parsing is in Python; the native host library (native/), when
present, decodes PGM batches on a thread pool; PNG/JPG need PIL.
"""
from __future__ import annotations

import dataclasses
import glob as globlib
import os
import re

import numpy as np


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


def parse_camera_uri(uri: str) -> CameraSource:
    """HAL-style camera URIs: ``file://<glob>``, ``file://[g0,g1]`` or a
    bare glob.  The other schemes of the reference (``deinterlace://``,
    ``rectify:``, ``uvc:``) are not ported yet (ROADMAP, queue 1, capture
    sources)."""
    m = re.match(r"^(\w+):(\[[^\]]*\])?//(.*)$", uri)
    scheme = m.group(1).lower() if m else "file"
    if scheme != "file":
        raise NotImplementedError(
            f"camera URI scheme {scheme!r} is not ported yet; see ROADMAP.md "
            "queue 1 (capture sources)")
    path = m.group(3) if m else uri
    if path.startswith("["):
        globs = [g.strip() for g in path.strip("[]").split(",")]
    else:
        globs = [path]
    return CameraSource(globs)


def parse_imu_uri(uri: str, use_system_time: bool = False) -> ImuSource:
    path = uri[len("csv://"):] if uri.startswith("csv://") else uri
    return ImuSource(path, use_system_time=use_system_time)
