"""Live USB camera capture: the ``uvc://`` HAL camera source equivalent.

The reference calibrates directly from a live UVC camera
(the reference's README.md:34-42: ``uvc://`` camera URIs into hal::Camera).
This module implements the same surface on Linux's V4L2 API with nothing but
the standard library: ``fcntl.ioctl`` + ``ctypes`` structs + ``mmap`` ring
buffers (the classic QUERYCAP -> S_FMT -> REQBUFS -> QBUF/STREAMON ->
DQBUF loop).

Because the rest of the engine is a batch/streaming pipeline over a finite
frame set, ``UvcSource`` is capture-then-replay: on first access it streams
``num`` frames from the device into memory (grayscale uint8, with the
kernel's monotonic buffer timestamp as the device clock and the host wall
clock at dequeue as the system clock), then serves the standard source
interface (``n_frames`` / ``timestamp`` / ``channel_stamps`` /
``read_batch``) exactly like the file replay sources.  Pixel formats:
``GREY`` natively, ``YUYV`` via luma extraction, ``MJPG`` via PIL; GREY
and YUYV rows are read at the device's ``bytesperline`` stride, which may
exceed the active width.

The thin layer that actually touches the kernel (open / ioctl / mmap /
select) is injectable (``kernel=``) so the full negotiation + streaming
state machine is unit-tested against a simulated device
(tests/test_torch_sources.py); the real path differs only in where the
bytes come from.  Host code (numpy), a copy of the JAX package's module.
"""
from __future__ import annotations

import ctypes
import dataclasses
import errno
import logging
import os
import select
import time

import numpy as np

log = logging.getLogger("vicalib_tpu_torch.uvc")


# ---------------------------------------------------------------------------
# V4L2 ABI (linux/videodev2.h), LP64 layout
# ---------------------------------------------------------------------------

def _fourcc(a, b, c, d):
    return ord(a) | (ord(b) << 8) | (ord(c) << 16) | (ord(d) << 24)


PIX_FMT_GREY = _fourcc("G", "R", "E", "Y")
PIX_FMT_YUYV = _fourcc("Y", "U", "Y", "V")
PIX_FMT_MJPG = _fourcc("M", "J", "P", "G")

BUF_TYPE_VIDEO_CAPTURE = 1
MEMORY_MMAP = 1
CAP_VIDEO_CAPTURE = 0x00000001
CAP_STREAMING = 0x04000000


class _Capability(ctypes.Structure):
    _fields_ = [("driver", ctypes.c_uint8 * 16),
                ("card", ctypes.c_uint8 * 32),
                ("bus_info", ctypes.c_uint8 * 32),
                ("version", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("device_caps", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 3)]


class _PixFormat(ctypes.Structure):
    _fields_ = [("width", ctypes.c_uint32),
                ("height", ctypes.c_uint32),
                ("pixelformat", ctypes.c_uint32),
                ("field", ctypes.c_uint32),
                ("bytesperline", ctypes.c_uint32),
                ("sizeimage", ctypes.c_uint32),
                ("colorspace", ctypes.c_uint32),
                ("priv", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("ycbcr_enc", ctypes.c_uint32),
                ("quantization", ctypes.c_uint32),
                ("xfer_func", ctypes.c_uint32)]


class _Format(ctypes.Structure):
    # struct v4l2_format: __u32 type; union { ... } fmt;  The union holds a
    # pointer-bearing member (v4l2_window), so on LP64 it is 8-aligned at
    # offset 8 and 200 bytes wide -> sizeof == 208.
    _fields_ = [("type", ctypes.c_uint32),
                ("_pad", ctypes.c_uint32),
                ("pix", _PixFormat),
                ("_raw", ctypes.c_uint8 * (200 - ctypes.sizeof(_PixFormat)))]


class _RequestBuffers(ctypes.Structure):
    _fields_ = [("count", ctypes.c_uint32),
                ("type", ctypes.c_uint32),
                ("memory", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 2)]


class _Timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _Timecode(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
                ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
                ("userbits", ctypes.c_uint8 * 4)]


class _BufferM(ctypes.Union):
    _fields_ = [("offset", ctypes.c_uint32),
                ("userptr", ctypes.c_ulong),
                ("planes", ctypes.c_void_p),
                ("fd", ctypes.c_int32)]


class _Buffer(ctypes.Structure):
    # sizeof == 88 on LP64 (timeval is 8-aligned at offset 24).
    _fields_ = [("index", ctypes.c_uint32),
                ("type", ctypes.c_uint32),
                ("bytesused", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("field", ctypes.c_uint32),
                ("_pad", ctypes.c_uint32),
                ("timestamp", _Timeval),
                ("timecode", _Timecode),
                ("sequence", ctypes.c_uint32),
                ("memory", ctypes.c_uint32),
                ("m", _BufferM),
                ("length", ctypes.c_uint32),
                ("reserved2", ctypes.c_uint32),
                ("request_fd", ctypes.c_int32)]


class _StreamParm(ctypes.Structure):
    # struct v4l2_streamparm: type + union { v4l2_captureparm; ... } (200 B)
    # capture: capability, capturemode, timeperframe{num,denom}, extendedmode,
    # readbuffers, reserved[4]
    _fields_ = [("type", ctypes.c_uint32),
                ("capability", ctypes.c_uint32),
                ("capturemode", ctypes.c_uint32),
                ("tpf_num", ctypes.c_uint32),
                ("tpf_den", ctypes.c_uint32),
                ("extendedmode", ctypes.c_uint32),
                ("readbuffers", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 4),
                ("_raw", ctypes.c_uint8 * (200 - 40))]


def _ioc(direction, nr, size):
    # _IOC(dir, 'V', nr, size): dir<<30 | size<<16 | 'V'<<8 | nr
    return (direction << 30) | (size << 16) | (ord("V") << 8) | nr


_IOC_W, _IOC_R = 1, 2
VIDIOC_QUERYCAP = _ioc(_IOC_R, 0, ctypes.sizeof(_Capability))
VIDIOC_S_FMT = _ioc(_IOC_W | _IOC_R, 5, ctypes.sizeof(_Format))
VIDIOC_REQBUFS = _ioc(_IOC_W | _IOC_R, 8, ctypes.sizeof(_RequestBuffers))
VIDIOC_QUERYBUF = _ioc(_IOC_W | _IOC_R, 9, ctypes.sizeof(_Buffer))
VIDIOC_QBUF = _ioc(_IOC_W | _IOC_R, 15, ctypes.sizeof(_Buffer))
VIDIOC_DQBUF = _ioc(_IOC_W | _IOC_R, 17, ctypes.sizeof(_Buffer))
VIDIOC_STREAMON = _ioc(_IOC_W, 18, 4)
VIDIOC_STREAMOFF = _ioc(_IOC_W, 19, 4)
VIDIOC_S_PARM = _ioc(_IOC_W | _IOC_R, 22, ctypes.sizeof(_StreamParm))


class RealV4l2:
    """The only code that touches the kernel: open/ioctl/mmap/poll."""

    def open(self, path):
        return os.open(path, os.O_RDWR | os.O_NONBLOCK)

    def close(self, fd):
        os.close(fd)

    def ioctl(self, fd, request, arg):
        import fcntl
        while True:
            try:
                return fcntl.ioctl(fd, request, arg)
            except OSError as e:
                if e.errno != errno.EINTR:
                    raise

    def mmap(self, fd, length, offset):
        import mmap as mmap_mod
        return mmap_mod.mmap(fd, length,
                             flags=mmap_mod.MAP_SHARED,
                             prot=mmap_mod.PROT_READ | mmap_mod.PROT_WRITE,
                             offset=offset)

    def wait_readable(self, fd, timeout_s):
        r, _, _ = select.select([fd], [], [], timeout_s)
        return bool(r)


def _rows(data: bytes, row_bytes: int, h: int, stride: int) -> np.ndarray:
    """(h, row_bytes) pixels of a frame whose rows start ``stride`` bytes
    apart (stride 0, as some V4L2 devices report it: tightly packed)."""
    stride = max(stride, row_bytes)
    arr = np.frombuffer(data, dtype=np.uint8,
                        count=stride * (h - 1) + row_bytes)
    return np.lib.stride_tricks.as_strided(arr, (h, row_bytes), (stride, 1))


def _grey(data: bytes, w: int, h: int, stride: int = 0) -> np.ndarray:
    return _rows(data, w, h, stride).copy()


def _yuyv_to_grey(data: bytes, w: int, h: int,
                  stride: int = 0) -> np.ndarray:
    return _rows(data, 2 * w, h, stride)[:, 0::2].copy()


def _mjpg_to_grey(data: bytes) -> np.ndarray:
    import io as io_mod

    from PIL import Image
    return np.asarray(Image.open(io_mod.BytesIO(data)).convert("L"))


@dataclasses.dataclass
class UvcSource:
    """Capture-then-replay live camera source (``uvc://`` HAL source analog).

    device: /dev/videoN path (or bare index).  num: frames to capture.
    width/height 0 = the device's default.  Mirrors the replay-source interface
    once `_capture()` has run (triggered lazily by the first frame/stamp
    access) so the engine's gating -> detection -> solve pipeline is
    identical for live and recorded data.
    """
    device: str = "/dev/video0"
    num: int = 100
    width: int = 0
    height: int = 0
    fps: float = 30.0
    n_buffers: int = 4
    timeout_s: float = 5.0
    kernel: object = None
    frame_rate: float = 30.0

    def __post_init__(self):
        if self.kernel is None:
            self.kernel = RealV4l2()
        if str(self.device).isdigit():
            self.device = f"/dev/video{self.device}"
        self.frame_rate = self.fps
        self._frames = None
        self._dev_times = None
        self._sys_times = None

    # -- capture ------------------------------------------------------------

    def _negotiate(self, k, fd):
        cap = _Capability()
        k.ioctl(fd, VIDIOC_QUERYCAP, cap)
        caps = cap.device_caps or cap.capabilities
        if not (caps & CAP_VIDEO_CAPTURE) or not (caps & CAP_STREAMING):
            raise ValueError(
                f"{self.device} does not support streaming video capture")

        chosen = None
        for want in (PIX_FMT_GREY, PIX_FMT_YUYV, PIX_FMT_MJPG):
            fmt = _Format(type=BUF_TYPE_VIDEO_CAPTURE)
            fmt.pix.width = self.width or 640
            fmt.pix.height = self.height or 480
            fmt.pix.pixelformat = want
            fmt.pix.field = 1  # V4L2_FIELD_NONE
            try:
                k.ioctl(fd, VIDIOC_S_FMT, fmt)
            except OSError:
                continue
            # V4L2 devices adjust rather than fail: accept whatever came back
            # if it is a format we can convert
            if fmt.pix.pixelformat in (PIX_FMT_GREY, PIX_FMT_YUYV,
                                       PIX_FMT_MJPG):
                chosen = fmt
                break
        if chosen is None:
            raise ValueError(
                f"{self.device}: no supported pixel format "
                "(need GREY, YUYV or MJPG)")

        if self.fps > 0:
            parm = _StreamParm(type=BUF_TYPE_VIDEO_CAPTURE)
            parm.tpf_num, parm.tpf_den = 1, int(round(self.fps))
            try:
                k.ioctl(fd, VIDIOC_S_PARM, parm)
            except OSError:
                pass  # fixed-rate devices reject S_PARM; keep going
        return chosen.pix

    def _capture(self):
        if self._frames is not None:
            return
        k = self.kernel
        fd = k.open(self.device)
        maps = []
        try:
            pix = self._negotiate(k, fd)
            req = _RequestBuffers(count=self.n_buffers,
                                  type=BUF_TYPE_VIDEO_CAPTURE,
                                  memory=MEMORY_MMAP)
            k.ioctl(fd, VIDIOC_REQBUFS, req)
            if req.count < 1:
                raise ValueError(f"{self.device}: no mmap buffers granted")
            for i in range(req.count):
                buf = _Buffer(index=i, type=BUF_TYPE_VIDEO_CAPTURE,
                              memory=MEMORY_MMAP)
                k.ioctl(fd, VIDIOC_QUERYBUF, buf)
                maps.append(k.mmap(fd, buf.length, buf.m.offset))
                k.ioctl(fd, VIDIOC_QBUF, buf)
            k.ioctl(fd, VIDIOC_STREAMON,
                    ctypes.c_int(BUF_TYPE_VIDEO_CAPTURE))

            frames, dev_t, sys_t = [], [], []
            while len(frames) < self.num:
                if not k.wait_readable(fd, self.timeout_s):
                    raise TimeoutError(
                        f"{self.device}: no frame within {self.timeout_s}s")
                buf = _Buffer(type=BUF_TYPE_VIDEO_CAPTURE,
                              memory=MEMORY_MMAP)
                try:
                    k.ioctl(fd, VIDIOC_DQBUF, buf)
                except OSError as e:
                    if e.errno == errno.EAGAIN:
                        continue
                    raise
                raw = bytes(maps[buf.index][:buf.bytesused or buf.length])
                k.ioctl(fd, VIDIOC_QBUF, buf)
                w, h = pix.width, pix.height
                if pix.pixelformat == PIX_FMT_GREY:
                    img = _grey(raw, w, h, pix.bytesperline)
                elif pix.pixelformat == PIX_FMT_YUYV:
                    img = _yuyv_to_grey(raw, w, h, pix.bytesperline)
                else:
                    img = _mjpg_to_grey(raw)
                frames.append(img)
                dev_t.append(buf.timestamp.tv_sec
                             + buf.timestamp.tv_usec * 1e-6)
                sys_t.append(time.time())
            k.ioctl(fd, VIDIOC_STREAMOFF,
                    ctypes.c_int(BUF_TYPE_VIDEO_CAPTURE))
        finally:
            for m in maps:
                try:
                    m.close()
                except (OSError, ValueError):
                    pass
            k.close(fd)
        self._frames = frames
        self._dev_times = np.asarray(dev_t, np.float64)
        self._sys_times = np.asarray(sys_t, np.float64)
        log.info("uvc: captured %d frames %dx%d from %s",
                 len(frames), frames[0].shape[1], frames[0].shape[0],
                 self.device)

    # -- replay-source interface --------------------------------------------

    @property
    def n_frames(self):
        self._capture()
        return len(self._frames)

    @property
    def num_channels(self):
        return 1

    @property
    def has_system_times(self):
        return True

    def timestamp(self, k: int, system: bool = False) -> float:
        self._capture()
        return float((self._sys_times if system else self._dev_times)[k])

    def channel_stamps(self, c: int, system: bool = False) -> np.ndarray:
        self._capture()
        return self._sys_times if system else self._dev_times

    def frame(self, k: int):
        self._capture()
        return self.timestamp(k), [self._frames[k]]

    def read_batch(self, channel: int, indices):
        self._capture()
        return [self._frames[int(i)] for i in indices]

    def __iter__(self):
        for k in range(self.n_frames):
            yield self.frame(k)
