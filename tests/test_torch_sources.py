"""The port's capture sources: deinterlace://, rectify:[file=..]// and uvc://.

The counterpart of tests/test_sources.py (reference analog: the HAL camera
URI sources, README.md:34-42), through the interface the engine reads
(``n_frames``, ``num_channels``, ``channel_stamps``, ``read_batch``), plus
what the port's copies add: GREY and YUYV frames whose rows are padded to
the device's ``bytesperline``, and a parse-time log when a wrapper makes a
``uvc://`` source capture.  The rectify remap table is held to the JAX
package's at 1e-9 (both project the same rays in float64; the tables are
float32).
"""
import logging

import numpy as np
import pytest

from vicalib_tpu.io import sources as jsources
from vicalib_tpu_torch.io import outputs, sources, uvc


def _write_pgms(tmp_path, imgs, sub="images"):
    d = tmp_path / sub
    d.mkdir()
    for k, im in enumerate(imgs):
        sources.write_pgm(str(d / f"f{k:03d}.pgm"), im)
    np.savetxt(str(d / "timestamps.txt"), np.arange(len(imgs)) * 0.1)
    return str(d / "*.pgm")


def _rig(path, model, params, width, height):
    outputs.write_cameras_xml(
        str(path), [model], [np.asarray(params, dtype=np.float64)],
        [(np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))], [width], [height],
        calibrate_imu=False)


def test_deinterlace_splits_fields(tmp_path):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (32, 16), dtype=np.uint8) for _ in range(3)]
    glob = _write_pgms(tmp_path, imgs)
    src = sources.parse_camera_uri(f"deinterlace://file://{glob}")
    assert src.num_channels == 2
    assert src.n_frames == 3
    for c in (0, 1):
        np.testing.assert_allclose(src.channel_stamps(c), [0.0, 0.1, 0.2])
        batch = src.read_batch(c, [0, 2])
        np.testing.assert_array_equal(batch[0], imgs[0][c::2])
        np.testing.assert_array_equal(batch[1], imgs[2][c::2])
    src.frame_rate = 25.0
    assert src.inner.frame_rate == 25.0
    # superframe association sees one clock for both fields
    times, sel = sources.associate_channels(src)
    np.testing.assert_array_equal(sel[0], sel[1])


def test_rectify_linear_is_identity(tmp_path):
    """Rectifying through a linear model is (bilinear-exact) identity."""
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (24, 32), dtype=np.uint8)
            for _ in range(2)]
    glob = _write_pgms(tmp_path, imgs)
    rig = tmp_path / "rig.xml"
    _rig(rig, "linear", [40.0, 40.0, 16.0, 12.0], 32, 24)
    src = sources.parse_camera_uri(f"rectify:[file={rig}]//file://{glob}")
    assert src.num_channels == 1 and src.n_frames == 2
    (out,) = src.read_batch(0, [0])
    # interior pixels identical (borders clamp)
    np.testing.assert_allclose(out[1:-1, 1:-1], imgs[0][1:-1, 1:-1], atol=1)


@pytest.mark.parametrize("model,params", [
    ("linear", [40.0, 40.0, 16.0, 12.0]),
    ("poly3", [300.0, 302.0, 15.5, 12.5, -0.21, 0.05, -0.01])])
def test_rectify_map_matches_jax(tmp_path, model, params):
    imgs = [np.full((24, 32), 128, np.uint8)]
    glob = _write_pgms(tmp_path, imgs)
    rig = tmp_path / "rig.xml"
    _rig(rig, model, params, 32, 24)
    uri = f"rectify:[file={rig}]//file://{glob}"
    m_t = sources.parse_camera_uri(uri)._maps[0]
    m_j = jsources.parse_camera_uri(uri)._maps[0]
    assert m_t.dtype == m_j.dtype == np.float32
    np.testing.assert_allclose(m_t, m_j, rtol=1e-9, atol=0)


class _FakeMmap:
    """Stands in for an mmap'd V4L2 buffer: writable bytes + close()."""

    def __init__(self, length):
        self.data = bytearray(length)
        self.closed = False

    def __getitem__(self, sl):
        return bytes(self.data[sl])

    def close(self):
        self.closed = True


class _FakeV4l2:
    """Simulated V4L2 kernel: a one-format camera driving the full
    negotiate -> mmap ring -> QBUF/DQBUF state machine in io/uvc.py.
    ``stride`` > the row's bytes pads every row, as V4L2 devices may."""

    def __init__(self, width=32, height=24, n_frames=64,
                 fmt=uvc.PIX_FMT_YUYV, stride=0):
        self.width, self.height, self.fmt = width, height, fmt
        bpp = 2 if fmt == uvc.PIX_FMT_YUYV else 1
        self.stride = stride or width * bpp
        self.frame_bytes = self.stride * height
        self.opened = self.streaming = False
        self.maps = {}
        self.queued = []
        self.seq = 0
        self.frames = []
        rng = np.random.default_rng(7)
        for _ in range(n_frames):
            y = rng.integers(0, 255, (height, width), dtype=np.uint8)
            rows = np.full((height, self.stride), 77, np.uint8)
            if bpp == 2:
                rows[:, 0:2 * width:2] = y
                rows[:, 1:2 * width:2] = 128
            else:
                rows[:, :width] = y
            self.frames.append((y, rows.tobytes()))

    def open(self, path):
        assert path == "/dev/video1"
        self.opened = True
        return 42

    def close(self, fd):
        self.opened = False

    def mmap(self, fd, length, offset):
        m = _FakeMmap(length)
        self.maps[offset] = m
        return m

    def wait_readable(self, fd, timeout_s):
        return True

    def ioctl(self, fd, request, arg):
        assert self.opened
        if request == uvc.VIDIOC_QUERYCAP:
            arg.device_caps = uvc.CAP_VIDEO_CAPTURE | uvc.CAP_STREAMING
        elif request == uvc.VIDIOC_S_FMT:
            # the device adjusts to its one format at its native size
            # regardless of what was asked (standard V4L2 behavior)
            arg.pix.pixelformat = self.fmt
            arg.pix.width, arg.pix.height = self.width, self.height
            arg.pix.sizeimage = self.frame_bytes
            if self.stride != self.width * (
                    2 if self.fmt == uvc.PIX_FMT_YUYV else 1):
                arg.pix.bytesperline = self.stride
        elif request == uvc.VIDIOC_S_PARM:
            assert arg.tpf_den == 15
        elif request == uvc.VIDIOC_REQBUFS:
            arg.count = min(arg.count, 2)  # grant fewer than asked
        elif request == uvc.VIDIOC_QUERYBUF:
            arg.length = self.frame_bytes
            arg.m.offset = 4096 * (arg.index + 1)
        elif request == uvc.VIDIOC_QBUF:
            self.queued.append((arg.index, arg.m.offset
                                or 4096 * (arg.index + 1)))
        elif request == uvc.VIDIOC_STREAMON:
            self.streaming = True
        elif request == uvc.VIDIOC_STREAMOFF:
            self.streaming = False
        elif request == uvc.VIDIOC_DQBUF:
            assert self.streaming and self.queued
            idx, off = self.queued.pop(0)
            _, raw = self.frames[self.seq % len(self.frames)]
            self.maps[off].data[:len(raw)] = raw
            arg.index = idx
            arg.bytesused = len(raw)
            arg.timestamp.tv_sec = 100 + self.seq // 15
            arg.timestamp.tv_usec = int((self.seq % 15) / 15.0 * 1e6)
            self.seq += 1
        else:
            raise AssertionError(f"unexpected ioctl {request:#x}")
        return 0


def test_uvc_capture_state_machine():
    """uvc:// drives the V4L2 ring correctly and yields grayscale frames
    with monotonic kernel timestamps (simulated YUYV device)."""
    fake = _FakeV4l2()
    src = sources.parse_camera_uri("uvc:[dev=/dev/video1,num=5,fps=15]//")
    assert src.num == 5 and src.fps == 15.0
    src.kernel = fake
    assert src.n_frames == 5
    assert src.num_channels == 1
    batch = src.read_batch(0, range(5))
    for k in range(5):
        np.testing.assert_array_equal(batch[k], fake.frames[k][0])
    stamps = src.channel_stamps(0)
    assert stamps.shape == (5,) and np.all(np.diff(stamps) > 0)
    np.testing.assert_allclose(stamps[1] - stamps[0], 1 / 15.0, atol=1e-6)
    # system clock present and distinct from the device clock
    assert src.has_system_times
    assert src.channel_stamps(0, system=True)[0] != stamps[0]
    # device released, ring unmapped, stream stopped
    assert not fake.opened and not fake.streaming
    assert all(m.closed for m in fake.maps.values())


@pytest.mark.parametrize("fmt", ["GREY", "YUYV"])
def test_uvc_rows_padded_to_bytesperline(fmt):
    """A device that pads each row to ``bytesperline``: the padding bytes
    (77) never reach the frame."""
    code = {"GREY": uvc.PIX_FMT_GREY, "YUYV": uvc.PIX_FMT_YUYV}[fmt]
    bpp = 2 if fmt == "YUYV" else 1
    fake = _FakeV4l2(width=30, height=8, fmt=code, stride=30 * bpp + 10)
    src = uvc.UvcSource(device="/dev/video1", num=3, fps=15, kernel=fake)
    for k, img in enumerate(src.read_batch(0, range(3))):
        assert img.shape == (8, 30)
        np.testing.assert_array_equal(img, fake.frames[k][0])


def test_uvc_device_index_and_missing_device():
    src = sources.parse_camera_uri("uvc://3")
    assert isinstance(src, uvc.UvcSource) and src.device == "/dev/video3"
    with pytest.raises((OSError, ValueError)):
        uvc.UvcSource(device="/dev/nonexistent-video", num=1).n_frames


def test_wrapped_uvc_logs_capture_at_parse_time(caplog, monkeypatch):
    """deinterlace://uvc... captures while the URI is parsed, and says
    so before it starts."""
    fake = _FakeV4l2(height=24)
    real_init = uvc.UvcSource.__post_init__

    def with_fake(self):
        real_init(self)
        self.kernel = fake

    monkeypatch.setattr(uvc.UvcSource, "__post_init__", with_fake)
    with caplog.at_level(logging.INFO):
        src = sources.parse_camera_uri(
            "deinterlace://uvc:[dev=/dev/video1,num=4,fps=15]//")
    msgs = [r.getMessage() for r in caplog.records]
    i = next(i for i, m in enumerate(msgs)
             if "capturing 4 frames from /dev/video1" in m)
    assert any("uvc: captured 4 frames" in m for m in msgs[i + 1:])
    assert src.num_channels == 2 and src.n_frames == 4
    np.testing.assert_array_equal(src.read_batch(1, [2])[0],
                                  fake.frames[2][0][1::2])

