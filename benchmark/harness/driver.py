"""The one general driver of the traffic mixes.

A traffic file (traffic/<name>.json) names the program's entry point, the
flags added to every call, whether the IMU files are passed, the frames per
chunk of a live (streaming) calibration, and how the
window's time is divided into its end-to-end metric (``per``: seconds per
completed ``call`` or per published ``chunk``).  Calls run back to back from
one client (a closed loop): a user hands the program a recording and waits
for its calibration.  Every call writes its outputs into a directory of its
own, where the reference reads them once the window has closed.
"""
from __future__ import annotations

import dataclasses
import importlib
import logging
import os
import time

import torch


class _Capture(logging.Handler):
    """The program's structured log records: the engine's phase timers
    (``timings`` extra), the streaming calibrator's chunks (``chunk`` extra)
    and, after each chunk, the status line the CLI publishes for it."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.reset()

    def reset(self):
        self.timings = None
        self.chunks = []
        self.published = []

    def emit(self, record):
        if hasattr(record, "timings"):
            self.timings = dict(record.timings)
        if hasattr(record, "chunk"):
            self.chunks.append(dict(record.chunk))
        elif (len(self.published) < len(self.chunks)
              and isinstance(record.msg, str)
              and record.msg.startswith("status=")
              and isinstance(record.args, tuple) and len(record.args) == 5):
            status, _, _, iters, ts = record.args
            self.published.append({"status": status, "iters": int(iters),
                                   "ts": float(ts)})


_LOGGERS = ("vicalib_tpu_torch.engine", "vicalib_tpu_torch.streaming",
            "vicalib")


@dataclasses.dataclass
class Call:
    out: str
    wall_s: float
    rc: int
    error: str
    timings: dict
    chunks: list
    published: list
    traced: bool = False


def cli_argv(conf, traffic, paths, out, dtype):
    """The command line of one call: the rig's models and target, the
    seed's files, this call's output directory, the solver precision and
    the traffic's own flags."""
    argv = ["-models", ",".join(c["model"] for c in conf["rig"]["cameras"]),
            "-grid_preset", conf["target"]["preset"],
            "-cam", "file://[%s]" % ",".join(
                os.path.join(d, "*.pgm") for d in paths["cams"]),
            "-output", os.path.join(out, "cameras.xml"),
            "-output_log_file", os.path.join(out, "vicalibrator.log"),
            "-dtype", dtype]
    if traffic["imu"]:
        argv += ["-imu", "csv://" + paths["imu"]]
    if traffic.get("chunk"):
        argv += ["-stream_chunk", str(traffic["chunk"])]
    return argv + [f.replace("{out}", out) for f in traffic["flags"]]


class Client:
    """Runs calls of one traffic mix on ``device`` against the program."""

    def __init__(self, conf, traffic, paths, work, device, dtype):
        if traffic["entry"] != "cli":
            raise ValueError("unknown entry %r" % traffic["entry"])
        self._cli = importlib.import_module("vicalib_tpu_torch.cli")
        self.conf, self.traffic, self.paths = conf, traffic, paths
        self.work, self.device, self.dtype = work, device, dtype
        self.n = 0
        self._cap = _Capture()
        for name in _LOGGERS:
            logging.getLogger(name).addHandler(self._cap)

    def close(self):
        for name in _LOGGERS:
            logging.getLogger(name).removeHandler(self._cap)

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def call(self, label):
        """One call into its own directory (poses.txt is written into the
        working directory, so the call runs there)."""
        out = os.path.join(self.work, "%s%04d" % (label, self.n))
        self.n += 1
        os.makedirs(out)
        argv = cli_argv(self.conf, self.traffic, self.paths, out,
                        self.dtype)
        self._cap.reset()
        here = os.getcwd()
        err = ""
        t0 = time.perf_counter()
        try:
            os.chdir(out)
            rc = self._cli.main(argv, device=self.device)
            self._sync()
        except Exception as e:   # a failed call is counted, not fatal
            rc, err = -1, "%s: %s" % (type(e).__name__, e)
        finally:
            os.chdir(here)
        wall = time.perf_counter() - t0
        return Call(out=out, wall_s=wall, rc=rc, error=err,
                    timings=self._cap.timings, chunks=self._cap.chunks,
                    published=self._cap.published)

    def window(self, seconds, traced=None):
        """Calls back to back until ``seconds`` have passed; the call
        running at the deadline completes and counts.  With ``traced``, a
        context manager (the traced run's profiler and spans), one call
        runs inside it first and the window of untraced calls follows it.
        Returns the calls and the window's length."""
        calls = []
        if traced is not None:
            with traced:
                calls.append(dataclasses.replace(self.call("call"),
                                                 traced=True))
        t0 = time.perf_counter()
        while True:
            calls.append(self.call("call"))
            if time.perf_counter() - t0 >= seconds:
                break
        return calls, time.perf_counter() - t0


def end_to_end(traffic, calls, window_s):
    """The traffic's end-to-end metric: the window's seconds over the work
    completed in it."""
    if traffic["per"] == "call":
        n = sum(1 for c in calls if c.rc == 0)
    elif traffic["per"] == "chunk":
        n = sum(len(c.published) for c in calls if c.rc == 0)
    else:
        raise ValueError("unknown per %r" % traffic["per"])
    return window_s / n if n else float("inf")
