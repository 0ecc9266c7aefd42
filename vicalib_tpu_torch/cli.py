"""Command-line entry point, flag-compatible with the reference's vicalib.

Reference analog: src/main.cc:13-31 + the gflags inventory.  Accepts both
``--flag value`` and gflags-style ``-flag value`` / ``-noflag`` booleans
(README.md:56's negation convention).

Runs on the CUDA device (the engine raises when there is none).  The
multi-device flags (-n_shards, -coordinator_address, -num_processes) are
not ported yet and raise NotImplementedError.  Usage example, a stereo
camera-IMU rig:
  python -m vicalib_tpu_torch.cli -models linear,linear \
      -cam 'file://[<dir0>/*.pgm,<dir1>/*.pgm]' -imu 'csv://<imu_dir>' \
      -nouse_only_when_static
Live mode: ``-stream_chunk 32`` re-solves every 32 frames, ``-report_file
report.html`` rewrites an HTML report after each chunk and ``-status_port
8080`` serves stats.json, the report and a scene SVG over HTTP.  Long
solves: ``-checkpoint_file state.npz`` after every stage, ``-resume_file
state.npz`` to continue; ``-profile_dir <dir>`` writes a torch.profiler
Chrome trace of the solve.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from .config import VicalibConfig


# config fields that are not command-line flags
_NOT_FLAGS = ("device",)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vicalib",
        description="visual-inertial calibration on a CUDA device (PyTorch port)",
        prefix_chars="-",
    )
    for f in dataclasses.fields(VicalibConfig):
        name = f.name
        if name in _NOT_FLAGS:
            continue
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(f"--{name}", f"-{name}", dest=name,
                           action="store_true", default=None)
            p.add_argument(f"--no{name}", f"-no{name}", dest=name,
                           action="store_false", default=None)
        else:
            typ = type(f.default)
            p.add_argument(f"--{name}", f"-{name}", dest=name, type=typ,
                           default=None)
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    return p


def parse_args(argv=None) -> tuple[VicalibConfig, argparse.Namespace]:
    parser = _build_parser()
    ns = parser.parse_args(argv)
    cfg = VicalibConfig()
    for f in dataclasses.fields(VicalibConfig):
        if f.name in _NOT_FLAGS:
            continue
        v = getattr(ns, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    return cfg, ns


def main(argv=None, device="cuda") -> int:
    """Run the CLI on ``device`` (a keyword for callers in Python; the
    command line always uses the CUDA device)."""
    cfg, ns = parse_args(argv)
    cfg.device = device
    logging.basicConfig(
        level=logging.DEBUG if ns.verbose else logging.INFO,
        format="%(levelname).1s %(name)s: %(message)s")
    log = logging.getLogger("vicalib")

    if not cfg.cam:
        if cfg.output_pattern_file:
            from .engine import make_grid
            make_grid(cfg)
            return 0
        log.error("No camera URI given")
        return 1

    from .engine import VicalibEngine

    def print_stats(stats):
        log.info("status=%s mse=%.6g rmse=%s iters=%d ts=%.6g",
                 stats.status.name, stats.total_mse,
                 ["%.4f" % r for r in stats.reprojection_error],
                 stats.num_iterations, stats.ts)

    engine = VicalibEngine(cfg, update_stats_callback=print_stats)
    result = engine.run()
    for c, name in enumerate(result.model_names):
        log.info("camera %d (%s): params %s", c, name,
                 result.stats.cam_intrinsics[c])
    log.info("wrote %s; success=%s", cfg.output, result.success)
    return 0 if result.success else 2


if __name__ == "__main__":
    sys.exit(main())
