"""Benchmark of vicalib_tpu_torch on one CUDA card.

  python3 benchmark/run.py --workload vi_sim.batch --seed 7 --seconds 10 \
      --trace 0

Runs one cell of BENCHMARK.json from the root of a checkout: renders the
cell's rig from ``--seed`` (harness/sim.py, a frozen copy of the
simulator), writes the frames and IMU CSV a user hands the program, warms up
with one call of the cell's traffic (set-up), then calls the program back to
back for ``--seconds`` (the window).  With ``--trace 0`` it reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from
the program's timers and logs and from a torch.profiler trace of the
window.  Once the window has closed, every call's outputs are checked
against a plain calibration of the same files (harness/reference.py,
plainref/) with the cell's limits (limits/<workload>.json).  The last lines on standard error are the numbers
compared beside their limits; the last line on standard output is the
result as one JSON object.

Exits non-zero, with no result, without as many CUDA cards as the cell asks
for, when the program is not in this checkout, or when the run loaded JAX
or the JAX package.
"""
from __future__ import annotations

import os
import sys
import time


def _since_process_start():
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


T0 = time.perf_counter() - _since_process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [ROOT, HERE]

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402


def main(argv=None):
    # imported here: the reference's matcher workers re-import this module
    import torch

    from harness import runner, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("%s needs %d CUDA card(s); torch sees %s" % (
            args.workload, cell.chips, torch.cuda.device_count()
            if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 2
    try:
        result, _ = runner.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", t0=T0)
    except runner.ForbiddenImport as e:
        print("FORBIDDEN IMPORT: %s" % e, file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("correct %s: %d calls, %d failed" % (
        result["correct"], result["attempted"], result["failed"]),
        file=sys.stderr)
    for name, c in result["checks"].items():
        print("check %-20s %.6g (limit %.6g) %s" % (
            name, c["value"], c["limit"],
            "ok" if c["value"] <= c["limit"] else "OVER"), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


def _finite(x):
    """The result with every non-finite number as null (JSON has none)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
