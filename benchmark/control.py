"""Readings for the limits that decide ``correct``: a cell's compared numbers
over many seeds, for the program as the configuration states it and for the
control (the program's own lower-precision path, ``-dtype float32`` where
the configuration states float64).

  python3 benchmark/control.py --workload vi_sim.batch --dtype float32 \
      --seeds 1 2 3 [--out chiprun_out/control.jsonl]

Each seed is one run of the cell's traffic at its own size (the benchmark's
runner, one call in the window, no warm-up call); the numbers are printed,
and appended to ``--out`` as JSON lines, with the limits they are judged
by.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def readings(workload, seeds, dtype, device, n_frames=None, out=None):
    """[(seed, correct, checks)] of one window call per seed."""
    from harness import runner, spec

    cell = spec.load_cell(workload)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        res, _ = runner.run_cell(cell, seed, 0.0, False, device,
                                 n_frames=n_frames, dtype=dtype, warm=False)
        row = {"workload": workload, "dtype": dtype, "seed": seed,
               "correct": res["correct"], "failed": res["failed"],
               "seconds": time.perf_counter() - t0,
               "checks": res["checks"], "device": res["device"]}
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append((seed, res["correct"], res["checks"]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.dtype, "cuda", out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
