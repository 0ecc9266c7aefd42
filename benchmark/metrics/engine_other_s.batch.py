"""Seconds of a calibration outside the engine's phase timers: the harness's
wall time around ``cli.main`` less the sum of read, detect, build and solve
(argument parsing, engine set-up, outputs, the report)."""
from harness.readers import per_call


def read(rec):
    return per_call(rec, lambda c: c["wall_s"] - sum(c["timings"].values()))
