"""Seconds per calibration associating detected dots with the grid (the
native batch matcher, else the Python one): the program's
``vicalib.detect.match`` span."""
from harness.spans import per_call_span


def read(rec):
    return per_call_span(rec, "vicalib.detect.match")
