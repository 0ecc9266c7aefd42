"""Seconds per calibration starting the intrinsics from the target's
homographies (inside the build phase): the program's
``vicalib.engine.intr_start`` span.  A program without the span reads as
nothing."""
from harness.spans import per_call_span


def read(rec):
    return per_call_span(rec, "vicalib.engine.intr_start")
