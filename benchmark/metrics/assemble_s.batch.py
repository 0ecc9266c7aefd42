"""Seconds per calibration assembling the normal equations of the LM
iterations: the program's ``vicalib.lm.assemble`` span."""
from harness.spans import per_call_span


def read(rec):
    return per_call_span(rec, "vicalib.lm.assemble")
