"""Seconds per calibration in the LM steps after assembly (damped Schur
solves, retraction, trial costs, candidate selection): the program's
``vicalib.lm.step`` span."""
from harness.spans import per_call_span


def read(rec):
    return per_call_span(rec, "vicalib.lm.step")
