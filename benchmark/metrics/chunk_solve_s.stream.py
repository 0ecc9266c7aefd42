"""Seconds per chunk in its warm-started staged re-solve (the program's
``vicalib.live.solve`` span)."""
from harness.spans import per_span


def read(rec):
    return per_span(rec, "vicalib.live.solve")
