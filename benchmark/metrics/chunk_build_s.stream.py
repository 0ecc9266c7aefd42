"""Seconds per chunk building the padded problem and carrying the previous
estimate over (the program's ``vicalib.live.build`` span)."""
from harness.spans import per_span


def read(rec):
    return per_span(rec, "vicalib.live.build")
