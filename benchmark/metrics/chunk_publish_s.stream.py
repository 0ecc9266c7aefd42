"""Seconds per chunk publishing its estimate: stats, the HTML report
rewritten, the scene (the program's ``vicalib.live.publish`` span)."""
from harness.spans import per_span


def read(rec):
    return per_span(rec, "vicalib.live.publish")
