"""Shared arithmetic of the per-layer metric readers (metrics/*.py).  Each
reader takes the traced run's record and returns a number, or None where
it finds nothing to read."""
from __future__ import annotations


def untraced(rec):
    """The window's completed calls that ran without the profiler (in a
    traced run it is open around the first call alone)."""
    return [c for c in rec["calls"] if c["rc"] == 0 and not c["traced"]]


def per_call(rec, fn):
    """Mean of ``fn`` over the window's completed untraced calls."""
    vals = [fn(c) for c in untraced(rec) if c["timings"]]
    return sum(vals) / len(vals) if vals else None


def device_idle_pct(rec):
    t = rec["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline_pct(rec):
    t = rec["trace"]
    if not t or not t["kernel_device_s"] or not rec["kernel_bytes"] \
            or not rec["peaks"]:
        return None
    least_s = rec["kernel_bytes"] / rec["peaks"]["hbm_bytes_per_s"]
    return 100.0 * least_s / t["kernel_device_s"]
