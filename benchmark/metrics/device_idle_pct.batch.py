"""The share of the traced window in which no kernel, copy or set ran on
the device (100 minus the union of device intervals over the window)."""
from harness.readers import device_idle_pct


def read(rec):
    return device_idle_pct(rec)
