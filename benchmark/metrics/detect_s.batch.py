"""The engine's ``detect`` phase timer (device-synchronised), seconds per
calibration."""
from harness.readers import per_call


def read(rec):
    return per_call(rec, lambda c: c["timings"]["detect"])
