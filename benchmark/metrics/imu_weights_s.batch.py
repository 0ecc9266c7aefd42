"""Seconds per calibration in the IMU covariance-whitening refreshes
(``imu_weights``, every fourth LM iteration and after each stage): the
program's ``vicalib.lm.weights`` span."""
from harness.spans import per_call_span


def read(rec):
    return per_call_span(rec, "vicalib.lm.weights")
