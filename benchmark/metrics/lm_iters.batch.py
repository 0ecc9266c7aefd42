"""LM iterations of a calibration, summed over its stages (the result
log's stage rows); a count."""
from harness.readers import per_call


def read(rec):
    return per_call(rec, lambda c: sum(i for _, i in c["stages"]))
