"""Seconds per calibration of the solve phase outside the LM iterations
(initializers, stage bookkeeping, final costs and weights): the program's
``vicalib.engine.solve`` span less its ``vicalib.lm.iter`` spans."""
from harness.spans import per_call_spans


def read(rec):
    return per_call_spans(rec, lambda sp: sp["vicalib.engine.solve"][1]
                          - sp["vicalib.lm.iter"][1])
