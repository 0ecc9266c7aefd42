"""Milliseconds an LM iteration waits at its one stop-test read
(``bool(converged)``, where the host waits for the device): the program's
``vicalib.lm.wait`` span over the iterations."""
from harness.spans import per_call_spans


def read(rec):
    return per_call_spans(rec, lambda sp: 1000.0 * sp["vicalib.lm.wait"][1]
                          / sp["vicalib.lm.iter"][0])
