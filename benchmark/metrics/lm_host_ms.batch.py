"""Host milliseconds of an LM iteration outside its stop-test read: the
program's ``vicalib.lm.iter`` span less its ``vicalib.lm.wait`` span, over
the iterations (the result log's span rows)."""
from harness.spans import per_call_spans


def read(rec):
    return per_call_spans(rec, lambda sp: 1000.0 * (
        sp["vicalib.lm.iter"][1] - sp["vicalib.lm.wait"][1])
        / sp["vicalib.lm.iter"][0])
