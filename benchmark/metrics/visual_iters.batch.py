"""LM iterations of a calibration's visual stage (the result log's
``stage visual`` row), where a start far from the truth shows; a count."""
from harness.readers import untraced


def read(rec):
    vals = [sum(i for name, i in c["stages"] if name == "visual")
            for c in untraced(rec)
            if any(name == "visual" for name, _ in c["stages"])]
    return sum(vals) / len(vals) if vals else None
