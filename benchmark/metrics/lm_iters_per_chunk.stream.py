"""LM iterations per published chunk of a live calibration (the streaming
calibrator's chunk records); a count."""
from harness.readers import untraced


def read(rec):
    chunks = [ch for c in untraced(rec) for ch in c["chunks"]]
    if not chunks:
        return None
    return sum(ch["iterations"] for ch in chunks) / len(chunks)
